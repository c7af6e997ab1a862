"""Device time of one call under torch.profiler: the sum of its kernels'
device times (the device's busy time) beside the call's wall time.

Used by `python -m parq_torch.bench` (its `device_busy_ms`) and by
chip_smoke.py's profiles.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch


def device_profile(run: Callable[[], object],
                   device="cuda") -> Optional[dict]:
    """Profile one call of `run` on `device`: {"wall_ms", "busy_ms",
    "kernels": [(name, device ms, count), ...] by device time}, or None
    when the profiler saw no device time (a CPU device, or a tracer that
    recorded nothing)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    device = torch.device(device)
    if device.type != "cuda":
        return None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the tracer can miss the first kernel after it starts: give it one
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        return None
    return {"wall_ms": wall_ms,
            "busy_ms": sum(ms for _, ms, _ in kernels),
            "kernels": sorted(kernels, key=lambda k: -k[1])}

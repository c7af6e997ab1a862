"""Device time of one call under torch.profiler: the union of its
kernels' device intervals (the device's busy time: two kernels that
overlap count once) beside the call's wall time, and each kernel's summed
device time. The device spans of user annotations (`record_function`
ranges such as `Optimizer.step`, and the recorder's spans) are not kernels
and are left out.

Used by `python -m parq_torch.bench` (its `device_busy_ms`) and by
chip_smoke.py's profiles.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch


def device_profile(run: Callable[[], object],
                   device="cuda") -> Optional[dict]:
    """Profile one call of `run` on `device`: {"wall_ms", "busy_ms" (the
    union of the kernels' intervals), "kernels": [(name, device ms, count),
    ...] by summed device time}, or None when the profiler saw no device
    time (a CPU device, or a tracer that recorded nothing)."""
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
    # a record_function range (Optimizer.step, zero_grad) shows on the
    # device as the span of its kernels: counted, they would be counted
    # twice (torch's own table leaves them out too)
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.self_device_time_total > 0]
    if not kernels:
        return None
    return {"wall_ms": wall_ms,
            "busy_ms": union_ms([
                (e.time_range.start, e.time_range.end)
                for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]),
            "kernels": sorted(kernels, key=lambda k: -k[1])}


def union_ms(intervals) -> float:
    """The length in ms of the union of (start, end) intervals in µs."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3

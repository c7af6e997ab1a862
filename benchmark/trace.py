"""A profiled stretch of a window: the device's operations and copies from
`torch.profiler`'s trace, and what they add up to.

`Stretch` wraps part of a window in the profiler and in a host range
named ``bench.stretch``; the device is synchronised on entry and before
the range closes, so every operation launched inside has ended inside.
Busy time is the union of the device's intervals (kernels, copies,
fills), not their sum: two overlapping kernels count once. Host ranges
that the loops open with `span` (``bench.*``) name the idle gaps.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Tuple

import torch

Interval = Tuple[str, float, float]      # name, start, end (microseconds)


@contextlib.contextmanager
def span(name: str, on: bool):
    """A host range `name` in the trace, when tracing is `on`."""
    if not on:
        yield
        return
    with torch.profiler.record_function(name):
        yield


def union(intervals: List[Tuple[float, float]], lo: float, hi: float
          ) -> List[Tuple[float, float]]:
    """The union of `intervals` clipped to [lo, hi], sorted, disjoint."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Stretch:
    """The device trace of the code run inside `with Stretch(device):`."""

    def __init__(self, device, on: bool = True):
        self.device, self.on = torch.device(device), on
        self.ops: List[Interval] = []       # kernels, copies, fills
        self.host: List[Interval] = []      # the loops' bench.* ranges
        self.lo = self.hi = 0.0
        self._prof = None

    def __enter__(self):
        if not self.on:
            return self
        from torch.profiler import ProfilerActivity, profile
        cuda = self.device.type == "cuda"
        self._sync()
        self._prof = profile(activities=[ProfilerActivity.CPU]
                             + ([ProfilerActivity.CUDA] if cuda else []))
        self._prof.__enter__()
        torch.zeros(1, device=self.device)   # the tracer's first kernel
        self._sync()
        self._range = torch.profiler.record_function("bench.stretch")
        self._range.__enter__()
        return self

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __exit__(self, *exc):
        if not self.on:
            return False
        self._sync()
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        return False

    def _read(self) -> None:
        """The trace's events, read on first use: after the window, so
        that reading them takes no time from the work it measures."""
        if self._prof is None:
            return
        from torch.autograd import DeviceType
        events, self._prof = self._prof.events(), None
        for e in events:
            name = e.name
            s, t = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if getattr(e, "is_user_annotation", False) or \
                        name.startswith(("bench.", "Optimizer.",
                                         "ProfilerStep")):
                    continue
                self.ops.append((name, s, t))
            elif name.startswith("bench."):
                if name == "bench.stretch":
                    self.lo, self.hi = s, t
                else:
                    self.host.append((name, s, t))
        if self.hi <= self.lo:
            raise RuntimeError("the trace has no bench.stretch range")

    # -- readings ----------------------------------------------------------

    def window_s(self) -> float:
        self._read()
        return (self.hi - self.lo) / 1e6

    def busy_s(self) -> float:
        self._read()
        return sum(e - s for s, e in union([(s, e) for _, s, e in self.ops],
                                           self.lo, self.hi)) / 1e6

    def device_s(self, match: Callable[[str], bool]) -> float:
        """Summed device seconds of the operations whose name matches."""
        self._read()
        return sum(min(e, self.hi) - max(s, self.lo)
                   for n, s, e in self.ops
                   if match(n) and min(e, self.hi) > max(s, self.lo)) / 1e6

    def idle_in(self, span: str) -> List[float]:
        """For each host range named `span`: the seconds of it in which
        the device ran nothing (the range's length less the union of the
        device's intervals inside it)."""
        self._read()
        busy = union([(s, e) for _, s, e in self.ops], self.lo, self.hi)
        return [((hi - lo) - sum(min(e, hi) - max(s, lo) for s, e in busy
                                 if e > lo and s < hi)) / 1e6
                for n, lo, hi in self.host if n == span]

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s()

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time (by name), and the
        idle gaps summed by the innermost host range open at each gap's
        middle."""
        self._read()
        by_name: Dict[str, float] = {}
        for n, s, e in self.ops:
            d = min(e, self.hi) - max(s, self.lo)
            if d > 0:
                key = n[:120]
                by_name[key] = by_name.get(key, 0.0) + d / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = union([(s, e) for _, s, e in self.ops], self.lo, self.hi)
        gaps, prev = [], self.lo
        for s, e in busy + [(self.hi, self.hi)]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        hosts = sorted(self.host, key=lambda h: h[2] - h[1])
        by_host: Dict[str, float] = {}
        for s, e in gaps:
            mid = 0.5 * (s + e)
            label = next((n for n, hs, he in hosts if hs <= mid <= he),
                         "host outside the benchmark's ranges")
            by_host[label[:120]] = by_host.get(label[:120], 0.0) \
                + (e - s) / 1e6
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in idle]}


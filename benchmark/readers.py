"""Helpers of the per-layer metric readers (``metrics/<name>.py``). A
reader returns None where the run gave it nothing to read, never 0 for a
share of a roofline or of a peak."""
from __future__ import annotations

import statistics
from typing import Callable, Optional, Sequence

from .work.peaks import BF16_FLOP_PER_S


def kernel_name(demangled: str) -> str:
    """A kernel's own name from the trace's demangled signature: no
    return type, namespaces, template arguments or parameters."""
    name = demangled.replace("(anonymous namespace)", "")
    name = name.split("(")[0].split("<")[0].split()[-1:] or [""]
    return name[0].split("::")[-1]


def starts(*prefixes: str) -> Callable[[str], bool]:
    """Whether a kernel's own name starts with one of `prefixes`."""
    return lambda name: kernel_name(name).startswith(prefixes)


def share_of_bound(bound_s: float, spent_s: Optional[float]
                   ) -> Optional[float]:
    """bound / time as a percentage, or None without a time."""
    if not spent_s or spent_s <= 0:
        return None
    return 100.0 * bound_s / spent_s


def mfu(flops: float, seconds: Optional[float]) -> Optional[float]:
    """flops over seconds as a percentage of the bf16 peak."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * flops / seconds / BF16_FLOP_PER_S


def device_per(run, match, count_key: str) -> Optional[float]:
    """Device seconds of the matching operations in the traced stretch,
    per unit of `count_key` (steps, batches, forwards)."""
    n = run.counts.get(count_key, 0)
    if run.trace is None or not n:
        return None
    t = run.trace.device_s(match)
    return t / n if t > 0 else None


def idle_percent(run) -> Optional[float]:
    if run.trace is None or run.trace.window_s() <= 0:
        return None
    return 100.0 * run.trace.idle_share()


def median_ms(values: Sequence[float]) -> Optional[float]:
    return 1e3 * statistics.median(values) if values else None

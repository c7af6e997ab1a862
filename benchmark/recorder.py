"""What the per-layer readers take from the program's own recorder
(`parq_torch.telemetry`): its snapshot after the run, and the device marks
of each batch placed on the host clock.

A program without the recorder (an older checkout) gives no snapshot and
every reader returns None. Per batch (one replay of the graphed forward
and the parse of its outputs) the marks are ``replay_start`` (after the
graph's copy-in, before the replay), ``replay_end`` and ``decode_end`` (the
end of parse_pred's device half). The readers take the batches made
before a profiler first ran in the process: the profiler slows the
stretch it traces, and a traced run's batches after that stretch run
slower too (the host's launches take longer once the profiler has run).
They read the recorder's head (the first spans and marks it kept) and,
where nothing fell out of its ring, the ring after it: a faster loop
makes them read fewer of the run's first batches, never others.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional

MARKS = ("replay_start", "replay_end", "decode_end")


def snapshot(run) -> Optional[dict]:
    """The recorder's snapshot, taken once per run; None where the program
    has no recorder."""
    snap = getattr(run, "_recorder_snapshot", False)
    if snap is False:
        try:
            from parq_torch import telemetry
        except ImportError:
            snap = None
        else:
            snap = telemetry.snapshot()
        run._recorder_snapshot = snap
    return snap


def unprofiled(run) -> List[dict]:
    """The kept spans and marks of the batches before the first one a
    profiler saw: those before the events that fell out of the ring, if
    any did (the head is the start of the run: whatever it holds came
    before a profiled batch it does not hold); all of them where none was
    profiled."""
    snap = snapshot(run)
    if snap is None:
        return []
    ring = snap["ring"]
    if snap["dropped"]:
        ring = ring[:snap["dropped_at"]]
    first = min((e["batch"] for e in ring if e["profiled"]), default=None)
    return [e for e in ring if first is None or e["batch"] < first]


def batches(run) -> Dict[int, Dict[str, int]]:
    """{batch id: {mark: host-clock ns}} of the unprofiled batches whose
    three marks were all placed."""
    got: Dict[int, Dict[str, int]] = {}
    for e in unprofiled(run):
        if e["kind"] == "mark" and e["name"] in MARKS and \
                e["at_ns"] is not None:
            got.setdefault(e["batch"], {})[e["name"]] = e["at_ns"]
    return {b: m for b, m in got.items() if len(m) == len(MARKS)}


def gaps_ms(run, first: str, then: str, next_batch: bool = False
            ) -> List[float]:
    """Per batch, `then` − `first` in ms; with `next_batch`, `then` of the
    batch that follows (ids one apart)."""
    bs = batches(run)
    return [(bs[b + next_batch][then] - m[first]) / 1e6
            for b, m in sorted(bs.items()) if b + next_batch in bs]


def median(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None


def span_ms(run, name: str) -> List[float]:
    """The unprofiled batches' spans `name`, in ms."""
    return [(e["end_ns"] - e["start_ns"]) / 1e6 for e in unprofiled(run)
            if e["kind"] == "span" and e["name"] == name]


def per_call(run, counter: str, span: str) -> Optional[float]:
    """The counter `counter` over the count of the spans `span`, over the
    whole run; None where either was not recorded."""
    snap = snapshot(run)
    if snap is None or counter not in snap["counters"] or \
            span not in snap["spans"]:
        return None
    return snap["counters"][counter] / snap["spans"][span]["count"]


def total_s(run, *names: str, key: str = "total_s") -> Optional[float]:
    """The summed seconds of the spans `names` over the whole run (set-up
    included), `key` "total_s" or "self_s" (less their child spans); None
    where none was recorded."""
    snap = snapshot(run)
    if snap is None:
        return None
    got = [snap["spans"][n][key] for n in names if n in snap["spans"]]
    return sum(got) if got else None

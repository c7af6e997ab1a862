"""The port's recorder: spans, counters and device marks at its layer
boundaries, kept in memory and read with `snapshot()`.

    from parq_torch import telemetry
    with telemetry.span("parse_pred.nms"):
        ...
    telemetry.count("kernels.builds")
    telemetry.count_later(lambda: {"parse_pred.kept": int(mask.sum())})
    telemetry.mark("decode_end")          # a CUDA event on the stream
    snap = telemetry.snapshot()

A **span** records its name, its start and end (`time.perf_counter_ns`),
its parent (the innermost span open on the same thread) and the thread's
batch id: `next_batch()` (called by `graphs.Graphed` on every call) opens
a batch, and every span and mark that follows on that thread, the parse
of the outputs too, carries its id. Per name the recorder keeps the count,
the total, the longest and the self time (the total less the time inside
its child spans). The spans and marks themselves are kept in order: the
first `HEAD` since the recorder was emptied (the start of a run, its
set-up and first batches, whatever follows) and the newest `RING` after
them in a ring; `snapshot()` says how many fell between the two. A
**counter** adds up a number under a name.

While a `torch.profiler` is active, a span also opens a `record_function`
range of its name, so the span lies on the profiler's clock beside the
kernels. Without the profiler the device is seen through **marks**: CUDA
timing events from a fixed pool (`MARKS` of them), recorded on the current
stream, in two consecutive batches of every `MARK_EVERY` (so that the gap
from one batch to the next is seen too; an event recorded on an idle
stream costs the host tens of microseconds, a share of a batch that every
batch would pay). An **anchor** (`anchor()`, taken by `parse_pred` and
`petr_decode` right after their blocking copies to the host, when the
stream has drained, at most once a tenth of a second) pairs a host time with an event that runs
within microseconds of it; a mark is placed on the host clock as the
latest anchor's host time plus the device time from the anchor to the
mark. The placement is exact only where the stream is empty at the
anchor, as in a loop that waits for each batch's detections; where later
work was queued before the anchor, its marks come out early by the queued
time (such a mark is placed before the host time that enqueued it, which
`snapshot()` counts under ``marks.placed_before_enqueue``). Marks are
placed by `resolve()` and `snapshot()`, without a sync: a mark whose event
has not run yet waits for a later call; one whose pool slot comes round
again first is dropped.

Every span and mark records whether a profiler was active when it was
made, so that readers can leave out a profiled stretch. While the current
stream is capturing a CUDA graph the recorder records nothing: no span,
no counter, and above all no mark, which would become a node of the graph.
On the hot path the recorder does not sync, allocates no device memory,
takes no lock (it appends to a queue that `resolve()` folds in) and keeps
no structure that grows with the number of calls.

The recorder is on by default, as an operator's metrics registry is;
`enable(False)` turns it off (nothing is recorded and spans open no
profiler range) and exists to measure what it costs. `reset()` empties it.
"""
from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import deque
from typing import Callable, Dict

import torch

HEAD = 65536          # the first spans and marks kept (≈ 9,000 eval batches)
RING = 65536          # the newest spans and marks kept after them
MARKS = 8192          # CUDA events in the mark pool (≈ 11,000 eval batches)
ANCHORS = 64          # CUDA events in the anchor pool
FOLD_AT = 512         # events queued before a call folds them in itself
MARK_EVERY = 8        # marks on two consecutive batches in every MARK_EVERY
ANCHOR_EVERY_NS = 100_000_000       # at most one anchor a tenth of a second

_profiling = torch._C._autograd._profiler_enabled
_stream_capturing = torch._C._cuda_isCurrentStreamCapturing  # CUDA builds
_now = time.perf_counter_ns


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return torch.cuda.is_initialized() and _stream_capturing()


# a placed mark is a list ["mark", name, enqueued ns, placed ns, batch,
# profiled, parent, anchor, pool slot]; these are the fields that change
_AT, _ANCHOR, _SLOT = 3, 7, 8


class _Span:
    __slots__ = ("rec", "name", "t0", "frame", "range", "stack")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        if not rec.on or _capturing():
            self.stack = None
            return self
        local = rec._local
        try:
            stack = local.stack
        except AttributeError:
            stack = local.stack = []
        self.stack = stack
        self.frame = [self.name, 0]          # name, ns inside child spans
        stack.append(self.frame)
        self.range = None
        if _profiling():
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = _now()
        return self

    def _close(self, t1: int, exc=(None, None, None)) -> None:
        if self.range is not None:
            self.range.__exit__(*exc)
        stack = self.stack
        parent = stack[-2] if len(stack) > 1 else None
        if parent is not None:
            parent[1] += t1 - self.t0
        rec = self.rec
        rec._queue.append(("span", self.name, self.t0, t1, self.frame[1],
                           parent[0] if parent else None,
                           getattr(rec._local, "batch", 0),
                           self.range is not None))
        if len(rec._queue) > FOLD_AT:
            rec._fold()

    def __exit__(self, *exc):
        if self.stack is None:
            return False
        self._close(_now(), exc)
        self.stack.pop()
        return False

    def next(self, name: str) -> None:
        """End this span and start its sibling `name` in its place: one
        span a phase of a sequence, at less cost than a span each."""
        if self.stack is None:
            return
        self._close(_now())
        self.name = self.frame[0] = name
        self.frame[1] = 0
        if self.range is not None:
            self.range = torch.autograd.profiler.record_function(name)
            self.range.__enter__()
        self.t0 = _now()


class Recorder:
    """Spans, counters and device marks (see the module's docstring). The
    module's functions use one process-wide recorder; tests make their
    own.

    The hot path only records: a span, count or mark appends one tuple to
    a queue (deque appends are atomic, so it takes no lock). `_fold`
    moves the queue into the aggregates, counters and ring under the
    lock; `resolve` folds first, and the hot path folds once the queue
    passes FOLD_AT."""

    def __init__(self):
        self.on = True
        self._lock = threading.Lock()
        self._local = threading.local()
        self._batches = itertools.count(1)
        self._mark_seq = itertools.count()
        self._anchor_seq = itertools.count(1)
        self._pool = self._anchor_pool = self._device = None
        self._stream_cache = (None, None)    # (current stream's key, Stream)
        self._queue: deque = deque()
        self.reset()

    def reset(self) -> None:
        """Forget every span, counter and mark (the pools are kept)."""
        with self._lock:
            self._queue.clear()
            # name: [count, ns, max ns, self ns (less its child spans)]
            self._agg: Dict[str, list] = {}
            self._counters: Dict[str, float] = {}
            self._head: list = []
            self._ring: deque = deque(maxlen=RING)
            self._dropped = 0       # events that fell out of the ring
            self._pending: deque = deque(maxlen=MARKS)
            self._slots = [None] * MARKS             # the mark each holds
            self._anchor = None     # [event, host ns, slot, sequence]
            self._last_anchor = -ANCHOR_EVERY_NS
            self._anchor_gen = [0] * ANCHORS
            self._marks = {"made": 0, "placed": 0, "dropped": 0}

    def enable(self, on: bool = True) -> None:
        """Turn recording on or off (off: to measure what it costs)."""
        self.on = bool(on)

    # -- spans and counters ------------------------------------------------

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def batch(self) -> int:
        """The current thread's batch id (0 before its first batch)."""
        return getattr(self._local, "batch", 0)

    def next_batch(self) -> int:
        """Open a new batch on this thread: the spans and marks that follow
        carry its id. Marks are made in two consecutive batches of every
        MARK_EVERY."""
        if self.on:
            b = self._local.batch = next(self._batches)
            self._local.marking = b % MARK_EVERY < 2
        return self.batch()

    def span(self, name: str) -> _Span:
        """A context manager that records a span `name`."""
        return _Span(self, name)

    def count(self, name: str, n: float = 1) -> None:
        """Add `n` to the counter `name`."""
        if self.on and not _capturing():
            self._queue.append(("count", name, n))

    def count_later(self, counts: Callable[[], Dict[str, float]]) -> None:
        """Add to each counter what `counts()` returns for it; `counts` is
        called when the queue is folded in, off the caller's path (so it
        must not read state that changes before then)."""
        if self.on and not _capturing():
            self._queue.append(("later", counts))

    # -- device marks --------------------------------------------------------

    def _stream(self):
        """The current CUDA stream where a mark can be made on it, else
        None: off, no CUDA, a capture under way, or another device than
        the first that asked (the pools are made on it, and marks stay
        there). The Stream object is kept while the stream stays current
        (making one costs more than recording an event)."""
        if not self.on:
            return None
        if self._pool is None:
            if not torch.cuda.is_initialized():
                return None
            with self._lock:
                if self._pool is None:
                    self._anchor_pool = [
                        torch.cuda.Event(enable_timing=True)
                        for _ in range(ANCHORS)]
                    self._device = torch._C._cuda_getDevice()
                    self._pool = [torch.cuda.Event(enable_timing=True)
                                  for _ in range(MARKS)]
        if _stream_capturing():
            return None
        key = torch._C._cuda_getCurrentStream(-1)   # the current device's
        cached = self._stream_cache
        if cached[0] != key:
            if key[1] != self._device:
                return None
            cached = (key, torch.cuda.Stream(stream_id=key[0],
                                             device_index=key[1],
                                             device_type=key[2]))
            self._stream_cache = cached
        return cached[1]

    def mark(self, name: str) -> None:
        """Record a timing event `name` on the current CUDA stream (nothing
        without CUDA, while off, while the stream captures, or in a batch
        that `next_batch` left unmarked)."""
        if not getattr(self._local, "marking", True):
            return
        stream = self._stream()
        if stream is None:
            return
        i = next(self._mark_seq) % MARKS
        t = _now()
        self._pool[i].record(stream)
        stack = self._stack()
        self._queue.append(("mark", name, t, self.batch(), _profiling(),
                            stack[-1][0] if stack else None, i))

    def anchor(self) -> None:
        """Pair the host clock with the device's: an event recorded now,
        where the stream has just drained (after a blocking copy to the
        host), and the host time. Marks made after it are placed from it.
        One a tenth of a second is enough (the two clocks drift apart by
        microseconds a second) and costs less: recording an event on an
        idle stream costs the host tens of microseconds."""
        if _now() - self._last_anchor < ANCHOR_EVERY_NS:
            return
        stream = self._stream()
        if stream is None:
            return
        self._last_anchor = _now()
        seq = next(self._anchor_seq)
        j = seq % ANCHORS
        self._anchor_pool[j].record(stream)
        self._queue.append(("anchor", j, seq, _now()))

    def _keep(self, e) -> None:
        """Keep a span or mark: in the head until it is full, then in the
        ring (under the lock)."""
        if len(self._head) < HEAD:
            self._head.append(e)
            return
        if len(self._ring) == self._ring.maxlen:
            self._dropped += 1
        self._ring.append(e)

    def _fold(self) -> None:
        """Move the queued events into the aggregates, counters, head and
        ring."""
        q = self._queue
        with self._lock:
            while True:
                try:
                    e = q.popleft()
                except IndexError:
                    return
                kind = e[0]
                if kind == "span":
                    _, name, t0, t1, child, parent, batch, profiled = e
                    d = t1 - t0
                    a = self._agg.get(name)
                    if a is None:
                        self._agg[name] = [1, d, d, d - child]
                    else:
                        a[0] += 1
                        a[1] += d
                        a[3] += d - child
                        if d > a[2]:
                            a[2] = d
                    self._keep(("span", name, t0, t1, parent, batch,
                                profiled))
                elif kind == "count":
                    c = self._counters
                    c[e[1]] = c.get(e[1], 0) + e[2]
                elif kind == "later":
                    c = self._counters
                    for name, n in e[1]().items():
                        c[name] = c.get(name, 0) + n
                elif kind == "mark":
                    _, name, t, batch, profiled, parent, i = e
                    m = ["mark", name, t, None, batch, profiled, parent,
                         self._anchor, i]
                    old, self._slots[i] = self._slots[i], m
                    if old is not None and old[_AT] is None:
                        self._marks["dropped"] += 1
                    self._marks["made"] += 1
                    self._keep(m)
                    self._pending.append(m)
                else:                                    # an anchor
                    _, j, seq, t = e
                    self._anchor_gen[j] = seq
                    self._anchor = [self._anchor_pool[j], t, j, seq]

    def resolve(self) -> None:
        """Fold the queue in, and place on the host clock the pending marks
        whose events have run (in order; no sync). Cheap where the host
        waits anyway."""
        self._fold()
        with self._lock:
            pending = self._pending
            while pending:
                m = pending[0]
                if self._slots[m[_SLOT]] is not m:   # its event was reused
                    pending.popleft()
                    continue
                a = m[_ANCHOR] or self._anchor
                if a is None:
                    return
                if self._anchor_gen[a[2]] != a[3]:   # so was its anchor's
                    pending.popleft()
                    m[_ANCHOR] = None
                    self._marks["dropped"] += 1
                    continue
                ev = self._pool[m[_SLOT]]
                if not (a[0].query() and ev.query()):
                    return
                m[_AT] = a[1] + int(1e6 * a[0].elapsed_time(ev))
                m[_ANCHOR] = None            # the anchor is no longer needed
                self._marks["placed"] += 1
                pending.popleft()

    # -- reading -------------------------------------------------------------

    def spans(self, prefix: str = "") -> Dict[str, dict]:
        """Per span name starting with `prefix`: count, total_s, max_s and
        self_s (the total less the time inside its child spans)."""
        self._fold()
        with self._lock:
            return {k: {"count": a[0], "total_s": a[1] / 1e9,
                        "max_s": a[2] / 1e9, "self_s": a[3] / 1e9}
                    for k, a in self._agg.items() if k.startswith(prefix)}

    def snapshot(self) -> dict:
        """Everything recorded: the span aggregates (`spans`), the counters
        with the kernels' launch counts as ``kernels.<name>.launches``
        (`counters`), the kept spans and marks in the order they were made
        (`ring`: the first HEAD, then the newest RING; dicts with `kind`
        "span" or "mark"; a mark's `at_ns` is its place on the host clock,
        None until placed), how many fell out between the two (`dropped`)
        and where (`dropped_at`: the index in `ring` of the first event
        after them; None while nothing has fallen out), and the marks'
        tallies (`marks`)."""
        from .kernels import launch_counts
        self.resolve()
        spans = self.spans()
        with self._lock:
            counters = dict(self._counters)
            ring = []
            late = 0
            for e in itertools.chain(self._head, self._ring):
                if e[0] == "span":
                    ring.append({"kind": "span", "name": e[1],
                                 "start_ns": e[2], "end_ns": e[3],
                                 "parent": e[4], "batch": e[5],
                                 "profiled": e[6]})
                else:
                    ring.append({"kind": "mark", "name": e[1],
                                 "enqueued_ns": e[2], "at_ns": e[_AT],
                                 "batch": e[4], "profiled": e[5],
                                 "parent": e[6]})
                    late += e[_AT] is not None and e[_AT] < e[2]
            marks = dict(self._marks, placed_before_enqueue=late)
            dropped = self._dropped
            dropped_at = len(self._head) if dropped else None
        for name, n in launch_counts().items():
            counters[f"kernels.{name}.launches"] = n
        return {"enabled": self.on, "spans": spans, "counters": counters,
                "ring": ring, "dropped": dropped, "dropped_at": dropped_at,
                "marks": marks}


RECORDER = Recorder()


def span(name: str) -> _Span:
    """Record a span `name` on the process's recorder (a context manager)."""
    return _Span(RECORDER, name)


def spanned(name: str):
    """Decorate a function so that each call is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with _Span(RECORDER, name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: float = 1) -> None:
    RECORDER.count(name, n)


def count_later(counts: Callable[[], Dict[str, float]]) -> None:
    RECORDER.count_later(counts)


def mark(name: str) -> None:
    RECORDER.mark(name)


def anchor() -> None:
    RECORDER.anchor()


def resolve() -> None:
    RECORDER.resolve()


def next_batch() -> int:
    return RECORDER.next_batch()


def snapshot() -> dict:
    return RECORDER.snapshot()


def spans(prefix: str = "") -> Dict[str, dict]:
    return RECORDER.spans(prefix)


def enable(on: bool = True) -> None:
    """Turn the process's recorder on or off. It is on by default; off
    exists to measure what recording costs."""
    RECORDER.enable(on)


def reset() -> None:
    RECORDER.reset()

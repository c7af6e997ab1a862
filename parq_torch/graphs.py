"""The port's counterpart of `jax.jit` on one card: a function captured
once per input signature as a CUDA graph and replayed after that.

`Graphed(fn)` works like jit's cache. Its key is the structure of the
arguments (dicts, tuples, lists), each tensor's shape, dtype and device,
each generator object and every other leaf's value. A generator is held
by the key: a new generator object is a new key and captures again (and
keeps a memory pool of its own), so a caller reuses one generator and
reseeds it. On the first call
of a key it copies the tensors into static buffers it owns, runs `fn` on
them eagerly on a side stream (the warm-up, which is that call's real
work: its result is returned), then captures `fn` on the same stream into
a `torch.cuda.CUDAGraph` (a capture records the launches and runs none).
Every later call of the key copies its tensors into the static buffers
(`non_blocking`), replays the graph and returns clones of the graph's
outputs, so a result outlives the next replay as a jitted call's result
does.

What a capture needs, and what provides it:
- no host sync and no host-to-device copy inside `fn`: the dropout seeds
  stay on the device (models/decoder.py:DropoutDraws), constants are
  uploaded once (geometry/obb.py, losses/set_loss.py, models/ray_pe.py),
  the matcher's LAP runs on the card (kernel M1);
- every random draw from a CUDA generator among the arguments: the graph
  registers it (`CUDAGraph.register_generator_state`), so a replay reads
  the generator's seed and offset and advances it as the eager call would,
  and draws the same numbers;
- the kernels launch on the current stream, take their scratch from
  torch's allocator and encode their TMA maps on the host by value, which
  holds on replay because the graph's buffers keep their addresses;
- autocast without its weight cache (models/parq.py turns it off while a
  capture is under way).
There is no fallback: a capture or a replay that fails raises.

Launch counts (`kernels.launch_counts`) are Python counters that a replay
does not run. The capture's launches are recorded and taken back out of
the counters (the capture ran nothing); each graph keeps them in a
`kernels.GraphLaunches` and counts its replays, so `launch_counts` reads as
it would for eager calls.

The recorder (`telemetry`) sees every call: a call opens a batch; the
first call of a key is the spans ``graphs.warmup`` and ``graphs.capture``,
a replay the spans ``graphs.copy_in``, ``graphs.replay`` and
``graphs.clone_out`` and the device marks ``replay_start`` (after the
copy-in) and ``replay_end``. The spans' counts are the captures and the
replays.

Tensors on the CPU run `fn` eagerly: the caller asked for the CPU.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils import _pytree as pytree

from . import telemetry
from .kernels import KERNELS, GraphLaunches


def _flatten(tree, leaves: List[Any]):
    """The structure of `tree` (dicts, tuples, lists; anything else is a
    leaf appended to `leaves`) as a hashable spec."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _flatten(v, leaves))
                              for k, v in tree.items()))
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(v, leaves) for v in tree))
    leaves.append(tree)
    return None


def _unflatten(spec, leaves):
    """`_flatten`'s inverse over an iterator of leaves."""
    if spec is None:
        return next(leaves)
    kind, items = spec
    if kind == "dict":
        return {k: _unflatten(s, leaves) for k, s in items}
    return kind(_unflatten(s, leaves) for s in items)


def _signature(x):
    """A leaf's part of the key: a tensor's shape, dtype and device; any
    other leaf itself (a generator hashes by identity, and the key holds
    it, so its identity cannot pass to another generator while the graph
    that registered it lives)."""
    if torch.is_tensor(x):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    return x


def _clone(tree):
    return pytree.tree_map(lambda t: t.clone() if torch.is_tensor(t) else t,
                           tree)


class _Capture:
    """One key's graph: its static input tensors, its outputs and the
    launches of one replay by kernel name."""

    def __init__(self, graph, inputs, outputs, launches):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.launches = GraphLaunches(launches)
        weakref.finalize(self, self.launches.fold)

    def replay(self, tensors):
        with telemetry.span("graphs.copy_in") as phase:
            moved = [(s, t) for s, t in zip(self.inputs, tensors)
                     if s is not t]
            if moved:
                dst, src = zip(*moved)
                torch._foreach_copy_(list(dst), list(src), non_blocking=True)
            phase.next("graphs.replay")
            telemetry.mark("replay_start")
            self.graph.replay()
            telemetry.mark("replay_end")
            phase.next("graphs.clone_out")
            out = _clone(self.outputs)
        self.launches.replays += 1
        return out


class Graphed:
    """`fn` captured once per input signature and replayed after that (see
    the module's docstring). `capture=False` is the eager path, for the
    paths that stay eager by rule; `reset()` drops every capture (after
    state the graphs read was replaced, e.g. an optimizer's by a
    checkpoint)."""

    def __init__(self, fn: Callable, capture: bool = True):
        self.fn, self.capture = fn, capture
        self._captures: Dict[Tuple, _Capture] = {}

    def reset(self) -> None:
        self._captures.clear()

    def __len__(self) -> int:
        return len(self._captures)

    def __call__(self, *args):
        telemetry.next_batch()
        leaves: List[Any] = []
        spec = _flatten(args, leaves)
        tensors = [x for x in leaves if torch.is_tensor(x)]
        if not self.capture or not tensors or \
                tensors[0].device.type != "cuda":
            return self.fn(*args)
        for g in leaves:
            if isinstance(g, torch.Generator) and g.device.type != "cuda":
                raise ValueError("a captured call draws only from CUDA "
                                 f"generators; got one on {g.device}")
        key = (spec, tuple(_signature(x) for x in leaves))
        cap = self._captures.get(key)
        if cap is None:
            out, self._captures[key] = self._capture(spec, leaves)
            return out
        return cap.replay(tensors)

    def _capture(self, spec, leaves):
        static = [x.clone() if torch.is_tensor(x) else x for x in leaves]
        args = _unflatten(spec, iter(static))
        dev = next(x.device for x in static if torch.is_tensor(x))
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with telemetry.span("graphs.warmup"), torch.cuda.stream(stream):
            out = self.fn(*args)                 # the warm-up: this call
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        for g in static:
            if isinstance(g, torch.Generator):
                graph.register_generator_state(g)
        before = {name: fn.launches for name, fn in KERNELS.items()}
        with telemetry.span("graphs.capture"), \
                torch.cuda.graph(graph, stream=stream):
            outputs = self.fn(*args)
        launches = {}
        for name, fn in KERNELS.items():
            n, fn.launches = fn.launches - before[name], before[name]
            if n:
                launches[name] = n
        return out, _Capture(graph, [x for x in static if torch.is_tensor(x)],
                             outputs, launches)

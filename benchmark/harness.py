"""What every cell shares: finding a cell's files by name, the clock of
set-up, the device's description, the guard against JAX in the process,
and the run's last line.

Files are found by the names in BENCHMARK.json, under the checkout's
``benchmark/`` folder:
- a configuration: the file its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<traffic>.json``, which names its loop kind;
- a loop kind: ``loops/<kind>.py`` with ``run(ctx) -> Run``;
- the limits of a cell's comparison: ``limits/<cell>.json``;
- a per-layer metric: ``metrics/<metric>.py`` with ``read(cell, run)``.
A later cell, configuration, loop or metric is a new file and a new
entry; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Tuple

FORBIDDEN = ("jax", "jaxlib", "flax", "parq_tpu", "__graft_entry__",
             "chip_smoke", "scripts")


class BenchError(RuntimeError):
    """A cell or file that cannot be found or does not fit."""


def process_start() -> float:
    """The wall time (time.time()) at which this process started, from
    /proc; the import time of this module where /proc says nothing."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])                 # starttime, clock ticks
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f
                         if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


def load_json(path: Path) -> Any:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise BenchError(f"missing file {path}") from None


def load_module(path: Path) -> ModuleType:
    """A loop or metric file, imported by its path."""
    if not path.is_file():
        raise BenchError(f"missing file {path}")
    name = "benchmark_file_" + "".join(
        c if c.isalnum() else "_" for c in str(path))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with everything its name leads to."""
    root: Path
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    def end_to_end(self) -> List[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric it reports."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]

    def loop(self) -> ModuleType:
        return load_module(self.root / "benchmark" / "loops"
                           / f"{self.traffic['loop']}.py")

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.root / "benchmark" / "metrics"
                           / f"{metric}.py")


def find_cell(root: Path, name: str) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json, with its configuration,
    traffic and limits files read."""
    bench = load_json(root / "BENCHMARK.json")
    work = [w for w in bench["workloads"] if w["name"] == name]
    if not work:
        raise BenchError(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{[w['name'] for w in bench['workloads']]}")
    w = work[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]]
    if not conf:
        raise BenchError(f"workload {name!r} names unknown config "
                         f"{w['config']!r}")
    d = root / "benchmark"
    return Cell(root, bench, w, load_json(root / conf[0]["file"]),
                load_json(d / "traffic" / f"{w['traffic']}.json"),
                load_json(d / "limits" / f"{name}.json"))


@dataclasses.dataclass
class Run:
    """What a loop hands back: its end-to-end readings, the comparison's
    numbers with their limits, counts, and what the per-layer readers
    read (`trace`: a `trace.Stretch`, `spans`: host intervals by name,
    `counts`: work done in the traced stretch)."""
    attempted: int
    failed: int
    metrics: Dict[str, float]
    checks: Dict[str, Tuple[float, float]]
    memory_peak_bytes: int
    trace: Any = None
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(math.isfinite(v) and v <= lim
                   for v, lim in self.checks.values())


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_block(device, memory_peak_bytes: int) -> dict:
    import torch
    return {"platform": "gpu" if torch.device(device).type == "cuda"
            else torch.device(device).type,
            "kind": (torch.cuda.get_device_name(device)
                     if torch.device(device).type == "cuda" else "cpu"),
            "count": 1, "memory_peak_bytes": int(memory_peak_bytes)}


def result_line(cell: Cell, run: Run, trace: bool, device) -> dict:
    """The run's last line: correct, attempted, failed, metrics (the
    end-to-end ones, or with `trace` the per-layer ones), device, and,
    traced, the breakdown; the compared numbers last, under `checks`."""
    units = {m["name"]: m["unit"] for m in cell.bench["end_to_end"]
             + cell.bench["per_layer"]}
    metrics = {}
    if trace:
        for m in cell.per_layer():
            value = cell.reader(m["name"]).read(cell, run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": units[m["name"]]}
    else:
        for m in cell.end_to_end():
            if m["name"] not in run.metrics:
                raise BenchError(f"loop gave no {m['name']}")
            metrics[m["name"]] = {"value": float(run.metrics[m["name"]]),
                                  "unit": units[m["name"]]}
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics,
           "device": device_block(device, run.memory_peak_bytes)}
    if trace and run.trace is not None:
        out["device"]["busy_s"] = run.trace.busy_s()
        out["device"]["window_s"] = run.trace.window_s()
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: {"value": finite(v), "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out


def finite(v: float) -> float:
    """v, or the largest float where v is not finite (a reading that
    could not be made), so that the line stays strict JSON."""
    return v if math.isfinite(v) else sys.float_info.max


def check_lines(run: Run) -> List[str]:
    return [f"check {k}: {v!r} (limit {lim!r})"
            + ("" if v <= lim else "  FAILED")
            for k, (v, lim) in run.checks.items()]

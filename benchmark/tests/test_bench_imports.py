"""Nothing a run loads has a top-level module name of JAX, the JAX
package or the repository's JAX-side entry points: compared whole, so
that `parq_torch` is never taken for `parq_tpu`."""
import json
import subprocess
import sys

from benchmark import harness
from benchmark.tests.tiny import REPO

SCRIPT = """
import json, sys, tempfile
from pathlib import Path
import torch
from benchmark.tests.tiny import make_root
from benchmark.run import run_cell
root = make_root(Path(tempfile.mkdtemp()))
run_cell(root, "tiny-eval", 3, 0.5, False, torch.device("cpu"), 0.0)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "parq_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "parq_tpux", sys)
    monkeypatch.setitem(sys.modules, "scripts_x.y", sys)
    assert harness.forbidden_modules() == [] or \
        set(harness.forbidden_modules()) <= set(harness.FORBIDDEN)
    assert "parq_tpux" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "parq_tpu.models", sys)
    assert "parq_tpu" in harness.forbidden_modules()


def test_the_harness_sources_import_no_jax():
    for path in (REPO / "benchmark").rglob("*.py"):
        text = path.read_text()
        for name in ("jax", "parq_tpu", "__graft_entry__", "chip_smoke"):
            assert f"import {name}" not in text, path
            assert f"from {name}" not in text, path

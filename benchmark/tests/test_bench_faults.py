"""The comparison that decides `correct` fails where it must: a run with
the timed path broken underneath comes out not correct, once for each
fault the eval cell can have (a forward that hands back the outputs of
an earlier batch, as a replay whose new inputs never reach the graph
would; an answer altered where it is produced; a suppression that keeps
every box), and the control (the
reference in the program's place, in fp8) reads above the real cell's
limit. On the CPU at the tiny size; the card test runs every real cell
briefly."""
import importlib
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import checks, data, program
from benchmark.harness import find_cell
from benchmark.run import run_cell
from benchmark.tests.tiny import REPO, make_root
from benchmark.weights import make_weights

CPU = torch.device("cpu")


def run(root, cell="tiny-eval", seed=11):
    out, _ = run_cell(root, cell, seed, 0.5, False, CPU, 0.0)
    return out


@pytest.fixture
def root(tmp_path):
    return make_root(tmp_path)


def test_sound_runs_are_correct(root):
    assert run(root)["correct"]


def test_a_forward_that_returns_an_earlier_batch(root, monkeypatch):
    graphs = importlib.import_module("parq_torch.graphs")
    real = graphs.Graphed.__call__
    first = {}

    def stale(self, *a, **kw):
        out = real(self, *a, **kw)
        return first.setdefault("out", out)
    monkeypatch.setattr(graphs.Graphed, "__call__", stale)
    out = run(root)
    assert not out["correct"]
    assert out["checks"]["output_gap"]["value"] > 0.1


def test_an_eval_answer_altered(root, monkeypatch):
    pp = importlib.import_module("parq_torch.evals.parse_pred")
    real = pp.parse_pred

    def altered(*a, **kw):
        host = real(*a, **kw)
        host["pred_mask"][0, 0] = ~host["pred_mask"][0, 0]
        return host
    monkeypatch.setattr(pp, "parse_pred", altered)
    out = run(root)
    assert not out["correct"]
    assert out["checks"]["parse_mismatch"]["value"] >= 1


def test_an_nms_that_keeps_every_box(root, monkeypatch):
    nms = importlib.import_module("parq_torch.evals.nms")
    monkeypatch.setattr(nms.native, "nms3d",
                        lambda rows, thresh, same: np.arange(len(rows)))
    out = run(root)
    assert not out["correct"]
    assert out["checks"]["parse_mismatch"]["value"] >= 1


def limits(cell):
    return json.loads((REPO / "benchmark" / "limits" / f"{cell}.json")
                      .read_text())


def test_the_control_fails_the_real_cells_limits(root):
    cfg = find_cell(root, "tiny-eval").config
    w = make_weights(cfg, 5, CPU)
    pool = data.make_pool(2, 3, cfg["image_size"], [1, 4], 5, CPU)
    x = data.take(pool, slice(0, 2), program.EVAL_KEYS)
    ctrl = checks.reference_forward(cfg, root, w, x, CPU, "fp8")
    got, _ = checks.forward_readings(cfg, root, w, x, ctrl, CPU)
    for w_ in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]:
        assert got["output_gap"] > limits(w_["name"])["output_gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]])
def test_each_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "-m", "benchmark.run",
                          "--workload", cell, "--seed", "2147483659",
                          "--seconds", "3", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]

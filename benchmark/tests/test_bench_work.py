"""The frozen FLOP and byte counts against the hand arithmetic of the
port's bench twin and of the kernels' bounds."""
import json
from pathlib import Path

import pytest

from benchmark.work import attention, flops

ROOT = Path(__file__).resolve().parents[2]


def config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json")
                      .read_text())


def test_release_forward_flops():
    parts = flops.forward_flops(config("parq-release"))
    assert sum(parts.values()) / 1e9 == pytest.approx(338.69, abs=0.01)
    assert parts["backbone"] / 3 / 1e9 == pytest.approx(21.37, abs=0.01)
    assert parts["cross_attention"] / 1e9 == pytest.approx(3 * 40.27,
                                                           abs=0.05)


def test_attention_bounds():
    rel = config("parq-release")
    # per launch: B2 0.1434 ms at B=8, 0.0179 at B=1
    assert attention.fwd_bound_s(rel, 8) / 8 * 1e3 == pytest.approx(
        0.1434, abs=1e-4)
    assert attention.fwd_bound_s(rel, 1) / 8 * 1e3 == pytest.approx(
        0.0179, abs=1e-4)

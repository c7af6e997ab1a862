"""The port's ARKitScenes mean-size tool (`python -m
parq_torch.tools.arkit_mean_sizes`) against scripts/arkit_mean_sizes.py:
on the fake annotation tree of tests/test_mean_size_table.py both write
the same file byte for byte, and the port's table parser reads it as the
JAX test reads the script's; on a tree without annotations both exit
non-zero with the same message."""
import os
import subprocess
import sys

import numpy as np
import pytest

from test_mean_size_table import _fake_arkit_scene

from parq_torch.data.arkitscenes import ARKIT_CLASSES
from parq_torch.models.box_processor import load_mean_size_table

import torch_common  # noqa: F401

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _run_both(root, tmp_path):
    """(JAX script's result, port tool's result, their --out paths)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    outs = [tmp_path / "jax" / "arkit_mean_sizes.txt",
            tmp_path / "port" / "arkit_mean_sizes.txt"]
    cmds = [[sys.executable, os.path.join(REPO, "scripts",
                                          "arkit_mean_sizes.py")],
            [sys.executable, "-m", "parq_torch.tools.arkit_mean_sizes"]]
    res = [subprocess.run(cmd + ["--data", str(root), "--out", str(out)],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO, env=env)
           for cmd, out in zip(cmds, outs)]
    return res, outs


def test_table_equals_the_jax_script_byte_for_byte(tmp_path):
    root = tmp_path / "Training"
    os.makedirs(root)
    _fake_arkit_scene(root, "41000001",
                      [("chair", (0.4, 0.8, 0.4)), ("table", (1.0, 0.6, 1.2)),
                       ("not_a_class", (9, 9, 9))])
    _fake_arkit_scene(root, "41000002", [("chair", (0.6, 1.0, 0.6))])
    (jax_res, port_res), (jax_out, port_out) = _run_both(root, tmp_path)
    assert jax_res.returncode == 0, jax_res.stderr
    assert port_res.returncode == 0, port_res.stderr
    assert port_out.read_bytes() == jax_out.read_bytes()
    warn = [ln for ln in port_res.stderr.splitlines()
            if ln.startswith("WARNING")]
    assert warn == [ln for ln in jax_res.stderr.splitlines()
                    if ln.startswith("WARNING")]
    assert len(warn) == len(ARKIT_CLASSES) - 2
    assert port_res.stdout.replace(str(port_out), "") \
        == jax_res.stdout.replace(str(jax_out), "")

    tab = load_mean_size_table(str(port_out), len(ARKIT_CLASSES),
                               class2type=dict(enumerate(ARKIT_CLASSES)))
    assert tab.shape == (len(ARKIT_CLASSES) + 2, 3)
    np.testing.assert_array_equal(tab[len(ARKIT_CLASSES)], [1.0, 1.0, 1.0])
    chair = ARKIT_CLASSES.index("chair")
    table = ARKIT_CLASSES.index("table")
    np.testing.assert_allclose(tab[chair], [0.5, 0.9, 0.5], atol=1e-6)
    np.testing.assert_allclose(tab[table], [1.0, 0.6, 1.2], atol=1e-6)
    bed = ARKIT_CLASSES.index("bed")
    np.testing.assert_array_equal(tab[bed], [1.0, 1.0, 1.0])


def test_empty_tree_fails_like_the_jax_script(tmp_path):
    root = tmp_path / "Empty"
    os.makedirs(root / "41000001")         # a scene without annotations
    (jax_res, port_res), (jax_out, port_out) = _run_both(root, tmp_path)
    assert jax_res.returncode != 0 and port_res.returncode != 0
    assert port_res.returncode == jax_res.returncode
    msg = f"no *_3dod_annotation.json found under {root}"
    assert port_res.stderr.strip().splitlines()[-1] == msg
    assert jax_res.stderr.strip().splitlines()[-1] == msg
    assert not port_out.exists() and not jax_out.exists()

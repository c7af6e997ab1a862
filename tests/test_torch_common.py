"""The port tests' shared set-up (tests/torch_common.py) holds:

- every port test module imports torch_common, so the one-thread pin never
  rests on one module happening to be collected, and none imports another
  port test module (shared helpers live in torch_common);
- the test process runs torch on one intra-op thread, and so does a
  subprocess it starts.
(tests/test_torch_model.py checks that the JAX twin's forward is compiled
once for a model and reused.)
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torch_common  # noqa: F401

TESTS = Path(__file__).resolve().parent
PORT_TESTS = sorted(TESTS.glob("test_torch_*.py"))


def _imported_modules(nodes):
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_TESTS, ids=[p.name for p in PORT_TESTS])
def test_port_test_imports_torch_common_and_no_other_port_test(path):
    """torch_common at the module's top level (so at collection); no port
    test module anywhere in it."""
    tree = ast.parse(path.read_text(), filename=str(path))
    assert "torch_common" in set(_imported_modules(tree.body))
    everywhere = set(_imported_modules(ast.walk(tree)))
    assert not {n for n in everywhere if n.startswith("test_torch_")}


def test_one_torch_thread_here_and_in_subprocesses():
    assert torch.get_num_threads() == 1
    assert os.environ["OMP_NUM_THREADS"] == "1"
    out = subprocess.run(
        [sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1"

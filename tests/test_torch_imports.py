"""The port stands alone: no module of parq_torch/, and not chip_smoke.py,
imports jax, flax, optax or anything of parq_tpu. The check parses each
source and reads its import statements (mentions in prose are fine).
It also checks that a CPU-only box can import every port module (the
kernels are built only when first launched on a card), and that importing
them all pulls in none of the packages the card machine lacks (PyYAML,
PIL, tensorboardX, orbax, cv2: the vis utilities draw and write PNGs
themselves)."""
import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

import torch_common  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex", "parq_tpu"}
PORT_FILES = sorted((ROOT / "parq_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_imports(path):
    bad = FORBIDDEN.intersection(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_modules_import_without_gpu():
    for path in PORT_FILES[:-1]:
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        importlib.import_module(".".join(parts))


def _module_names():
    for path in PORT_FILES[:-1]:
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_imports_need_no_yaml_pil_tensorboard_or_orbax():
    absent = ("yaml", "PIL", "tensorboardX", "orbax", "cv2")
    code = ("import importlib, sys\n"
            f"for m in {sorted(_module_names())!r}:\n"
            "    importlib.import_module(m)\n"
            f"print(sorted(m for m in {absent!r} if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

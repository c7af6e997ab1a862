"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each library of `LIBRARIES` is built on first use from its
``parq_torch/csrc/*.cu`` sources into one shared library with a plain C
interface: one ``nvcc -c`` per source, all started together, then one link::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas=-v -c -o <lib>-<hash>.<source>.o <source>.cu
    nvcc -shared -o build/parq_torch/<lib>-<hash>.so <lib>-<hash>.*.o

Nothing links against libcuda: the one call into it that the kernels need
(cuTensorMapEncodeTiled, for the TMA tensor maps) is fetched at run time
through cudaGetDriverEntryPoint (csrc/hopper.cuh). The file name carries a
hash of the library's sources, every header in csrc/ and the flags, so an
edited source builds anew and an unchanged one is reused. The compiler's
report (registers, shared memory, spills and `setmaxnreg` warnings per
kernel: look for "spill" and "setmaxnreg ignored") is kept beside each
library as ``<lib>-<hash>.log``.

The recorder (`telemetry`) times each library's first `load` (its build,
where one is needed, and the dlopen) as the span ``kernels.load``, counts
the libraries nvcc built under ``kernels.builds``, and times the import
that the custom ops' first call brings (`import_dynamo`) as the span
``kernels.dynamo_import``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

from .. import telemetry

LIBRARIES = {
    "pixel_align": ("pixel_align",),
    "pixel_align_bwd": ("pixel_align_bwd",),
    "cross_attention": ("cross_attention", "flash_fwd_sm90",
                        "flash_bwd_sm90"),
    "lap": ("lap",),
    "dropout": ("dropout",),
    "heads": ("heads",),
    "deform_conv": ("deform_conv",),
    "frozen_bn": ("frozen_bn",),
    "nms": ("nms",),
    "ms_deform_attn": ("ms_deform_attn",),
}
SOURCES = tuple(LIBRARIES)
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "parq_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "parq_torch: nvcc not found (looked in $CUDA_HOME/bin, "
            "/usr/local/cuda/bin and PATH); the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in LIBRARIES[name]:
        h.update((CSRC / f"{src}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Build every library in `names` that is not built yet: one nvcc
    process per source, all started together, then a link per library.
    Returns the wall seconds spent; raises with the compiler's output if
    any build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        jobs = []
        for src in LIBRARIES[name]:
            obj = out.with_suffix(f".{src}.{os.getpid()}.o")
            cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                   str(CSRC / f"{src}.cu")]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        libs.append((name, out, jobs))
    failed = []
    for name, out, jobs in libs:
        logs, ok = [], True
        for src, obj, proc in jobs:
            log, _ = proc.communicate()
            logs.append(f"--- {src}.cu (nvcc exit {proc.returncode})\n{log}")
            ok = ok and proc.returncode == 0
        objs = [str(obj) for _, obj, _ in jobs]
        if ok:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            link = subprocess.run(
                [_nvcc(), "-shared", "-o", str(tmp), *objs],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs.append(f"--- link (nvcc exit {link.returncode})\n"
                        f"{link.stdout}")
            ok = link.returncode == 0
            if ok:   # atomic: a concurrent loader sees all or none
                os.replace(tmp, out)
                telemetry.count("kernels.builds")
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        out.with_suffix(".log").write_text("\n".join(logs))
        if not ok:
            failed.append(f"=== {name}\n" + "\n".join(logs))
    if failed:
        raise RuntimeError("parq_torch: kernel build failed\n"
                           + "\n".join(failed))
    return time.perf_counter() - t0


_dynamo_imported = False


def import_dynamo() -> None:
    """Import torch._dynamo once, as the span ``kernels.dynamo_import``.
    PyTorch runs a custom op's dispatch under `torch._disable_dynamo`,
    which imports torch._dynamo (and with it sympy and FSDP) at the first
    call of any custom op: seconds of Python. The callers of the port's
    custom ops call this first, so that the import is a span of its own
    and not a part of the span that made the first call."""
    global _dynamo_imported
    if not _dynamo_imported:
        with telemetry.span("kernels.dynamo_import"):
            import torch._dynamo  # noqa: F401
        _dynamo_imported = True


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            with telemetry.span("kernels.load"):
                build_all([name])
                lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib

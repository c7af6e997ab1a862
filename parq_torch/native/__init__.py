"""The port's host C++ library for evaluation (port of parq_tpu/native):
`lap_solve`, `iou3d_pair`, `iou3d_matrix` and `nms3d`, with the signatures
of the JAX package's loader, from ``native.cpp`` (a copy of the JAX
package's source with the clip repaired: the IoU of a box with itself is
1).

The library is built with g++ at first use into ``build/parq_torch/`` at
the repository's root::

    g++ -O3 -shared -fPIC -std=c++17 native.cpp -o native-<hash>.so

The name carries a hash of the source and the flags, and the finished file
is renamed into place, so processes that build at the same moment each
load a whole library. There is no fallback: a failed build raises with the
compiler's output. The plain versions the tests hold it against are
`evals.iou3d.iou3d` and `evals.nms.greedy_nms`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "parq_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the library unless it is built; returns its path. Raises with
    the compiler's output if g++ fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"parq_torch.native: cannot run g++ ({e})") from e
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(f"parq_torch.native: g++ exit {proc.returncode}\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        dp = ctypes.POINTER(ctypes.c_double)
        lib.lap_solve.restype = ctypes.c_int
        lib.lap_solve.argtypes = [dp, ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int)]
        lib.iou3d_pair.restype = ctypes.c_double
        lib.iou3d_pair.argtypes = [dp, dp]
        lib.iou3d_matrix.restype = None
        lib.iou3d_matrix.argtypes = [dp, ctypes.c_int, dp, ctypes.c_int, dp]
        lib.nms3d.restype = None
        lib.nms3d.argtypes = [dp, ctypes.c_int, ctypes.c_double, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_ubyte)]
        _lib = lib
        return _lib


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def lap_solve(cost: np.ndarray) -> np.ndarray:
    """(nr, nc) cost, nr <= nc → (nr,) int32 column assigned to each row."""
    cost = np.ascontiguousarray(cost, np.float64)
    nr, nc = cost.shape
    out = np.empty(nr, np.int32)
    rc = get_lib().lap_solve(_dp(cost), nr, nc,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if rc != 0:
        raise ValueError(f"lap_solve: {nr} x {nc} "
                         + ("has more rows than columns" if rc == -1
                            else "is infeasible"))
    return out


def iou3d_pair(c1: np.ndarray, c2: np.ndarray) -> float:
    """3D IoU of two (8, 3) ODAM-convention corner sets."""
    c1 = np.ascontiguousarray(c1, np.float64)
    c2 = np.ascontiguousarray(c2, np.float64)
    return float(get_lib().iou3d_pair(_dp(c1), _dp(c2)))


def iou3d_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(na, 8, 3) x (nb, 8, 3) ODAM-convention corners → (na, nb) IoU."""
    a = np.ascontiguousarray(a, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    na, nb = a.shape[0], b.shape[0]
    out = np.zeros((na, nb), np.float64)
    if na and nb:
        get_lib().iou3d_matrix(_dp(a), na, _dp(b), nb, _dp(out))
    return out


def nms3d(rows: np.ndarray, thresh: float, same_class: bool) -> np.ndarray:
    """(n, 8) AABB rows [min xyz, max xyz, score, class] → (n,) bool
    keep."""
    rows = np.ascontiguousarray(rows, np.float64)
    n = rows.shape[0]
    keep = np.zeros(n, np.uint8)
    if n:
        get_lib().nms3d(_dp(rows), n, float(thresh), int(same_class),
                        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    return keep.astype(bool)

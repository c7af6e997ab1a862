"""Kernel M1 — the matcher's linear assignment, batched
(``csrc/lap.cu``).

M1 replaces parq_tpu/ops/hungarian.py:solve_lap (:24), the JAX package's
Jonker–Volgenant search in `lax.while_loop`s, vmapped over the (iteration,
sample) pairs of a step. It is not a Pallas kernel, but it is device code:
with it the JAX step never waits on the host. `solve_lap` launches the CUDA
kernel (one warp a problem, its cost rows staged in shared memory as far
as the card's budget allows: `smem_plan`) for a CUDA tensor (or raises)
and runs `solve_lap_plain` for a CPU tensor. Both follow JAX's f32 arithmetic step for step (INF = 1e18, the
first index wins a tie, the dual updates before the augmentation), so
col4row equals JAX's exactly, ties included.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

INF = 1e18                 # parq_tpu/ops/hungarian.py:21
MAX_CHUNKS = 32            # mbarriers of a problem's staged rows (lap.cu)
REG_COLUMNS = 32 * 32      # columns whose state lives in registers
PAD = REG_COLUMNS * 4      # bytes after the staged rows (lap.cu: kPad)


def smem_plan(R: int, C: int, budget: int, whole_rows: bool = True):
    """(fixed bytes, rows staged) of one problem's CTA, as csrc/lap.cu
    plans it: the fixed part is the mbarriers, a pad after the rows,
    row4col and the steps' records over the columns, u and col4row over
    the rows, and past REG_COLUMNS columns the lanes' column state (13
    bytes a column); the first rows of the problem are staged in what
    `budget` (the card's opt-in shared memory per block) leaves, the rest
    read from global memory. `whole_rows`: a row is a multiple of 16 bytes
    at a 16-byte address (else nothing is staged)."""
    slots = -(-C // 32)
    fixed = MAX_CHUNKS * 8 + PAD + C * 12 + R * 8 \
        + (slots * 32 * 13 if C > REG_COLUMNS else 0)
    if not whole_rows or C % 4 or fixed > budget:
        return fixed, 0
    return fixed, min(R, (budget - fixed) // (C * 4))


def solve_lap_plain(cost: torch.Tensor, n_rows: torch.Tensor,
                    stats: Optional[dict] = None) -> torch.Tensor:
    """Plain version of kernel M1: cost (P, R, C) with R ≤ C, n_rows (P,)
    → col4row (P, R) int32, −1 for rows at or past n_rows[p]. JAX's
    `solve_lap` vectorised over P as `jax.vmap` does it: a loop over rows
    and search steps, problems that are done masked out. With `stats`, a
    dict, stats["row_reads"] is the number of cost rows the searches read
    (one a search step: what the kernel's bound counts)."""
    P, R, C = cost.shape
    if R > C:
        raise ValueError(f"solve_lap: {R} rows > {C} columns")
    dev = cost.device
    cost = cost.float()
    n = n_rows.long().clamp(0, R)
    ar = torch.arange(P, device=dev)
    rows = torch.arange(R, device=dev)
    inf = torch.full((), INF, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    u = torch.zeros((P, R), dtype=torch.float32, device=dev)
    v = torch.zeros((P, C), dtype=torch.float32, device=dev)
    col4row = torch.full((P, R), -1, dtype=torch.long, device=dev)
    row4col = torch.full((P, C), -1, dtype=torch.long, device=dev)
    row_reads = 0
    for cur in range(R):
        act = cur < n
        if not bool(act.any()):
            break
        i = torch.full((P,), cur, dtype=torch.long, device=dev)
        min_val = torch.zeros(P, dtype=torch.float32, device=dev)
        sink = torch.full((P,), -1, dtype=torch.long, device=dev)
        spc = torch.full((P, C), INF, dtype=torch.float32, device=dev)
        path = torch.full((P, C), -1, dtype=torch.long, device=dev)
        SR = torch.zeros((P, R), dtype=torch.bool, device=dev)
        SC = torch.zeros((P, C), dtype=torch.bool, device=dev)
        searching = act.clone()
        while bool(searching.any()):        # hungarian.py:57-70
            s = searching
            if stats is not None:
                row_reads += int(s.sum())
            SR[ar[s], i[s]] = True
            r = min_val[:, None] + cost[ar, i]
            r = r - u[ar, i][:, None]
            r = r - v
            update = s[:, None] & ~SC & (r < spc)
            path = torch.where(update, i[:, None], path)
            spc = torch.where(update, r, spc)
            masked = torch.where(SC, inf, spc)
            j = masked.argmin(dim=1)          # the first index on ties
            if bool(SC[ar[s], j[s]].any()):
                raise AssertionError("solve_lap: a search step landed on a "
                                     "scanned column")
            min_val = torch.where(s, masked[ar, j], min_val)
            SC[ar[s], j[s]] = True
            free = row4col[ar, j] < 0
            sink = torch.where(s & free, j, sink)
            i = torch.where(s & ~free, row4col[ar, j], i)
            searching = s & ~free
        # dual updates (hungarian.py:84-88), col4row from before the augment
        u_new = u.clone()
        u_new[:, cur] = u[:, cur] + min_val
        other = SR & (rows != cur)
        c = col4row.clamp(0, C - 1)
        u_new = u_new + torch.where(
            other, min_val[:, None] - torch.gather(spc, 1, c), zero)
        v_new = v - torch.where(SC, min_val[:, None] - spc, zero)
        u = torch.where(act[:, None], u_new, u)
        v = torch.where(act[:, None], v_new, v)
        # augment along the alternating path (hungarian.py:90-105)
        j = sink
        walking = act.clone()
        while bool(walking.any()):
            pw = ar[walking]
            jw = j[walking]
            iw = path[pw, jw]
            row4col[pw, jw] = iw
            nxt = col4row[pw, iw]
            col4row[pw, iw] = jw
            j = j.clone()
            j[walking] = nxt
            done = torch.zeros_like(walking)
            done[walking] = iw == cur
            walking = walking & ~done
    if stats is not None:
        stats["row_reads"] = row_reads
    return col4row.int()


def _lib():
    lib = _build.load("lap")
    fn = lib.parq_lap_solve
    if fn.argtypes is None:   # declare once: pointers must not pass as int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def solve_lap(cost: torch.Tensor, n_rows: torch.Tensor) -> torch.Tensor:
    """Kernel M1. cost (P, R, C) f32 contiguous with R ≤ C, n_rows (P,)
    int32 on the same device → col4row (P, R) int32, −1 for rows at or
    past n_rows[p]. n_rows is read by the kernel, never by the host. CPU
    tensors take the plain version."""
    if cost.device.type == "cpu":
        return solve_lap_plain(cost, n_rows)
    if cost.device.type != "cuda":
        raise ValueError(f"solve_lap: no kernel for {cost.device}")
    if cost.dim() != 3 or cost.dtype != torch.float32 \
            or not cost.is_contiguous():
        raise ValueError(f"solve_lap: cost must be (P, R, C) contiguous f32, "
                         f"got {cost.dtype} {tuple(cost.shape)}")
    P, R, C = cost.shape
    if R > C or R < 1:
        raise ValueError(f"solve_lap: needs 1 <= rows <= columns, got "
                         f"{R} x {C}")
    budget = torch.cuda.get_device_properties(
        cost.device).shared_memory_per_block_optin
    fixed, _ = smem_plan(R, C, budget)
    if fixed > budget:
        raise ValueError(f"solve_lap: {R} x {C} needs {fixed} bytes of "
                         f"shared memory, more than the card's {budget}")
    if n_rows.dtype != torch.int32 or tuple(n_rows.shape) != (P,) \
            or n_rows.device != cost.device or not n_rows.is_contiguous():
        raise ValueError(f"solve_lap: n_rows must be ({P},) int32 on "
                         f"{cost.device}, got {n_rows.dtype} "
                         f"{tuple(n_rows.shape)} on {n_rows.device}")
    out = torch.empty((P, R), dtype=torch.int32, device=cost.device)
    if P == 0:
        return out
    stream = torch.cuda.current_stream(cost.device).cuda_stream
    err = _lib()(cost.data_ptr(), n_rows.data_ptr(), out.data_ptr(), P, R, C,
                 stream)
    if err:
        raise RuntimeError(f"solve_lap: CUDA launch failed, error {err}")
    solve_lap.launches += 1
    return out


solve_lap.launches = 0

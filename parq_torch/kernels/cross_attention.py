"""Kernels B2 and B3 — flash cross-attention over the fused K/V buffer,
forward and backward (``csrc/cross_attention.cu``).

Replaces parq_tpu/kernels/cross_attention_pallas.py:_fwd_call (B2) and
_bwd_call (B3). K/V arrive as one (B, N, H·2D) buffer whose lanes
[h·2D, h·2D + D) hold K_h and [h·2D + D, (h+1)·2D) hold V_h — the output of
the decoder's single fused projection. Each wrapper launches its CUDA
kernel for CUDA tensors (or raises) and runs its plain version for CPU
tensors:

- `flash_cross_attention_kv_fused` — B2, eval form (no dropout, no LSE);
- `flash_fwd_lse` — B2, train form: also the rowwise logsumexp, and
  weight dropout drawn in the kernel from one seed per group of rows;
- `flash_bwd` — B3, (dq, dKV) from (q, kv, do, lse, delta, seeds).

The three autograd entries of the JAX package sit on top of them:
`flash_cross_attention_kv_fused_train` (forward B2-train, backward B3),
`flash_cross_attention_kv_fused_fwd_lse` (no gradient) and
`flash_cross_attention_kv_fused_precomputed` (forward returns the saved o,
backward B3).

Dropout is the JAX package's v1 counter hash of (seed, b·H + h,
group-local row, global kv column) (`_keep_mask`, :58-117), bit for bit:
`keep_mask` is its plain version. The v2 hash (PARQ_DROPOUT_HASH=v2) is not
ported.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Union

import torch

from . import _build

HEAD_DIMS = (64, 128, 256)  # head dims the CUDA kernel is built for


def split_kv(kv: torch.Tensor, heads: int):
    """Fused (B, N, H·2D) → k, v views (B, H, N, D) (strided, no copy)."""
    B, N, F = kv.shape
    kvh = kv.view(B, N, heads, 2, F // (2 * heads))
    return kvh[:, :, :, 0].transpose(1, 2), kvh[:, :, :, 1].transpose(1, 2)


def cross_attention_kv_fused_plain(q: torch.Tensor,
                                   kv: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel B2: the materializing softmax in f32.
    q (B, H, Q, D), kv (B, N, H·2D) → (B, H, Q, D) in q's dtype."""
    D = q.shape[-1]
    k, v = split_kv(kv, q.shape[1])
    s = (q.float() * D ** -0.5) @ k.float().transpose(-1, -2)
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a · b) mod 2³² for int64 `a` in [0, 2³²) and a constant `b` in
    [0, 2³²), without leaving int64: b is split into 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def dropout_threshold(rate: float) -> int:
    """min(⌊rate·2³²⌋, 2³² − 1): keep where the hash is ≥ this."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def keep_mask(seeds, bh, rows: int, cols: int, rate: float,
              q0: int = 0) -> torch.Tensor:
    """Plain version of the kernels' dropout draw (v1 hash).

    seeds: int tensor (...) of group seeds; bh: b·H + h, an int or an int
    tensor broadcastable with `seeds`; rows `q0 .. q0 + rows − 1` are
    local to the seed's group; cols `0 .. cols − 1` are global kv indices.
    Returns bool (..., rows, cols), True where the weight is kept. The
    uint32 arithmetic runs in int64, masked to 32 bits."""
    s = torch.as_tensor(seeds, dtype=torch.int64)
    dev = s.device
    bh = torch.as_tensor(bh, dtype=torch.int64, device=dev)
    h0 = _mul32(s & _M32, 2654435761) ^ _mul32(bh & _M32, 2246822519)
    r = _mul32(torch.arange(q0, q0 + rows, dtype=torch.int64, device=dev),
               3266489917)
    c = _mul32(torch.arange(cols, dtype=torch.int64, device=dev), 668265263)
    h = (h0[..., None, None] + r[:, None] + c[None, :]) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h >= dropout_threshold(rate)


def _seed_vector(dropout_seed, rate: float, Q: int, q_tile, device
                 ) -> torch.Tensor:
    """The argument checks of the JAX package's `_prep_fused_args`: G
    seeds force q_tile = Q/G, and a scalar seed with a q tile < Q under
    dropout is refused (it would repeat the mask in every tile). Returns
    the (G,) int32 seeds on `device`."""
    if rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    seeds = torch.as_tensor(0 if dropout_seed is None else dropout_seed)
    seeds = seeds.reshape(-1).to(device=device, dtype=torch.int32)
    G = seeds.numel()
    if G > 1:
        if Q % G:
            raise ValueError(f"Q={Q} not divisible by seed groups G={G}")
        q_tile = Q // G
    if q_tile is not None and Q % q_tile:
        raise ValueError(f"Q={Q} not divisible by q_tile={q_tile}")
    if rate > 0.0 and G == 1 and q_tile is not None and q_tile < Q:
        raise ValueError(
            "scalar dropout_seed combined with q_tile replicates the "
            "dropout mask across q-tiles; pass a (Q//q_tile,)-shaped seed "
            "vector instead")
    return seeds


def _keep_rows(seeds, b: int, H: int, Q: int, N: int, rate: float):
    """(H, Q, N) keep mask of batch element b (G groups of Q/G rows)."""
    G = seeds.numel()
    bh = b * H + torch.arange(H, device=seeds.device)
    return keep_mask(seeds.long()[None, :], bh[:, None], Q // G, N,
                     rate).reshape(H, Q, N)


def cross_attention_kv_fused_train_plain(q: torch.Tensor, kv: torch.Tensor,
                                         seeds: torch.Tensor, rate: float):
    """Plain version of B2's train form: (o (B, H, Q, D) in q's dtype, lse
    (B, H, Q) f32, natural log). p is dropped after the softmax, as
    keep·p/(1 − rate). One batch element at a time bounds the (H, Q, N)
    temporaries."""
    B, H, Q, D = q.shape
    N = kv.shape[1]
    k, v = split_kv(kv, H)
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Q, dtype=torch.float32, device=q.device)
    with torch.autocast(q.device.type, enabled=False):
        for b in range(B):
            s = (q[b].float() @ k[b].float().transpose(-1, -2)) * D ** -0.5
            lse[b] = torch.logsumexp(s, dim=-1)
            p = torch.exp(s - lse[b][..., None])
            if rate > 0.0:
                keep = _keep_rows(seeds, b, H, Q, N, rate)
                p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
            o[b] = (p @ v[b].float()).to(q.dtype)
    return o, lse


def cross_attention_kv_fused_bwd_plain(q, kv, do, lse, delta, seeds,
                                       rate: float):
    """Plain version of B3: (dq in q's dtype, dKV (B, N, H·2D) in kv's
    dtype, summed over every q row). ds and w are rounded to the working
    dtype before the last three products, as the JAX kernel does."""
    B, H, Q, D = q.shape
    N = kv.shape[1]
    k, v = split_kv(kv, H)
    scale = D ** -0.5
    dq = torch.empty_like(q)
    dkv = torch.empty_like(kv).view(B, N, H, 2, D)
    with torch.autocast(q.device.type, enabled=False):
        for b in range(B):
            kb, vb = k[b].float(), v[b].float()
            qb, dob = q[b].float(), do[b].float()
            p = torch.exp((qb @ kb.transpose(-1, -2)) * scale
                          - lse[b][..., None])
            w = p
            if rate > 0.0:
                keep = _keep_rows(seeds, b, H, Q, N, rate)
                w = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
            dw = dob @ vb.transpose(-1, -2)
            ds = (w * dw - p * delta[b][..., None]).to(q.dtype).float()
            w = w.to(do.dtype).float()
            dq[b] = ((ds @ kb) * scale).to(q.dtype)
            dkv[b, :, :, 0] = ((ds.transpose(-1, -2) @ qb) * scale
                               ).transpose(0, 1).to(kv.dtype)
            dkv[b, :, :, 1] = (w.transpose(-1, -2) @ dob
                               ).transpose(0, 1).to(kv.dtype)
    return dq, dkv.view(B, N, 2 * H * D)


def _fn(name: str, n_ptr: int, tail):
    lib = _build.load("cross_attention")
    fn = getattr(lib, name)
    if fn.argtypes is None:   # declare once: pointers must not pass as int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + tail
        fn.restype = ctypes.c_int
    return fn


def _lib():
    return _fn("parq_flash_fwd_kv_fused", 3,
               [ctypes.c_int] * 6 + [ctypes.c_void_p])


_DROP_ARGS = [ctypes.c_int, ctypes.c_uint32, ctypes.c_float]


def _check(q: torch.Tensor, kv: torch.Tensor, what: str):
    B, H, Q, D = q.shape
    if kv.dim() != 3 or kv.shape[0] != B or kv.shape[2] != 2 * H * D:
        raise ValueError(f"{what}: kv {tuple(kv.shape)} vs q "
                         f"{tuple(q.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or kv.dtype != q.dtype:
        raise TypeError(f"{what}: dtypes q {q.dtype}, kv {kv.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} not in {HEAD_DIMS}")
    if kv.device != q.device or kv.shape[1] < 1:
        raise ValueError(f"{what}: kv must be non-empty and on q's device")


def _aligned(what: str, *ts):
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what}: inputs must be 16-byte aligned")


def _drop_args(seeds: torch.Tensor, Q: int, rate: float):
    """(group_rows, thresh, keep_scale) as the kernels take them; the
    threshold comes from the double `rate`, as in the JAX package."""
    if rate <= 0.0:
        return (Q // seeds.numel(), 0, 1.0)
    return (Q // seeds.numel(), dropout_threshold(rate), 1.0 / (1.0 - rate))


def flash_cross_attention_kv_fused(q: torch.Tensor,
                                   kv: torch.Tensor) -> torch.Tensor:
    """Kernel B2. q (B, H, Q, D), kv (B, N, H·2D), both bf16 or both f32
    → o (B, H, Q, D) in q's dtype. CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return cross_attention_kv_fused_plain(q, kv)
    B, H, Q, D = q.shape
    if kv.dim() != 3 or kv.shape[0] != B or kv.shape[2] != 2 * H * D:
        raise ValueError(f"flash: kv {tuple(kv.shape)} vs q {tuple(q.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or kv.dtype != q.dtype:
        raise TypeError(f"flash: dtypes q {q.dtype}, kv {kv.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash: head dim {D} not in {HEAD_DIMS}")
    if kv.device != q.device or kv.shape[1] < 1:
        raise ValueError("flash: kv must be non-empty and on q's device")
    q, kv = q.contiguous(), kv.contiguous()
    o = torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, kv, o)):
        raise ValueError("flash: inputs must be 16-byte aligned")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), kv.data_ptr(), o.data_ptr(), B, H, Q,
                 kv.shape[1], D, int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"flash: CUDA launch failed, error {err}")
    flash_cross_attention_kv_fused.launches += 1
    return o


flash_cross_attention_kv_fused.launches = 0


def flash_fwd_lse(q: torch.Tensor, kv: torch.Tensor, seeds: torch.Tensor,
                  rate: float = 0.0):
    """Kernel B2, train form. q (B, H, Q, D), kv (B, N, H·2D), both bf16 or
    both f32; seeds (G,) int32 on q's device, G dividing Q → (o in q's
    dtype, lse (B, H, Q) f32). CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return cross_attention_kv_fused_train_plain(q, kv, seeds, rate)
    _check(q, kv, "flash_fwd_lse")
    B, H, Q, D = q.shape
    seeds = seeds.to(device=q.device, dtype=torch.int32).contiguous()
    q, kv = q.contiguous(), kv.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Q, dtype=torch.float32, device=q.device)
    _aligned("flash_fwd_lse", q, kv, o, lse)
    fn = _fn("parq_flash_fwd_kv_fused_lse", 5,
             [ctypes.c_int] * 5 + _DROP_ARGS + [ctypes.c_int,
                                                ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), kv.data_ptr(), o.data_ptr(), lse.data_ptr(),
             seeds.data_ptr(), B, H, Q, kv.shape[1], D,
             *_drop_args(seeds, Q, rate), int(q.dtype == torch.bfloat16),
             stream)
    if err:
        raise RuntimeError(f"flash_fwd_lse: CUDA launch failed, error {err}")
    flash_fwd_lse.launches += 1
    return o, lse


flash_fwd_lse.launches = 0


def flash_bwd(q: torch.Tensor, kv: torch.Tensor, do: torch.Tensor,
              lse: torch.Tensor, delta: torch.Tensor, seeds: torch.Tensor,
              rate: float = 0.0):
    """Kernel B3. q, do (B, H, Q, D) and kv (B, N, H·2D) in one dtype (bf16
    or f32); lse and delta = rowsum(do·o) (B, H, Q) f32; seeds as for
    `flash_fwd_lse` → (dq, dKV in the fused layout, summed over every q
    row). CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return cross_attention_kv_fused_bwd_plain(q, kv, do, lse, delta,
                                                  seeds, rate)
    _check(q, kv, "flash_bwd")
    B, H, Q, D = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"flash_bwd: do {do.dtype} {tuple(do.shape)}")
    for t in (lse, delta):
        if t.shape != (B, H, Q) or t.dtype != torch.float32:
            raise ValueError(f"flash_bwd: lse/delta {t.dtype} "
                             f"{tuple(t.shape)}")
    seeds = seeds.to(device=q.device, dtype=torch.int32).contiguous()
    q, kv, do = q.contiguous(), kv.contiguous(), do.contiguous()
    lse, delta = lse.contiguous(), delta.contiguous()
    dq, dkv = torch.empty_like(q), torch.empty_like(kv)
    _aligned("flash_bwd", q, kv, do, dq, dkv)
    fn = _fn("parq_flash_bwd_kv_fused", 8,
             [ctypes.c_int] * 5 + _DROP_ARGS + [ctypes.c_int,
                                                ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), kv.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), seeds.data_ptr(), dq.data_ptr(),
             dkv.data_ptr(), B, H, Q, kv.shape[1], D,
             *_drop_args(seeds, Q, rate), int(q.dtype == torch.bfloat16),
             stream)
    if err:
        raise RuntimeError(f"flash_bwd: CUDA launch failed, error {err}")
    flash_bwd.launches += 1
    return dq, dkv


flash_bwd.launches = 0


def _backward(q, kv, seeds, o, lse, rate, do):
    """B3 from the saved forward: delta = rowsum(do·o) in f32 outside the
    kernel, as `_flash_attn_kv_bwd` does (:814-823)."""
    do = do.to(q.dtype)
    delta = (do.float() * o.float()).sum(dim=-1)
    return flash_bwd(q, kv, do, lse, delta, seeds, rate)


class _FlashTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, seeds, rate):
        o, lse = flash_fwd_lse(q, kv, seeds, rate)
        ctx.save_for_backward(q, kv, seeds, o, lse)
        ctx.rate = rate
        return o

    @staticmethod
    def backward(ctx, do):
        q, kv, seeds, o, lse = ctx.saved_tensors
        dq, dkv = _backward(q, kv, seeds, o, lse, ctx.rate, do)
        return dq, dkv, None, None


class _FlashPrecomputed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, o, lse, seeds, rate):
        ctx.save_for_backward(q, kv, seeds, o, lse)
        ctx.rate = rate
        return o.clone()

    @staticmethod
    def backward(ctx, do):
        q, kv, seeds, o, lse = ctx.saved_tensors
        dq, dkv = _backward(q, kv, seeds, o, lse, ctx.rate, do)
        return dq, dkv, None, None, None, None


Seed = Union[None, int, Sequence[int], torch.Tensor]


def _prep(q, kv, dropout_rate, dropout_seed, q_tile):
    """Casts and checks shared by the three entries: q takes kv's dtype
    (under bf16 autocast both arrive bf16; the kernels refuse a mix)."""
    seeds = _seed_vector(dropout_seed, float(dropout_rate), q.shape[2],
                         q_tile, q.device)
    return q.to(kv.dtype), seeds, float(dropout_rate)


def flash_cross_attention_kv_fused_train(
        q: torch.Tensor, kv: torch.Tensor, *, dropout_rate: float = 0.0,
        dropout_seed: Seed = None, q_tile: Optional[int] = None):
    """Differentiable flash cross-attention over the fused K/V buffer:
    forward B2-train, backward B3 (dKV in the fused layout). `dropout_seed`
    is an int, or a (G,) vector of seeds, one per Q/G rows."""
    q, seeds, rate = _prep(q, kv, dropout_rate, dropout_seed, q_tile)
    return _FlashTrain.apply(q, kv, seeds, rate)


def flash_cross_attention_kv_fused_fwd_lse(
        q: torch.Tensor, kv: torch.Tensor, *, dropout_rate: float = 0.0,
        dropout_seed: Seed = None, q_tile: Optional[int] = None):
    """B2-train with no gradient: (o, lse (B, H, Q) f32). It feeds the
    trajectory pass; the gradient runs through
    `flash_cross_attention_kv_fused_precomputed`."""
    q, seeds, rate = _prep(q, kv, dropout_rate, dropout_seed, q_tile)
    with torch.no_grad():
        return flash_fwd_lse(q.detach(), kv.detach(), seeds, rate)


def flash_cross_attention_kv_fused_precomputed(
        q: torch.Tensor, kv: torch.Tensor, o: torch.Tensor,
        lse: torch.Tensor, *, dropout_rate: float = 0.0,
        dropout_seed: Seed = None, q_tile: Optional[int] = None):
    """Differentiable flash cross-attention whose forward is skipped: (o,
    lse) come from an identical earlier call with the same q, kv and
    seeds. The backward is B3."""
    q, seeds, rate = _prep(q, kv, dropout_rate, dropout_seed, q_tile)
    return _FlashPrecomputed.apply(q, kv, o.detach().to(q.dtype),
                                   lse.detach(), seeds, rate)

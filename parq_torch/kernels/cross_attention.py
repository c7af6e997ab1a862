"""Kernels B2 and B3 — flash cross-attention, forward and backward
(``csrc/cross_attention.cu``), on K and V in every layout of the JAX
package.

Replaces parq_tpu/kernels/cross_attention_pallas.py:_fwd_call (B2) and
_bwd_call (B3). The kernels read K and V, and write dK and dV, through
strided (B, H, N, D) views (pointer, row, batch and head strides), so one
kernel serves every layout in place:

- fused: one (B, N, H·2D) buffer whose lanes [h·2D, h·2D + D) hold K_h and
  [h·2D + D, (h+1)·2D) hold V_h — the decoder's single fused projection;
- natural ("split"): K and V as two (B, N, H·D) buffers, the projections'
  own output (the sequence-parallel training path);
- legacy: (B, H, N, D) K and V, or a pre-transposed (B, H, D, N) K, padded
  past `n_valid` (`pad_kv_for_flash`). The JAX wrapper turns a (B, H, N, D)
  K into (B, H, D, N) with one swapaxes (:985); this one does the mirror
  image, one transpose of a (B, H, D, N) K into (B, H, N, D).

Each wrapper launches its CUDA kernel for CUDA tensors (or raises) and
runs its plain version for CPU tensors:

- `flash_cross_attention_kv_fused` — B2, eval form (no dropout, no LSE),
  through the custom op ``parq::flash_kv_fused`` so that `torch.export`
  keeps the launch;
- `flash_fwd_lse` — B2, train form: also the rowwise logsumexp, and
  weight dropout drawn in the kernel from one seed per group of rows;
- `flash_bwd` — B3, (dq, dKV) from (q, kv, do, lse, delta, seeds);
- `flash_fwd_lse_kv` and `flash_bwd_kv` — B2-train and B3 on separate K
  and V views (the same kernels, other strides).

The autograd entries of the JAX package sit on top of them:
`flash_cross_attention_kv_fused_train` (forward B2-train, backward B3),
`flash_cross_attention_kv_fused_fwd_lse` (no gradient) and
`flash_cross_attention_kv_fused_precomputed` (forward returns the saved o,
backward B3); and on separate K and V, under the JAX package's names,
`flash_cross_attention`, `flash_cross_attention_fwd_lse` and
`flash_cross_attention_precomputed`.

For bf16 at the release head dim (D = 256) the kernels are the Hopper
ones (``csrc/flash_fwd_sm90.cu``, ``csrc/flash_bwd_sm90.cu``: wgmma on
TMA-fed shared-memory rings), and the forward may split the KV range over
several CTAs per q tile (`kv_splits`) and merge the partials in a combine
kernel; `merge_partials` and `cross_attention_kv_fused_split_plain` are the
plain version of that. B3's dq pass splits the same way (`dq_splits`), its
combine adding f32 partials of dq in split order
(`cross_attention_kv_fused_bwd_split_plain`). A split call and its combine
count as one launch.

Dropout is the JAX package's counter hash of (seed, b·H + h, group-local
row, global kv column) (`_keep_mask`, :58-117), bit for bit: v1, or v2
where the environment says PARQ_DROPOUT_HASH=v2 (read at each call, as the
JAX package reads it at each trace). `keep_mask` is its plain version. b is
the GLOBAL batch index: a data-parallel rank passes `b_offset`, the index
of its first row in the global batch, and draws what one process over the
whole batch draws.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Union

import torch

from . import _build

HEAD_DIMS = (64, 128, 256)  # head dims the CUDA kernel is built for
SPLIT_HEAD_DIM = 256        # the head dim whose bf16 forward can split KV
MAX_SPLITS = 16             # most KV splits B2 and B3's dq pass take
_Q_TILE, _KV_BLOCK = 128, 64   # the Hopper forward's CTA tile


def split_kv(kv: torch.Tensor, heads: int):
    """Fused (B, N, H·2D) → k, v views (B, H, N, D) (strided, no copy)."""
    B, N, F = kv.shape
    kvh = kv.view(B, N, heads, 2, F // (2 * heads))
    return kvh[:, :, :, 0].transpose(1, 2), kvh[:, :, :, 1].transpose(1, 2)


def heads_view(t: torch.Tensor, heads: int, n_valid: int) -> torch.Tensor:
    """The (B, H, n_valid, D) view of a K or V buffer: natural (B, N, H·D)
    or legacy (B, H, N, D). No copy."""
    if t.dim() == 3:
        t = t.unflatten(-1, (heads, t.shape[-1] // heads)).transpose(1, 2)
    return t[:, :, :n_valid]


def dropout_v2() -> bool:
    """Whether the environment asks for the v2 dropout hash
    (PARQ_DROPOUT_HASH=v2; anything else is v1, as in the JAX package)."""
    return os.environ.get("PARQ_DROPOUT_HASH", "v1") == "v2"


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
              q0: int = 0, v2: bool = False) -> torch.Tensor:
    """Plain version of the kernels' dropout draw (v1 or v2 hash).

    seeds: int tensor (...) of group seeds; bh: b·H + h, an int or an int
    tensor broadcastable with `seeds`; rows `q0 .. q0 + rows − 1` are
    local to the seed's group; cols `0 .. cols − 1` are global kv indices.
    Returns bool (..., rows, cols), True where the weight is kept. The
    uint32 arithmetic runs in int64, masked to 32 bits."""
    s = torch.as_tensor(seeds, dtype=torch.int64)
    dev = s.device
    bh = torch.as_tensor(bh, dtype=torch.int64, device=dev)
    h0 = _mul32(s & _M32, 2654435761) ^ _mul32(bh & _M32, 2246822519)
    r = torch.arange(q0, q0 + rows, dtype=torch.int64, device=dev)
    c = torch.arange(cols, dtype=torch.int64, device=dev)
    if v2:    # a mixed row term plus a mixed column term, one final round
        rv = _mul32((h0[..., None] + r) & _M32, 3266489917)
        rv = _mul32(rv ^ (rv >> 15), 0x85EBCA6B)
        cv = _mul32(c, 668265263)
        cv = _mul32(cv ^ (cv >> 13), 0xC2B2AE35)
        h = (rv[..., :, None] + cv) & _M32
        h = _mul32(h ^ (h >> 16), 0x7FEB352D)
        h = h ^ (h >> 15)
        return h >= dropout_threshold(rate)
    h = (h0[..., None, None] + _mul32(r, 3266489917)[:, None]
         + _mul32(c, 668265263)[None, :]) & _M32
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
    the (G,) int32 seeds on `device`. A tensor of seeds on `device` (the
    decoder's, `DropoutDraws.flash_seeds`) is reshaped and cast there and
    never goes through the host; Python ints (the tests, the CPU) are
    uploaded."""
    if rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    seeds = (dropout_seed if torch.is_tensor(dropout_seed)
             else torch.as_tensor(0 if dropout_seed is None else dropout_seed))
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


def _keep_rows(seeds, b: int, H: int, Q: int, N: int, rate: float,
               v2: bool = False):
    """(H, Q, N) keep mask of global batch element b (G groups of Q/G
    rows)."""
    G = seeds.numel()
    bh = b * H + torch.arange(H, device=seeds.device)
    return keep_mask(seeds.long()[None, :], bh[:, None], Q // G, N,
                     rate, v2=v2).reshape(H, Q, N)


def attention_train_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, seeds: torch.Tensor, rate: float,
                          b_offset: int = 0, v2: bool = False):
    """Plain version of B2's train form on (B, H, N, D) k and v: (o (B, H,
    Q, D) in q's dtype, lse (B, H, Q) f32, natural log). p is dropped after
    the softmax, as keep·p/(1 − rate), with the mask of global batch element
    b_offset + b. One batch element at a time bounds the (H, Q, N)
    temporaries."""
    B, H, Q, D = q.shape
    N = k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Q, dtype=torch.float32, device=q.device)
    with torch.autocast(q.device.type, enabled=False):
        for b in range(B):
            s = (q[b].float() @ k[b].float().transpose(-1, -2)) * D ** -0.5
            lse[b] = torch.logsumexp(s, dim=-1)
            p = torch.exp(s - lse[b][..., None])
            if rate > 0.0:
                keep = _keep_rows(seeds, b_offset + b, H, Q, N, rate, v2)
                p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
            o[b] = (p @ v[b].float()).to(q.dtype)
    return o, lse


def cross_attention_kv_fused_train_plain(q: torch.Tensor, kv: torch.Tensor,
                                         seeds: torch.Tensor, rate: float,
                                         b_offset: int = 0, v2: bool = False):
    """Plain version of B2's train form over the fused buffer."""
    return attention_train_plain(q, *split_kv(kv, q.shape[1]), seeds, rate,
                                 b_offset, v2)


def merge_partials(parts):
    """LSE-weighted merge of attention partials over disjoint token
    ranges: parts is a sequence of (o_i (..., Q, D), lse_i (..., Q)), each
    o_i normalised within its range and lse_i its natural-log logsumexp.
    Returns (o f32, lse f32) with w_i = exp(lse_i − max lse),
    o = Σ w_i o_i / Σ w_i, lse = max + log Σ w_i: the arithmetic of the JAX
    package's `_merge_partials` (parallel/seq_parallel.py:78-91) and of
    the forward's combine kernel."""
    lses = torch.stack([l.float() for _, l in parts])
    m = lses.max(dim=0).values
    w = torch.exp(lses - m)
    num = sum(o.float() * w[i][..., None] for i, (o, _) in enumerate(parts))
    den = w.sum(dim=0)
    return num / den[..., None], m + torch.log(den)


def split_bounds(N: int, splits: int):
    """The token ranges [(n0, n1), ...] the forward gives its `splits`
    CTAs: runs of ⌈blocks/splits⌉ whole 64-token blocks, the last ragged."""
    nblocks = -(-N // _KV_BLOCK)
    per = -(-nblocks // splits) * _KV_BLOCK
    return [(n0, min(N, n0 + per)) for n0 in range(0, N, per)]


def cross_attention_kv_fused_split_plain(q: torch.Tensor, kv: torch.Tensor,
                                         seeds: torch.Tensor, rate: float,
                                         bounds):
    """Plain version of the split-KV forward: the plain attention over each
    token range of `bounds`, merged by `merge_partials`. Dropout draws with
    the GLOBAL kv column, so the kept set is that of the unsplit form.
    Returns (o in q's dtype, lse (B, H, Q) f32)."""
    B, H, Q, D = q.shape
    k, v = split_kv(kv, H)
    parts = []
    for n0, n1 in bounds:
        s = (q.float() @ k[:, :, n0:n1].float().transpose(-1, -2)) * D ** -0.5
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[..., None])
        if rate > 0.0:
            keep = torch.stack([_keep_rows(seeds, b, H, Q, n1, rate)
                                for b in range(B)])[..., n0:n1]
            p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
        parts.append((p @ v[:, :, n0:n1].float(), lse))
    o, lse = merge_partials(parts)
    return o.to(q.dtype), lse


def attention_bwd_plain(q, k, v, do, lse, delta, seeds, rate: float,
                        dk: torch.Tensor, dv: torch.Tensor,
                        b_offset: int = 0, v2: bool = False, bounds=None):
    """Plain version of B3 on (B, H, N, D) k and v: returns dq in q's
    dtype and writes dK and dV, summed over every q row, into the (B, H,
    N, D) views `dk` and `dv`. ds and w are rounded to the working dtype
    before the last three products, as the JAX kernel does. With `bounds`
    (token ranges, `split_bounds`) dq is the split dq pass's arithmetic:
    one f32 partial of ds·K per range, added in split order, then
    scaled."""
    B, H, Q, D = q.shape
    N = k.shape[2]
    scale = D ** -0.5
    dq = torch.empty_like(q)
    with torch.autocast(q.device.type, enabled=False):
        for b in range(B):
            kb, vb = k[b].float(), v[b].float()
            qb, dob = q[b].float(), do[b].float()
            p = torch.exp((qb @ kb.transpose(-1, -2)) * scale
                          - lse[b][..., None])
            w = p
            if rate > 0.0:
                keep = _keep_rows(seeds, b_offset + b, H, Q, N, rate, v2)
                w = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
            dw = dob @ vb.transpose(-1, -2)
            ds = (w * dw - p * delta[b][..., None]).to(q.dtype).float()
            w = w.to(do.dtype).float()
            if bounds is None:
                dq[b] = ((ds @ kb) * scale).to(q.dtype)
            else:
                parts = [ds[..., n0:n1] @ kb[:, n0:n1] for n0, n1 in bounds]
                acc = parts[0]
                for part in parts[1:]:
                    acc = acc + part
                dq[b] = (acc * scale).to(q.dtype)
            dk[b] = ((ds.transpose(-1, -2) @ qb) * scale).to(dk.dtype)
            dv[b] = (w.transpose(-1, -2) @ dob).to(dv.dtype)
    return dq


def cross_attention_kv_fused_bwd_plain(q, kv, do, lse, delta, seeds,
                                       rate: float, b_offset: int = 0,
                                       v2: bool = False):
    """Plain version of B3 over the fused buffer: (dq in q's dtype, dKV
    (B, N, H·2D) in kv's dtype, summed over every q row)."""
    H = q.shape[1]
    dkv = torch.empty_like(kv)
    dq = attention_bwd_plain(q, *split_kv(kv, H), do, lse, delta, seeds,
                             rate, *split_kv(dkv, H), b_offset, v2)
    return dq, dkv


def cross_attention_kv_fused_bwd_split_plain(q, kv, do, lse, delta, seeds,
                                             rate: float, bounds,
                                             b_offset: int = 0,
                                             v2: bool = False):
    """Plain version of B3 with its dq pass split over the token ranges of
    `bounds` (`split_bounds`): (dq, dKV) as
    `cross_attention_kv_fused_bwd_plain`, dq summed per range in f32 and
    the ranges added in split order, as the kernel's combine does."""
    H = q.shape[1]
    dkv = torch.empty_like(kv)
    dq = attention_bwd_plain(q, *split_kv(kv, H), do, lse, delta, seeds,
                             rate, *split_kv(dkv, H), b_offset, v2, bounds)
    return dq, dkv


class _KV(ctypes.Structure):
    """parq::KV (csrc/flash_common.cuh): a (B, H, N, D) view with unit
    stride along D, its strides in elements."""
    _fields_ = [("ptr", ctypes.c_void_p), ("row", ctypes.c_longlong),
                ("batch", ctypes.c_longlong), ("head", ctypes.c_longlong)]


def _kv_arg(t: torch.Tensor) -> _KV:
    return _KV(t.data_ptr(), t.stride(2), t.stride(0), t.stride(1))


def _fn(name: str, argtypes):
    lib = _build.load("cross_attention")
    fn = getattr(lib, name)
    if fn.argtypes is None:   # declare once: pointers must not pass as int
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int


def kv_splits(B: int, H: int, group_rows: int, N: int, sms: int) -> int:
    """How many CTAs share the KV range of one q tile in the Hopper
    forward. A fixed rule: the largest count, at most MAX_SPLITS, that keeps
    B·H·⌈group_rows/128⌉·splits CTAs within the card's `sms` SMs, and never
    more than there are 64-token blocks. It depends on the rows of ONE seed
    group, not on Q, so a folded call of G groups takes the split of each
    of its G separate calls and sums in their order (bit for bit equal)."""
    ctas = B * H * -(-group_rows // _Q_TILE)
    nblocks = -(-N // _KV_BLOCK)
    splits = max(1, min(MAX_SPLITS, sms // ctas, nblocks))
    return len(split_bounds(N, splits))   # drop splits left without a block


def dq_splits(B: int, H: int, Q: int, N: int, sms: int) -> int:
    """How many CTAs share the KV range of one q tile in B3's dq pass: the
    rule of `kv_splits` on all Q rows of the call (the dq pass has no
    per-group state to keep apart). The release fold (B=8, Q=2048: 512
    CTAs) takes 1; B=1 at Q=256 takes up to 16. A folded call's dq does
    NOT in general equal its G separate calls' bit for bit: the fold has
    G times the rows, so it may take fewer splits, and a split sums each
    KV range in f32 before adding the ranges. Nothing needs that equality:
    the fold and the per-iteration paths already sum dK and dV over the
    iterations in different orders."""
    return kv_splits(B, H, Q, N, sms)


def _splits_for(q: torch.Tensor, N: int, rows: int, splits) -> int:
    """The KV split of this call's forward (`rows` the rows of one seed
    group) or dq pass (`rows` = Q): 1 except for bf16 at D = 256; `splits`
    overrides the rule (tests hold every split against plain). A split the
    kernels do not take raises."""
    B, H, Q, D = q.shape
    if q.dtype != torch.bfloat16 or D != SPLIT_HEAD_DIM:
        if splits not in (None, 1):
            raise ValueError("flash: only the bf16 D=256 kernels split KV")
        return 1
    if splits is None:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        return kv_splits(B, H, rows, N, sms)
    if not 1 <= splits <= MAX_SPLITS or \
            len(split_bounds(N, splits)) != splits:
        raise ValueError(f"flash: splits={splits} for N={N}")
    return splits


def _scratch(q: torch.Tensor, splits: int, lse: bool = True):
    """A split call's f32 scratch: `splits` partials of o (then their
    logsumexp rows, `lse`) for the forward's combine, or of dq for B3's.
    None for an unsplit call."""
    if splits == 1:
        return None
    B, H, Q, D = q.shape
    return torch.empty(splits * B * H * Q * (D + int(lse)),
                       dtype=torch.float32, device=q.device)


_DROP_ARGS = [_I, ctypes.c_uint32, ctypes.c_float, _I, _I]


def _check_dtype(q: torch.Tensor, t: torch.Tensor, what: str):
    B, H, Q, D = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32) or t.dtype != q.dtype:
        raise TypeError(f"{what}: dtypes q {q.dtype}, kv {t.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} not in {HEAD_DIMS}")
    if t.device != q.device:
        raise ValueError(f"{what}: kv must be on q's device")


def _check(q: torch.Tensor, kv: torch.Tensor, what: str):
    B, H, Q, D = q.shape
    if kv.dim() != 3 or kv.shape[0] != B or kv.shape[2] != 2 * H * D:
        raise ValueError(f"{what}: kv {tuple(kv.shape)} vs q "
                         f"{tuple(q.shape)}")
    _check_dtype(q, kv, what)
    if kv.shape[1] < 1:
        raise ValueError(f"{what}: kv must be non-empty")


def _check_views(q: torch.Tensor, what: str, *views: torch.Tensor):
    """K, V (and dK, dV) as the strided kernels take them: (B, H, N, D)
    views with unit stride along D, strides and pointers 16-byte aligned."""
    B, H, Q, D = q.shape
    shape = views[0].shape
    for t in views:
        if t.dim() != 4 or t.shape != shape or tuple(shape[::3]) != (B, D) \
                or shape[1] != H or shape[2] < 1:
            raise ValueError(f"{what}: k/v view {tuple(t.shape)} vs q "
                             f"{tuple(q.shape)}")
        _check_dtype(q, t, what)
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{what}: k/v strides {t.stride()} (want unit "
                             "stride along D, the others multiples of 8)")


def _aligned(what: str, *ts):
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what}: inputs must be 16-byte aligned")


def _drop_args(seeds: torch.Tensor, Q: int, rate: float, b_offset: int,
               v2: Optional[bool]):
    """(group_rows, thresh, keep_scale, b_offset, v2) as the kernels take
    them; the threshold comes from the double `rate`, as in the JAX
    package; v2 None reads the environment."""
    v2 = int(dropout_v2() if v2 is None else v2)
    if rate <= 0.0:
        return (Q // seeds.numel(), 0, 1.0, b_offset, v2)
    return (Q // seeds.numel(), dropout_threshold(rate), 1.0 / (1.0 - rate),
            b_offset, v2)


def _stream(q: torch.Tensor):
    return torch.cuda.current_stream(q.device).cuda_stream


def _raise_on(err: int, what: str):
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed, error {err}")


def flash_cross_attention_kv_fused(q: torch.Tensor, kv: torch.Tensor
                                   ) -> torch.Tensor:
    """Kernel B2. q (B, H, Q, D), kv (B, N, H·2D), both bf16 or both f32
    → o (B, H, Q, D) in q's dtype. CPU tensors take the plain version. It
    runs through the custom op ``parq::flash_kv_fused``, so `torch.export`
    keeps the launch in an exported program."""
    _build.import_dynamo()
    return torch.ops.parq.flash_kv_fused(q, kv)


@torch.library.custom_op("parq::flash_kv_fused", mutates_args=())
def _flash_kv_fused_op(q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    return cross_attention_kv_fused_plain(q, kv)


@_flash_kv_fused_op.register_fake
def _(q, kv):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@_flash_kv_fused_op.register_kernel("cuda")
def _flash_kv_fused_cuda(q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    return _flash_fwd(q, kv, None)


def _flash_fwd(q: torch.Tensor, kv: torch.Tensor, splits: Optional[int]
               ) -> torch.Tensor:
    """B2's launch on CUDA tensors. `splits` None takes `kv_splits`; the
    tests give a number to hold every split against the plain version."""
    _check(q, kv, "flash")
    B, H, Q, D = q.shape
    q, kv = q.contiguous(), kv.contiguous()
    o = torch.empty_like(q)
    _aligned("flash", q, kv, o)
    splits = _splits_for(q, kv.shape[1], Q, splits)
    scratch = _scratch(q, splits)
    fn = _fn("parq_flash_fwd_kv_fused", [_P] * 4 + [_I] * 7 + [_P])
    _raise_on(fn(q.data_ptr(), kv.data_ptr(), o.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), splits, B,
                 H, Q, kv.shape[1], D, int(q.dtype == torch.bfloat16),
                 _stream(q)), "flash")
    flash_cross_attention_kv_fused.launches += 1
    return o


flash_cross_attention_kv_fused.launches = 0


def flash_fwd_lse(q: torch.Tensor, kv: torch.Tensor, seeds: torch.Tensor,
                  rate: float = 0.0, b_offset: int = 0,
                  v2: Optional[bool] = None):
    """Kernel B2, train form. q (B, H, Q, D), kv (B, N, H·2D), both bf16 or
    both f32; seeds (G,) int32 on q's device, G dividing Q; b_offset the
    global batch index of row 0; v2 the hash (None: the environment's) →
    (o in q's dtype, lse (B, H, Q) f32). CPU tensors take the plain
    version."""
    if q.device.type == "cpu":
        return cross_attention_kv_fused_train_plain(
            q, kv, seeds, rate, b_offset, dropout_v2() if v2 is None else v2)
    return _flash_fwd_lse(q, kv, seeds, rate, None, b_offset, v2)


def _flash_fwd_lse(q: torch.Tensor, kv: torch.Tensor, seeds: torch.Tensor,
                   rate: float, splits: Optional[int], b_offset: int = 0,
                   v2: Optional[bool] = None):
    """The train form's launch on CUDA tensors; `splits` as in `_flash_fwd`."""
    _check(q, kv, "flash_fwd_lse")
    B, H, Q, D = q.shape
    seeds = seeds.to(device=q.device, dtype=torch.int32).contiguous()
    q, kv = q.contiguous(), kv.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Q, dtype=torch.float32, device=q.device)
    _aligned("flash_fwd_lse", q, kv, o, lse)
    drop = _drop_args(seeds, Q, rate, b_offset, v2)
    splits = _splits_for(q, kv.shape[1], drop[0], splits)
    scratch = _scratch(q, splits)
    fn = _fn("parq_flash_fwd_kv_fused_lse",
             [_P] * 6 + [_I] * 6 + _DROP_ARGS + [_I, _P])
    _raise_on(fn(q.data_ptr(), kv.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 seeds.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), splits, B,
                 H, Q, kv.shape[1], D, *drop, int(q.dtype == torch.bfloat16),
                 _stream(q)), "flash_fwd_lse")
    flash_fwd_lse.launches += 1
    return o, lse


flash_fwd_lse.launches = 0


def _check_bwd(q, do, lse, delta, what):
    B, H, Q, D = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{what}: do {do.dtype} {tuple(do.shape)}")
    for t in (lse, delta):
        if t.shape != (B, H, Q) or t.dtype != torch.float32:
            raise ValueError(f"{what}: lse/delta {t.dtype} {tuple(t.shape)}")


def flash_bwd(q: torch.Tensor, kv: torch.Tensor, do: torch.Tensor,
              lse: torch.Tensor, delta: torch.Tensor, seeds: torch.Tensor,
              rate: float = 0.0, b_offset: int = 0,
              v2: Optional[bool] = None):
    """Kernel B3. q, do (B, H, Q, D) and kv (B, N, H·2D) in one dtype (bf16
    or f32); lse and delta = rowsum(do·o) (B, H, Q) f32; seeds, b_offset
    and v2 as for `flash_fwd_lse` → (dq, dKV in the fused layout, summed
    over every q row). CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return cross_attention_kv_fused_bwd_plain(
            q, kv, do, lse, delta, seeds, rate, b_offset,
            dropout_v2() if v2 is None else v2)
    return _flash_bwd(q, kv, do, lse, delta, seeds, rate, None, b_offset, v2)


def _flash_bwd(q, kv, do, lse, delta, seeds, rate: float,
               splits: Optional[int], b_offset: int = 0,
               v2: Optional[bool] = None):
    """B3's launch on CUDA tensors; `splits` is the dq pass's KV split
    (None: `dq_splits`; a split dq pass and its combine count as one
    launch)."""
    _check(q, kv, "flash_bwd")
    _check_bwd(q, do, lse, delta, "flash_bwd")
    B, H, Q, D = q.shape
    seeds = seeds.to(device=q.device, dtype=torch.int32).contiguous()
    q, kv, do = q.contiguous(), kv.contiguous(), do.contiguous()
    lse, delta = lse.contiguous(), delta.contiguous()
    dq, dkv = torch.empty_like(q), torch.empty_like(kv)
    _aligned("flash_bwd", q, kv, do, dq, dkv)
    splits = _splits_for(q, kv.shape[1], Q, splits)
    scratch = _scratch(q, splits, lse=False)
    fn = _fn("parq_flash_bwd_kv_fused",
             [_P] * 9 + [_I] * 6 + _DROP_ARGS + [_I, _P])
    _raise_on(fn(q.data_ptr(), kv.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), seeds.data_ptr(), dq.data_ptr(),
                 dkv.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), splits, B,
                 H, Q, kv.shape[1], D,
                 *_drop_args(seeds, Q, rate, b_offset, v2),
                 int(q.dtype == torch.bfloat16), _stream(q)), "flash_bwd")
    flash_bwd.launches += 1
    return dq, dkv


flash_bwd.launches = 0


def flash_fwd_lse_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     seeds: torch.Tensor, rate: float = 0.0,
                     b_offset: int = 0, v2: Optional[bool] = None):
    """Kernel B2, train form, on K and V as (B, H, N, D) views (unit stride
    along D: `heads_view` of a natural or legacy buffer, or `split_kv` of a
    fused one); the other arguments as for `flash_fwd_lse` → (o, lse (B, H,
    Q) f32). CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return attention_train_plain(q, k, v, seeds, rate, b_offset,
                                     dropout_v2() if v2 is None else v2)
    return _flash_fwd_lse_kv(q, k, v, seeds, rate, None, b_offset, v2)


def _flash_fwd_lse_kv(q, k, v, seeds, rate: float, splits: Optional[int],
                      b_offset: int = 0, v2: Optional[bool] = None):
    """The split train form's launch on CUDA tensors; `splits` as in
    `_flash_fwd`."""
    _check_views(q, "flash_fwd_lse_kv", k, v)
    B, H, Q, D = q.shape
    N = k.shape[2]
    seeds = seeds.to(device=q.device, dtype=torch.int32).contiguous()
    q = q.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Q, dtype=torch.float32, device=q.device)
    _aligned("flash_fwd_lse_kv", q, k, v, o, lse)
    drop = _drop_args(seeds, Q, rate, b_offset, v2)
    splits = _splits_for(q, N, drop[0], splits)
    scratch = _scratch(q, splits)
    fn = _fn("parq_flash_fwd_kv_lse",
             [_P, _KV, _KV] + [_P] * 4 + [_I] * 6 + _DROP_ARGS + [_I, _P])
    _raise_on(fn(q.data_ptr(), _kv_arg(k), _kv_arg(v), o.data_ptr(),
                 lse.data_ptr(), seeds.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), splits, B,
                 H, Q, N, D, *drop, int(q.dtype == torch.bfloat16),
                 _stream(q)), "flash_fwd_lse_kv")
    flash_fwd_lse_kv.launches += 1
    return o, lse


flash_fwd_lse_kv.launches = 0


def flash_bwd_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 seeds: torch.Tensor, rate: float, dk: torch.Tensor,
                 dv: torch.Tensor, b_offset: int = 0,
                 v2: Optional[bool] = None) -> torch.Tensor:
    """Kernel B3 on K and V as (B, H, N, D) views (as for
    `flash_fwd_lse_kv`): returns dq and writes dK and dV, summed over every
    q row, into the (B, H, N, D) views `dk` and `dv` of their buffers. CPU
    tensors take the plain version."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, do, lse, delta, seeds, rate, dk,
                                   dv, b_offset,
                                   dropout_v2() if v2 is None else v2)
    return _flash_bwd_kv(q, k, v, do, lse, delta, seeds, rate, dk, dv, None,
                         b_offset, v2)


def _flash_bwd_kv(q, k, v, do, lse, delta, seeds, rate: float, dk, dv,
                  splits: Optional[int], b_offset: int = 0,
                  v2: Optional[bool] = None) -> torch.Tensor:
    """The split-K/V backward's launch on CUDA tensors; `splits` as in
    `_flash_bwd`."""
    _check_views(q, "flash_bwd_kv", k, v, dk, dv)
    _check_bwd(q, do, lse, delta, "flash_bwd_kv")
    B, H, Q, D = q.shape
    N = k.shape[2]
    seeds = seeds.to(device=q.device, dtype=torch.int32).contiguous()
    q, do = q.contiguous(), do.contiguous()
    lse, delta = lse.contiguous(), delta.contiguous()
    dq = torch.empty_like(q)
    _aligned("flash_bwd_kv", q, k, v, do, dq, dk, dv)
    splits = _splits_for(q, N, Q, splits)
    scratch = _scratch(q, splits, lse=False)
    fn = _fn("parq_flash_bwd_kv", [_P, _KV, _KV] + [_P] * 5
             + [_KV, _KV, _P] + [_I] * 6 + _DROP_ARGS + [_I, _P])
    _raise_on(fn(q.data_ptr(), _kv_arg(k), _kv_arg(v), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), seeds.data_ptr(),
                 dq.data_ptr(), _kv_arg(dk), _kv_arg(dv),
                 None if scratch is None else scratch.data_ptr(), splits, B,
                 H, Q, N, D, *_drop_args(seeds, Q, rate, b_offset, v2),
                 int(q.dtype == torch.bfloat16), _stream(q)), "flash_bwd_kv")
    flash_bwd_kv.launches += 1
    return dq


flash_bwd_kv.launches = 0


def wgmma_selftest(a: torch.Tensor, b: torch.Tensor, v: torch.Tensor):
    """The Hopper kernels' building blocks on one tile, on the card: a, b
    (64, 64) and v (64, 256) bf16 → (c1 (64, 64) f32 = a @ bᵀ through
    shared-memory K-major descriptors, c2 (64, 256) f32 = bf16(c1) @ v with
    c1 from registers and v read MN-major)."""
    for t, shape in ((a, (64, 64)), (b, (64, 64)), (v, (64, 256))):
        if t.device.type != "cuda" or t.dtype != torch.bfloat16 or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError("wgmma_selftest: contiguous bf16 CUDA tensors "
                             "(64, 64), (64, 64), (64, 256)")
    c1 = torch.empty(64, 64, dtype=torch.float32, device=a.device)
    c2 = torch.empty(64, 256, dtype=torch.float32, device=a.device)
    fn = _fn("parq_wgmma_selftest", [_P] * 6)
    _raise_on(fn(a.data_ptr(), b.data_ptr(), v.data_ptr(), c1.data_ptr(),
                 c2.data_ptr(), _stream(a)), "wgmma_selftest")
    return c1, c2


def _delta(do, o):
    """delta = rowsum(do·o) in f32 outside the kernel, as
    `_flash_attn_kv_bwd` computes it (:814-823)."""
    return (do.float() * o.float()).sum(dim=-1)


def _backward(q, kv, seeds, o, lse, args, do):
    """B3 from the saved forward."""
    do = do.to(q.dtype)
    return flash_bwd(q, kv, do, lse, _delta(do, o), seeds, *args)


class _FlashTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, seeds, rate, b_offset, v2):
        o, lse = flash_fwd_lse(q, kv, seeds, rate, b_offset, v2)
        ctx.save_for_backward(q, kv, seeds, o, lse)
        ctx.args = (rate, b_offset, v2)
        return o

    @staticmethod
    def backward(ctx, do):
        q, kv, seeds, o, lse = ctx.saved_tensors
        dq, dkv = _backward(q, kv, seeds, o, lse, ctx.args, do)
        return dq, dkv, None, None, None, None


class _FlashPrecomputed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, o, lse, seeds, rate, b_offset, v2):
        ctx.save_for_backward(q, kv, seeds, o, lse)
        ctx.args = (rate, b_offset, v2)
        return o.clone()

    @staticmethod
    def backward(ctx, do):
        q, kv, seeds, o, lse = ctx.saved_tensors
        dq, dkv = _backward(q, kv, seeds, o, lse, ctx.args, do)
        return dq, dkv, None, None, None, None, None, None


Seed = Union[None, int, Sequence[int], torch.Tensor]


def _prep(q, kv, dropout_rate, dropout_seed, q_tile):
    """Casts and checks shared by the entries: q takes kv's dtype (under
    bf16 autocast both arrive bf16; the kernels refuse a mix); the hash is
    read from the environment once per call."""
    seeds = _seed_vector(dropout_seed, float(dropout_rate), q.shape[2],
                         q_tile, q.device)
    return q.to(kv.dtype), seeds, float(dropout_rate), dropout_v2()


def flash_cross_attention_kv_fused_train(
        q: torch.Tensor, kv: torch.Tensor, *, dropout_rate: float = 0.0,
        dropout_seed: Seed = None, q_tile: Optional[int] = None,
        b_offset: int = 0):
    """Differentiable flash cross-attention over the fused K/V buffer:
    forward B2-train, backward B3 (dKV in the fused layout). `dropout_seed`
    is an int, or a (G,) vector of seeds, one per Q/G rows; `b_offset` the
    global batch index of row 0."""
    q, seeds, rate, v2 = _prep(q, kv, dropout_rate, dropout_seed, q_tile)
    return _FlashTrain.apply(q, kv, seeds, rate, b_offset, v2)


def flash_cross_attention_kv_fused_fwd_lse(
        q: torch.Tensor, kv: torch.Tensor, *, dropout_rate: float = 0.0,
        dropout_seed: Seed = None, q_tile: Optional[int] = None,
        b_offset: int = 0):
    """B2-train with no gradient: (o, lse (B, H, Q) f32). It feeds the
    trajectory pass; the gradient runs through
    `flash_cross_attention_kv_fused_precomputed`."""
    q, seeds, rate, v2 = _prep(q, kv, dropout_rate, dropout_seed, q_tile)
    with torch.no_grad():
        return flash_fwd_lse(q.detach(), kv.detach(), seeds, rate, b_offset,
                             v2)


def flash_cross_attention_kv_fused_precomputed(
        q: torch.Tensor, kv: torch.Tensor, o: torch.Tensor,
        lse: torch.Tensor, *, dropout_rate: float = 0.0,
        dropout_seed: Seed = None, q_tile: Optional[int] = None,
        b_offset: int = 0):
    """Differentiable flash cross-attention whose forward is skipped: (o,
    lse) come from an identical earlier call with the same q, kv and
    seeds. The backward is B3."""
    q, seeds, rate, v2 = _prep(q, kv, dropout_rate, dropout_seed, q_tile)
    return _FlashPrecomputed.apply(q, kv, o.detach().to(q.dtype),
                                   lse.detach(), seeds, rate, b_offset, v2)


# ------------------------------------------------ separate K and V ------
def pad_kv_for_flash(k_t: torch.Tensor, v: torch.Tensor,
                     block_k: int = 1920):
    """Pad a pre-transposed K (B, H, D, N) and V (B, H, N, D) with zeros to
    a multiple of the block, as the JAX package's `pad_kv_for_flash`
    (:419-430); pass the true N as `n_valid`. The kernels here need no
    padding: they read the first n_valid rows of a padded buffer in
    place."""
    N = k_t.shape[-1]
    block_k = min(block_k, max(128, -(-N // 128) * 128))
    n_pad = (-N) % block_k
    if n_pad:
        k_t = torch.nn.functional.pad(k_t, (0, n_pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, n_pad))
    return k_t, v


def _prep_flash_args(q, k, v, k_transposed, n_valid, dropout_rate,
                     dropout_seed, q_tile):
    """The JAX package's `_prep_flash_args` (:967-1019): K/V in the natural
    (B, N, H·D) layout (ndim 3), or the legacy (B, H, N, D) one (ndim 4;
    `k_transposed`: K is (B, H, D, N), transposed here once); n_valid
    defaults to N; the seed-vector rules of `_seed_vector`. Returns (q in
    k's dtype, k, v, n_valid, seeds, rate, v2)."""
    B, H, Q, D = q.shape
    if k.dim() == 3:
        if k.shape[-1] != H * D or v.shape != k.shape:
            raise ValueError(f"flash: natural k {tuple(k.shape)}, v "
                             f"{tuple(v.shape)} vs q {tuple(q.shape)}")
    else:
        if k_transposed:
            k = k.transpose(-1, -2).contiguous()
        if k.shape[:2] != (B, H) or k.shape[-1] != D or v.shape != k.shape:
            raise ValueError(f"flash: legacy k {tuple(k.shape)}, v "
                             f"{tuple(v.shape)} vs q {tuple(q.shape)}")
    N = k.shape[1] if k.dim() == 3 else k.shape[2]
    n_valid = N if n_valid is None else int(n_valid)
    if not 1 <= n_valid <= N:
        raise ValueError(f"flash: n_valid={n_valid} for N={N}")
    q, seeds, rate, v2 = _prep(q, k, dropout_rate, dropout_seed, q_tile)
    return q, k.contiguous(), v.contiguous(), n_valid, seeds, rate, v2


def _split_backward(q, k, v, seeds, o, lse, n_valid, rate, b_offset, v2,
                    do):
    """B3 on separate K and V from the saved forward: (dq, dK, dV), dK and
    dV in the layout of K and V, zero in the rows past n_valid."""
    H = q.shape[1]
    do = do.to(q.dtype)
    full = n_valid == (k.shape[1] if k.dim() == 3 else k.shape[2])
    dk = torch.empty_like(k) if full else torch.zeros_like(k)
    dv = torch.empty_like(v) if full else torch.zeros_like(v)
    dq = flash_bwd_kv(q, heads_view(k, H, n_valid), heads_view(v, H, n_valid),
                      do, lse, _delta(do, o), seeds, rate,
                      heads_view(dk, H, n_valid), heads_view(dv, H, n_valid),
                      b_offset, v2)
    return dq, dk, dv


class _FlashSplitTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seeds, n_valid, rate, b_offset, v2):
        H = q.shape[1]
        o, lse = flash_fwd_lse_kv(q, heads_view(k, H, n_valid),
                                  heads_view(v, H, n_valid), seeds, rate,
                                  b_offset, v2)
        ctx.save_for_backward(q, k, v, seeds, o, lse)
        ctx.args = (n_valid, rate, b_offset, v2)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seeds, o, lse = ctx.saved_tensors
        return (*_split_backward(q, k, v, seeds, o, lse, *ctx.args, do),
                None, None, None, None, None)


class _FlashSplitPrecomputed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, o, lse, seeds, n_valid, rate, b_offset, v2):
        ctx.save_for_backward(q, k, v, seeds, o, lse)
        ctx.args = (n_valid, rate, b_offset, v2)
        return o.clone()

    @staticmethod
    def backward(ctx, do):
        q, k, v, seeds, o, lse = ctx.saved_tensors
        return (*_split_backward(q, k, v, seeds, o, lse, *ctx.args, do),
                None, None, None, None, None, None, None)


def flash_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, k_transposed: bool = False,
                          n_valid: Optional[int] = None,
                          dropout_rate: float = 0.0, dropout_seed: Seed = None,
                          q_tile: Optional[int] = None, b_offset: int = 0):
    """Differentiable flash cross-attention on separate K and V (the JAX
    package's `flash_cross_attention`, :931): q (B, H, Q, D); k and v
    natural (B, N, H·D), or legacy (B, H, N, D) (k (B, H, D, N) with
    `k_transposed`), padded past `n_valid` where given. Forward B2-train,
    backward B3; gradients come back in the layout of k and v. Dropout and
    `b_offset` as for `flash_cross_attention_kv_fused_train`."""
    q, k, v, n_valid, seeds, rate, v2 = _prep_flash_args(
        q, k, v, k_transposed, n_valid, dropout_rate, dropout_seed, q_tile)
    return _FlashSplitTrain.apply(q, k, v, seeds, n_valid, rate, b_offset,
                                  v2)


def flash_cross_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *,
                                  k_transposed: bool = False,
                                  n_valid: Optional[int] = None,
                                  dropout_rate: float = 0.0,
                                  dropout_seed: Seed = None,
                                  q_tile: Optional[int] = None,
                                  b_offset: int = 0):
    """`flash_cross_attention`'s forward with no gradient: (o, lse (B, H,
    Q) f32), for trajectory passes (the JAX package's :700)."""
    q, k, v, n_valid, seeds, rate, v2 = _prep_flash_args(
        q, k, v, k_transposed, n_valid, dropout_rate, dropout_seed, q_tile)
    H = q.shape[1]
    with torch.no_grad():
        return flash_fwd_lse_kv(q.detach(), heads_view(k.detach(), H, n_valid),
                                heads_view(v.detach(), H, n_valid), seeds,
                                rate, b_offset, v2)


def flash_cross_attention_precomputed(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor, o: torch.Tensor,
                                      lse: torch.Tensor, *,
                                      k_transposed: bool = False,
                                      n_valid: Optional[int] = None,
                                      dropout_rate: float = 0.0,
                                      dropout_seed: Seed = None,
                                      q_tile: Optional[int] = None,
                                      b_offset: int = 0):
    """Differentiable `flash_cross_attention` whose forward is skipped: (o,
    lse) come from an identical earlier call (the JAX package's :718). The
    backward is B3."""
    q, k, v, n_valid, seeds, rate, v2 = _prep_flash_args(
        q, k, v, k_transposed, n_valid, dropout_rate, dropout_seed, q_tile)
    return _FlashSplitPrecomputed.apply(q, k, v, o.detach().to(q.dtype),
                                        lse.detach(), seeds, n_valid, rate,
                                        b_offset, v2)

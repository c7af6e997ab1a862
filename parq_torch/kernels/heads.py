"""The decoder's four detection heads and the box decode that reads them,
in three kernels (``csrc/heads.cu``).

Not a TPU kernel: the JAX package fuses the same heads with XLA
(parq_tpu/models/mlp.py: `fused_detection_heads`). Per decoder iteration
the per-head path (`models/mlp.py:HeadMLP` and the decode in
`models/decoder.py:PARQDecoder._iteration`) makes some 90 small launches;
`detection_heads` makes 3: the two hidden layers of the center and rotation
heads (K1, K2: wgmma, with GroupNorm1's statistics written by each tile's
epilogue and combined by the next kernel) and the output projections with
the decode (K3). The rounding points are the per-head path's under bf16
autocast: bf16 inputs and outputs of the two hidden products, f32
GroupNorm statistics, f32 output projections, sem_cls and size from the
f32 input. Only the order of the sums differs.

`engages` is the dispatch rule, on what the call can observe: CUDA
tensors, no gradient, bf16 autocast, one group (not the training fold),
and widths the kernels take. Everything else (training, the f32 dtype, the
CPU, the fold's trajectory pass that runs the center head alone) keeps the
per-head path. The weights are read from the live parameters in every
call: nothing is cached.

`detection_heads_plain` is the plain version: the per-head path's own
operations on the same parameters, bit for bit on the CPU. The call runs
through the custom op ``parq::detection_heads`` (CPU: the plain version),
so a `torch.export` program launches the kernels as the live model does.
`detection_heads.launches` counts calls (three kernels each).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..geometry import denormalize_points, inverse_sigmoid, normalize_points
from . import _build

TILE = 64            # Q and D must be multiples of it (csrc/heads.cu)
MAX_DIM = 1024       # K3 holds a row's activations in registers
MAX_CLASSES = 32     # K3's softmax runs in one warp
OUTPUT_KEYS = ("pred_logits", "center_unnormalized", "size_unnormalized",
               "ortho6d", "sem_cls_prob")


def head_tensors(heads) -> List[torch.Tensor]:
    """The four heads' parameters in the kernels' order: center, then
    rotation (layer-1 weight, GroupNorm scale and bias, layer-2 weight,
    scale, bias, output weight, output bias), then sem_cls and size (output
    weight, output bias). Conv1d weights keep their (O, I, 1) shape."""
    out = []
    for head in (heads.center_head, heads.rotation_head):
        ly = head.layers
        out += [ly[0].weight, ly[1].weight, ly[1].bias, ly[4].weight,
                ly[5].weight, ly[5].bias, ly[8].weight, ly[8].bias]
    for head in (heads.sem_cls_head, heads.size_head):
        out += [head.layers[0].weight, head.layers[0].bias]
    return out


def head_eps(heads) -> List[float]:
    """GroupNorm eps: center layer 1, layer 2, rotation layer 1, layer 2."""
    return [heads.center_head.layers[1].eps, heads.center_head.layers[5].eps,
            heads.rotation_head.layers[1].eps,
            heads.rotation_head.layers[5].eps]


def _widths_taken(heads, D: int) -> bool:
    def shape(head, hidden: int, out: int) -> bool:
        ly = head.layers
        if len(ly) != 4 * hidden + 1:
            return False
        dims = [D] * (hidden + 1) + [out]
        convs = [ly[4 * i] for i in range(hidden)] + [ly[-1]]
        return all(c.weight.shape == (o, i, 1)
                   for c, i, o in zip(convs, dims[:-1], dims[1:]))

    nc = heads.sem_cls_head.layers[-1].weight.shape[0]
    return (shape(heads.center_head, 2, 3)
            and shape(heads.rotation_head, 2, 6)
            and shape(heads.sem_cls_head, 0, nc) and nc <= MAX_CLASSES
            and shape(heads.size_head, 0, 3)
            and all(p.dtype == torch.float32 for p in head_tensors(heads)))


def autocast_bf16() -> bool:
    """Whether CUDA autocast to bf16 is on (the model's bf16 forward)."""
    return (torch.is_autocast_enabled("cuda")
            and torch.get_autocast_dtype("cuda") == torch.bfloat16)


def engages(out: torch.Tensor, ref: torch.Tensor, heads,
            n_groups: int) -> bool:
    """Whether `detection_heads` takes this call: CUDA tensors, no
    gradient, bf16 autocast, one group, an f32 (B, Q, D) input and f32
    reference points, Q and D multiples of 64, D ≤ 1024, center and
    rotation hidden widths (D, D), outputs 3, 6, at most 32 classes, 3."""
    if out.device.type != "cuda" or torch.is_grad_enabled() \
            or not autocast_bf16():
        return False
    if n_groups != 1 or out.dim() != 3 or out.dtype != torch.float32 \
            or ref.dtype != torch.float32:
        return False
    B, Q, D = out.shape
    return (Q % TILE == 0 and D % TILE == 0 and D <= MAX_DIM
            and _widths_taken(heads, D))


# ------------------------------------------------------------- plain --
def _hidden(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """autocast's F.linear: both operands rounded to bf16, bf16 out."""
    return F.linear(x.to(torch.bfloat16), w[:, :, 0].to(torch.bfloat16))


def _norm_relu(h: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    """GroupNorm1 (one group) then ReLU, as `models/mlp.py` computes it."""
    B, N, C = h.shape
    xf = h.float().view(B, 1, N, C)
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).view(B, N, C)
    return F.relu((y * g + b).to(h.dtype))


def detection_heads_plain(out: torch.Tensor, ref: torch.Tensor,
                          params: Sequence[torch.Tensor],
                          mean_size: torch.Tensor, scale: Sequence[float],
                          eps: Sequence[float]) -> Tuple[torch.Tensor, ...]:
    """Plain version: the per-head path under bf16 autocast, written out.
    out (B, Q, D) f32, ref (B, Q, 3) f32, `params` as `head_tensors`
    gives them → (new_ref, pred_logits, center_unnormalized,
    size_unnormalized, ortho6d, sem_cls_prob), all f32."""
    (wc1, gc1, bc1, wc2, gc2, bc2, wc3, bc3,
     wr1, gr1, br1, wr2, gr2, br2, wr3, br3, ws, bs, wz, bz) = params
    with torch.autocast(out.device.type, enabled=False):
        trunk = []
        for w1, g1, b1, w2, g2, b2, e1, e2 in (
                (wc1, gc1, bc1, wc2, gc2, bc2, eps[0], eps[1]),
                (wr1, gr1, br1, wr2, gr2, br2, eps[2], eps[3])):
            h = _norm_relu(_hidden(out, w1), g1, b1, e1)
            trunk.append(_norm_relu(_hidden(h, w2), g2, b2, e2).float())
        center_offset = F.linear(trunk[0], wc3[:, :, 0], bc3)
        ortho6d = F.linear(trunk[1], wr3[:, :, 0], br3)
        x = out.float()
        cls_logits = F.linear(x, ws[:, :, 0], bs)
        size_scale = F.linear(x, wz[:, :, 0], bz)
        center_norm = torch.sigmoid(center_offset + inverse_sigmoid(ref))
        center_unnorm = denormalize_points(center_norm, scale)
        new_ref = normalize_points(center_unnorm, scale)
        sem_cls_prob = torch.softmax(cls_logits, dim=-1)
        size_unnorm = torch.exp(size_scale) * \
            mean_size[sem_cls_prob.argmax(dim=-1)]
    return (new_ref, cls_logits, center_unnorm, size_unnorm, ortho6d,
            sem_cls_prob)


# ------------------------------------------------------------ kernel --
def detection_heads(out: torch.Tensor, ref: torch.Tensor, heads,
                    mean_size: torch.Tensor, scale: Sequence[float]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The four heads of `heads` (`models/decoder._MLPHeads`) on `out` and
    the decode from `ref`: (new_ref, {pred_logits, center_unnormalized,
    size_unnormalized, ortho6d, sem_cls_prob}), the per-head path's
    outputs. Runs through the custom op ``parq::detection_heads``."""
    _build.import_dynamo()
    res = torch.ops.parq.detection_heads(
        out, ref, head_tensors(heads), mean_size,
        [float(s) for s in scale], head_eps(heads))
    return res[0], dict(zip(OUTPUT_KEYS, res[1:]))


@torch.library.custom_op("parq::detection_heads", mutates_args=())
def _detection_heads_op(out: torch.Tensor, ref: torch.Tensor,
                        params: List[torch.Tensor], mean_size: torch.Tensor,
                        scale: List[float], eps: List[float]
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor, torch.Tensor, torch.Tensor]:
    return detection_heads_plain(out, ref, params, mean_size, scale, eps)


def _output_shapes(out, params):
    B, Q, _ = out.shape
    nc = params[16].shape[0]
    return ((B, Q, 3), (B, Q, nc), (B, Q, 3), (B, Q, 3), (B, Q, 6),
            (B, Q, nc))


@_detection_heads_op.register_fake
def _(out, ref, params, mean_size, scale, eps):
    return tuple(out.new_empty(s, dtype=torch.float32)
                 for s in _output_shapes(out, params))


_P = ctypes.c_void_p


class _HeadsArgs(ctypes.Structure):
    """csrc/heads.cu: HeadsArgs, field for field."""
    _fields_ = [("x", _P), ("ref", _P), ("w1", _P * 2), ("g1", _P * 2),
                ("b1", _P * 2), ("w2", _P * 2), ("g2", _P * 2),
                ("b2", _P * 2), ("w3", _P * 2), ("b3", _P * 2),
                ("ws", _P), ("bs", _P), ("wz", _P), ("bz", _P),
                ("mean_size", _P), ("h1", _P), ("h2", _P), ("part1", _P),
                ("part2", _P), ("new_ref", _P), ("logits", _P),
                ("center", _P), ("size", _P), ("ortho", _P), ("prob", _P),
                ("ref_bstride", ctypes.c_longlong),
                ("eps1", ctypes.c_float * 2), ("eps2", ctypes.c_float * 2),
                ("smul", ctypes.c_float * 3), ("sadd", ctypes.c_float * 3),
                ("sinv", ctypes.c_float * 3),
                ("B", ctypes.c_int), ("Q", ctypes.c_int), ("D", ctypes.c_int),
                ("NC", ctypes.c_int)]


def _lib():
    fn = _build.load("heads").parq_detection_heads
    if fn.argtypes is None:   # declare once: pointers must not pass as int
        fn.argtypes = [ctypes.POINTER(_HeadsArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _scale_box(scale: Sequence[float]):
    """The scale box as the decode's f32 scalars, as PyTorch's CUDA ops
    apply them: metric = p * (s1 - s0) + s0 and p = (metric - s0) * r with
    r = 1 / (s1 - s0) in f32 (a division by a CPU scalar)."""
    s = [float(v) for v in scale]
    mul = [s[2 * i + 1] - s[2 * i] for i in range(3)]
    inv = [float(np.float32(1.0) / np.float32(m)) for m in mul]
    return mul, [s[2 * i] for i in range(3)], inv


@_detection_heads_op.register_kernel("cuda")
def _detection_heads_cuda(out, ref, params, mean_size, scale, eps):
    B, Q, D = out.shape
    tensors = [out, ref, mean_size, *params]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("detection_heads: every tensor must be float32")
    if any(t.device != out.device for t in tensors):
        raise ValueError("detection_heads: tensors on different devices")
    nc = params[16].shape[0]
    if Q % TILE or D % TILE or D > MAX_DIM or nc > MAX_CLASSES \
            or tuple(ref.shape) != (B, Q, 3):
        raise ValueError(f"detection_heads: out {tuple(out.shape)}, ref "
                         f"{tuple(ref.shape)}, {nc} classes: needs Q and D "
                         f"multiples of {TILE}, D <= {MAX_DIM}, at most "
                         f"{MAX_CLASSES} classes")
    x = out.contiguous()
    if ref.stride(2) != 1 or ref.stride(1) != 3:
        ref = ref.contiguous()
    mean_size = mean_size.contiguous()
    if any(not t.is_contiguous() for t in params):
        raise ValueError("detection_heads: parameters must be contiguous")
    dev = out.device
    M, P = B * Q, (Q // TILE) * (D // TILE)
    h = torch.empty((2, M, 2 * D), dtype=torch.bfloat16, device=dev)
    part = torch.empty((2, B * 2 * P, 2), dtype=torch.float32, device=dev)
    res = tuple(torch.empty(s, dtype=torch.float32, device=dev)
                for s in _output_shapes(out, params))
    if any(t.data_ptr() % 16 for t in (x, *params, h, part)):
        raise ValueError("detection_heads: tensors must be 16-byte aligned")
    a = _HeadsArgs()
    ptr = [t.data_ptr() for t in params]
    a.x, a.ref = x.data_ptr(), ref.data_ptr()
    for k in range(2):   # center, rotation
        (a.w1[k], a.g1[k], a.b1[k], a.w2[k], a.g2[k], a.b2[k], a.w3[k],
         a.b3[k]) = ptr[8 * k:8 * k + 8]
    a.ws, a.bs, a.wz, a.bz = ptr[16:20]
    a.mean_size = mean_size.data_ptr()
    a.h1, a.h2 = h[0].data_ptr(), h[1].data_ptr()
    a.part1, a.part2 = part[0].data_ptr(), part[1].data_ptr()
    (a.new_ref, a.logits, a.center, a.size, a.ortho,
     a.prob) = [t.data_ptr() for t in res]
    a.ref_bstride = ref.stride(0)
    a.eps1[:] = [eps[0], eps[2]]
    a.eps2[:] = [eps[1], eps[3]]
    a.smul[:], a.sadd[:], a.sinv[:] = _scale_box(scale)
    a.B, a.Q, a.D, a.NC = B, Q, D, nc
    err = _lib()(ctypes.byref(a),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"detection_heads: CUDA launch failed, error {err}")
    detection_heads.launches += 1
    return res


detection_heads.launches = 0

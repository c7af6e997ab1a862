"""JAX-package variables → the port's state_dict.

`state_dict_from_flax` takes the ``{"params", "frozen"}`` tree of
parq_tpu's PARQModel (nested dicts of numpy arrays) and returns the port's state_dict in the reference checkpoint's key
layout. It inverts parq_tpu/io/torch_convert.py:convert_parq_checkpoint:

- Dense kernels (I, O) → Linear weights (O, I); conv kernels
  (kh, kw, I, O) → (O, I, kh, kw); head Dense kernels → Conv1d (O, I, 1);
- FrozenBN ``frozen/{scale, bias, mean, var}`` → ``weight, bias,
  running_mean, running_var`` buffers;
- self-attention query/key/value/out DenseGenerals → ``in_proj_*`` and
  ``out_proj``; the cross-attention query/out (in the iteration) and the
  key/value projections hoisted to the decoder (``cross_attn_key/value``)
  → one ``multihead_attn.in_proj_weight``;
- the rayPE encoder's first kernel maps as it is: the JAX encoder stores
  it in the sample-major row order and applies its channel-major
  permutation in the forward (MLP2.in_perm), which is the port's order;
- ``refpoint`` → ``box3d_decoder.refpoint.weight``;
- unshared iterations (SHARE_WEIGHTS False): ``iteration_0`` maps as the
  shared ``iteration`` does, ``iteration_{i}`` for i ≥ 1 into
  ``box3d_decoder.iterations.{i}.{position_encoder, layer, mlp_heads}``,
  its cross-attention query into ``layer.multihead_attn.q_proj``.

The dead ``decoder.norm`` of released checkpoints has no counterpart.

`grads_from_flax` maps a params-only tree, such as `jax.grad`'s output,
the same way: it has no FrozenBN statistics, and it yields the port's
parameter names only (no buffers). `decoder_state_dict_from_flax` maps the
params of parq_tpu's PARQDecoder alone to a `PARQDecoder`'s state_dict.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_DEC = "box3d_decoder.parq_module.decoder"
_HEADS = "box3d_decoder.mlp_heads"


def _node(tree: Mapping, path: str):
    for p in path.split("/"):
        tree = tree[p]
    return tree


def _get(tree: Mapping, path: str) -> np.ndarray:
    return np.asarray(_node(tree, path), np.float32)


def state_dict_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    return _from_flax(variables["params"], variables.get("frozen", {}))


def decoder_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """parq_tpu PARQDecoder params → the port PARQDecoder's state_dict."""
    prefix = "box3d_decoder."
    sd = _from_flax({"box3d_decoder": params}, None)
    return {k[len(prefix):]: v for k, v in sd.items()}


def grads_from_flax(grad_tree: Mapping) -> Dict[str, torch.Tensor]:
    """A params-only tree (e.g. `jax.grad`'s) → {port parameter name:
    tensor}."""
    return _from_flax(grad_tree, None)


def _from_flax(params: Mapping, frozen) -> Dict[str, torch.Tensor]:
    """`frozen` None: a params-only tree; the BN statistics are skipped."""
    sd: Dict[str, np.ndarray] = {}

    def linear(path_f, key_t, perm=(1, 0)):
        sd[f"{key_t}.weight"] = _get(params, f"{path_f}/kernel") \
            .transpose(perm)
        if "bias" in _node(params, path_f):
            sd[f"{key_t}.bias"] = _get(params, f"{path_f}/bias")

    def conv(path_f, key_t):
        linear(path_f, key_t, perm=(3, 2, 0, 1))

    def frozen_bn(path_f, key_t):
        if frozen is None:
            return
        for src, dst in (("scale", "weight"), ("bias", "bias"),
                         ("mean", "running_mean"), ("var", "running_var")):
            sd[f"{key_t}.{dst}"] = _get(frozen, f"{path_f}/{src}")

    if "backbone2d" in params:
        _backbone_and_ray_pe(params, linear, conv, frozen_bn)
    _decoder(params, sd, linear)
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            for k, v in sd.items()}


def _backbone_and_ray_pe(params, linear, conv, frozen_bn):
    body_t = "backbone2d.resnet_fpn.body"
    conv("backbone2d/body/conv1", f"{body_t}.conv1")
    frozen_bn("backbone2d/body/bn1", f"{body_t}.bn1")
    for blk in params["backbone2d"]["body"]:
        m = re.fullmatch(r"layer(\d+)_(\d+)", blk)
        if not m:
            continue
        pf, pt = f"backbone2d/body/{blk}", f"{body_t}.layer{m[1]}.{m[2]}"
        for k in (1, 2, 3):
            if f"conv{k}" in params["backbone2d"]["body"][blk]:
                conv(f"{pf}/conv{k}", f"{pt}.conv{k}")
                frozen_bn(f"{pf}/bn{k}", f"{pt}.bn{k}")
        if "downsample_conv" in params["backbone2d"]["body"][blk]:
            conv(f"{pf}/downsample_conv", f"{pt}.downsample.0")
            frozen_bn(f"{pf}/downsample_bn", f"{pt}.downsample.1")
    for i in range(4):
        conv(f"backbone2d/fpn/inner_{i}",
             f"backbone2d.resnet_fpn.fpn.inner_blocks.{i}")
        conv(f"backbone2d/fpn/layer_{i}",
             f"backbone2d.resnet_fpn.fpn.layer_blocks.{i}")

    # ---- ray PE -------------------------------------------------------------
    linear("add_ray_pe/encoder/Dense_0", "add_ray_pe.encoder.0")
    linear("add_ray_pe/encoder/Dense_1", "add_ray_pe.encoder.2")



def _decoder(params, sd, linear):
    """The decoder: the shared ``iteration``, or ``iteration_{i}`` of an
    unshared decoder (iteration 0 into the shared layout's keys, i ≥ 1
    into ``iterations.{i}``, whose layer has the query projection alone)."""
    dec = params["box3d_decoder"]
    if "iteration" in dec:
        _iteration(params, sd, linear, "box3d_decoder/iteration", _DEC,
                   f"{_DEC}.layers.0", _HEADS, kv=True)
    else:
        i = 0
        while f"iteration_{i}" in dec:
            it = f"box3d_decoder/iteration_{i}"
            if i == 0:
                _iteration(params, sd, linear, it, _DEC, f"{_DEC}.layers.0",
                           _HEADS, kv=True)
            else:
                own = f"box3d_decoder.iterations.{i}"
                _iteration(params, sd, linear, it, own, f"{own}.layer",
                           f"{own}.mlp_heads", kv=False)
            i += 1
    sd["box3d_decoder.refpoint.weight"] = _get(params,
                                               "box3d_decoder/refpoint")


def _iteration(params, sd, linear, it, pe_t, lay_t, heads_t, kv):
    """One DecoderIteration's params → the port's keys: the position
    encoder under `pe_t`, the layer under `lay_t`, the heads under
    `heads_t`. `kv`: the layer's cross-attention carries the decoder-level
    key/value projections (one ``in_proj_weight``); else ``q_proj``."""
    linear(f"{it}/position_encoder/Dense_0", f"{pe_t}.position_encoder.0")
    linear(f"{it}/position_encoder/Dense_1", f"{pe_t}.position_encoder.2")
    lay = f"{it}/layer"

    def heads_kernel(path):          # (D, H, hd) → torch (D_out, D_in)
        k = _get(params, f"{path}/kernel")
        return k.reshape(k.shape[0], -1).T

    def heads_bias(path):
        return _get(params, f"{path}/bias").reshape(-1)

    def out_proj(path, key_t):       # (H, hd, D) → (D, H·hd)
        k = _get(params, f"{path}/kernel")
        sd[f"{key_t}.out_proj.weight"] = k.reshape(-1, k.shape[-1]).T
        sd[f"{key_t}.out_proj.bias"] = _get(params, f"{path}/bias")

    sa = f"{lay}/self_attn"
    sd[f"{lay_t}.self_attn.in_proj_weight"] = np.concatenate(
        [heads_kernel(f"{sa}/{n}") for n in ("query", "key", "value")])
    sd[f"{lay_t}.self_attn.in_proj_bias"] = np.concatenate(
        [heads_bias(f"{sa}/{n}") for n in ("query", "key", "value")])
    out_proj(f"{sa}/out", f"{lay_t}.self_attn")
    if kv:
        cross = (f"{lay}/cross_attn_query", "box3d_decoder/cross_attn_key",
                 "box3d_decoder/cross_attn_value")
        sd[f"{lay_t}.multihead_attn.in_proj_weight"] = np.concatenate(
            [heads_kernel(p) for p in cross])
        sd[f"{lay_t}.multihead_attn.in_proj_bias"] = np.concatenate(
            [heads_bias(p) for p in cross])
    else:
        sd[f"{lay_t}.multihead_attn.q_proj.weight"] = heads_kernel(
            f"{lay}/cross_attn_query")
        sd[f"{lay_t}.multihead_attn.q_proj.bias"] = heads_bias(
            f"{lay}/cross_attn_query")
    out_proj(f"{lay}/cross_attn_out", f"{lay_t}.multihead_attn")
    linear(f"{lay}/linear1", f"{lay_t}.linear1")
    linear(f"{lay}/linear2", f"{lay_t}.linear2")
    for n in ("norm1", "norm2", "norm3"):
        sd[f"{lay_t}.{n}.weight"] = _get(params, f"{lay}/{n}/scale")
        sd[f"{lay_t}.{n}.bias"] = _get(params, f"{lay}/{n}/bias")

    # ---- heads: GenericMLP layer indices (Conv1d, GN, ReLU, Dropout)·n, out
    for name, n_hidden in (("sem_cls_head", 0), ("center_head", 2),
                           ("size_head", 0), ("rotation_head", 2)):
        pf, pt = f"{it}/{name}", f"{heads_t}.{name}.layers"
        for h in range(n_hidden):
            sd[f"{pt}.{4 * h}.weight"] = \
                _get(params, f"{pf}/Dense_{h}/kernel").T[:, :, None]
            sd[f"{pt}.{4 * h + 1}.weight"] = \
                _get(params, f"{pf}/GroupNorm1_{h}/scale")
            sd[f"{pt}.{4 * h + 1}.bias"] = \
                _get(params, f"{pf}/GroupNorm1_{h}/bias")
        sd[f"{pt}.{4 * n_hidden}.weight"] = \
            _get(params, f"{pf}/Dense_{n_hidden}/kernel").T[:, :, None]
        sd[f"{pt}.{4 * n_hidden}.bias"] = \
            _get(params, f"{pf}/Dense_{n_hidden}/bias")

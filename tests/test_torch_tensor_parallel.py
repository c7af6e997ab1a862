"""Tensor parallelism of the port (parq_torch/parallel/tensor_parallel.py)
against the JAX package's `param_sharding_rules` and its sharded step, on
the CPU. Ranks are processes over gloo (tests/torch_dist_workers.py); the
JAX package runs on the 8-device CPU mesh of tests/conftest.py.

(a) the plan: the JAX rule on a (4, 2) mesh over the tiny model's
    parameter shapes (`jax.eval_shape`) against the port's plan, shared
    and unshared iterations: the same weights on the corresponding axis,
    no cross-attention leaf sharded in either package; the port's column
    biases listed apart (storage, not result);
(b) a TP step on 2 ranks against one process, f32, dropout 0.1: loss,
    grad_norm, every clipped gradient and updated parameter within 1e-5
    (the parameters where Adam's first step is well posed), and each
    rank's dropout masks equal to its slice of one process's;
(c) the JAX package's step with the rule's sharding on the (4, 2) mesh at
    dropout 0 against the port's TP step from the same parameters (the
    JAX tree through from_jax), within the project's ~1e-4;
(d) a TP checkpoint loads strictly into one process, and one process's
    into the TP ranks;
(e) the `dryrun_multichip(4)` twin prints its OK line;
and the refusals: TP with sequence parallelism, a model size that does not
divide the heads.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from parq_tpu.io.torch_convert import convert_parq_checkpoint
from parq_tpu.parallel import make_mesh as j_make_mesh
from parq_tpu.parallel import param_sharding_rules as j_rules
from parq_tpu.parallel import shard_batch as j_shard_batch
from parq_tpu.train import LossConfig as JLossConfig
from parq_tpu.train import forward_and_loss as j_forward_and_loss
from parq_tpu.train import make_optimizer as j_make_optimizer

import torch_dist_workers as w
from parq_torch.config import ModelConfig
from parq_torch.data.synthetic import make_batch
from parq_torch.io.from_jax import state_dict_from_flax
from parq_torch.models import build_model
from parq_torch.models.decoder import DropoutDraws
from parq_torch.parallel import dryrun_multichip, shard_model_
from parq_torch.parallel.mesh import Mesh
from parq_torch.parallel.tensor_parallel import (COLUMN_BIASES, Shard,
                                                 param_sharding_rules,
                                                 storage_plan,
                                                 tensor_parallel)
from parq_torch.train.checkpoint import (CheckpointManager, load_pretrained,
                                         restore_state)
from parq_torch.train.train_step import make_optimizer, train_step
from parq_torch.train.__main__ import TRAIN_KEYS

from torch_common import (jax_tiny_model, numpy_state_dict,
                          randomize_frozen_bn)

B = 4          # the rows of the JAX (4, 2) mesh's data axis
LR_JAX = 1e-4


def _batch():
    raw = make_batch(list(range(B)), image_size=ModelConfig.tiny().image_size)
    return {k: np.asarray(raw[k], np.float32) for k in TRAIN_KEYS}


def _jax_tiny(share_weights=True, rate=0.1):
    return jax_tiny_model(ModelConfig.tiny()).clone(
        share_weights=share_weights, dropout_rate=rate)


# ---- (a) the plan ------------------------------------------------------
def _port_name(jax_path):
    """A JAX layer kernel's path → (the port's parameter name, Shard),
    the spec translated through io/from_jax.py's mapping."""
    m = re.fullmatch(r"box3d_decoder/iteration(?:_(\d+))?/layer/(.+)",
                     jax_path)
    assert m, jax_path
    i = int(m[1] or 0)
    prefix = ("box3d_decoder.parq_module.decoder.layers.0" if i == 0
              else f"box3d_decoder.iterations.{i}.layer")
    leaf = {
        # Dense kernel (in, out) → torch weight (out, in)
        "linear1/kernel": ("linear1.weight", P(None, "model"), Shard(0)),
        "linear2/kernel": ("linear2.weight", P("model", None), Shard(1)),
        # (D, H, hd) sharded on heads → rows of each q/k/v block
        "self_attn/query/kernel": ("self_attn.in_proj_weight",
                                   P(None, "model", None), Shard(0, 3)),
        "self_attn/key/kernel": ("self_attn.in_proj_weight",
                                 P(None, "model", None), Shard(0, 3)),
        "self_attn/value/kernel": ("self_attn.in_proj_weight",
                                   P(None, "model", None), Shard(0, 3)),
        # (H, hd, D) sharded on heads → columns of out_proj (D, H·hd)
        "self_attn/out/kernel": ("self_attn.out_proj.weight",
                                 P("model", None, None), Shard(1)),
    }[m[2]]
    return f"{prefix}.{leaf[0]}", leaf[1], leaf[2]


@pytest.mark.parametrize("share_weights", [True, False])
def test_plan_matches_jax_rule(share_weights):
    """(a)"""
    jmodel = _jax_tiny(share_weights)
    raw = make_batch([0], image_size=ModelConfig.tiny().image_size)
    jbatch = {k: jnp.asarray(raw[k]) for k in TRAIN_KEYS}
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jbatch))["params"]
    rules = j_rules(j_make_mesh(data=4, model=2), shapes)
    want = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(rules)[0]:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if sh.spec == P():
            continue
        assert "cross_attn" not in name, name
        port, spec, shard = _port_name(name)
        assert sh.spec == spec, (name, sh.spec)
        want[port] = shard
    model = build_model(ModelConfig.tiny(share_weights=share_weights),
                        seed=0, device="cpu")
    plan = param_sharding_rules(Mesh(data=4, model=2), model)
    assert sorted(plan) == sorted(n for n, _ in model.named_parameters())
    got = {n: s for n, s in plan.items() if s is not None}
    assert got == want
    layers = 2 if not share_weights else 1      # L = 2
    assert len(got) == 4 * layers
    assert not any("multihead_attn" in n for n in got)

    # the port also stores the column-parallel biases as shards, and each
    # sharded parameter is 1/model of its rows or columns
    stored = storage_plan(Mesh(data=4, model=2), model)
    biases = {n: s for n, s in stored.items() if n not in got}
    prefixes = {n[:-len(".linear1.weight")] for n in got
                if n.endswith(".linear1.weight")}
    assert len(prefixes) == layers
    assert biases == {f"{p}.{b}": s for p in prefixes
                      for b, s in COLUMN_BIASES.items()}
    params = dict(model.named_parameters())
    for n, s in stored.items():
        for r in range(2):
            part = s.local(params[n], r, 2)
            assert part.shape[s.dim] * 2 == params[n].shape[s.dim], n


def test_plan_replicates_everything_at_model_1():
    model = build_model(ModelConfig.tiny(), seed=0, device="cpu")
    before = {n: p.clone() for n, p in model.named_parameters()}
    assert all(s is None for s in
               param_sharding_rules(Mesh(4, 1), model).values())
    shard_model_(model, Mesh(4, 1))
    assert tensor_parallel(model).plan == {}
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n


def test_refusals(tp_case):
    """TP with SEQ_PARALLEL either way round (the other way on the TP
    ranks of the module's spawn); heads or DEC_FFN_DIM not divisible by
    the model group; a model axis without its process group."""
    def tiny(**kw):
        return build_model(ModelConfig.tiny(**kw), seed=0, device="cpu")
    with pytest.raises(ValueError, match="DEC_HEADS"):
        shard_model_(tiny(), Mesh(data=1, model=3))
    with pytest.raises(ValueError, match="DEC_FFN_DIM"):
        shard_model_(tiny(dec_ffn_dim=18), Mesh(data=1, model=4))
    with pytest.raises(ValueError, match="model group"):
        shard_model_(tiny(), Mesh(data=1, model=2))
    model = tiny()
    model.set_parallel(Mesh(data=1, model=2, model_group=object()), True)
    with pytest.raises(ValueError, match="SEQ_PARALLEL"):
        shard_model_(model, Mesh(data=1, model=2))
    for out in tp_case["ranks"]:
        assert "sequence parallelism on a model sharded" in out["sp_refused"]


# ---- (b), (c), (d): one spawn of 2 ranks --------------------------------
@pytest.fixture(scope="module")
def tp_case(tmp_path_factory):
    """The one-process step (dropout 0.1) and its checkpoint, the JAX
    case's weights and matcher draws, and the 2 ranks' results."""
    tmp = tmp_path_factory.mktemp("tp")
    batch = _batch()
    mcfg = ModelConfig.tiny(dropout_rate=0.1)
    model = build_model(mcfg, seed=1, device="cpu").train()
    opt = make_optimizer(model, lr=1e-3)
    m = train_step(model, opt, {k: torch.from_numpy(v)
                                for k, v in batch.items()},
                   torch.Generator().manual_seed(7))
    one = ({k: float(v) for k, v in m.items()},
           {n: p.grad.clone() for n, p in model.named_parameters()},
           {n: p.detach().clone() for n, p in model.named_parameters()},
           model)
    CheckpointManager(str(tmp / "one"), save_top_k=1).save(1, model, opt)

    # the JAX case's parameters: a seeded port model (FrozenBN statistics
    # randomized) in the JAX layout, and back through from_jax
    jmodel = _jax_tiny(rate=0.0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    port = build_model(ModelConfig.tiny(dropout_rate=0.0), seed=2,
                       device="cpu")
    randomize_frozen_bn(port, 3)
    tree = convert_parq_checkpoint(numpy_state_dict(port), num_heads=4)
    init = {k: jax.tree_util.tree_map(np.asarray, tree[k])
            for k in ("params", "frozen")}
    state = {k: v.numpy() for k, v in state_dict_from_flax(init).items()}
    key = jax.random.PRNGKey(3)
    _, k_match = jax.random.split(key)
    L, Q, K = 2, 8, batch["obbs_padded"].shape[1]
    u = np.array(jax.vmap(lambda k: jax.random.uniform(k, (Q, K)))(
        jax.random.split(k_match, L * B)))
    jax_case = (ModelConfig.tiny(dropout_rate=0.0), state, u, LR_JAX)
    ranks = w.run_ranks(w.tp_runs, 2, tmp, mcfg, batch, str(tmp / "one"),
                        str(tmp / "tp"), jax_case)
    return {"one": one, "ranks": ranks, "tmp": tmp, "mcfg": mcfg,
            "jax": (jmodel, init, jbatch, key)}


def test_tp_step_matches_single_process(tp_case):
    """(b) f32, dropout 0.1: loss and grad_norm rtol 1e-5; every clipped
    gradient, gathered into the reference layout, within 1e-5 (max abs);
    every updated parameter within 1e-5 where Adam's first step is well
    posed (|g| > max(2·|Δg|, 1e-6), as test_train_step_matches_jax holds
    it) and within 2·lr elsewhere; the same dropout bits."""
    metrics1, grads1, params1, model1 = tp_case["one"]
    mcfg = tp_case["mcfg"]
    drops = DropoutDraws(mcfg.dropout_rate, mcfg.dec_layers, "cpu",
                         torch.Generator().manual_seed(7))
    layer = model1.box3d_decoder.parq_module.decoder.layers[0]
    L, Q, H, F = (mcfg.dec_layers, mcfg.num_queries, mcfg.dec_heads,
                  mcfg.dec_ffn_dim)
    sa1 = layer.sa_keep(drops, range(L), B, Q)
    ffn1 = layer.ffn_keep(drops, range(L), B, Q)
    assert 0.05 < 1 - float(ffn1.float().mean()) < 0.15
    for r, out in enumerate(tp_case["ranks"]):
        metrics, grads, params, (sa, ffn) = out["b"]
        for k in ("total_loss", "grad_norm", "valid_bs"):
            np.testing.assert_allclose(metrics[k], metrics1[k], rtol=1e-5,
                                       err_msg=k)
        assert sorted(grads) == sorted(grads1)
        for n, g1 in grads1.items():
            np.testing.assert_allclose(grads[n].numpy(), g1.numpy(),
                                       rtol=0, atol=1e-5, err_msg=n)
            # Adam's first step is lr·g/(|g| + eps): where |g| is within
            # its own rounding the step is ill-posed (either sign, up to
            # lr), so the 1e-5 holds where it is well posed
            posed = g1.abs() > torch.clamp(2 * (grads[n] - g1).abs(),
                                           min=1e-6)
            diff = (params[n] - params1[n]).abs()
            assert float(torch.where(posed, diff, 0.0).max()) <= 1e-5, n
            assert float(diff.max()) <= 2 * 1e-3 + 1e-5, n
        hl, fl = H // 2, F // 2
        assert torch.equal(sa, sa1.view(B, L, H, Q, Q)
                           [:, :, r * hl:(r + 1) * hl].reshape(B * L, hl,
                                                               Q, Q))
        assert torch.equal(ffn, ffn1[..., r * fl:(r + 1) * fl])


def test_tp_step_matches_jax_sharded_step(tp_case):
    """(c) the JAX step with `param_sharding_rules` on the (4, 2) mesh,
    dropout 0, against the port's TP step on 2 ranks: the tolerances of
    tests/test_torch_train_model.py::test_train_step_matches_jax (loss
    atol 2e-4, grad_norm rtol 1e-4, each clipped gradient ‖Δ‖ ≤
    1e-3·‖g‖ + 1e-5, the updated parameters where Adam's step is well
    posed to 1e-3·lr)."""
    jmodel, init, jbatch, key = tp_case["jax"]
    mesh = j_make_mesh(data=4, model=2)
    params = jax.tree_util.tree_map(jax.device_put, init["params"],
                                    j_rules(mesh, init["params"]))
    lay = params["box3d_decoder"]["iteration"]["layer"]
    assert lay["linear1"]["kernel"].sharding.spec == P(None, "model")
    assert lay["self_attn"]["query"]["kernel"].sharding.spec == \
        P(None, "model", None)
    sbatch = j_shard_batch(jbatch, mesh)

    def loss_fn(p):
        losses, _ = j_forward_and_loss(jmodel.apply, p, init["frozen"],
                                       sbatch, key, JLossConfig(),
                                       deterministic=False)
        return losses["total_loss"], losses

    tx = j_make_optimizer(lambda s: LR_JAX, grad_clip=1.0)

    @jax.jit
    def step(p):
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return (losses, grads, optax.apply_updates(p, updates),
                optax.global_norm(grads))

    jlosses, jgrads, jnew, jnorm = step(params)
    jnew = jax.tree_util.tree_map(np.asarray, jnew)
    jnorm = float(jnorm)
    from parq_torch.io.from_jax import grads_from_flax
    scale = min(1.0, 1.0 / jnorm)
    want_g = {n: g * scale for n, g in grads_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads)).items()}
    want_p = state_dict_from_flax({"params": jnew, "frozen": init["frozen"]})
    for out in tp_case["ranks"]:
        metrics, grads, params_p = out["c"]
        for name in jlosses:
            np.testing.assert_allclose(metrics[name], float(jlosses[name]),
                                       atol=2e-4, rtol=0, err_msg=name)
        np.testing.assert_allclose(metrics["grad_norm"], jnorm, rtol=1e-4)
        assert sorted(want_g) == sorted(grads)
        for n, g_ref in want_g.items():
            err = float((grads[n] - g_ref).norm())
            assert err <= 1e-3 * float(g_ref.norm()) + 1e-5, (n, err)
            posed = g_ref.abs() > torch.clamp(2 * (grads[n] - g_ref).abs(),
                                              min=1e-6)
            excess = ((params_p[n] - want_p[n]).abs()
                      - 1e-6 * want_p[n].abs())[posed]
            assert excess.numel() == 0 or \
                float(excess.max()) <= 1e-3 * LR_JAX, n


def test_tp_checkpoint_loads_into_one_process_and_back(tp_case):
    """(d) the TP step's checkpoint (written by rank 0 in the reference
    layout) loads strictly into one process, with AdamW's moments, equal
    to the ranks' gathered parameters bit for bit; the one-process
    checkpoint restored into the TP ranks gives each its shards."""
    tmp, mcfg = tp_case["tmp"], tp_case["mcfg"]
    _, _, params_tp, _ = tp_case["ranks"][0]["b"]
    mgr = CheckpointManager(str(tmp / "tp"), save_top_k=1)
    model = build_model(mcfg, seed=9, device="cpu")
    opt = make_optimizer(model, lr=1e-3)
    restore_state(mgr, model, opt)
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), params_tp[n]), n
        assert opt.state[p]["exp_avg"].shape == p.shape, n
    strict = build_model(mcfg, seed=9, device="cpu")
    load_pretrained(strict, mgr.path(1), strict=True)
    for n, p in strict.named_parameters():
        assert torch.equal(p.detach(), params_tp[n]), n

    _, _, params1, model1 = tp_case["one"]
    one_opt = torch.load(str(tmp / "one" / "step_1.pt"))["optimizer"]
    names = [n for n, _ in model1.named_parameters()]
    plan = storage_plan(Mesh(data=1, model=2), model1)
    for r, out in enumerate(tp_case["ranks"]):
        shards, moments = out["d"]
        for i, n in enumerate(names):
            want = params1[n] if n not in plan else \
                plan[n].local(params1[n], r, 2)
            assert torch.equal(shards[n], want), (r, n)
            m = one_opt["state"][i]["exp_avg"]
            want_m = m if n not in plan else plan[n].local(m, r, 2)
            assert torch.equal(moments[n]["exp_avg"], want_m), (r, n)


def test_dryrun_multichip_twin():
    """(e)"""
    text = dryrun_multichip(4, "cpu")
    first = text.splitlines()[0]
    assert re.fullmatch(r"dryrun_multichip\(4\): mesh=\{'data': 2, "
                        r"'model': 2\} loss=\d+\.\d{4} OK "
                        r"\(\+SP attention exact\)", first), first
    assert "restored bit for bit" in text

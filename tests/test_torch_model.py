"""The port's weights and whole forward against the JAX package.

- state_dict round trip: port state_dict → parq_tpu's
  convert_parq_checkpoint → parq_torch's state_dict_from_flax gives back
  the same arrays;
- a JAX PARQModel.init tree (FrozenBN statistics randomized) loads into
  the port with no missing or unexpected keys;
- the tiny flagship model (`_flagship_model(tiny=True)` dims: resnet18,
  64x48, L=2, Q=8), B=2, f32: JAX `PARQModel.apply(deterministic=True)`
  vs the port on the CPU with the same weights, every output key of every
  iteration.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_model
from parq_tpu.io.torch_convert import convert_parq_checkpoint
from parq_tpu.train.checkpoint import _merge

from parq_torch.config import ModelConfig
from parq_torch.data.synthetic import make_batch, to_device
from parq_torch.io.from_jax import state_dict_from_flax
from parq_torch.models import BATCH_KEYS, build_model
from parq_torch.models.box_processor import load_mean_size_table

# conv and matmul rounding accumulates through the ResNet and 2 decoder
# iterations. Measured max abs error on this CPU: 4e-5 on the heads'
# outputs, 1.1e-4 on center_im (pixel coordinates up to ~1e2).
ATOL = RTOL = 2e-4


def randomize_frozen_bn(model, seed):
    """Identity BN statistics would make FrozenBN a no-op in the test."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            n = buf.numel()
            if name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(rng.randn(n).astype(np.float32)
                                           * 0.3))
            elif name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.rand(n).astype(np.float32)
                                           + 0.5))
            elif ".bn" in name or "downsample.1" in name:
                buf.copy_(torch.from_numpy(rng.randn(n).astype(np.float32)
                                           * 0.2 + (name.endswith("weight"))))


def numpy_state_dict(model):
    return {k: v.detach().cpu().numpy() for k, v in
            model.state_dict().items()}


def jax_tiny_model(cfg: ModelConfig):
    mean = load_mean_size_table(cfg.mean_size_path, cfg.num_semcls)
    return _flagship_model(tiny=True).clone(
        mean_size=tuple(tuple(float(v) for v in r) for r in mean))


def jax_forward(jmodel, variables, batch):
    return jax.jit(lambda v, b: jmodel.apply(v, b, deterministic=True))(
        variables, {k: jnp.asarray(batch[k]) for k in BATCH_KEYS})


def port_and_jax(seed=0, batch_size=2):
    """(port model on CPU, JAX model, JAX variables with the port's
    weights, numpy batch)."""
    cfg = ModelConfig.tiny()
    port = build_model(cfg, seed=seed, device="cpu")
    randomize_frozen_bn(port, seed + 1)
    jmodel = jax_tiny_model(cfg)
    batch = make_batch(list(range(batch_size)), image_size=cfg.image_size)
    jbatch = {k: jnp.asarray(batch[k]) for k in BATCH_KEYS}
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch)
    tree = convert_parq_checkpoint(numpy_state_dict(port), num_heads=4)
    variables = {"params": _merge(init["params"], tree["params"]),
                 "frozen": _merge(init["frozen"], tree["frozen"])}
    return port, jmodel, variables, batch


def test_state_dict_round_trip():
    port = build_model(ModelConfig.tiny(), seed=3, device="cpu")
    randomize_frozen_bn(port, 4)
    sd = numpy_state_dict(port)
    back = state_dict_from_flax(convert_parq_checkpoint(sd, num_heads=4))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_jax_init_tree_loads_into_port():
    cfg = ModelConfig.tiny()
    jmodel = jax_tiny_model(cfg)
    batch = make_batch([0], image_size=cfg.image_size)
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(5), {k: jnp.asarray(batch[k]) for k in BATCH_KEYS})
    rng = np.random.RandomState(6)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables["frozen"] = jax.tree_util.tree_map(
        lambda a: rng.rand(*a.shape).astype(np.float32) + 0.5,
        variables["frozen"])
    port = build_model(cfg, seed=0, device="cpu")
    sd = state_dict_from_flax(variables)
    result = port.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    bn = "backbone2d.resnet_fpn.body.layer1.0.bn1.running_var"
    np.testing.assert_array_equal(
        port.state_dict()[bn].numpy(),
        variables["frozen"]["backbone2d"]["body"]["layer1_0"]["bn1"]["var"])


def test_full_tiny_forward_matches_jax():
    port, jmodel, variables, batch = port_and_jax()
    want = jax_forward(jmodel, variables, batch)
    with torch.no_grad():
        got = port(to_device(batch, BATCH_KEYS, "cpu"))
    assert sorted(got) == sorted(want)
    L = port.cfg.dec_layers
    for key in want:
        assert got[key].shape == want[key].shape, key
        for l in range(L):
            g, w = got[key][l].numpy(), np.asarray(want[key][l])
            if g.dtype == bool:
                np.testing.assert_array_equal(g, w, err_msg=f"{key}[{l}]")
            else:
                np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                           err_msg=f"{key}[{l}]")


def test_default_device_is_cuda():
    """No quiet move to the CPU: the default device is CUDA, and without a
    GPU the entry point raises."""
    if torch.cuda.is_available():
        assert next(build_model(ModelConfig.tiny()).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(ModelConfig.tiny())

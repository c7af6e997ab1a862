"""The port's weights and whole forward against the JAX package.

- state_dict round trip: port state_dict → parq_tpu's
  convert_parq_checkpoint → parq_torch's state_dict_from_flax gives back
  the same arrays;
- a JAX PARQModel.init tree (FrozenBN statistics randomized) loads into
  the port with no missing or unexpected keys;
- the tiny flagship model (`_flagship_model(tiny=True)` dims: resnet18,
  64x48, L=2, Q=8), B=2, f32: JAX `PARQModel.apply(deterministic=True)`
  vs the port on the CPU with the same weights, every output key of every
  iteration; a second, equal JAX model reuses the compiled forward
  (tests/torch_common.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parq_tpu.io.torch_convert import convert_parq_checkpoint

from parq_torch.config import ModelConfig
from parq_torch.data.synthetic import make_batch, to_device
from parq_torch.io.from_jax import state_dict_from_flax
from parq_torch.models import BATCH_KEYS, build_model

import torch_common
from torch_common import (jax_forward, jax_init, jax_tiny_model,
                          numpy_state_dict, port_and_jax,
                          randomize_frozen_bn)

# conv and matmul rounding accumulates through the ResNet and 2 decoder
# iterations. Measured max abs error on this CPU: 4e-5 on the heads'
# outputs, 1.1e-4 on center_im (pixel coordinates up to ~1e2).
ATOL = RTOL = 2e-4


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
    variables = jax_init(
        jmodel, jax.random.PRNGKey(5),
        {k: jnp.asarray(batch[k]) for k in BATCH_KEYS})
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

    # a second JAX model equal to the first reuses the compiled forward
    compiled = torch_common._jitted()[1]._cache_size()
    again = jax_forward(jax_tiny_model(port.cfg), variables, batch)
    assert torch_common._jitted()[1]._cache_size() == compiled
    for key in want:
        np.testing.assert_array_equal(np.asarray(again[key]),
                                      np.asarray(want[key]), err_msg=key)


def test_default_device_is_cuda():
    """No quiet move to the CPU: the default device is CUDA, and without a
    GPU the entry point raises."""
    if torch.cuda.is_available():
        assert next(build_model(ModelConfig.tiny()).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(ModelConfig.tiny())

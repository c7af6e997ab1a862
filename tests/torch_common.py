"""Set-up shared by the port's tests (tests/test_torch_*.py).

Every port test module imports this module, and no port test module imports
another one: what they share lives here.

Threads. pytest-xdist runs several workers on the machine's cores, and each
worker also holds XLA's own thread pools. Torch's default of one intra-op
thread a core in every worker oversubscribes the cores many times over for
the tests' tiny CPU ops, and most of the suite's wall time went to that
contention. So importing this module pins torch to one intra-op thread for
the process (`torch.set_num_threads(1)`). It also sets OMP_NUM_THREADS=1 in
`os.environ`, so that the subprocesses the port tests start run with one
thread too, and a result compared across processes comes from the same
thread count. The variable alone would not do in the test process itself:
torch reads it when it is first imported, and another test module may
already have imported torch before this one is collected. The call works
whenever it comes, and since the workers collect every module, each of them
is pinned before its first test runs. It is also the faster of the two: six
port files (test_torch_{graphs,heads,telemetry,model,frozen_bn,evals}.py)
under `-n 6 --dist loadfile` on an 8-core CPU took 149.8 s with torch's
default, 69.0 s with OMP_NUM_THREADS=1 set for the whole run, and 58.7 s
with this module and its once-compiled twins (60.8 s with the variable set
as well).

JAX twins. The functions below make the JAX package's tiny PARQ model with
a port model's weights. JAX and the JAX package are imported inside them,
never at import, because tests/test_torch_cuda.py imports this module on a
machine without JAX; PIL likewise, inside `save_jpg`. The JAX model's init
and forward are jitted once per process with the model as a static
argument: a model equal to one already seen reuses its compiled function,
and new shapes retrace as jit does.
"""
import functools
import os

os.environ["OMP_NUM_THREADS"] = "1"

import numpy as np  # noqa: E402
import torch  # noqa: E402

from parq_torch.config import ModelConfig  # noqa: E402
from parq_torch.data.synthetic import make_batch  # noqa: E402
from parq_torch.models import BATCH_KEYS, build_model  # noqa: E402
from parq_torch.models.box_processor import load_mean_size_table  # noqa: E402

torch.set_num_threads(1)


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


def rand_pose(rng):
    """A random camera-to-world pose (4x4) looking roughly along +x+y."""
    f = rng.randn(3) + np.array([1.0, 1.0, 0.2])
    f /= np.linalg.norm(f)
    x = np.cross([0.0, 0.0, 1.0], f)
    x /= np.linalg.norm(x)
    T = np.eye(4)
    T[:3, :3] = np.stack([x, np.cross(f, x), f], axis=1)
    T[:3, 3] = rng.randn(3)
    return T


def save_jpg(rng, path, size=(64, 48)):
    """A JPEG of random pixels, `size` = (width, height)."""
    from PIL import Image
    Image.fromarray((rng.rand(size[1], size[0], 3) * 255)
                    .astype(np.uint8)).save(path)


def jax_tiny_model(cfg):
    """The JAX package's tiny flagship model with `cfg`'s mean-size
    table (`cfg` a parq_torch ModelConfig)."""
    from __graft_entry__ import _flagship_model
    mean = load_mean_size_table(cfg.mean_size_path, cfg.num_semcls)
    return _flagship_model(tiny=True).clone(
        mean_size=tuple(tuple(float(v) for v in r) for r in mean))


@functools.cache
def _jitted():
    import jax
    init = jax.jit(lambda m, key, batch: m.init(key, batch),
                   static_argnums=0)
    apply = jax.jit(lambda m, v, batch: m.apply(v, batch, deterministic=True),
                    static_argnums=0)
    return init, apply


def jax_init(jmodel, key, batch):
    """`jax.jit(jmodel.init)(key, batch)`, compiled once per model."""
    return _jitted()[0](jmodel, key, batch)


def jax_forward(jmodel, variables, batch):
    """The JAX model's eval forward on a numpy batch of BATCH_KEYS."""
    import jax.numpy as jnp
    return _jitted()[1](jmodel, variables,
                        {k: jnp.asarray(batch[k]) for k in BATCH_KEYS})


def jax_variables(jmodel, port, batch):
    """The JAX model's variables holding `port`'s weights: JAX's init on
    `batch`, overwritten by the port's state_dict through parq_tpu's
    converter."""
    import jax
    import jax.numpy as jnp

    from parq_tpu.io.torch_convert import convert_parq_checkpoint
    from parq_tpu.train.checkpoint import _merge
    init = jax_init(jmodel, jax.random.PRNGKey(0),
                    {k: jnp.asarray(batch[k]) for k in BATCH_KEYS})
    tree = convert_parq_checkpoint(numpy_state_dict(port),
                                   num_heads=port.cfg.dec_heads)
    return {k: _merge(init[k], tree[k]) for k in ("params", "frozen")}


def port_and_jax(seed=0, batch_size=2):
    """(port model on CPU, JAX model, JAX variables with the port's
    weights, numpy batch)."""
    cfg = ModelConfig.tiny()
    port = build_model(cfg, seed=seed, device="cpu")
    randomize_frozen_bn(port, seed + 1)
    jmodel = jax_tiny_model(cfg)
    batch = make_batch(list(range(batch_size)), image_size=cfg.image_size)
    return port, jmodel, jax_variables(jmodel, port, batch), batch


# NMS cases (tests/test_torch_nms.py on the CPU, tests/test_torch_cuda.py
# on the card): (corners (B, K, 8, 3) f32, scores (B, K) f32, labels (B, K)
# int64, num_semcls, thresh, same_class), as parse_pred's NMS takes them.
NMS_SEMCLS = 9
NMS_EDGE_CASES = ("at", "above", "below", "ties", "background", "same_box",
                  "same_class")
_SIGNS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                   [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float32)


def aabb_corners(lo, hi):
    """(..., 3) bounds → (..., 8, 3) f32 corners of the axis-aligned box."""
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    return np.where(_SIGNS == 1, hi[..., None, :], lo[..., None, :])


def nms_edge_case(name):
    """One sample built to land on an edge of the greedy pass: "at" (two
    boxes of IoU exactly 0.1: 1 / (5.5 + 5.5 - 1), both kept), "above"
    and "below" (the second box's lower x one f32 ulp lower or higher:
    suppressed, kept), "ties" (equal scores go in index order), "background"
    (nothing kept), "same_box" (one box eight times: the first kept),
    "same_class" (0.2, same class: IoU exactly 0.2 kept, a heavy overlap of
    another class kept, one of the same class suppressed)."""
    lbl = np.zeros((1, 8), np.int64)
    thresh, same = 0.1, False
    lo = np.stack([np.arange(8) * 20.0, np.zeros(8), np.zeros(8)], -1)
    hi = lo + 1.0                                  # far apart by default
    scores = np.linspace(0.9, 0.2, 8)
    if name in ("at", "above", "below"):
        x0 = np.float32(4.5)
        if name != "at":
            x0 = np.nextafter(x0, np.float32(0 if name == "above" else 9))
        lo[:2], hi[:2] = [[0, 0, 0], [x0, 0, 0]], [[5.5, 1, 1], [10, 1, 1]]
    elif name == "ties":
        lo[1:4] = lo[0] + [[0.1, 0, 0], [0.05, 0.05, 0], [0, 0.1, 0]]
        hi[1:4] = lo[1:4] + 1.0
        scores[:4] = 0.5
        scores[5:7] = 0.3
        lo[5] = lo[6] + 0.05
        hi[5] = lo[5] + 1.0
    elif name == "background":
        lbl[:] = NMS_SEMCLS
    elif name == "same_box":
        lo[:], hi[:] = lo[0], hi[0]
    elif name == "same_class":
        thresh, same = 0.2, True
        lo[:4] = [[0, 0, 0], [2, 0, 0], [0.1, 0, 0], [0.2, 0, 0]]
        hi[:4] = [[3, 1, 1], [5, 1, 1], [3.1, 1, 1], [3.2, 1, 1]]
        lbl[0, :4] = [1, 1, 2, 1]
    else:
        raise ValueError(name)
    return (aabb_corners(lo, hi)[None], scores[None].astype(np.float32),
            lbl, NMS_SEMCLS, thresh, same)


def nms_cluster_case(seed, B=1, K=256, thresh=0.1, same=False):
    """B samples of K rotated boxes in a few clusters that overlap, a
    tenth of them background, scores on a coarse grid (ties)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(B, rng.randint(1, 8), 3) * 1.5
    center = centers[np.arange(B)[:, None], rng.randint(0, centers.shape[1],
                                                        (B, K))]
    center = center + rng.randn(B, K, 3) * 0.3
    size = rng.rand(B, K, 3) * 1.2 + 0.1
    q, _ = np.linalg.qr(rng.randn(B, K, 3, 3))
    local = (_SIGNS - 0.5) * size[..., None, :]
    corners = np.einsum("bkij,bknj->bkni", q, local) + center[..., None, :]
    scores = rng.randint(1, 40, (B, K)) / 40.0
    labels = rng.randint(0, NMS_SEMCLS, (B, K))
    labels[rng.rand(B, K) < 0.1] = NMS_SEMCLS
    return (corners.astype(np.float32), scores.astype(np.float32),
            labels.astype(np.int64), NMS_SEMCLS, thresh, same)

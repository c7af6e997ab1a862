"""The matcher's assignment on the tensors' device against the JAX package
on the CPU, with the same inputs from numpy seeds:

(a) `solve_lap_plain` (the plain version of kernel M1) against JAX's
    `solve_lap`, vmapped over the problems: col4row equal exactly, on random
    costs, n_rows below R and 0, flat 1e4 rows and columns, duplicated
    columns and integer costs (ties), R = C; P problems at once equal P
    single calls;
(b) the same costs against scipy's linear_sum_assignment, the oracle of
    the totals: equal assigned totals to 1e-6 relative;
(c) `match_batch` against JAX's `match_single` on crowded ties (queries
    sharing a reference point and logits, targets sharing a center and a
    label), both branches;
(d) `match_batch`'s assignment totals equal those of scipy's route (the
    matcher's host route before M1, kept here as the oracle);
(e) `match_batch` reads nothing back to the host.
The kernel itself is held against `solve_lap_plain` on the card in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from parq_tpu.ops.hungarian import match_single, solve_lap as j_solve_lap

from parq_torch.kernels import lap
from parq_torch.kernels.lap import solve_lap, solve_lap_plain
from parq_torch.ops import hungarian
from parq_torch.ops.hungarian import match_batch

_j_batched = jax.jit(jax.vmap(j_solve_lap))


def jax_col4row(cost, n_rows):
    return np.asarray(_j_batched(jnp.asarray(cost), jnp.asarray(n_rows)))


def plain_col4row(cost, n_rows):
    return solve_lap_plain(torch.from_numpy(cost),
                           torch.from_numpy(n_rows)).numpy()


def _costs(kind, P, R, C, seed):
    rng = np.random.RandomState(seed)
    cost = rng.uniform(-2.0, 1.0, (P, R, C)).astype(np.float32)
    if kind == "ties":
        cost[:, R // 2:, :] = 1e4          # flat rows (invalid targets)
        cost[:, :, C - 3:] = 1e4           # flat columns
        cost[:, :, 1] = cost[:, :, 0]      # duplicated columns
        cost[:, :, 4] = cost[:, :, 2]
    elif kind == "integer":
        cost = rng.randint(0, 3, (P, R, C)).astype(np.float32)
    return cost


CASES = [
    # kind, P, R, C, n_rows
    ("random", 3, 6, 10, [6, 6, 6]),
    ("random", 4, 6, 10, [0, 2, 5, 6]),        # n_rows < R, and 0
    ("ties", 3, 6, 10, [6, 3, 4]),
    ("integer", 3, 6, 10, [6, 5, 6]),
    ("random", 3, 7, 7, [7, 7, 4]),            # R = C
    ("integer", 2, 7, 7, [7, 7]),
    ("random", 2, 6, 10, [0, 0]),              # nothing to assign
]


@pytest.mark.parametrize("kind,P,R,C,n_rows", CASES)
def test_solve_lap_plain_equals_jax(kind, P, R, C, n_rows):
    cost = _costs(kind, P, R, C, seed=P * 100 + R + C)
    n = np.asarray(n_rows, np.int32)
    got = plain_col4row(cost, n)
    np.testing.assert_array_equal(got, jax_col4row(cost, n))
    for p in range(P):
        assert (got[p, n[p]:] == -1).all()
        assigned = got[p, :n[p]]
        assert len(set(assigned.tolist())) == n[p] and (assigned >= 0).all()


@pytest.mark.parametrize("kind,P,R,C,n_rows", CASES)
def test_solve_lap_plain_totals_equal_scipy(kind, P, R, C, n_rows):
    cost = _costs(kind, P, R, C, seed=P * 100 + R + C)
    n = np.asarray(n_rows, np.int32)
    got = plain_col4row(cost, n)
    for p in range(P):
        c = cost[p, :n[p]].astype(np.float64)
        rows, cols = linear_sum_assignment(c)
        want = c[rows, cols].sum()
        total = c[np.arange(n[p]), got[p, :n[p]]].sum()
        assert total == pytest.approx(want, rel=1e-6, abs=1e-6)


def test_solve_lap_plain_batch_equals_single_calls():
    cost = _costs("ties", 5, 8, 12, seed=3)
    n = np.array([8, 0, 5, 8, 2], np.int32)
    got = plain_col4row(cost, n)
    for p in range(5):
        np.testing.assert_array_equal(
            got[p], plain_col4row(cost[p:p + 1], n[p:p + 1])[0])


def test_solve_lap_takes_the_plain_version_on_the_cpu():
    cost = torch.from_numpy(_costs("random", 2, 4, 6, seed=1))
    n = torch.tensor([4, 2], dtype=torch.int32)
    before = solve_lap.launches
    got = solve_lap(cost, n)
    assert solve_lap.launches == before      # the kernel counts launches only
    assert got.dtype == torch.int32
    assert torch.equal(got, solve_lap_plain(cost, n))
    with pytest.raises(ValueError):
        solve_lap_plain(cost.transpose(1, 2), n)   # more rows than columns


H100_OPTIN = 232448        # shared memory a block may opt into (H100)


def test_shared_memory_limit_is_checked():
    # the release problem (100 targets x 256 queries): every row staged
    fixed, rows = lap.smem_plan(100, 256, H100_OPTIN)
    assert fixed < 12 * 1024 and rows == 100
    assert fixed + rows * 256 * 4 <= H100_OPTIN
    # R = C = 1000: the budget stages the first rows, the rest are read
    # from global memory
    fixed, rows = lap.smem_plan(1000, 1000, H100_OPTIN)
    assert 0 < rows < 1000 and fixed + rows * 4000 <= H100_OPTIN
    assert fixed + (rows + 1) * 4000 > H100_OPTIN
    # rows that are not whole 16-byte units are all read from global memory
    assert lap.smem_plan(31, 33, H100_OPTIN)[1] == 0
    assert lap.smem_plan(8, 8, H100_OPTIN, whole_rows=False)[1] == 0
    # past 1024 columns the lanes' column state moves to shared memory
    assert lap.smem_plan(100, 2048, H100_OPTIN)[0] \
        > lap.smem_plan(100, 1024, H100_OPTIN)[0] + 2048 * 13
    # a problem whose bookkeeping alone exceeds the budget
    fixed, rows = lap.smem_plan(100, 16384, H100_OPTIN)
    assert fixed > H100_OPTIN and rows == 0


def _crowded_inputs(rng, LB, Q, K, n_valid):
    """Ties everywhere: the first 6 queries share one reference point and
    one row of logits, targets 0 and 1 share a center and a label, and
    every other query sits on a coarse grid."""
    logits = rng.randn(LB, Q, 10).astype(np.float32)
    logits[:, :6] = logits[:, :1]
    center = rng.randint(-4, 5, (LB, K, 3)).astype(np.float32) / 4
    center[:, 1] = center[:, 0]
    coord = rng.randint(-4, 5, (LB, Q, 3)).astype(np.float32) / 4
    coord[:, :6] = center[:, :1] + 0.05
    labels = rng.randint(0, 9, (LB, K)).astype(np.int32)
    labels[:, 1] = labels[:, 0]
    valid = np.zeros((LB, K), bool)
    valid[:, :n_valid] = True
    valid[-1] = False                         # a pair with no target
    labels[~valid] = -1
    return logits, coord, labels, center, valid


@pytest.mark.parametrize("Q,K,n_valid", [(24, 10, 8), (6, 12, 9)])
def test_match_batch_equals_jax_on_crowded_ties(Q, K, n_valid):
    rng = np.random.RandomState(11)
    LB = 4
    inputs = _crowded_inputs(rng, LB, Q, K, n_valid)
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, LB)
    u = np.array(jax.vmap(lambda k: jax.random.uniform(k, (Q, K)))(keys))
    got = match_batch(*(torch.from_numpy(a) for a in inputs),
                      uniforms=torch.from_numpy(u))
    for i in range(LB):
        want = match_single(*(jnp.asarray(a[i]) for a in inputs), keys[i])
        for name in ("assign", "is_hungarian", "punish_mask"):
            np.testing.assert_array_equal(
                getattr(got, name)[i].numpy(),
                np.asarray(getattr(want, name)), err_msg=f"{name}[{i}]")
    assert got.is_hungarian[:LB - 1].sum(1).eq(min(Q, n_valid)).all()


def _lap_assign(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """(Q,) target per query from scipy's assignment of one pair: cost
    (Q, K), valid (K,) with valid targets first; −1 if unmatched."""
    Q, K = cost.shape
    hung = np.full(Q, -1, np.int64)
    idx = np.flatnonzero(valid)
    if idx.size == 0:
        return hung
    if K <= Q:   # rows = valid targets, cols = queries
        rows, cols = linear_sum_assignment(cost[:, idx].T)
        hung[cols] = idx[rows]
    else:        # the transposed problem: rows = queries
        rows, cols = linear_sum_assignment(cost[:, idx])
        hung[rows] = idx[cols]
    return hung


@pytest.mark.parametrize("Q,K,n_valid", [(32, 12, 7), (8, 20, 5),
                                         (8, 20, 12)])
def test_match_batch_lap_totals_equal_scipy(Q, K, n_valid):
    rng = np.random.RandomState(Q + K + n_valid)
    LB = 4
    logits, coord, labels, center, valid = _crowded_inputs(rng, LB, Q, K,
                                                           n_valid)
    coord[:, 6:] = rng.uniform(-1, 1, (LB, Q - 6, 3))   # general position
    t = [torch.from_numpy(a) for a in (logits, coord, labels, center, valid)]
    got = match_batch(*t, uniforms=torch.zeros(LB, Q, K))
    cost = hungarian.match_cost(*t[:4])[0].double().numpy()
    for i in range(LB):
        want = _lap_assign(cost[i], valid[i])
        hung = np.where(got.is_hungarian[i].numpy(), got.assign[i].numpy(),
                        -1)
        assert (hung >= 0).sum() == (want >= 0).sum()
        q = np.arange(Q)
        total = cost[i][q[hung >= 0], hung[hung >= 0]].sum()
        want_total = cost[i][q[want >= 0], want[want >= 0]].sum()
        assert total == pytest.approx(want_total, rel=1e-6, abs=1e-6)


def test_match_batch_reads_nothing_back_to_the_host():
    """No .cpu(), .numpy(), .item() or .tolist() in the matcher: on the
    card the step's assignment never waits on the host."""
    src = "\n".join(inspect.getsource(f) for f in
                    (match_batch, hungarian._hungarian_assign))
    calls = {n.func.attr for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert not calls & {"cpu", "numpy", "item", "tolist"}
    assert "solve_lap" in src

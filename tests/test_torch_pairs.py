"""The pair-axis ops of the port against the JAX package's batched forms,
on the CPU (the ops' plain versions).

* ``ops.directed_hausdorff_pairs(q, ds, q_valid, ds_valid)`` is the
  counterpart of the JAX ExactHaus oracle's
  ``vmap(lambda dp, dv: ops.directed_hausdorff(q, dp, q_valid, dv))``
  (``repro.core.search.topk_hausdorff_host``), and
  ``ops.nn_distance_batched`` of ``repro.kernels.ops.nn_distance_batched``.
* Against eager ``repro.kernels.ref``, pair by pair, the port is held
  BITWISE (distances) and exactly (indices): both run one op at a time.
* Against the JAX package's jitted batched calls, in its own CPU route
  (``use_kernel=True``: the Pallas kernel in interpret mode under vmap;
  ``use_kernel=False``: the jnp oracle), distances are held to
  ``rtol=1e-6``: under ``jit`` XLA:CPU may contract ``d0*d0 + d1*d1``
  into an FMA, about one ulp.  Indices are held exactly where the nearest
  point is clear (the two nearest squared distances apart by more than
  that), and invalid query rows get exactly 0.0 and -1.
* A numpy emulation of the ``nn_distance`` kernel's order (each warp's
  points split over two running (value, index) minima with a strict
  ``<``, the minima combined by (value, index), then (inf, the first valid
  index) and (BIG, the first invalid index) as two more candidates) is
  held exactly to the plain version, overflow past BIG included.
* ``point_search.nnp_batched`` equals ``nnp`` pair by pair, and the JAX
  package's ``nn_distance_batched`` on the same JAX-built index rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_clustered_datasets
from repro.core.build import build_repository as jbuild
from repro.engine import QueryEngine as JEngine
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.core import point_search
from repro_torch.kernels import ops, ref
from torch_lm_parity import one_torch_thread  # noqa: F401

RTOL = 1e-6
BIG = np.float32(ref.BIG)

# (P, nq, nd, W): nq and nd from 1 to a few hundred
CASES = [(1, 1, 1, 2), (3, 7, 130, 2), (4, 200, 57, 3), (5, 300, 260, 2),
         (3, 33, 1, 3), (6, 90, 300, 2)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _mk(seed, P, nq, nd, W, shared_q):
    """Query rows (one set for every pair, or a set per pair) and P
    datasets, with ragged validity: each dataset's valid points a prefix
    with holes; where P >= 3 the last dataset has no valid point and, for
    per-pair queries, the second last query no valid row."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, W) if shared_q else (P, nq, W)).astype(np.float32)
    ds = rng.normal(loc=0.5, size=(P, nd, W)).astype(np.float32)
    qv = rng.random(q.shape[:-1]) > 0.2
    qv[..., 0] = True
    n_valid = rng.integers(1, nd + 1, P)
    dv = (np.arange(nd)[None] < n_valid[:, None]) & (rng.random((P, nd)) > 0.1)
    dv[:, 0] = True
    if P >= 3:
        dv[-1] = False
        if not shared_q:
            qv[-2] = False
    return q, ds, qv, dv


def _clear(q, d, dv):
    """Rows whose two nearest valid squared distances are apart by more
    than the FMA's rounding."""
    d2 = ((q[:, None].astype(np.float64) - d[None]) ** 2).sum(-1)
    d2 = np.sort(np.where(dv[None], d2, np.inf), axis=1)
    if d2.shape[1] < 2:
        return np.isfinite(d2[:, 0])
    return np.isfinite(d2[:, 0]) & (d2[:, 1] > d2[:, 0] * (1 + 4 * RTOL))


@pytest.mark.parametrize("P,nq,nd,W", CASES)
def test_directed_hausdorff_pairs_bitwise_vs_eager_ref(P, nq, nd, W):
    q, ds, qv, dv = _mk(P + nq + nd + W, P, nq, nd, W, shared_q=True)
    got = ops.directed_hausdorff_pairs(_t(q), _t(ds), _t(qv), _t(dv))
    assert got.shape == (P,) and got.dtype == torch.float32
    want = [jref.directed_hausdorff(*map(jnp.asarray, (q, ds[p], qv, dv[p])))
            for p in range(P)]
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # and the one-pair op, pair by pair
    for p in range(P):
        one = ops.directed_hausdorff(_t(q), _t(ds[p]), _t(qv), _t(dv[p]))
        assert _bits(one) == _bits(got[p])


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("P,nq,nd,W", CASES)
def test_directed_hausdorff_pairs_vs_jax_oracle(P, nq, nd, W, use_kernel):
    """The JAX oracle's chunk evaluation: a jitted vmap of its one-pair
    op over the chunk's datasets."""
    q, ds, qv, dv = _mk(P + nq + nd + W, P, nq, nd, W, shared_q=True)
    got = ops.directed_hausdorff_pairs(_t(q), _t(ds), _t(qv), _t(dv))
    qj, qvj = jnp.asarray(q), jnp.asarray(qv)
    eval_chunk = jax.jit(jax.vmap(lambda dp, dvp: jops.directed_hausdorff(
        qj, dp, qvj, dvp, use_kernel=use_kernel)))
    want = np.asarray(eval_chunk(jnp.asarray(ds), jnp.asarray(dv)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_directed_hausdorff_pairs_no_valid_row():
    """A query set with no valid row: -BIG for every pair, as in JAX."""
    q, ds, qv, dv = _mk(3, 4, 50, 80, 2, shared_q=True)
    qv[:] = False
    got = ops.directed_hausdorff_pairs(_t(q), _t(ds), _t(qv), _t(dv))
    want = [jref.directed_hausdorff(*map(jnp.asarray, (q, ds[p], qv, dv[p])))
            for p in range(4)]
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (got.numpy() == -BIG).all()


@pytest.mark.parametrize("P,nq,nd,W", CASES)
def test_nn_distance_batched_bitwise_vs_eager_ref(P, nq, nd, W):
    q, ds, qv, dv = _mk(P * nq + nd + W, P, nq, nd, W, shared_q=False)
    dist, idx = ops.nn_distance_batched(_t(q), _t(ds), _t(qv), _t(dv))
    assert dist.shape == idx.shape == (P, nq) and idx.dtype == torch.int32
    for p in range(P):
        wd, wi = jref.nn_distance(*map(jnp.asarray, (q[p], ds[p], qv[p],
                                                     dv[p])))
        np.testing.assert_array_equal(_bits(dist[p]), _bits(wd))
        np.testing.assert_array_equal(idx[p].numpy(), np.asarray(wi))
        one = ops.nn_distance(_t(q[p]), _t(ds[p]), _t(qv[p]), _t(dv[p]))
        np.testing.assert_array_equal(_bits(one[0]), _bits(dist[p]))
        np.testing.assert_array_equal(one[1].numpy(), idx[p].numpy())
    assert (dist.numpy()[~qv] == 0.0).all() and (idx.numpy()[~qv] == -1).all()


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("P,nq,nd,W", CASES)
def test_nn_distance_batched_vs_jax_ops(P, nq, nd, W, use_kernel):
    q, ds, qv, dv = _mk(P * nq + nd + W, P, nq, nd, W, shared_q=False)
    dist, idx = ops.nn_distance_batched(_t(q), _t(ds), _t(qv), _t(dv))
    wd, wi = jops.nn_distance_batched(*map(jnp.asarray, (q, ds, qv, dv)),
                                      use_kernel=use_kernel)
    wd, wi = np.asarray(wd), np.asarray(wi)
    np.testing.assert_allclose(dist.numpy(), wd, rtol=RTOL)
    for p in range(P):
        clear = qv[p] & _clear(q[p], ds[p], dv[p])
        np.testing.assert_array_equal(idx[p].numpy()[clear], wi[p][clear])
    assert (dist.numpy()[~qv] == 0.0).all() and (idx.numpy()[~qv] == -1).all()
    assert (wd[~qv] == 0.0).all() and (wi[~qv] == -1).all()


# ---------------------------------------------------------------------------
# the nn_distance kernel's order, emulated in numpy
# ---------------------------------------------------------------------------

K_WARPS, K_PER, K_ACC = 8, 4, 2          # csrc/nn_distance.cu
K_SEG = K_PER * 32
K_TILE = K_WARPS * K_SEG
INT_MAX = np.iinfo(np.int32).max


def _kernel_order_nn(q, d, qv, dv):
    """One pair as the kernel reduces it: the valid points of each warp's
    segment of each tile, compacted in index order, go to the warp's two
    running minima alternately (a trailing odd point to the first); each
    running minimum keeps the first index of its least value under a
    strict ``<`` from (inf, INT_MAX); the minima are combined by (value,
    index), and (inf, first valid) and (BIG, first invalid) join them."""
    nd = d.shape[0]
    j = np.arange(nd)
    warp = (j % K_TILE) // K_SEG
    group = np.full(nd, -1)
    for t0 in range(0, nd, K_TILE):
        for w in range(K_WARPS):
            seg = j[(j >= t0) & (j < t0 + K_TILE) & (warp == w) & dv]
            acc = np.arange(seg.size) % K_ACC
            if seg.size % K_ACC:
                acc[-1] = 0
            group[seg] = w * K_ACC + acc
    d2 = None
    for c in range(q.shape[1]):
        diff = q[:, None, c] - d[None, :, c]
        sq = diff * diff
        d2 = sq if d2 is None else d2 + sq
    cands = []
    for g in range(K_WARPS * K_ACC):
        vals = np.where(group[None] == g, d2, np.float32(np.inf))
        m = vals.min(axis=1)
        first = np.argmax(vals == m[:, None], axis=1)
        cands.append((m, np.where(np.isinf(m), INT_MAX, first)))
    first_valid = int(np.argmax(dv)) if dv.any() else nd
    first_invalid = int(np.argmax(~dv)) if not dv.all() else nd
    if first_valid < nd:
        cands.append((np.full(q.shape[0], np.inf, np.float32),
                      np.full(q.shape[0], first_valid)))
    if first_invalid < nd:
        cands.append((np.full(q.shape[0], BIG), np.full(q.shape[0],
                                                        first_invalid)))
    v, vi = cands[0]
    for m, mi in cands[1:]:
        take = (m < v) | ((m == v) & (mi < vi))
        v, vi = np.where(take, m, v), np.where(take, mi, vi)
    return (np.where(qv, np.sqrt(v), np.float32(0)).astype(np.float32),
            np.where(qv, vi, -1).astype(np.int32))


def _check_order(q, ds, qv, dv):
    with np.errstate(over="ignore", invalid="ignore"):
        dist, idx = ops.nn_distance_batched(_t(q), _t(ds), _t(qv), _t(dv))
        for p in range(ds.shape[0]):
            ed, ei = _kernel_order_nn(q[p], ds[p], qv[p], dv[p])
            np.testing.assert_array_equal(_bits(ed), _bits(dist[p]))
            np.testing.assert_array_equal(ei, idx[p].numpy())
    return dist, idx


@pytest.mark.parametrize("P,nq,nd,W", [(3, 20, 1100, 2), (4, 9, 2100, 3),
                                       (3, 5, 33, 1)])
def test_nn_kernel_order_random(P, nq, nd, W):
    """nd past one and two 1024-point tiles, ties at indices 0, 1 and
    nd // 2 (first index wins), a dataset with no valid point."""
    q, ds, qv, dv = _mk(P + nq + nd, P, nq, nd, W, shared_q=False)
    dv[:, 1] = dv[:, 0]
    ds[:, 1] = ds[:, 0]
    ds[:, nd // 2] = ds[:, 0]
    _, idx = _check_order(q, ds, qv, dv)
    assert not (idx.numpy() == 1).any()


@pytest.mark.parametrize("W", [1, 2])
def test_nn_kernel_order_overflow(W):
    """Squares near and past BIG: every point valid and every distance
    infinite (W = 2: infinity at the first valid index); the same with
    holes (BIG at the first invalid index); no valid point (index 0)."""
    rng = np.random.default_rng(W)
    P, nq, nd = 3, 12, 300
    q = -rng.uniform(0.8e19, 1e19, (P, nq, W)).astype(np.float32)
    ds = rng.uniform(0.8e19, 1e19, (P, nd, W)).astype(np.float32)
    qv = np.ones((P, nq), bool)
    qv[:, -2:] = False
    dv = np.ones((P, nd), bool)
    dv[1, 7::5] = False
    dv[2] = False
    ds[~dv] = np.inf
    dist, idx = _check_order(q, ds, qv, dv)
    idx = idx.numpy()
    if W == 2:
        assert (idx[0][qv[0]] == 0).all()
        assert np.isinf(dist.numpy()[0][qv[0]]).all()
        assert (idx[1][qv[1]] == 7).all()
    assert (idx[2][qv[2]] == 0).all()


# ---------------------------------------------------------------------------
# the batched unpruned NNP on a JAX-built index
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def index_pairs():
    datasets = make_clustered_datasets(12, seed=4, n_points=(20, 300))
    jrepo, _ = jbuild(datasets, leaf_capacity=16, theta=5,
                      remove_outliers=False)
    jq = JEngine(jrepo, result_cache_size=0).build_queries(
        [datasets[i] for i in (1, 5, 8)])
    trepo = bridge.repository_to_torch(jax.tree.map(np.asarray, jrepo),
                                       device="cpu")
    tq = bridge.index_to_torch(jax.tree.map(np.asarray, jq), device="cpu")
    qi = np.array([0, 0, 1, 1, 2, 2, 2])
    wi = np.array([0, 3, 7, 11, 2, 5, 9])
    return trepo, tq, qi, wi


def test_nnp_batched_matches_nnp_and_jax(index_pairs):
    trepo, tq, qi, wi = index_pairs
    q_pairs = type(tq)(*[x[_t(qi)] for x in tq])
    d_pairs = type(tq)(*[x[_t(wi)] for x in trepo.ds_index])
    dist, idx = point_search.nnp_batched(q_pairs, d_pairs)
    for p, (i, w) in enumerate(zip(qi, wi)):
        d1, i1 = point_search.nnp(type(tq)(*[x[i] for x in tq]),
                                  type(tq)(*[x[w] for x in trepo.ds_index]))
        np.testing.assert_array_equal(_bits(dist[p]), _bits(d1))
        np.testing.assert_array_equal(idx[p].numpy(), i1.numpy())
    qs, qsv = q_pairs.points.numpy(), q_pairs.valid.numpy()
    ds, dsv = d_pairs.points.numpy(), d_pairs.valid.numpy()
    wd, wj = jops.nn_distance_batched(*map(jnp.asarray, (qs, ds, qsv, dsv)))
    np.testing.assert_allclose(dist.numpy(), np.asarray(wd), rtol=RTOL)
    for p in range(len(qi)):
        clear = qsv[p] & _clear(qs[p], ds[p], dsv[p])
        np.testing.assert_array_equal(idx[p].numpy()[clear],
                                      np.asarray(wj)[p][clear])

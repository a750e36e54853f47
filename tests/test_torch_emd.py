"""The port's top-k EMD (``repro_torch.core.emd``) against the JAX package.

The lakes are those of ``tests/test_emd.py``, built by JAX and carried
across with ``repro_torch.bridge``, so both packages run on the same index.

* Histograms: exactly (integer counts over their total), against JAX and
  against a numpy ``bincount``.
* Cell centers: to ``rtol=1e-6``.
* ``topk_emd``: values to ``rtol=1e-4`` against JAX (100 Sinkhorn
  iterations of float32 matrix products, summed in another order), ids
  exactly except inside groups of values within that tolerance.
* The three properties ``tests/test_emd.py`` asks of the JAX package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import emd as jemd
from repro.core.build import build_repository as jbuild
from repro_torch import bridge
from repro_torch.core import emd, zorder
from test_torch_exacthaus import assert_bitwise, assert_topk_close
from torch_lm_parity import one_torch_thread  # noqa: F401

RTOL = 1e-4


def _cluster(rng, center, n=100):
    return (center + rng.normal(size=(n, 2))).astype(np.float32)


def _repos(lake):
    jrepo, _ = jbuild(lake, leaf_capacity=16, theta=5)
    return jrepo, bridge.repository_to_torch(jax.tree.map(np.asarray, jrepo),
                                             device="cpu")


@pytest.fixture(scope="module")
def lakes():
    """The two lakes of ``tests/test_emd.py`` (same shapes, so one JAX
    build compiles for both) and their queries."""
    rng = np.random.default_rng(0)
    A, B, C = np.array([0., 0.]), np.array([20., 0.]), np.array([0., 20.])
    clusters = ([_cluster(rng, A) for _ in range(5)]
                + [_cluster(rng, B) for _ in range(5)]
                + [_cluster(rng, C) for _ in range(5)])
    q_a = _cluster(rng, A)
    rng = np.random.default_rng(1)
    spread = [_cluster(rng, rng.uniform(0, 30, 2)) for _ in range(16)]
    return {"clusters": (_repos(clusters), q_a),
            "spread": (_repos(spread), spread[3])}


def _topk(lake, k, **kw):
    (jrepo, trepo), q = lake
    valid = np.ones(len(q), bool)
    v, i = emd.topk_emd(trepo, torch.from_numpy(q), torch.from_numpy(valid),
                        k, theta=4, **kw)
    jv, ji = jemd.topk_emd(jrepo, jnp.asarray(q), jnp.asarray(valid), k,
                           theta=4, **kw)
    return v.numpy(), i.numpy(), np.asarray(jv), np.asarray(ji)


@pytest.mark.parametrize("theta", [3, 4, 5])
def test_histograms_and_centers_match_jax(lakes, theta):
    (jrepo, trepo), q = lakes["clusters"]
    lo, hi = trepo.space_lo, trepo.space_hi
    idx = trepo.ds_index
    hists = emd.cell_histogram(idx.points, idx.valid, lo, hi, theta)
    assert hists.shape == (trepo.n_slots, 4 ** theta)
    cells = zorder.cell_ids(idx.points, lo, hi, theta).numpy()
    valid = idx.valid.numpy()
    want = np.asarray(jax.vmap(lambda p, v: jemd.cell_histogram(
        p, v, jrepo.space_lo, jrepo.space_hi, theta))(
        jrepo.ds_index.points, jrepo.ds_index.valid))
    assert_bitwise(hists.numpy(), want)
    for s in range(trepo.n_slots):
        counts = np.bincount(cells[s][valid[s]], minlength=4 ** theta)
        assert_bitwise(hists[s].numpy(), (counts / max(counts.sum(), 1))
                       .astype(np.float32))
    # one query alone: the same as a row of the batch
    one = emd.cell_histogram(torch.from_numpy(q), torch.ones(len(q),
                             dtype=torch.bool), lo, hi, theta)
    assert_bitwise(one.numpy(), np.asarray(jemd.cell_histogram(
        jnp.asarray(q), jnp.ones(len(q), bool), jrepo.space_lo,
        jrepo.space_hi, theta)))
    np.testing.assert_allclose(
        emd.cell_centers(lo, hi, theta).numpy(),
        np.asarray(jemd.cell_centers(jrepo.space_lo, jrepo.space_hi, theta)),
        rtol=1e-6)


def test_emd_ranks_by_distribution_distance(lakes):
    v, i, jv, ji = _topk(lakes["clusters"], 15)
    assert all(x < 5 for x in i[:5])            # cluster A first
    assert v[:5].max() < v[5:].min()            # strict separation
    assert np.isfinite(v).all() and (v >= -1e-6).all()
    assert_topk_close(v, i, jv, ji, rtol=RTOL)


@pytest.mark.parametrize("prefilter", [0, 8])
def test_emd_prefilter_matches_full(lakes, prefilter):
    v, i, jv, ji = _topk(lakes["spread"], 3, prefilter=prefilter)
    assert int(i[0]) == 3                       # self-match survives
    assert_topk_close(v, i, jv, ji, rtol=RTOL)
    v_full, i_full, _, _ = _topk(lakes["spread"], 3)
    np.testing.assert_allclose(v[0], v_full[0], atol=1e-5)


def test_emd_prefilter_can_drop_the_query_itself(lakes):
    """The prefilter orders by histogram overlap ``hists @ q_hist``: a
    dataset concentrated on the query's densest cell overlaps it more
    than the query itself, so with a narrow filter the query is not
    scored, in both packages."""
    rng = np.random.default_rng(5)

    def tight(n):
        return (np.array([10., 10.]) + rng.normal(scale=0.01, size=(n, 2))
                ).astype(np.float32)

    q = np.concatenate([tight(50), rng.uniform(0, 30, (50, 2)).astype(
        np.float32)])
    lake = ([_cluster(rng, rng.uniform(0, 30, 2)) for _ in range(14)]
            + [q, tight(100)])
    lake = (_repos(lake), q)
    v, i, jv, ji = _topk(lake, 3)
    assert i[0] == ji[0] == 14                  # the query itself first
    v, i, jv, ji = _topk(lake, 3, prefilter=1)
    assert i[0] == ji[0] == 15                  # ... unless filtered out
    assert np.isinf(v[1:]).all() and np.isinf(jv[1:]).all()
    np.testing.assert_allclose(v[0], jv[0], rtol=RTOL)


def test_emd_unscored_and_padded_slots_are_inf(lakes):
    """Past the prefilter's candidates the values are inf."""
    v, i, jv, ji = _topk(lakes["spread"], 12, prefilter=8)
    assert np.isfinite(v[:8]).all() and np.isinf(v[8:]).all()
    np.testing.assert_array_equal(np.isinf(jv), np.isinf(v))
    assert_topk_close(v[:8], i[:8], jv[:8], ji[:8], rtol=RTOL)


def test_sinkhorn_emd_basic_properties():
    n = 64
    cost = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :]) / n
    cost = torch.from_numpy(cost.astype(np.float32))
    a = torch.zeros(n)
    a[10] = 1.0
    b = torch.zeros(n)
    b[20] = 1.0
    d = float(emd.sinkhorn_emd(a, b, cost, reg=0.01, iters=200))
    # point masses 10 cells apart on a line: EMD = 10/n
    assert abs(d - 10 / n) < 0.02
    d0 = float(emd.sinkhorn_emd(a, a, cost, reg=0.01, iters=200))
    assert d0 < 0.01
    for x, y in ((a, b), (a, a)):
        want = float(jemd.sinkhorn_emd(jnp.asarray(x.numpy()),
                                       jnp.asarray(y.numpy()),
                                       jnp.asarray(cost.numpy()), reg=0.01,
                                       iters=200))
        np.testing.assert_allclose(float(emd.sinkhorn_emd(
            x, y, cost, reg=0.01, iters=200)), want, rtol=RTOL, atol=1e-7)
    # a batch of b is the rows one at a time
    batch = emd.sinkhorn_emd(a, torch.stack([b, a]), cost, reg=0.01,
                             iters=200)
    np.testing.assert_allclose(batch.numpy(), [d, d0], rtol=1e-6)

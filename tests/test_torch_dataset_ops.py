"""The port's dataset ops (RangeS, top-k IA, top-k GBO, ApproHaus) against
the JAX package, on one index.

The repository and the query trees are built by JAX and carried across with
``repro_torch.bridge``, so both packages search the same index.

* Masks, ids, levels and counters: exact.
* IA and GBO values: exact (GBO counts are integers; IA is a product of two
  clamped differences, which no compiler can contract).
* ApproHaus scores: bitwise against eager JAX (``search`` and
  ``batched_ops`` called directly), since both add the squares in
  coordinate order; against the jitted JAX engine within ``RTOL`` with ids
  compared as sets inside near-ties (XLA:CPU may contract ``d0*d0 + d1*d1``
  into an FMA).
* ``sq_dist_matrix``: the JAX package takes ``x @ y.T`` through XLA's dot;
  the port adds the products in coordinate order.  The test states how far
  apart the two are.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_clustered_datasets
from repro.core import geometry as jgeometry
from repro.core import search as jsearch
from repro.core import zorder as jzorder
from repro.core.build import build_repository as jbuild
from repro.engine import Pipeline as JPipeline
from repro.engine import Query as JQuery
from repro.engine import QueryEngine as JEngine
from repro.engine import batched_ops as jbatched
from repro_torch import bridge
from repro_torch.core import geometry, search
from repro_torch.engine import Pipeline, Query, QueryEngine, batched_ops
from test_torch_exacthaus import assert_bitwise, assert_topk_close
from torch_lm_parity import one_torch_thread  # noqa: F401

RTOL = 1e-6
THETA = 5


def _t(x):
    return torch.from_numpy(np.array(x))


def _row(tree, i):
    return type(tree)(*[x[i] for x in tree])


@pytest.fixture(scope="module")
def env():
    datasets = make_clustered_datasets(40, seed=4, n_points=(20, 300))
    jrepo, _ = jbuild(datasets, leaf_capacity=16, theta=THETA,
                      remove_outliers=False)
    trepo = bridge.repository_to_torch(jax.tree.map(np.asarray, jrepo),
                                       device="cpu")
    rng = np.random.default_rng(1)
    lo = rng.uniform(-60, 40, (6, 2)).astype(np.float32)
    hi = lo + rng.uniform(5, 40, (6, 2)).astype(np.float32)
    lo[4], hi[4] = (-200, -200), (200, 200)       # every dataset
    lo[5], hi[5] = (500, 500), (510, 510)         # none
    q_sets = [datasets[i] for i in (0, 3, 9, 11)] + [
        rng.normal(scale=20, size=(150, 2)).astype(np.float32)]
    sigs = np.stack([np.asarray(jzorder.signature(
        jnp.asarray(q), jnp.ones(len(q), bool), jrepo.space_lo,
        jrepo.space_hi, THETA)) for q in q_sets])
    eps = float(jzorder.default_epsilon(jrepo.space_lo, jrepo.space_hi,
                                        THETA))
    jq = JEngine(jrepo, result_cache_size=0).build_queries(q_sets)
    tq = bridge.index_to_torch(jax.tree.map(np.asarray, jq), device="cpu")
    return dict(datasets=datasets, jrepo=jrepo, trepo=trepo, lo=lo, hi=hi,
                q_sets=q_sets, sigs=sigs, eps=eps, jq=jq, tq=tq)


def test_range_search_matches_jax(env):
    for lo, hi in zip(env["lo"], env["hi"]):
        mask, stats = search.range_search(env["trepo"], _t(lo), _t(hi))
        jmask, jstats = jsearch.range_search(env["jrepo"], jnp.asarray(lo),
                                             jnp.asarray(hi))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        assert stats == jstats
    # the all-covering box finds every dataset, the far one none
    assert mask.sum() == 0
    assert int(search.range_search(env["trepo"], _t(env["lo"][4]),
                                   _t(env["hi"][4]))[0].sum()) == 40


def test_range_search_batched_matches_jax(env):
    masks, live = batched_ops.range_search_batched(
        env["trepo"], _t(env["lo"]), _t(env["hi"]))
    jmasks, jlive = jbatched.range_search_batched(
        env["jrepo"], jnp.asarray(env["lo"]), jnp.asarray(env["hi"]))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
    np.testing.assert_array_equal(live.numpy(), np.asarray(jlive))


@pytest.mark.parametrize("k", [5, 64])
def test_topk_ia_matches_jax(env, k):
    """k = 64 runs past the 40 valid datasets into the -1 sentinels."""
    lo, hi = env["lo"], env["hi"]
    vals, ids = batched_ops.topk_ia_batched(env["trepo"], _t(lo), _t(hi), k)
    jv, ji = jbatched.topk_ia_batched(env["jrepo"], jnp.asarray(lo),
                                      jnp.asarray(hi), k)
    assert_bitwise(vals.numpy(), jv)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    for b in range(lo.shape[0]):
        v, i = search.topk_ia(env["trepo"], _t(lo[b]), _t(hi[b]), k)
        assert_bitwise(v.numpy(), vals[b].numpy())
        np.testing.assert_array_equal(i.numpy(), ids[b].numpy())
    if k > 40:
        assert (ids.numpy()[:, 40:] == -1).all()


@pytest.mark.parametrize("k", [5, 64])
def test_topk_gbo_matches_jax(env, k):
    """GBO counts tie often: the tie order (smaller slot first) decides the
    ids, and they must match exactly."""
    sigs = env["sigs"]
    vals, ids = batched_ops.topk_gbo_batched(
        env["trepo"], _t(sigs.astype(np.int64)), k)
    jv, ji = jbatched.topk_gbo_batched(env["jrepo"], jnp.asarray(sigs), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    for b in range(sigs.shape[0]):
        v, i = search.topk_gbo(env["trepo"], _t(sigs[b].astype(np.int64)), k)
        jv1, ji1 = jsearch.topk_gbo(env["jrepo"], jnp.asarray(sigs[b]), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv1))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji1))
    assert (np.diff(vals.numpy(), axis=1) == 0).any()     # ties were met


@pytest.mark.parametrize("scale", [0.5, 1.0, 4.0])
def test_stopping_levels_match_jax(env, scale):
    eps = env["eps"] * scale
    trepo, jrepo, tq, jq = env["trepo"], env["jrepo"], env["tq"], env["jq"]
    assert (search.approx_level(trepo.ds_index, eps)
            == jsearch.approx_level(jrepo.ds_index, eps))
    oks = search._levels_ok(tq.radii, tq.counts, tq.depth, eps)
    lq = search._level_for_eps(oks, tq.depth)
    for b in range(tq.points.shape[0]):
        want = jsearch.approx_level(_row(jq, b), eps)
        assert search.approx_level(_row(tq, b), eps) == want
        jok = jbatched._levels_ok(jq.radii[b], jq.counts[b], jq.depth,
                                  np.float32(eps))
        np.testing.assert_array_equal(oks[b].numpy(), np.asarray(jok))
        assert int(lq[b]) == want
    n = 1 << int(lq.max())
    got = batched_ops._gather_frontier(tq.centers, tq.radii, tq.counts, lq,
                                       n)
    for b in range(tq.points.shape[0]):
        want = jbatched._gather_frontier(jq.centers[b], jq.radii[b],
                                         jq.counts[b], jnp.int32(lq[b]),
                                         1 << jq.depth)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w)[:n])


@pytest.mark.parametrize("scale", [0.5, 1.0, 4.0])
def test_topk_hausdorff_approx_matches_jax(env, scale):
    """Single-query and batched ApproHaus, bitwise against eager JAX; the
    batched rows bitwise equal to the single-query op."""
    eps, k = env["eps"] * scale, 6
    trepo, jrepo, tq, jq = env["trepo"], env["jrepo"], env["tq"], env["jq"]
    vals, ids, eps_eff = batched_ops.topk_hausdorff_approx_batched(
        trepo, tq, k, eps)
    jv, ji, je = jbatched.topk_hausdorff_approx_batched(
        jrepo, jq, k, np.float32(eps))
    assert_bitwise(vals.numpy(), jv)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    assert_bitwise(eps_eff.numpy(), je)
    for b in range(tq.points.shape[0]):
        v, i, info = search.topk_hausdorff_approx(trepo, _row(tq, b), k, eps)
        jv1, ji1, jinfo = jsearch.topk_hausdorff_approx(jrepo, _row(jq, b),
                                                        k, eps)
        assert_bitwise(v.numpy(), jv1)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji1))
        assert info == jinfo
        assert_bitwise(v.numpy(), vals[b].numpy())
        np.testing.assert_array_equal(i.numpy(), ids[b].numpy())


def test_geometry_matches_jax():
    rng = np.random.default_rng(8)
    a = rng.normal(scale=30, size=(3, 40, 2)).astype(np.float32)
    b = rng.normal(scale=30, size=(3, 50, 2)).astype(np.float32)
    lo_a, hi_a = a.min(1), a.max(1)
    lo_b, hi_b = b.min(1), b.max(1) - 20
    for fn in ("box_overlaps", "intersect_area"):
        got = getattr(geometry, fn)(_t(lo_a)[:, None], _t(hi_a)[:, None],
                                    _t(lo_b)[None], _t(hi_b)[None])
        want = getattr(jgeometry, fn)(lo_a[:, None], hi_a[:, None],
                                      lo_b[None], hi_b[None])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        geometry.box_contains(_t(lo_b[0]), _t(hi_b[0]), _t(a[0])).numpy(),
        np.asarray(jgeometry.box_contains(lo_b[0], hi_b[0], a[0])))
    for p in range(3):
        assert_bitwise(geometry.pairwise_dist_exact(_t(a[p]), _t(b[p])),
                       jgeometry.pairwise_dist_exact(a[p], b[p]))
    # the cancelling form: batched rows equal single ones bitwise, and
    # XLA's dot is held to a few ulps of the squared distances' scale
    got = geometry.sq_dist_matrix(_t(a), _t(b)).numpy()
    scale = float((a ** 2).sum(-1).max() + (b ** 2).sum(-1).max())
    for p in range(3):
        assert_bitwise(geometry.sq_dist_matrix(_t(a[p]), _t(b[p])), got[p])
        want = np.asarray(jgeometry.sq_dist_matrix(a[p], b[p]))
        np.testing.assert_allclose(got[p], want, rtol=0,
                                   atol=4 * np.spacing(np.float32(scale)))


# ---------------------------------------------------------------------------
# the mixed batch: every ported op and both pipeline kinds in one search()
# ---------------------------------------------------------------------------


def _mixed_batch(Q, P, env):
    lo, hi, q, sigs, eps = (env["lo"], env["hi"], env["q_sets"],
                            env["sigs"], env["eps"])
    return [
        Q(op="topk_ia", r_lo=lo[0], r_hi=hi[0], k=6),
        Q(op="range_search", r_lo=lo[1], r_hi=hi[1]),
        Q(op="nnp", ds_id=4, q=q[1]),
        Q(op="topk_hausdorff", q=q[0], k=6),
        Q(op="topk_gbo", q_sig=sigs[0], k=6),
        Q(op="topk_hausdorff_approx", q=q[2], k=6, eps=eps),
        Q(op="range_points", ds_id=7, r_lo=lo[3], r_hi=hi[3]),
        P(Q(op="topk_hausdorff", q=q[3], k=4), Q(op="nnp", q=q[4])),
        P(Q(op="topk_gbo", q_sig=sigs[2], k=3),
          Q(op="range_points", r_lo=lo[4], r_hi=hi[4])),
        P(Q(op="topk_hausdorff_approx", q=q[1], k=3, eps=eps),
          Q(op="nnp", q=q[0])),
        P(Q(op="topk_ia", r_lo=lo[2], r_hi=hi[2], k=5),
          Q(op="range_points", r_lo=lo[0], r_hi=hi[0])),
        Q(op="range_search", r_lo=lo[4], r_hi=hi[4]),
        Q(op="topk_ia", r_lo=lo[3], r_hi=hi[3], k=6),
    ]


def _assert_nnp_rows(d, i, jd, ji, valid):
    """NNP rows against the jitted JAX engine: distances to RTOL on valid
    points, indices exactly (the squared distances of the test data have
    no near-ties that one ulp could reorder)."""
    np.testing.assert_allclose(np.asarray(d)[valid], np.asarray(jd)[valid],
                               rtol=RTOL)
    np.testing.assert_array_equal(np.asarray(i)[valid],
                                  np.asarray(ji)[valid])


def _assert_result(r, j):
    assert r.op == j.op
    if r.op in ("range_search", "range_points") or (
            r.op == "pipeline" and r.vals is None):
        np.testing.assert_array_equal(r.mask, np.asarray(j.mask))
    elif r.op in ("topk_ia", "topk_gbo"):
        assert_bitwise(np.asarray(r.vals, np.float32),
                       np.asarray(j.vals, np.float32))
        np.testing.assert_array_equal(r.ids, np.asarray(j.ids))
    elif r.op in ("topk_hausdorff", "topk_hausdorff_approx"):
        assert_topk_close(r.vals, r.ids, j.vals, j.ids)
    if r.op == "topk_hausdorff_approx":
        np.testing.assert_allclose(r.extras["eps_eff"], j.extras["eps_eff"],
                                   rtol=RTOL)
    if r.op == "nnp":
        np.testing.assert_array_equal(r.mask, np.asarray(j.mask))
        _assert_nnp_rows(r.vals, r.ids, j.vals, j.ids, r.mask)
    if r.op == "pipeline":
        np.testing.assert_array_equal(np.asarray(r.extras["ds_ids"]),
                                      np.asarray(j.extras["ds_ids"]))
        np.testing.assert_array_equal(r.extras["valid"],
                                      np.asarray(j.extras["valid"]))
        if r.vals is not None:
            np.testing.assert_array_equal(r.mask, np.asarray(j.mask))
            _assert_nnp_rows(r.vals, r.ids, j.vals, j.ids, r.mask)
    if r.op in ("range_points", "nnp") or r.op == "pipeline":
        stats = r.stats if isinstance(r.stats, list) else [r.stats]
        jstats = j.stats if isinstance(j.stats, list) else [j.stats]
        for s, js in zip(stats, jstats):
            assert s.nodes_evaluated == js.nodes_evaluated
            assert s.leaves_scanned == js.leaves_scanned
            assert s.pruned_fraction == pytest.approx(js.pruned_fraction)
    if r.op == "topk_hausdorff":
        assert r.stats == j.stats


@pytest.fixture(scope="module")
def mixed(env):
    jres = JEngine(env["jrepo"], result_cache_size=0).search(
        _mixed_batch(JQuery, JPipeline, env))
    return jres


def test_mixed_batch_matches_jax_engine(env, mixed):
    engine = QueryEngine(env["trepo"], result_cache_size=0)
    res = engine.search(_mixed_batch(Query, Pipeline, env))
    assert len(res) == len(mixed)
    for r, j in zip(res, mixed):
        _assert_result(r, j)
    assert engine.stats.pipeline_stage1 == 4
    assert engine.stats.pipeline_stage2 == 4
    # 7 op groups (the two IA rows and a pipeline IA row with another k
    # are two groups; the ExactHaus rows with k 6 and 4 two more) ...
    assert engine.stats.group_counts["topk_ia"] == 2
    assert engine.stats.group_counts["topk_hausdorff"] == 2
    # ... and the stage-2 groups: both RangeP pipelines share one, the two
    # NNP pipelines share one only if their query sets build to one shape
    caps = {Query(op="nnp", q=q).built_capacity(16)
            for q in (env["q_sets"][4], env["q_sets"][0])}
    assert engine.stats.group_counts["range_points"] == 1 + 1
    assert engine.stats.group_counts["nnp"] == 1 + len(caps)


def test_result_cache_replays_every_op(env, mixed):
    """A repeated mixed batch is served from the LRU for every op whose ids
    arrive on the host, bitwise equal to the cold pass."""
    engine = QueryEngine(env["trepo"], result_cache_size=64)
    items = _mixed_batch(Query, Pipeline, env)
    first = engine.search(items)
    per = engine.stats.per_op
    cached = ("range_search", "topk_ia", "topk_gbo", "topk_hausdorff_approx",
              "topk_hausdorff")
    d0 = {op: per[op]["dispatches"] for op in cached + ("range_points",)}
    again = engine.search(items)
    for op in cached:
        assert per[op]["dispatches"] == d0[op]
        assert per[op]["result_hits"] >= 1
    # the standalone RangeP row is served from the LRU; the stage-2 rows,
    # whose ids arrive on the device, dispatch again (one group)
    assert per["range_points"]["dispatches"] == d0["range_points"] + 1
    for a, b, j in zip(first, again, mixed):
        _assert_result(a, j)
        _assert_result(b, j)

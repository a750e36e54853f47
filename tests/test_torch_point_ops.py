"""The port's point ops (RangeP, NNP) and dataset->point pipelines against
the JAX package, on one index.

The repository and the query trees are built by JAX and carried across with
``repro_torch.bridge``, so both packages search the same index.

* RangeP take masks, scanned-leaf masks and PointStats: exact.
* Pruned NNP against eager JAX (``point_search.nnp_pruned``): distances
  bitwise, indices exactly.  Its leaf bounds ``ub`` come from
  ``ops.bound_matrices`` (eager in both packages, squares added in
  coordinate order); its prune mask ``pair_live`` also reads
  ``pairwise_center_dist``, where JAX takes ``x @ y.T`` through XLA's dot
  and the port adds the two products in coordinate order.  On the
  clustered seeds the masks are equal (asserted): no pair lies within
  rounding of the prune boundary.  On clipped random walks, whose duplicate
  corner points put pairs on that boundary, 21 of the pairs flip; each is
  checked to lie within the cancellation error of the center distance
  (``test_nnp_pruned_on_tied_points``).
* Unpruned NNP (``ops.nn_distance``) against jitted JAX: distances within
  ``RTOL`` (XLA:CPU may contract ``d0*d0 + d1*d1`` into an FMA), indices
  exactly where the two nearest distances are apart by more than that.
* Inside the port, pruned and unpruned NNP agree bitwise on the distances
  of valid points: the per-entry arithmetic is the same.  The indices agree
  too, except where a pruned leaf held another point at the same squared
  distance (ties among duplicate points).
"""
import jax
import numpy as np
import pytest
import torch

from conftest import make_clustered_datasets
from repro.core import point_search as jpoint
from repro.core.build import build_repository as jbuild
from repro.engine import QueryEngine as JEngine
from repro.engine import batched_ops as jbatched
from repro_torch import bridge
from repro_torch.core import point_search
from repro_torch.core.build import build_repository
from repro_torch.engine import Pipeline, Query, QueryEngine, batched_ops
from test_torch_exacthaus import assert_bitwise

RTOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _row(tree, i):
    return type(tree)(*[x[i] for x in tree])


@pytest.fixture(scope="module")
def env():
    datasets = make_clustered_datasets(36, seed=6, n_points=(20, 300))
    jrepo, _ = jbuild(datasets, leaf_capacity=16, theta=5,
                      remove_outliers=False)
    trepo = bridge.repository_to_torch(jax.tree.map(np.asarray, jrepo),
                                       device="cpu")
    rng = np.random.default_rng(2)
    lo = rng.uniform(-60, 40, (5, 2)).astype(np.float32)
    hi = lo + rng.uniform(5, 60, (5, 2)).astype(np.float32)
    lo[4], hi[4] = (-200, -200), (200, 200)
    q_sets = [datasets[i] for i in (1, 5, 8)] + [
        rng.normal(scale=25, size=(90, 2)).astype(np.float32)]
    jq = JEngine(jrepo, result_cache_size=0).build_queries(q_sets)
    tq = bridge.index_to_torch(jax.tree.map(np.asarray, jq), device="cpu")
    ds_ids = np.array([0, 7, 13, 35], np.int64)
    return dict(datasets=datasets, jrepo=jrepo, trepo=trepo, lo=lo, hi=hi,
                q_sets=q_sets, jq=jq, tq=tq, ds_ids=ds_ids)


def test_range_points_matches_jax(env):
    trepo, jrepo = env["trepo"], env["jrepo"]
    for j, (lo, hi) in zip(env["ds_ids"], zip(env["lo"], env["hi"])):
        take, stats = point_search.range_points(
            _row(trepo.ds_index, int(j)), _t(lo), _t(hi))
        jtake, jstats = jpoint.range_points(_row(jrepo.ds_index, int(j)),
                                            lo, hi)
        np.testing.assert_array_equal(take.numpy(), np.asarray(jtake))
        assert stats == jstats
    ids = np.concatenate([env["ds_ids"], [2]])
    take, scanned = batched_ops.range_points_batched(
        trepo, _t(ids), _t(env["lo"]), _t(env["hi"]))
    jtake, jscanned = jbatched.range_points_batched(
        jrepo, ids.astype(np.int32), env["lo"], env["hi"])
    np.testing.assert_array_equal(take.numpy(), np.asarray(jtake))
    np.testing.assert_array_equal(scanned.numpy(), np.asarray(jscanned))
    # the all-covering box takes every valid point of dataset 2
    np.testing.assert_array_equal(take[4].numpy(),
                                  np.asarray(jrepo.ds_index.valid[2]))


def test_nnp_matches_jax(env):
    """Unpruned NNP (the ``nn_distance`` op) against jitted JAX."""
    tq, jq, trepo, jrepo = env["tq"], env["jq"], env["trepo"], env["jrepo"]
    for b, j in enumerate(env["ds_ids"]):
        d_t, d_j = _row(trepo.ds_index, int(j)), _row(jrepo.ds_index, int(j))
        dist, idx = point_search.nnp(_row(tq, b), d_t)
        jdist, jidx = jpoint.nnp(_row(jq, b), d_j)
        qv = tq.valid[b].numpy()
        np.testing.assert_allclose(dist.numpy(), np.asarray(jdist),
                                   rtol=RTOL)
        q, d = tq.points[b].numpy(), d_t.points.numpy()
        d2 = np.sort(np.where(d_t.valid.numpy()[None],
                              ((q[:, None] - d[None]) ** 2).sum(-1), np.inf),
                     axis=1)
        clear = qv & (d2[:, 1] > d2[:, 0] * (1 + 4 * RTOL))
        np.testing.assert_array_equal(idx.numpy()[clear],
                                      np.asarray(jidx)[clear])
        assert (idx.numpy()[~qv] == -1).all()


def test_nnp_pruned_matches_jax(env):
    """Pruned NNP, single pair and batched, against eager JAX."""
    tq, jq, trepo, jrepo = env["tq"], env["jq"], env["trepo"], env["jrepo"]
    ids = env["ds_ids"]
    dists, idxs, live = batched_ops.nnp_pruned_batched(trepo, _t(ids), tq)
    for b, j in enumerate(ids):
        d, i, st = point_search.nnp_pruned(_row(tq, b),
                                           _row(trepo.ds_index, int(j)))
        jd, ji, jst = jpoint.nnp_pruned(_row(jq, b),
                                        _row(jrepo.ds_index, int(j)))
        _, _, jlive = jpoint.nnp_pruned_core(_row(jq, b),
                                             _row(jrepo.ds_index, int(j)))
        np.testing.assert_array_equal(live[b].numpy(), np.asarray(jlive))
        assert_bitwise(d.numpy(), jd)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        assert (st.nodes_evaluated, st.leaves_scanned) == (
            jst.nodes_evaluated, jst.leaves_scanned)
        assert st.pruned_fraction == jst.pruned_fraction
        assert st.pruned_fraction > 0.0
        assert_bitwise(dists[b].numpy(), d.numpy())
        np.testing.assert_array_equal(idxs[b].numpy(), i.numpy())


def test_nnp_pruned_equals_unpruned(env):
    """The prune is exact: same distances (bitwise) and indices as the
    scan over all of D, on every valid query point."""
    tq, trepo = env["tq"], env["trepo"]
    for b, j in enumerate(env["ds_ids"]):
        d_t = _row(trepo.ds_index, int(j))
        pd, pi, _ = point_search.nnp_pruned(_row(tq, b), d_t)
        ud, ui = point_search.nnp(_row(tq, b), d_t)
        assert_bitwise(pd.numpy(), ud.numpy())
        np.testing.assert_array_equal(pi.numpy(), ui.numpy())


def test_nnp_pruned_blocks_change_no_bit(env, monkeypatch):
    """The leaf scan runs in blocks of pairs; a block of one pair gives the
    same bits as one block of all."""
    tq, trepo, ids = env["tq"], env["trepo"], _t(env["ds_ids"])
    whole = batched_ops.nnp_pruned_batched(trepo, ids, tq)
    monkeypatch.setattr(point_search, "SCAN_BLOCK", 1)
    one = batched_ops.nnp_pruned_batched(trepo, ids, tq)
    assert_bitwise(one[0].numpy(), whole[0].numpy())
    for a, b in zip(one[1:], whole[1:]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# engine: point queries and dataset -> point pipelines
# ---------------------------------------------------------------------------


def test_pipelines_match_two_call_baseline(env):
    """A pipeline equals its two calls on the host: the dataset op, then the
    point op on the winners."""
    trepo, q_sets, lo, hi = env["trepo"], env["q_sets"], env["lo"], env["hi"]
    engine = QueryEngine(trepo, result_cache_size=0)
    k = 4
    stage1s = [Query(op="topk_ia", r_lo=lo[0], r_hi=hi[0], k=k),
               Query(op="topk_hausdorff", q=q_sets[2], k=k),
               Query(op="topk_hausdorff_approx", q=q_sets[0], k=k, eps=4.0)]
    for stage2 in (Query(op="range_points", r_lo=lo[1], r_hi=hi[1]),
                   Query(op="nnp", q=q_sets[3])):
        res = engine.search([Pipeline(s1, stage2) for s1 in stage1s])
        base = QueryEngine(trepo, result_cache_size=0)
        for s1, r in zip(stage1s, res):
            ids = base.search([s1])[0].ids
            np.testing.assert_array_equal(r.extras["ds_ids"], ids)
            if stage2.op == "range_points":
                want = base.search([Query(op="range_points", ds_id=int(j),
                                          r_lo=lo[1], r_hi=hi[1])
                                    for j in ids])
                np.testing.assert_array_equal(
                    r.mask, np.stack([w.mask for w in want]))
            else:
                want = base.search([Query(op="nnp", ds_id=int(j),
                                          q=q_sets[3]) for j in ids])
                assert_bitwise(r.vals, np.stack([w.vals for w in want]))
                np.testing.assert_array_equal(
                    r.ids, np.stack([w.ids for w in want]))
                for s, w in zip(r.stats, want):
                    assert s == w.stats


def test_pipeline_sentinel_winners_masked(env):
    """k past the valid dataset count: the -1 sentinel winners' stage-2 rows
    are masked out, never gathered as real datasets."""
    trepo, lo, hi = env["trepo"], env["lo"], env["hi"]
    engine = QueryEngine(trepo, result_cache_size=0)
    k = trepo.n_slots
    assert k > int(trepo.ds_valid.sum())
    res = engine.search([
        Pipeline(Query(op="topk_ia", r_lo=lo[0], r_hi=hi[0], k=k),
                 Query(op="range_points", r_lo=lo[4], r_hi=hi[4])),
        Pipeline(Query(op="topk_ia", r_lo=lo[0], r_hi=hi[0], k=k),
                 Query(op="nnp", q=env["q_sets"][0]))])
    for r in res:
        ids = np.asarray(r.extras["ds_ids"])
        assert (ids == -1).any()
        np.testing.assert_array_equal(r.extras["valid"], ids >= 0)
        assert not r.mask[ids < 0].any()
    # every valid winner's row under the all-covering box is non-empty
    assert res[0].mask[ids >= 0].any(axis=1).all()


def test_two_pipelines_share_stage2_dispatch(env):
    """Compatible pipelines group their stage-2 point queries into one
    dispatch (ragged ks concatenated)."""
    trepo, lo, hi = env["trepo"], env["lo"], env["hi"]
    engine = QueryEngine(trepo, result_cache_size=0)
    engine.search([
        Pipeline(Query(op="topk_ia", r_lo=lo[0], r_hi=hi[0], k=3),
                 Query(op="range_points", r_lo=lo[1], r_hi=hi[1])),
        Pipeline(Query(op="topk_ia", r_lo=lo[2], r_hi=hi[2], k=5),
                 Query(op="range_points", r_lo=lo[3], r_hi=hi[3]))])
    # stage 1: one topk_ia group per k (2 dispatches); stage 2: one
    # range_points dispatch of 3 + 5 = 8 rows
    assert engine.stats.dispatches == 3
    assert engine.stats.per_op["range_points"] == {
        "queries": 8, "dispatches": 1, "nodes_evaluated": 8 * 32,
        "leaves_scanned": engine.stats.per_op["range_points"][
            "leaves_scanned"],
        "pruned_fraction": engine.stats.per_op["range_points"][
            "pruned_fraction"]}
    assert engine.stats.pipeline_stage2 == 2
    assert engine.stats.group_counts == {"topk_ia": 2, "range_points": 1}


def test_point_query_needs_ds_id(env):
    engine = QueryEngine(env["trepo"], result_cache_size=0)
    with pytest.raises(ValueError, match="requires ds_id"):
        engine.search([Query(op="nnp", q=env["q_sets"][0])])


def test_nnp_pruned_on_tied_points():
    """Random walks clipped to the space's edge pile duplicate points into
    corners, so nearest neighbours tie and prune decisions sit on their
    boundary.  There the two packages' ``pair_live`` masks differ: JAX's
    dot is an FMA (``fma(x1, y1, x0 * y0)`` on XLA:CPU), the port adds two
    rounded products, and ``|x|^2 + |y|^2 - 2 x.y`` cancels, so the center
    distance can move by up to ``sqrt(8 eps32 (|x|^2 + |y|^2))``.  Each
    flipped pair is checked to be such a boundary pair.  Inside the port,
    the pruned NNP keeps the unpruned distances bitwise; its index differs
    only where another point lies at the same squared distance."""
    from repro.core import geometry as jgeometry
    from repro.data import synthetic as jsynthetic
    from repro.kernels import ops as jops

    datasets = jsynthetic.trajectory_repository(
        184, seed=1, n_points=(100, 800))[-8:]
    q_sets = jsynthetic.trajectory_repository(2, seed=7,
                                              n_points=(100, 800))
    # the port builds the index (a JAX build at this size is slow); JAX
    # reads the same trees as numpy
    trepo, _ = build_repository(datasets, leaf_capacity=16, theta=5,
                                remove_outliers=False, device="cpu")
    tq = QueryEngine(trepo, result_cache_size=0).build_queries(q_sets)
    jq, jds = bridge.to_numpy(tq), bridge.to_numpy(trepo.ds_index)
    flips = ties = 0
    for b in range(2):
        for j in range(8):
            q_t, d_t = _row(tq, b), _row(trepo.ds_index, j)
            pd, pi, _ = point_search.nnp_pruned(q_t, d_t)
            ud, ui = point_search.nnp(q_t, d_t)
            assert_bitwise(pd.numpy(), ud.numpy())
            qv = q_t.valid.numpy()
            differ = qv & (pi.numpy() != ui.numpy())
            qp, dp = q_t.points.numpy(), d_t.points.numpy()
            d2 = lambda ix: ((qp[differ] - dp[ix[differ]]) ** 2).sum(-1)
            np.testing.assert_array_equal(d2(pi.numpy()), d2(ui.numpy()))
            ties += int(differ.sum())

            _, _, live = point_search.nnp_pruned_core(
                point_search._batched(q_t), point_search._batched(d_t))
            q_j, d_j = _row(jq, b), _row(jds, j)
            _, _, jlive = jpoint.nnp_pruned_core(q_j, d_j)
            flip = live[0].numpy() != np.asarray(jlive)
            if not flip.any():
                continue
            flips += int(flip.sum())
            # the JAX prune quantities, eagerly
            sl = q_j.level_slice(q_j.depth)
            oq, rq = np.asarray(q_j.centers[sl]), np.asarray(q_j.radii[sl])
            od, rd = np.asarray(d_j.centers[sl]), np.asarray(d_j.radii[sl])
            _, ub = jops.bound_matrices(oq, rq, od, rd, use_kernel=False)
            d_ok = np.asarray(d_j.counts[sl]) > 0
            row_ub = np.where(d_ok[None], np.asarray(ub), 3.4e38).min(1)
            cd = np.asarray(jgeometry.pairwise_center_dist(oq, od))
            plb = np.maximum(cd - rq[:, None] - rd[None], 0)
            cd_exact = np.sqrt(((oq[:, None].astype(np.float64)
                                 - od[None]) ** 2).sum(-1))
            bound = np.sqrt(8 * 2.0 ** -24 * ((oq ** 2).sum(-1)[:, None]
                                              + (od ** 2).sum(-1)[None]))
            gap = np.abs(np.maximum(cd_exact - rq[:, None] - rd[None], 0)
                         - row_ub[:, None])
            assert (gap[flip] <= bound[flip] + 1e-5).all()
            assert (np.abs(plb - row_ub[:, None])[flip]
                    <= 2 * bound[flip] + 1e-5).all()
    assert ties > 0          # the data does tie, and the test saw it
    print(f"pair_live flips against JAX: {flips}; tied indices: {ties}")

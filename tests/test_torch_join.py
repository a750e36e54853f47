"""The port's joinable ops and dataset -> dataset pipelines against the JAX
package, on one index.

The repository is built by JAX and carried across with
``repro_torch.bridge``, so both packages score the same signatures and
points.  Every join score is an integer, so everything is held exactly:
features, bounds, frontier counts, refine scores and counters, engine vals,
ids and ``SearchStats``, and pipeline outputs.  Both packages' host oracles
(``topk_join_host``) are held against the engines too.  Sizes are those of
``tests/test_join_search.py`` (26 datasets of 30-120 points, theta 5); the
upper tree is built with a leaf capacity of 4, so the node frontier has
several levels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_clustered_datasets
from repro.core import join_search as jjoin
from repro.core.build import build_repository as jbuild
from repro.engine import Pipeline as JPipeline
from repro.engine import Query as JQuery
from repro.engine import QueryEngine as JEngine
from repro_torch import bridge
from repro_torch.core import join_search
from repro_torch.engine import Pipeline, Query, QueryEngine
from repro_torch.engine import plan as plan_lib
from repro_torch.engine.query import OPS

THETA = 5
K = 6
N_DS = 26
MODES = [("topk_overlap", "overlap"), ("topk_coverage", "coverage")]


def _np(x):
    return np.asarray(x)


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


@pytest.fixture(scope="module")
def env():
    datasets = make_clustered_datasets(N_DS, seed=4, n_points=(30, 120))
    jrepo, _ = jbuild(datasets, leaf_capacity=16, repo_leaf_capacity=4,
                      theta=THETA, remove_outliers=False)
    trepo = bridge.repository_to_torch(jax.tree.map(np.asarray, jrepo),
                                       device="cpu")
    rng = np.random.default_rng(1)
    q_sets = [datasets[3][:40], datasets[11], datasets[7][:96],
              rng.uniform(200, 300, (25, 2)).astype(np.float32)]
    pts, val = plan_lib._stack_pointsets(q_sets, 128)
    return dict(datasets=datasets, jrepo=jrepo, trepo=trepo, q_sets=q_sets,
                pts=pts, val=val,
                jeng=JEngine(jrepo, result_cache_size=0),
                teng=QueryEngine(trepo, result_cache_size=0))


def _features(env, mode):
    theta_c, theta_f = join_search.join_thetas(env["trepo"])
    assert (theta_c, theta_f) == jjoin.join_thetas(env["jrepo"])
    jr, tr = env["jrepo"], env["trepo"]
    jf = jjoin.query_features(jnp.asarray(env["pts"]), jnp.asarray(env["val"]),
                              jr.space_lo, jr.space_hi, theta_c, theta_f, mode)
    tf = join_search.query_features(torch.from_numpy(env["pts"]),
                                    torch.from_numpy(env["val"]),
                                    tr.space_lo, tr.space_hi, theta_c,
                                    theta_f, mode)
    return jf, tf


@pytest.mark.parametrize("op,mode", MODES)
def test_query_features_and_hist_planes(env, op, mode):
    jf, tf = _features(env, mode)
    want = {"overlap": {"csig", "fsig", "fcnt"},
            "coverage": {"csig", "fsig", "fcnt", "cplanes", "fplanes"}}[mode]
    assert set(jf) == set(tf) == want
    for name in want:
        assert _np(jf[name]).shape == tuple(tf[name].shape), name
        _eq(tf[name].numpy().astype(_np(jf[name]).dtype), jf[name])
    if mode == "coverage":
        # the planes hold each cell's point count: summed back, the
        # histogram totals are the valid points of each query
        p = tf["fplanes"].shape[1]
        bits = (tf["fplanes"][..., None] >> torch.arange(32)) & 1
        totals = (bits.sum(dim=(2, 3)) << torch.arange(p)).sum(dim=1)
        _eq(totals, env["val"].sum(axis=1))


@pytest.mark.parametrize("op,mode", MODES)
def test_slot_bounds_and_node_frontier(env, op, mode):
    jf, tf = _features(env, mode)
    r2 = 1 << (2 * join_search.FINE_DELTA)
    jub = jjoin._slot_bounds(env["jrepo"], jf, mode, r2)
    tub = join_search._slot_bounds(env["trepo"], tf, mode, r2)
    assert tub.dtype == torch.int32
    _eq(tub, jub)
    assert env["trepo"].repo.depth >= 2
    for tau in ([-1, -1, -1, -1], [0, 3, 40, 1], [5, 0, 2, 1000]):
        t = np.asarray(tau, np.int32)
        got = join_search._node_frontier(env["trepo"], tf, torch.from_numpy(t),
                                         mode, r2)
        want = jjoin._node_frontier(env["jrepo"], jf, jnp.asarray(t), mode,
                                    r2)
        assert got.dtype == torch.int32
        _eq(got, want)


@pytest.mark.parametrize("chunk", [8, 32])
@pytest.mark.parametrize("op,mode", MODES)
def test_topk_join_scores(env, op, mode, chunk):
    """Exact scores and the three counters, pruned (chunk 8) and in one
    chunk (chunk = S)."""
    assert env["trepo"].n_slots == 32
    got = join_search.topk_join_scores(
        env["trepo"], torch.from_numpy(env["pts"]),
        torch.from_numpy(env["val"]), K, mode, chunk)
    want = jjoin.topk_join_scores(env["jrepo"], jnp.asarray(env["pts"]),
                                  jnp.asarray(env["val"]), K, mode, chunk)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        _eq(g, w)


def test_aliased_slot_zero_keeps_its_score(env):
    """S = 32 is not a multiple of chunk 17: the last chunk's padded tail
    names slot 0 again with score -1, and it runs, because it holds valid
    slots.  Slot 0 is the query's best match, so a write that let the -1
    win would drop it from the top-k."""
    q = env["datasets"][0]
    pts, val = plan_lib._stack_pointsets([q], 128)
    for op, mode in MODES:
        exact, _, _, evaluated = join_search.topk_join_scores(
            env["trepo"], torch.from_numpy(pts), torch.from_numpy(val), N_DS,
            mode, 17)
        assert int(evaluated[0]) == N_DS              # both chunks ran
        hv, hi = join_search.topk_join_host(env["trepo"], [q], N_DS, mode)
        assert hi[0, 0] == 0 and hv[0, 0] > 0
        # every valid slot was scored, each exactly as the host oracle
        _eq(exact[0, hi[0]], hv[0])
        assert (exact[0, N_DS:] == -1).all()
        res = QueryEngine(env["trepo"], result_cache_size=0,
                          default_chunk=17).search([Query(op=op, q=q, k=3)])
        _eq(res[0].ids, hi[0, :3])
        _eq(res[0].vals, hv[0, :3])


@pytest.mark.parametrize("op,mode", MODES)
def test_pair_scores(env, op, mode):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, N_DS, len(env["q_sets"]))
    jr, tr = env["jrepo"], env["trepo"]
    want = jjoin.pair_scores(jr, jr.ds_index.points[ids],
                             jr.ds_index.valid[ids], jnp.asarray(env["pts"]),
                             jnp.asarray(env["val"]), mode)
    t = torch.from_numpy(ids)
    got = join_search.pair_scores(tr, tr.ds_index.points[t],
                                  tr.ds_index.valid[t],
                                  torch.from_numpy(env["pts"]),
                                  torch.from_numpy(env["val"]), mode)
    assert got.dtype == torch.int32
    _eq(got, want)


@pytest.mark.parametrize("op,mode", MODES)
def test_engine_matches_jax_and_host_oracles(env, op, mode):
    q_sets, trepo = env["q_sets"], env["trepo"]
    for k in (K, trepo.n_slots):             # normal, overrun
        got = env["teng"].search([Query(op=op, q=q, k=k) for q in q_sets])
        want = env["jeng"].search([JQuery(op=op, q=q, k=k) for q in q_sets])
        hv, hi = join_search.topk_join_host(trepo, q_sets, k, mode)
        jv, ji = jjoin.topk_join_host(env["jrepo"], q_sets, k, mode)
        _eq(hv, jv)
        _eq(hi, ji)
        for i, (g, w) in enumerate(zip(got, want)):
            _eq(g.vals, w.vals)
            _eq(g.ids, w.ids)
            _eq(g.vals, hv[i])
            _eq(g.ids, hi[i])
            assert g.stats == w.stats
    # overrun rows carry -1 sentinels; the off-support query ties at 0
    # everywhere and ranks by slot id
    assert (got[0].vals < 0).any() and (got[0].ids[got[0].vals < 0] == -1).all()
    _eq(got[3].ids[:N_DS], np.arange(N_DS))


def test_default_chunk_changes_no_answer(env):
    q = env["datasets"][9]
    small = QueryEngine(env["trepo"], result_cache_size=0, default_chunk=8)
    full = QueryEngine(env["trepo"], result_cache_size=0, default_chunk=32)
    jsmall = JEngine(env["jrepo"], result_cache_size=0, default_chunk=8)
    for op, _ in MODES:
        r_s = small.search([Query(op=op, q=q, k=3)])[0]
        r_f = full.search([Query(op=op, q=q, k=3)])[0]
        j_s = jsmall.search([JQuery(op=op, q=q, k=3)])[0]
        _eq(r_s.vals, r_f.vals)
        _eq(r_s.ids, r_f.ids)
        assert r_s.stats == j_s.stats
        s = r_s.stats
        assert s.candidates_after_bounds <= s.exact_evaluations <= N_DS
        assert r_s.stats.exact_evaluations <= r_f.stats.exact_evaluations


def _pipelines(env):
    q = env["datasets"][3][:50]
    lo, hi = q.min(axis=0) - 5.0, q.max(axis=0) + 5.0
    specs = [
        (("topk_ia", dict(r_lo=lo, r_hi=hi, k=8)), ("topk_overlap",
                                                    dict(q=q, k=3))),
        (("topk_hausdorff", dict(q=q, k=5)), ("topk_coverage",
                                              dict(q=q, k=2))),
        (("topk_overlap", dict(q=q, k=5)), ("topk_coverage", dict(q=q, k=2))),
        (("topk_coverage", dict(q=q, k=4)), ("range_points",
                                             dict(r_lo=lo, r_hi=hi))),
        (("topk_overlap", dict(q=q, k=3)), ("nnp", dict(q=q))),
    ]
    return ([Pipeline(Query(op=a, **pa), Query(op=b, **pb))
             for (a, pa), (b, pb) in specs],
            [JPipeline(JQuery(op=a, **pa), JQuery(op=b, **pb))
             for (a, pa), (b, pb) in specs])


def test_pipelines_match_jax(env):
    """Dataset -> dataset (IA -> overlap, ExactHaus -> coverage, overlap ->
    coverage) and joinable-led dataset -> point pipelines, in one batch."""
    tp, jp = _pipelines(env)
    got = env["teng"].search(tp)
    want = env["jeng"].search(jp)
    for g, w, p in zip(got, want, tp):
        assert g.op == w.op == "pipeline"
        _eq(g.extras["ds_ids"], w.extras["ds_ids"])
        _eq(g.extras["valid"], w.extras["valid"])
        if p.point_stage.op == "nnp":
            continue       # below: jitted JAX distances may differ by 1 ulp
        for f in ("vals", "ids", "mask"):
            if getattr(w, f) is None:
                assert getattr(g, f) is None
            else:
                _eq(getattr(g, f), getattr(w, f))
    # the joinable-led NNP pipeline against the port's own point queries
    # over the stage-1 winners, bitwise
    nnp = [Query(op="nnp", ds_id=int(j), q=tp[4].point_stage.q)
           for j in got[4].extras["ds_ids"]]
    direct = QueryEngine(env["trepo"], result_cache_size=0).search(nnp)
    _eq(got[4].vals.view(np.uint32),
        np.stack([d.vals for d in direct]).view(np.uint32))
    _eq(got[4].ids, np.stack([d.ids for d in direct]))
    # the re-rank rows against a host baseline: stage-1 ids scored by the
    # oracle, a stable descending sort keeping stage-1 rank on ties
    full = {}
    for mode in ("overlap", "coverage"):
        v, i = join_search.topk_join_host(
            env["trepo"], [env["datasets"][3][:50]], env["trepo"].n_slots,
            mode)
        full[mode] = {int(a): int(b) for b, a in zip(v[0], i[0]) if a >= 0}
    for g, p in zip(got[:3], tp[:3]):
        mode = p.point_stage.op.split("_")[1]
        ids1 = np.asarray(g.extras["ds_ids"])
        sc = np.array([full[mode][int(d)] if d >= 0 else -1 for d in ids1])
        order = np.argsort(-sc, kind="stable")[:p.point_stage.k]
        _eq(g.vals, sc[order])
        _eq(g.ids, np.where(sc[order] < 0, -1, ids1[order]))


def test_pipelines_share_one_rerank_dispatch(env):
    engine = QueryEngine(env["trepo"], result_cache_size=0)
    q = env["datasets"][3][:50]
    lo, hi = q.min(axis=0) - 5.0, q.max(axis=0) + 5.0
    pipes = [Pipeline(Query(op="topk_ia", r_lo=lo, r_hi=hi, k=3),
                      Query(op="topk_overlap", q=q, k=2)),
             Pipeline(Query(op="topk_ia", r_lo=lo - 2, r_hi=hi + 2, k=5),
                      Query(op="topk_overlap", q=q, k=2))]
    assert plan_lib.count_groups(pipes, engine.leaf_capacity) == 3
    engine.search(pipes)
    # stage 1: the k=3 and k=5 IA groups; stage 2: one shared re-rank
    assert engine.stats.plan_groups == 3
    per = engine.stats.per_op["topk_overlap"]
    assert per["dispatches"] == 1 and per["queries"] == 8


def test_zero_surviving_winners_all_sentinel(env):
    """Every slot invalid (as after deleting every dataset): a standalone
    joinable query and both stage-2 flavours give all-sentinel output, as
    in the JAX package; the clamp to slot 0 never ranks slot 0."""
    jr = env["jrepo"]._replace(
        ds_valid=jnp.zeros_like(env["jrepo"].ds_valid))
    tr = env["trepo"]._replace(
        ds_valid=torch.zeros_like(env["trepo"].ds_valid))
    teng = QueryEngine(tr, result_cache_size=0)
    jeng = JEngine(jr, result_cache_size=0)
    q = env["datasets"][0][:16]
    lo, hi = q.min(axis=0) - 50.0, q.max(axis=0) + 50.0
    items = [("topk_overlap", dict(q=q, k=3)),
             ("pipeline", (("topk_ia", dict(r_lo=lo, r_hi=hi, k=3)),
                           ("topk_coverage", dict(q=q, k=2)))),
             ("pipeline", (("topk_ia", dict(r_lo=lo, r_hi=hi, k=3)),
                           ("range_points", dict(r_lo=lo, r_hi=hi))))]

    def specs(Q, P):
        return [Q(op=op, **p) if op != "pipeline"
                else P(Q(op=p[0][0], **p[0][1]), Q(op=p[1][0], **p[1][1]))
                for op, p in items]

    got = teng.search(specs(Query, Pipeline))
    want = jeng.search(specs(JQuery, JPipeline))
    _eq(got[0].vals, [-1, -1, -1])
    _eq(got[0].ids, [-1, -1, -1])
    _eq(got[1].extras["ds_ids"], [-1, -1, -1])
    assert not got[1].extras["valid"].any()
    _eq(got[1].vals, [-1, -1])
    _eq(got[1].ids, [-1, -1])
    assert not got[1].mask.any()
    assert not got[2].mask.any() and not got[2].extras["valid"].any()
    for g, w in zip(got, want):
        for f in ("vals", "ids", "mask"):
            if getattr(w, f) is not None:
                _eq(getattr(g, f), getattr(w, f))


def test_result_cache_hits(env):
    engine = QueryEngine(env["trepo"], result_cache_size=64)
    q = env["datasets"][3][:50]
    batch = [Query(op="topk_overlap", q=q, k=4),
             Query(op="topk_coverage", q=q, k=4),
             Query(op="topk_overlap", q=q, k=4)]           # an in-batch twin
    r0 = engine.search(batch)
    assert engine.stats.result_cache_hits == 1
    assert engine.stats.result_cache_misses == 2
    d0 = engine.stats.dispatches
    r1 = engine.search(batch)
    assert engine.stats.result_cache_hits == 1 + len(batch)
    assert engine.stats.dispatches == d0            # nothing dispatched
    for a, b in zip(r0, r1):
        _eq(a.vals, b.vals)
        _eq(a.ids, b.ids)
        assert a.stats == b.stats
    _eq(r0[0].vals, r0[2].vals)
    # another k is another key
    engine.search([Query(op="topk_overlap", q=q, k=5)])
    assert engine.stats.dispatches == d0 + 1


def test_every_op_is_ported():
    assert plan_lib.ROADMAP_ITEM == {}
    assert set(plan_lib.PORTED_OPS) == set(OPS)

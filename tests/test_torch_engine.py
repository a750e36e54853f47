"""The whole slice: raw points -> build -> ``QueryEngine.search``, through
the port and through the JAX package, on the same numpy datasets.

* Port vs JAX: vals to ``rtol=1e-6`` (jitted XLA:CPU may contract
  ``d0*d0 + d1*d1`` into an FMA), ids exactly with near-ties compared as
  sets, SearchStats exactly.
* The port's result on its own build equals its result on the bridged JAX
  build bitwise (vals) and exactly (ids): Hausdorff values come from raw
  point coordinates, and the bounds, whose node centers differ from XLA's
  by ulps, only decide pruning.
"""
import jax
import numpy as np
import pytest
import torch  # noqa: F401  (both packages load in one process)

from repro.core.build import build_repository as jbuild
from repro.engine import Query as JQuery
from repro.engine import QueryEngine as JEngine
from repro_torch import bridge
from repro_torch.core.build import build_repository
from repro_torch.data import synthetic
from repro_torch.engine import Pipeline, Query, QueryEngine
from test_torch_exacthaus import assert_bitwise, assert_topk_close

K = 5


@pytest.fixture(scope="module")
def env():
    datasets = synthetic.trajectory_repository(40, seed=1, n_points=(30, 300))
    q_sets = synthetic.trajectory_repository(6, seed=7, n_points=(30, 300))
    q_sets = q_sets + [q_sets[2]]                  # an in-batch duplicate
    jrepo, _ = jbuild(datasets, leaf_capacity=16, theta=5,
                      remove_outliers=True)
    trepo, _ = build_repository(datasets, leaf_capacity=16, theta=5,
                                remove_outliers=True, device="cpu")
    bridged = bridge.repository_to_torch(jax.tree.map(np.asarray, jrepo),
                                         device="cpu")
    jres = JEngine(jrepo, result_cache_size=0).search(
        [JQuery(op="topk_hausdorff", q=q, k=K) for q in q_sets])
    return datasets, q_sets, trepo, bridged, jres


def _queries(q_sets, **kw):
    return [Query(op="topk_hausdorff", q=q, k=K, **kw) for q in q_sets]


def test_search_matches_jax(env):
    _, q_sets, trepo, _, jres = env
    res = QueryEngine(trepo, result_cache_size=0).search(_queries(q_sets))
    assert len(res) == len(q_sets)
    for r, j in zip(res, jres):
        assert r.op == "topk_hausdorff"
        assert r.vals.shape == (K,) and r.ids.shape == (K,)
        assert_topk_close(r.vals, r.ids, j.vals, j.ids)
        assert r.stats == j.stats


@pytest.mark.parametrize("chunk", [32, 8])
def test_own_build_equals_bridged_build(env, chunk):
    _, q_sets, trepo, bridged, _ = env
    own = QueryEngine(trepo, result_cache_size=0).search(
        _queries(q_sets, chunk=chunk))
    via = QueryEngine(bridged, result_cache_size=0).search(
        _queries(q_sets, chunk=chunk))
    for a, b in zip(own, via):
        assert_bitwise(a.vals, b.vals)
        np.testing.assert_array_equal(a.ids, b.ids)


def test_result_cache_counters(env):
    _, q_sets, trepo, _, _ = env
    engine = QueryEngine(trepo, result_cache_size=16)
    first = engine.search(_queries(q_sets))
    # 7 rows, one a duplicate of another: 6 dispatched, 1 rides its twin
    assert engine.stats.result_cache_misses == 6
    assert engine.stats.result_cache_hits == 1
    assert engine.stats.queries == 7
    per = engine.stats.per_op["topk_hausdorff"]
    d0 = per["dispatches"]
    again = engine.search(_queries(q_sets[:3]))
    assert per["dispatches"] == d0                # all served from the LRU
    assert engine.stats.result_cache_hits == 4
    for a, b in zip(again, first):
        assert_bitwise(a.vals, b.vals)
        np.testing.assert_array_equal(a.ids, b.ids)
    assert per["queries"] == 10


def test_engine_stats_and_padding(env):
    _, q_sets, trepo, _, _ = env
    engine = QueryEngine(trepo, result_cache_size=0)
    res = engine.search(_queries(q_sets[:5]))
    # one query-index build plus one ExactHaus dispatch, padded 5 -> 8
    assert engine.stats.dispatches == 2
    assert engine.stats.padded_queries == 3
    assert engine.stats.plan_groups == 1
    per = engine.stats.per_op["topk_hausdorff"]
    assert per["exact_evaluations"] == sum(r.stats.exact_evaluations
                                           for r in res)


UNPORTED = [
    Query(op="topk_overlap", q=np.ones((4, 2), np.float32), k=3),
    Query(op="topk_coverage", q=np.ones((4, 2), np.float32), k=3),
    Pipeline(Query(op="topk_overlap", q=np.ones((4, 2), np.float32), k=3),
             Query(op="nnp", q=np.ones((4, 2), np.float32))),
    Pipeline(Query(op="topk_gbo", q_sig=np.zeros(32, np.uint32), k=3),
             Query(op="topk_coverage", q=np.ones((4, 2), np.float32), k=2)),
]


@pytest.mark.parametrize("item", UNPORTED, ids=[
    "topk_overlap", "topk_coverage", "pipeline", "pipeline_rerank"])
def test_unported_ops_raise(env, item, monkeypatch):
    """The joinable ops, once refused here, now run beside ExactHaus in one
    batch, each as it runs alone.  The planner still checks a whole batch
    before anything runs: an op missing from ``PORTED_OPS`` raises
    ``NotImplementedError`` naming its ROADMAP item, and nothing
    dispatches."""
    from repro_torch.engine import plan as plan_lib

    _, q_sets, trepo, _, _ = env
    engine = QueryEngine(trepo, result_cache_size=0)
    both = engine.search([Query(op="topk_hausdorff", q=q_sets[0], k=K),
                          item])
    alone = QueryEngine(trepo, result_cache_size=0).search([item])[0]
    for f in ("vals", "ids", "mask"):
        a, b = getattr(both[1], f), getattr(alone, f)
        assert (a is None and b is None) or np.array_equal(a, b)

    monkeypatch.setattr(plan_lib, "PORTED_OPS", tuple(
        op for op in plan_lib.PORTED_OPS
        if op not in ("topk_overlap", "topk_coverage")))
    monkeypatch.setattr(plan_lib, "ROADMAP_ITEM",
                        {"topk_overlap": 8, "topk_coverage": 8})
    engine = QueryEngine(trepo, result_cache_size=0)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md queue 1 item 8"):
        engine.search([Query(op="topk_hausdorff", q=q_sets[0], k=K), item])
    assert engine.stats.dispatches == 0       # nothing ran

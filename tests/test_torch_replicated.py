"""The port's ReplicatedQueryEngine against its own QueryEngine.

An R x D (replica, data) grid of ``device="cpu"`` entries: every group of
D shards holds the whole repository, and each dispatch's rows are split
over the R groups.  On the (2, 2), (4, 1), (1, 4) and (3, 1) grids every
op, both pipeline kinds and the join re-rank equal the local engine
bitwise, also for batches smaller than R (rows padded with copies of row
0).  The result cache answers before the rows are split, and the
planner's replica accounting (``replica_subgroups``, ``group_counts``)
equals the JAX package's: its ``ReplicatedDispatcher.row_subgroups`` over
the groups its own planner forms for the same batch.
"""
import dataclasses
import types

import pytest

from repro.engine import Pipeline as JPipeline
from repro.engine import Query as JQuery
from repro.engine import plan as jplan
from repro.engine.replicated import ReplicatedDispatcher as JReplicated
from repro_torch.engine import (Pipeline, Query, QueryEngine,
                                ReplicatedQueryEngine, replica_mesh)
from repro_torch.launch.mesh import make_serving_mesh
from test_torch_sharded import (assert_results_bitwise, every_op_batch,
                                make_env)

GRIDS = [(2, 2), (4, 1), (1, 4), (3, 1)]


def _engine(repo, R, D, **kw):
    return ReplicatedQueryEngine(
        repo, mesh=replica_mesh(R, D, ["cpu"] * (R * D)), **kw)


@pytest.fixture(scope="module")
def env():
    e = make_env()
    e.batch = every_op_batch(e)
    e.want = QueryEngine(e.repo, result_cache_size=0).search(e.batch)
    return e


@pytest.mark.parametrize("R,D", GRIDS)
def test_every_op_bitwise(env, R, D):
    engine = _engine(env.repo, R, D, result_cache_size=0)
    d = engine.dispatch
    assert (d.n_replicas, d.n_shards) == (R, D)
    assert len(d.groups) == R and engine.repo is None
    assert_results_bitwise(engine.search(env.batch), env.want)


@pytest.mark.parametrize("R,D", [(4, 1), (3, 1), (2, 2)])
def test_batches_below_the_replica_count(env, R, D):
    """A batch of 1 (and of 2) on R groups: the groups without a real row
    run copies of row 0, and the answer is the unsplit one."""
    q = env.q_sets[2]
    for items in (
            [Query(op="topk_hausdorff", q=q, k=5)],
            [Query(op="topk_hausdorff", q=q, k=5),
             Query(op="topk_hausdorff", q=env.q_sets[4], k=5),
             Query(op="nnp", ds_id=3, q=q),
             Query(op="topk_overlap", q=q, k=4)]):
        want = QueryEngine(env.repo, result_cache_size=0).search(items)
        got = _engine(env.repo, R, D, result_cache_size=0).search(items)
        assert_results_bitwise(got, want)


def test_result_cache_answers_before_the_split(env):
    """A repeat is answered by the result cache: no row reaches a group,
    and the answer is the first one.  The planner books its groups either
    way (a planning-level count, as in the JAX package)."""
    engine = _engine(env.repo, 2, 2)
    items = env.batch[:30]
    first = engine.search(items)
    per0 = {op: dict(v) for op, v in engine.stats.per_op.items()}
    sub0 = engine.stats.replica_subgroups
    again = engine.search(items)
    for op in ("topk_hausdorff", "topk_ia", "range_points", "nnp"):
        assert (engine.stats.per_op[op]["dispatches"]
                == per0[op]["dispatches"])
    assert engine.stats.replica_subgroups == 2 * sub0
    assert_results_bitwise(again, first)
    assert_results_bitwise(first, env.want[:30])


def _jax_items(items):
    """The same batch as the JAX package's Query / Pipeline (the two
    packages' specs have the same fields)."""
    def one(q):
        return JQuery(**{f.name: getattr(q, f.name)
                         for f in dataclasses.fields(q)})

    return [JPipeline(one(it.dataset_stage), one(it.point_stage))
            if isinstance(it, Pipeline) else one(it) for it in items]


@pytest.mark.parametrize("R", [2, 3, 4])
def test_replica_accounting_matches_jax(env, R):
    """``replica_subgroups`` and ``group_counts`` of a mixed batch equal
    what the JAX package books: its ``row_subgroups`` (through the JAX
    engine's bucket ladder) summed over the groups its planner forms."""
    engine = _engine(env.repo, R, 1, result_cache_size=0)
    engine.search(env.batch)
    jitems = _jax_items(env.batch)
    jd = types.SimpleNamespace(n_replicas=R)
    want, counts = 0, {}
    for g in jplan.plan(jitems):
        n = JReplicated.row_subgroups(jd, len(g.rows),
                                      engine.bucket_for(len(g.rows)))
        want += n
        counts[g.op] = counts.get(g.op, 0) + n
    stage2 = {}                     # the JAX planner's stage-2 groups
    for it in jitems:
        if isinstance(it, JPipeline):
            key = jplan._stage2_key(it.point_stage, engine.leaf_capacity)
            stage2[key] = stage2.get(key, 0) + it.dataset_stage.k
    assert len(stage2) == 4         # two RangeP pipelines share a group
    for key, total in stage2.items():
        n = JReplicated.row_subgroups(jd, total, engine.bucket_for(total))
        want += n
        counts[key[0]] = counts.get(key[0], 0) + n
    s = engine.stats
    assert s.replica_subgroups == want
    assert s.group_counts == counts
    assert s.plan_groups <= s.replica_subgroups <= s.plan_groups * R
    assert sum(s.group_counts.values()) == s.replica_subgroups


def test_serving_mesh_and_refusals():
    """make_serving_mesh is replica_mesh; a grid larger than the list
    raises, and R must be positive."""
    mesh = make_serving_mesh(2, None, ["cpu"] * 5)
    assert mesh.shape == {"replica": 2, "data": 2}
    with pytest.raises(ValueError, match="6 devices requested but only 4"):
        replica_mesh(3, 2, ["cpu"] * 4)
    with pytest.raises(ValueError, match="n_replicas must be >= 1"):
        replica_mesh(0, 1, ["cpu"])

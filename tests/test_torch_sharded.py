"""The port's ShardedQueryEngine against its own QueryEngine, and its
counters against the JAX package's ShardedQueryEngine.

Every op of ``OPS``, both pipeline kinds and the join re-rank run on
``device="cpu"`` meshes of 1, 3 and 8 shards (``data_mesh(devices=["cpu"]
* N)``, the counterpart of forced host devices) and must equal the local
engine bitwise: vals, ids and masks, no tolerance.  Covered: ExactHaus
ties from cloned datasets; batch sizes below, at and above a bucket
boundary; top-k past the valid count (-1 ids); the 64 -> 66 slot padding
of a 3-shard mesh; per-shard resident bytes of total / N.

The counters that depend on the split (ExactHaus's ``exact_evaluations``,
the joinable ``nodes_evaluated``, ``candidates_after_bounds`` and
``exact_evaluations``) equal the JAX package's ShardedQueryEngine at 8
shards on the same repository: the JAX side runs once for the module in a
subprocess with 8 forced host devices (``conftest.run_py``) and hands its
repository and counters over in an ``.npz``.  There ids and counters are
compared exactly and Hausdorff values to ``rtol=1e-6`` (jitted XLA:CPU may
contract ``d0*d0 + d1*d1`` into an FMA).
"""
import types

import numpy as np
import pytest
import torch

from conftest import make_clustered_datasets, run_py
from repro_torch import bridge
from repro_torch.core import search, zorder
from repro_torch.core.build import build_repository
from repro_torch.engine import (Pipeline, Query, QueryEngine,
                                ShardedQueryEngine, data_mesh)
from repro_torch.engine.sharded import repo_device_bytes
from torch_lm_parity import one_torch_thread  # noqa: F401

THETA = 5
K = 6
#: seconds the JAX subprocess may take (it compiles the sharded programs)
JAX_TIMEOUT = 300


def _cpu_mesh(n):
    return data_mesh(devices=["cpu"] * n)


def make_env(n_datasets=33, seed=2):
    """The repository of the JAX package's sharded tests (33 datasets of
    30-120 points in 64 slots) with 5 query sets, their signatures, boxes
    and the ApproHaus eps."""
    datasets = make_clustered_datasets(n_datasets, seed=seed,
                                       n_points=(30, 120))
    repo, _ = build_repository(datasets, leaf_capacity=16, theta=THETA,
                               remove_outliers=False, device="cpu")
    q_sets = [datasets[i % n_datasets] for i in (0, 3, 9, 11, 20)]
    pts = [torch.as_tensor(q)[None] for q in q_sets]
    sigs = [zorder.signature(p, torch.ones(p.shape[:2], dtype=torch.bool),
                             repo.space_lo, repo.space_hi, THETA)[0]
            .numpy().astype(np.uint32) for p in pts]
    eps = float(zorder.default_epsilon(repo.space_lo, repo.space_hi, THETA))
    rng = np.random.default_rng(5)
    lo = rng.uniform(-60, 40, (5, 2)).astype(np.float32)
    hi = lo + rng.uniform(5, 40, (5, 2)).astype(np.float32)
    return types.SimpleNamespace(datasets=datasets, repo=repo, q_sets=q_sets,
                                 sigs=sigs, eps=eps, lo=lo, hi=hi)


def every_op_batch(env):
    """Every op of ``OPS`` for each of the 5 query rows (k = K and k past
    the valid count), and the five pipeline kinds (dataset -> RangeP /
    NNP / overlap / coverage; one with every stage-1 winner past the
    valid count)."""
    n = env.repo.n_slots
    lo, hi, qs, sigs = env.lo, env.hi, env.q_sets, env.sigs
    batch = []
    for i in range(5):
        batch += [
            Query(op="range_search", r_lo=lo[i], r_hi=hi[i]),
            Query(op="topk_ia", r_lo=lo[i], r_hi=hi[i], k=(K, n)[i % 2]),
            Query(op="topk_gbo", q_sig=sigs[i], k=(K, n)[i % 2]),
            Query(op="topk_hausdorff_approx", q=qs[i], k=K, eps=env.eps),
            Query(op="topk_hausdorff", q=qs[i], k=K),
            Query(op="topk_hausdorff", q=qs[i], k=n),
            Query(op="range_points", ds_id=(7 + 5 * i) % 33, r_lo=lo[i],
                  r_hi=hi[i]),
            Query(op="nnp", ds_id=(4 + 7 * i) % 33, q=qs[i]),
            Query(op="topk_overlap", q=qs[i], k=(K, n)[i % 2]),
            Query(op="topk_coverage", q=qs[i], k=K)]
    batch += [
        Pipeline(Query(op="topk_ia", r_lo=lo[4], r_hi=hi[4], k=3),
                 Query(op="range_points", r_lo=lo[3], r_hi=hi[3])),
        Pipeline(Query(op="topk_gbo", q_sig=sigs[1], k=3),
                 Query(op="nnp", q=qs[3])),
        Pipeline(Query(op="topk_ia", r_lo=lo[0], r_hi=hi[0], k=n),
                 Query(op="range_points", r_lo=lo[1], r_hi=hi[1])),
        Pipeline(Query(op="topk_ia", r_lo=lo[2], r_hi=hi[2], k=5),
                 Query(op="topk_overlap", q=qs[2], k=3)),
        Pipeline(Query(op="topk_hausdorff_approx", q=qs[0], k=5,
                       eps=env.eps),
                 Query(op="topk_coverage", q=qs[1], k=3))]
    return batch


def assert_results_bitwise(got, want):
    """vals, ids and masks of two result lists: same dtype, same bytes."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.op == b.op
        fields = ("vals", "ids", "mask")
        if a.op == "pipeline":
            fields += ("ds_ids",)
        for f in fields:
            x = a.extras[f] if f == "ds_ids" else getattr(a, f)
            y = b.extras[f] if f == "ds_ids" else getattr(b, f)
            assert (x is None) == (y is None), (a.op, f)
            if x is not None:
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype and x.shape == y.shape, (a.op, f)
                assert x.tobytes() == y.tobytes(), (a.op, f)


@pytest.fixture(scope="module")
def env():
    e = make_env()
    e.batch = every_op_batch(e)
    e.want = QueryEngine(e.repo, result_cache_size=0).search(e.batch)
    return e


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_every_op_bitwise(env, n_shards):
    engine = ShardedQueryEngine(env.repo, mesh=_cpu_mesh(n_shards),
                                result_cache_size=0)
    got = engine.search(env.batch)
    assert_results_bitwise(got, env.want)
    for a, b in zip(got, env.want):
        if a.op == "topk_hausdorff":
            # the bound phases are slot-deterministic; phase 2's schedule
            # is the split's, within the candidates
            assert a.stats[:2] == b.stats[:2]
            assert 0 < a.stats.exact_evaluations \
                <= a.stats.candidates_after_bounds
    assert engine.stats.plan_groups == engine.stats.replica_subgroups


def test_slot_padding_and_placement(env):
    """64 slots on 3 shards pad to 66; the shards hold disjoint copies,
    none holds the whole repository, and the engine keeps none."""
    engine = ShardedQueryEngine(env.repo, mesh=_cpu_mesh(3))
    d = engine.dispatch
    assert (d.n_shards, d.n_slots_sharded, d.shard_slots) == (3, 66, 22)
    assert engine.repo is None and engine.device == torch.device("cpu")
    assert not d.shards[2].ds_valid[-2:].any()
    ptrs = {sh.ds_sigs.data_ptr() for sh in d.shards}
    assert len(ptrs) == 3 and env.repo.ds_sigs.data_ptr() not in ptrs


@pytest.mark.parametrize("n_shards", [8, 4])
def test_per_shard_bytes(env, n_shards):
    """Resident bytes per shard: 1/N of the slot arrays plus the upper
    tree and space bounds, which every shard holds whole."""
    repo = env.repo
    d = ShardedQueryEngine(repo, mesh=_cpu_mesh(n_shards)).dispatch
    replicated = sum(t.numel() * t.element_size()
                     for t in (*repo.repo, repo.space_lo, repo.space_hi))
    slots = repo.nbytes() - replicated
    per = repo_device_bytes(d.shards)
    assert per == [slots // n_shards + replicated] * n_shards
    assert replicated < slots // 4


@pytest.mark.parametrize("n_shards", [8, 3])
def test_exacthaus_ties(n_shards):
    """Cloned datasets give equal LBs and equal exact values at the top-k
    boundary: every split returns the local engine's and the host
    oracle's ids (ties toward the smaller slot id)."""
    base = make_clustered_datasets(9, seed=7, n_points=(20, 50))
    datasets = base + [d.copy() for d in base] + base[:4]
    repo, _ = build_repository(datasets, leaf_capacity=16, theta=THETA,
                               remove_outliers=False, device="cpu")
    items = [Query(op="topk_hausdorff", q=q, k=k, chunk=4)
             for q in (base[0], base[4]) for k in (5, 9, 18, repo.n_slots)]
    want = QueryEngine(repo, result_cache_size=0).search(items)
    got = ShardedQueryEngine(repo, mesh=_cpu_mesh(n_shards),
                             result_cache_size=0).search(items)
    assert_results_bitwise(got, want)
    q_idx = QueryEngine(repo).build_queries([base[0]])
    q1 = type(q_idx)(*[x[0] for x in q_idx])
    for pos, k in ((1, 9), (2, 18)):        # items[pos]: base[0] at k
        vals, ids, _ = search.topk_hausdorff_host(repo, q1, k, chunk=4)
        res = got[pos]
        assert res.vals.tobytes() == vals.numpy().tobytes()
        np.testing.assert_array_equal(res.ids, ids.numpy())
    assert len(set(np.asarray(want[1].vals).tolist())) < 9   # ties exist


@pytest.mark.parametrize("B", [7, 8, 9])
def test_bucket_boundaries(env, B):
    """Batch sizes below, at and above the bucket of 8 (padding rows are
    copies of row 0 on every shard)."""
    rng = np.random.default_rng(B)
    lo = rng.uniform(-60, 40, (B, 2)).astype(np.float32)
    hi = lo + rng.uniform(5, 40, (B, 2)).astype(np.float32)
    ids = rng.integers(0, 33, B)
    items = []
    for i in range(B):
        q = env.q_sets[i % 5][: 30 + 7 * i]
        items += [Query(op="topk_hausdorff", q=q, k=K),
                  Query(op="topk_ia", r_lo=lo[i], r_hi=hi[i], k=K),
                  Query(op="range_points", ds_id=int(ids[i]), r_lo=lo[i],
                        r_hi=hi[i]),
                  Query(op="nnp", ds_id=int(ids[i]), q=q),
                  Query(op="topk_coverage", q=q, k=K)]
    want = QueryEngine(env.repo, result_cache_size=0).search(items)
    for n in (3, 8):
        engine = ShardedQueryEngine(env.repo, mesh=_cpu_mesh(n),
                                    result_cache_size=0)
        assert_results_bitwise(engine.search(items), want)


def test_result_cache_on_a_mesh(env):
    """The result cache sits above the dispatcher: a repeat is served
    from it (only the query-tree builds run again), bitwise as the first
    answer."""
    engine = ShardedQueryEngine(env.repo, mesh=_cpu_mesh(3))
    items = env.batch[:20]
    first = engine.search(items)
    m0, h0 = engine.stats.result_cache_misses, engine.stats.result_cache_hits
    again = engine.search(items)
    assert engine.stats.result_cache_misses == m0
    assert engine.stats.result_cache_hits == h0 + len(items)
    assert_results_bitwise(again, first)
    assert_results_bitwise(first, env.want[:20])


def test_mesh_requests_are_exact():
    """A request larger than the device list raises; the list is never cut
    or widened on its own."""
    with pytest.raises(ValueError, match="4 devices requested but only 2"):
        data_mesh(4, devices=["cpu"] * 2)
    mesh = data_mesh(2, devices=["cpu"] * 5)
    assert mesh.shape == {"data": 2}
    assert mesh.flat == [torch.device("cpu")] * 2


# ---------------------------------------------------------------------------
# counters against the JAX package's ShardedQueryEngine at 8 shards
# ---------------------------------------------------------------------------

COUNTER_ITEMS = (("topk_hausdorff", 3), ("topk_overlap", 3),
                 ("topk_coverage", 3))
#: a small refine chunk, so that the schedule shows in the counters
CHUNK = 2

_JAX_SIDE = """
import numpy as np, jax
from conftest import make_clustered_datasets
from repro.core.build import build_repository
from repro.engine import Query, ShardedQueryEngine
from repro.engine.sharded import data_mesh

datasets = make_clustered_datasets(33, seed=2, n_points=(30, 120))
repo, _ = build_repository(datasets, leaf_capacity=16, theta=5,
                           remove_outliers=False)
q_sets = [datasets[i % 33] for i in (0, 3, 9, 11, 20)]
engine = ShardedQueryEngine(repo, mesh=data_mesh(8), result_cache_size=0)
engine.default_chunk = {chunk}
items = [Query(op=op, q=q, k=k, **({{"chunk": {chunk}}}
                                   if op == "topk_hausdorff" else {{}}))
         for op, k in {items} for q in q_sets]
res = engine.search(items)
out = {{"/".join(p): np.asarray(x) for p, x in
       jax.tree_util.tree_flatten_with_path(repo)[0]
       for p in [tuple(getattr(k, "name", str(k)) for k in p)]}}
out["counters"] = np.asarray([tuple(r.stats)[:3] for r in res])
out["vals"] = np.stack([np.asarray(r.vals, np.float64) for r in res])
out["ids"] = np.stack([np.asarray(r.ids) for r in res])
np.savez({path!r}, **out)
print("JAX_SIDE_OK")
"""


def _unflatten(z, prefix, fields):
    return types.SimpleNamespace(**{f: z[f"{prefix}{f}"] for f in fields})


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    from repro.core.index import DatasetIndex as JIndex
    from repro.core.repo_index import RepoIndex as JRepoIndex

    path = str(tmp_path_factory.mktemp("jax_sharded") / "side.npz")
    out = run_py(_JAX_SIDE.format(chunk=CHUNK, items=COUNTER_ITEMS,
                                  path=path), devices=8, timeout=JAX_TIMEOUT)
    assert "JAX_SIDE_OK" in out
    z = np.load(path)
    jrepo = types.SimpleNamespace(
        ds_index=_unflatten(z, "ds_index/", JIndex._fields),
        ds_sigs=z["ds_sigs"], ds_valid=z["ds_valid"],
        repo=_unflatten(z, "repo/", JRepoIndex._fields),
        space_lo=z["space_lo"], space_hi=z["space_hi"])
    return bridge.repository_to_torch(jrepo, device="cpu"), z


def test_counters_match_jax_sharded(jax_sharded):
    """On the JAX package's repository (bridged), the port's 8-shard
    engine gives the JAX 8-shard engine's results and every counter:
    ExactHaus (nodes, candidates after bounds, evaluated) and the joinable
    ops (nodes, candidates, evaluated).  The local engine's evaluated
    differ from them: the test sees the schedule."""
    repo, z = jax_sharded
    datasets = make_clustered_datasets(33, seed=2, n_points=(30, 120))
    q_sets = [datasets[i % 33] for i in (0, 3, 9, 11, 20)]
    items = [Query(op=op, q=q, k=k,
                   **({"chunk": CHUNK} if op == "topk_hausdorff" else {}))
             for op, k in COUNTER_ITEMS for q in q_sets]
    got = ShardedQueryEngine(repo, mesh=_cpu_mesh(8), result_cache_size=0,
                             default_chunk=CHUNK).search(items)
    local = QueryEngine(repo, result_cache_size=0,
                        default_chunk=CHUNK).search(items)
    counters = np.asarray([tuple(r.stats)[:3] for r in got])
    np.testing.assert_array_equal(counters, z["counters"])
    np.testing.assert_array_equal(np.stack([r.ids for r in got]), z["ids"])
    np.testing.assert_allclose(np.stack([r.vals for r in got]), z["vals"],
                               rtol=1e-6)
    assert_results_bitwise(got, local)
    local_ev = [r.stats.exact_evaluations for r in local]
    assert local_ev != counters[:, 2].tolist()

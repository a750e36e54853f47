"""ExactHaus in the port against the JAX package, on one index.

The repository and the query trees are built by JAX and carried across with
``repro_torch.bridge``, so both packages search the same index.

* Port vs JAX: vals to ``rtol=1e-6`` (jitted XLA:CPU may contract
  ``d0*d0 + d1*d1`` into an FMA, about one ulp), ids exactly except inside
  groups of values within that tolerance of each other, which are compared
  as sets; the SearchStats counters exactly.
* Inside the port: the batched pipeline and the host oracle
  ``topk_hausdorff_host`` agree bitwise on vals, exactly on ids and
  counters.
"""
import jax
import numpy as np
import pytest
import torch

from conftest import make_clustered_datasets
from repro.core import search as jsearch
from repro.core.build import build_repository as jbuild
from repro.engine import QueryEngine as JEngine
from repro_torch import bridge
from repro_torch.core import search
from repro_torch.engine import Query, QueryEngine
from repro_torch.kernels.ref import BIG
from torch_lm_parity import one_torch_thread  # noqa: F401

RTOL = 1e-6
K = 6


def assert_topk_close(got_v, got_i, want_v, want_i, rtol=RTOL):
    """vals to rtol; ids exactly, except that positions whose values lie
    within rtol of each other form a group compared as a set (a group cut
    by the k boundary is compared by size only)."""
    got_v, want_v = np.asarray(got_v), np.asarray(want_v)
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    np.testing.assert_allclose(got_v, want_v, rtol=rtol)
    if np.array_equal(got_i, want_i):
        return
    k = len(want_v)
    start = 0
    while start < k:
        end = start + 1
        while end < k and abs(want_v[end] - want_v[end - 1]) <= \
                rtol * abs(want_v[end]):
            end += 1
        if end < k or start == 0:
            assert set(got_i[start:end]) == set(want_i[start:end]), (
                got_i, want_i)
        start = end


def assert_bitwise(a, b):
    np.testing.assert_array_equal(np.asarray(a, np.float32).view(np.uint32),
                                  np.asarray(b, np.float32).view(np.uint32))


def _row(batch, i):
    return jax.tree.map(lambda x: x[i], batch)


@pytest.fixture(scope="module", params=["clustered", "outliers"])
def env(request):
    if request.param == "clustered":
        # 33 datasets -> 64 slots, so k can overrun the valid count
        datasets = make_clustered_datasets(33, seed=2, n_points=(30, 120))
        remove = False
    else:
        rng = np.random.default_rng(9)
        datasets = make_clustered_datasets(20, seed=9, n_points=(20, 200))
        datasets = [np.concatenate([d, rng.uniform(150, 200, (2, 2))
                                    .astype(np.float32)]) for d in datasets]
        remove = True
    jrepo, _ = jbuild(datasets, leaf_capacity=16, theta=5,
                      remove_outliers=remove)
    trepo = bridge.repository_to_torch(jax.tree.map(np.asarray, jrepo),
                                       device="cpu")
    jengine = JEngine(jrepo, result_cache_size=0)
    # ragged point counts, and a duplicate query (0 twice)
    q_sets = [datasets[i] for i in (0, 3, 9, 0, 11)]
    jq = jengine.build_queries(q_sets)
    tq = bridge.index_to_torch(jax.tree.map(np.asarray, jq), device="cpu")
    return datasets, jrepo, trepo, jq, tq


@pytest.mark.parametrize("chunk", [32, 8])
def test_batched_matches_jax(env, chunk):
    _, jrepo, trepo, jq, tq = env
    tv, ti, tn, tc, te = search._topk_hausdorff_device_batched(
        trepo, tq, K, 3, chunk)
    jv, ji, jn, jc, je = jsearch._topk_hausdorff_device_batched(
        jrepo, jq, k=K, refine_levels=3, chunk=chunk)
    for b in range(tv.shape[0]):
        assert_topk_close(tv[b], ti[b], jv[b], ji[b])
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


@pytest.mark.parametrize("overrun", [False, True])
def test_host_oracle_matches_jax_and_batched(env, overrun):
    """The port's host oracle against JAX's, and the port's batched
    pipeline against its own oracle (bitwise).  ``overrun`` takes k past
    the valid count: the tail is BIG on padded slots, smallest ids first."""
    datasets, jrepo, trepo, jq, tq = env
    k = len(datasets) + 7 if overrun else K
    tv, ti, tn, tc, te = search._topk_hausdorff_device_batched(
        trepo, tq, k, 3, 32)
    for b in range(tq.points.shape[0]):
        row = type(tq)(*[x[b] for x in tq])
        hv, hi, hs = search.topk_hausdorff_host(trepo, row, k)
        jv, ji, js = jsearch.topk_hausdorff_host(jrepo, _row(jq, b), k)
        assert_topk_close(hv, hi, jv, ji)
        assert hs == js
        assert_bitwise(tv[b], hv)
        np.testing.assert_array_equal(ti[b].numpy(), hi.numpy())
        assert (int(tn[b]), int(tc[b]), int(te[b])) == hs[:3]
        sv, si, ss = search.topk_hausdorff(trepo, row, k)
        assert_bitwise(sv, hv)
        assert ss == hs
        if overrun:
            assert hv.numpy()[-1] == np.float32(BIG)


@pytest.mark.parametrize("n", [1, 5, 9])
def test_engine_bucket_straddle_matches_jax_oracle(env, n):
    """Batches of 1, 5 and 9 pre-built rows (buckets 1, 8 and 16) through
    the port's engine, against JAX's host oracle per row."""
    _, jrepo, trepo, jq, tq = env
    rows = [b % tq.points.shape[0] for b in range(n)]
    engine = QueryEngine(trepo, result_cache_size=0)
    res = engine.search([
        Query(op="topk_hausdorff", q_index=type(tq)(*[x[b] for x in tq]),
              k=K) for b in rows])
    assert engine.stats.padded_queries == engine.bucket_for(n) - n
    for b, r in zip(rows, res):
        jv, ji, js = jsearch.topk_hausdorff_host(jrepo, _row(jq, b), K)
        assert_topk_close(r.vals, r.ids, jv, ji)
        assert r.stats == js


def test_port_batched_vs_host_on_duplicates(env):
    """Twin rows (query 0 at rows 0 and 3) give bitwise twin results."""
    _, _, trepo, _, tq = env
    tv, ti, _, _, te = search._topk_hausdorff_device_batched(
        trepo, tq, K, 3, 32)
    assert_bitwise(tv[0], tv[3])
    assert torch.equal(ti[0], ti[3]) and int(te[0]) == int(te[3])

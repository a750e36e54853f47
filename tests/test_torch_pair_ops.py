"""The port's pairwise and frontier functions against the JAX package, on
one index: ``hausdorff_pair_exact``, ``hausdorff_pair_approx``,
``frontier_bounds`` and ``gbo_frontier_stats``.

The repository and the query trees are built by JAX and carried across with
``repro_torch.bridge``, so both packages run on the same index.

* Hausdorff values and frontier bounds: to ``rtol=1e-6`` against JAX (its
  ``ops.bound_matrices`` is jitted, and XLA:CPU may contract
  ``d0*d0 + d1*d1`` into an FMA, about one ulp); the pruned fraction
  exactly; ExactHaus also to ``atol=1e-4`` of a numpy brute force, as the
  JAX package's own test holds it.
* Inside the port: ``frontier_bounds`` at level l is bitwise level l of the
  fused ``bound_grid`` pass, and ``hausdorff_pair_exact`` bitwise
  ``ops.directed_hausdorff`` wherever its value is not the ``glb`` term.
* ``gbo_frontier_stats``: every field exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_clustered_datasets
from repro.core import search as jsearch
from repro.core import zorder as jzorder
from repro.core.build import build_repository as jbuild
from repro.core.index import DatasetIndex as JIndex
from repro_torch import bridge
from repro_torch.core import search
from repro_torch.core.build import build_query_index
from repro_torch.core.index import DatasetIndex
from repro_torch.kernels import ops
from test_torch_exacthaus import assert_bitwise
from torch_lm_parity import one_torch_thread  # noqa: F401

RTOL = 1e-6
THETA = 5
PAIRS = (0, 3, 11, 17, 23)


def _row(tree, i):
    return type(tree)(*[x[i] for x in tree])


def _brute_h(q, d):
    dd = np.sqrt(((q[:, None].astype(np.float64) - d[None]) ** 2).sum(-1))
    return dd.min(axis=1).max()


@pytest.fixture(scope="module")
def env():
    datasets = make_clustered_datasets(24, seed=1, n_points=(20, 300))
    jrepo, _ = jbuild(datasets, leaf_capacity=16, theta=THETA,
                      remove_outliers=False)
    trepo = bridge.repository_to_torch(jax.tree.map(np.asarray, jrepo),
                                       device="cpu")
    # a lake dataset (its repository row and signature), and a spread query
    # far from most of them, shallower than the lake's trees (built by the
    # port and carried to JAX: one JAX build per file)
    far = np.random.default_rng(3).normal(scale=30, size=(170, 2)).astype(
        np.float32)
    t_far, t_sig = build_query_index(far, leaf_capacity=16, theta=THETA,
                                     space_lo=trepo.space_lo,
                                     space_hi=trepo.space_hi, device="cpu")
    j_far = JIndex(*[jnp.asarray(x) for x in bridge.to_numpy(t_far)])
    jq = [(jax.tree.map(lambda x: x[7], jrepo.ds_index), jrepo.ds_sigs[7]),
          (j_far, jnp.asarray(t_sig.numpy().astype(np.uint32)))]
    tq = [(_row(trepo.ds_index, 7), trepo.ds_sigs[7]), (t_far, t_sig)]
    return dict(datasets=datasets, jrepo=jrepo, trepo=trepo,
                q_sets=[datasets[7], far], jq=jq, tq=tq)


@pytest.mark.parametrize("qi", [0, 1])
def test_hausdorff_pair_exact_matches_jax(env, qi):
    jq, tq = env["jq"][qi][0], env["tq"][qi][0]
    for j in PAIRS:
        jd = jax.tree.map(lambda x: x[j], env["jrepo"].ds_index)
        td = _row(env["trepo"].ds_index, j)
        h, pruned = search.hausdorff_pair_exact(tq, td)
        jh, jpruned = jsearch.hausdorff_pair_exact(jq, jd)
        np.testing.assert_allclose(float(h), float(jh), rtol=RTOL)
        assert_bitwise(pruned.numpy(), np.asarray(jpruned))
        np.testing.assert_allclose(
            float(h), _brute_h(env["q_sets"][qi], env["datasets"][j]),
            atol=1e-4)
        # the exact value unless the glb term set it, from above
        want = ops.directed_hausdorff(tq.points, td.points, tq.valid,
                                      td.valid)
        if float(h) != float(want):
            assert float(h) > float(want)
            assert float(h) - float(want) <= 4 * np.spacing(np.float32(want))


def test_hausdorff_pair_exact_prunes(env):
    """The lake query against itself: h is 0, and pruning does work."""
    tq = env["tq"][0][0]
    h, pruned = search.hausdorff_pair_exact(tq, tq)
    assert float(h) == 0.0
    assert float(pruned) > 0.2


@pytest.mark.parametrize("cells", [0.5, 1.0, 3.0])
def test_hausdorff_pair_approx_matches_jax(env, cells):
    eps = cells * float(jzorder.default_epsilon(
        env["jrepo"].space_lo, env["jrepo"].space_hi, THETA))
    for qi in (0, 1):
        jq, tq = env["jq"][qi][0], env["tq"][qi][0]
        for j in PAIRS:
            jd = jax.tree.map(lambda x: x[j], env["jrepo"].ds_index)
            td = _row(env["trepo"].ds_index, j)
            a = float(search.hausdorff_pair_approx(tq, td, eps))
            np.testing.assert_allclose(
                a, float(jsearch.hausdorff_pair_approx(jq, jd, eps)),
                rtol=RTOL)
            # Lemma 1, with the radii the trees actually stop at
            r = max(eps, *[float(search._level_arrays(
                x, search.approx_level(x, eps))[1].max()) for x in (tq, td)])
            h = _brute_h(env["q_sets"][qi], env["datasets"][j])
            assert abs(a - h) <= 2 * r + 1e-4


@pytest.mark.parametrize("lq,ld", [(0, 0), (1, 2), (2, 1), (3, 3), (4, 2),
                                   ("leaf", "leaf")])
def test_frontier_bounds_match_jax(env, lq, ld):
    jrepo, trepo = env["jrepo"], env["trepo"]
    for (jq, _), (tq, _) in zip(env["jq"], env["tq"]):
        a = tq.depth if lq == "leaf" else lq
        b = trepo.ds_index.depth if ld == "leaf" else ld
        LB, UB = search.frontier_bounds(tq, trepo.ds_index, a, b)
        jLB, jUB = jsearch.frontier_bounds(jq, jrepo.ds_index, a, b)
        assert LB.shape == UB.shape == (trepo.n_slots,)
        np.testing.assert_allclose(LB.numpy(), np.asarray(jLB), rtol=RTOL)
        np.testing.assert_allclose(UB.numpy(), np.asarray(jUB), rtol=RTOL)
        ok = trepo.ds_valid.numpy()
        assert (LB.numpy()[ok] <= UB.numpy()[ok]).all()


def test_frontier_bounds_are_bound_grid_levels(env):
    """Level l of the fused pass reduces the same Eq. 4 values by
    selections: bitwise equal."""
    trepo = env["trepo"]
    for tq, _ in env["tq"]:
        batch = DatasetIndex(*[x[None] for x in tq])
        LBs, UBs = search._frontier_bound_all_levels(batch, trepo.ds_index, 3)
        for level in range(4):
            LB, UB = search.frontier_bounds(tq, trepo.ds_index, level, level)
            assert_bitwise(LB.numpy(), LBs[level, 0].numpy())
            assert_bitwise(UB.numpy(), UBs[level, 0].numpy())


def np_gbo_walk(repo, sig, k):
    """The pruned GBO walk in numpy, from the datasets' signatures: a
    node's bound is popcount(q AND the OR of the signatures beneath it).
    Returns (nodes visited, {surviving leaf: its datasets})."""
    def popcount(x):
        return np.unpackbits(x.astype(np.uint32).view(np.uint8),
                             axis=-1).sum(axis=-1).astype(np.int64)

    up = repo.repo
    order = up.order.numpy()
    valid = repo.ds_valid.numpy()
    q = sig.numpy().astype(np.uint32)
    exact = np.where(valid, popcount(q & repo.ds_sigs.numpy()), -1)
    kth = np.sort(exact)[-k] if exact.size >= k else -1
    sigs = np.where(valid[order, None], repo.ds_sigs.numpy()[order], 0)
    bounds, sizes = [], []
    for level in range(up.depth + 1):
        seg = sigs.reshape(1 << level, -1, sigs.shape[-1])
        bounds.append(popcount(q & np.bitwise_or.reduce(seg, axis=1)))
        sizes.append(valid[order].reshape(1 << level, -1).sum(axis=1))
    bounds, sizes = np.concatenate(bounds), np.concatenate(sizes)
    first_leaf = (1 << up.depth) - 1
    visited, leaves, stack = 0, {}, [0]
    while stack:
        node = stack.pop()
        visited += 1
        if sizes[node] == 0 or bounds[node] < kth:
            continue
        if node >= first_leaf:
            leaves[node - first_leaf] = int(sizes[node])
            continue
        stack += [2 * node + 1, 2 * node + 2]
    return visited, leaves


@pytest.mark.parametrize("k", [1, 3, 8, 24, 40])
def test_gbo_frontier_stats_match_jax(env, k):
    """k = 40 runs past the 24 valid datasets (kth is then -1).  The
    counts are a numpy walk's, every leaf that holds one of the top k is
    among its survivors, and they hold at least k datasets (or all)."""
    trepo = env["trepo"]
    up = trepo.repo
    slot_of = np.argsort(up.order.numpy())      # dataset slot -> tree slot
    f_up = up.ds_valid.shape[0] >> up.depth
    for (_, jsig), (_, tsig) in zip(env["jq"], env["tq"]):
        stats = search.gbo_frontier_stats(trepo, tsig, k)
        jstats = jsearch.gbo_frontier_stats(env["jrepo"], jsig, k)
        assert tuple(stats) == tuple(jstats)
        visited, leaves = np_gbo_walk(trepo, tsig, k)
        assert (stats.nodes_evaluated, stats.candidates_after_bounds) == (
            visited, len(leaves))
        _, ids = search.topk_gbo(trepo, tsig, k)
        ids = ids[ids >= 0].numpy()
        assert set((slot_of[ids] // f_up).tolist()) <= set(leaves)
        assert sum(leaves.values()) >= min(k, int(trepo.ds_valid.sum()))


def test_gbo_frontier_stats_one_intersect_call(env, monkeypatch):
    calls = []
    real = ops.set_intersect_counts
    monkeypatch.setattr(ops, "set_intersect_counts",
                        lambda *a: calls.append(a) or real(*a))
    search.gbo_frontier_stats(env["trepo"], env["tq"][0][1], 5)
    assert len(calls) == 1

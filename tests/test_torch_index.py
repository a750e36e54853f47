"""Index build parity: the port's build against the JAX package's, on the
same numpy datasets, carried across with ``repro_torch.bridge``.

The tree permutation (hence points), ``valid``, ``counts``, boxes,
signatures, the upper tree's ``order`` and every integer or selection
output must match exactly.  Node centers and radii come from sums whose
order differs between XLA and PyTorch, so they are held to ``rtol=1e-6``
(plus ``atol = 1e-6 * max|x|`` for values near zero, where a relative
bound is meaningless for a sum of terms of either sign).  No outlier
drop test (``sqrt(d2) > r'``) flipped on these seeds: ``valid`` is equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_clustered_datasets
from repro.core import outliers as joutliers
from repro.core.build import build_query_index as jbuild_query
from repro.core.build import build_repository as jbuild
from repro.data import synthetic as jsynthetic
from repro_torch import bridge
from repro_torch.core import outliers
from repro_torch.core.build import build_query_index, build_repository
from repro_torch.data import synthetic

EXACT_DS = ("points", "valid", "counts", "box_lo", "box_hi")
CLOSE_DS = ("centers", "radii")
EXACT_UP = ("order", "ds_valid", "box_lo", "box_hi", "sigs", "counts")
CLOSE_UP = ("centers", "radii")


def _close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)


def _datasets(kind):
    if kind == "clustered":
        return make_clustered_datasets(33, seed=2, n_points=(30, 120))
    if kind == "poi":     # GPS-failure outliers, 3 clusters
        return synthetic.poi_repository(40, seed=5, n_points=(20, 300))
    return synthetic.trajectory_repository(24, seed=1, n_points=(50, 400))


@pytest.mark.parametrize("kind", ["clustered", "poi", "trajectory"])
@pytest.mark.parametrize("remove", [False, True])
def test_repository_build_parity(kind, remove):
    ds = _datasets(kind)
    jrepo, jinfo = jbuild(ds, leaf_capacity=16, theta=5,
                          remove_outliers=remove)
    trepo, tinfo = build_repository(ds, leaf_capacity=16, theta=5,
                                    remove_outliers=remove, device="cpu")
    got = bridge.to_numpy(trepo)
    want = jax.tree.map(np.asarray, jrepo)
    for f in EXACT_DS:
        np.testing.assert_array_equal(getattr(got.ds_index, f),
                                      getattr(want.ds_index, f), err_msg=f)
    for f in CLOSE_DS:
        _close(getattr(got.ds_index, f), getattr(want.ds_index, f))
    assert got.ds_sigs.dtype == np.uint32
    np.testing.assert_array_equal(got.ds_sigs, want.ds_sigs)
    np.testing.assert_array_equal(got.ds_valid, want.ds_valid)
    for f in EXACT_UP:
        np.testing.assert_array_equal(getattr(got.repo, f),
                                      getattr(want.repo, f), err_msg=f)
    for f in CLOSE_UP:
        _close(getattr(got.repo, f), getattr(want.repo, f))
    np.testing.assert_array_equal(got.space_lo, want.space_lo)
    np.testing.assert_array_equal(got.space_hi, want.space_hi)
    assert {k: v for k, v in tinfo.items() if k != "outlier_threshold"} == \
        {k: v for k, v in jinfo.items() if k != "outlier_threshold"}
    if remove:
        _close(float(tinfo["outlier_threshold"]),
               float(jinfo["outlier_threshold"]))


def test_bridge_round_trip():
    ds = make_clustered_datasets(9, seed=4, n_points=(20, 90))
    jrepo, _ = jbuild(ds, leaf_capacity=16, theta=5)
    want = jax.tree.map(np.asarray, jrepo)
    trepo = bridge.repository_to_torch(want, device="cpu")
    assert trepo.ds_sigs.dtype == torch.int64
    assert trepo.repo.order.dtype == torch.int64
    got = bridge.to_numpy(trepo)
    for g, w in zip(jax.tree.leaves(tuple(got)), jax.tree.leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [5, 16, 17, 100])
def test_query_index_parity(n):
    rng = np.random.default_rng(n)
    pts = rng.normal(size=(n, 2)).astype(np.float32) * 10
    lo, hi = np.float32([-40, -40]), np.float32([40, 40])
    jq, jsig = jbuild_query(pts, leaf_capacity=16, theta=5,
                            space_lo=jnp.asarray(lo), space_hi=jnp.asarray(hi))
    tq, tsig = build_query_index(pts, leaf_capacity=16, theta=5,
                                 space_lo=torch.from_numpy(lo),
                                 space_hi=torch.from_numpy(hi), device="cpu")
    got = bridge.to_numpy(tq)
    for f in EXACT_DS:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(jq, f)), err_msg=f)
    for f in CLOSE_DS:
        _close(getattr(got, f), np.asarray(getattr(jq, f)))
    np.testing.assert_array_equal(tsig.numpy().astype(np.uint32),
                                  np.asarray(jsig))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kneedle_threshold_parity(seed):
    rng = np.random.default_rng(seed)
    radii = np.concatenate([rng.uniform(0.1, 1.0, 200),
                            rng.uniform(5, 50, 7)]).astype(np.float32)
    valid = rng.random(radii.shape[0]) > 0.1
    got = outliers.kneedle_threshold(torch.from_numpy(radii),
                                     torch.from_numpy(valid))
    want = joutliers.kneedle_threshold(jnp.asarray(radii), jnp.asarray(valid))
    _close(float(got), float(want))


def test_synthetic_copy_matches():
    for name in ("tdrive", "multiopen", "chicago"):
        a = synthetic.REPOSITORIES[name](5)
        b = jsynthetic.REPOSITORIES[name](5)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)

"""The port's plain kernel versions against the JAX package's.

All six: the three distance / bound kernels of ExactHaus, and
``set_intersect`` (GBO), ``nn_distance`` (NNP) and ``bound_matrices``
(the pruned NNP's leaf bounds).  Integer outputs (GBO counts, NN indices)
are held exactly.

Inputs are numpy arrays made from a seed and handed to both packages.

* Against eager ``repro.kernels.ref`` the port is held BITWISE: both run one
  op at a time, so both compute the uncontracted IEEE float32 values.
* Against ``repro.kernels.ops`` (jitted, with ``use_kernel=True`` = the
  Pallas kernel in interpret mode, and ``use_kernel=False`` = the jnp
  oracle) the port is held to ``rtol=1e-6``: under ``jit`` XLA:CPU may
  contract ``d0*d0 + d1*d1`` into an FMA, which moves a distance by about
  one ulp.  For ``bound_grid`` the two JAX routes do not even agree bitwise
  with each other at every shape (``repro/kernels/ref.py:108-115``; the
  failing ``test_bound_grid_routing_boundary[1-128-True]``).  The Eq. 4
  lower bound ``max(cd - rd, 0)`` subtracts two values of similar size, so
  its one-ulp drift is absolute (one ulp of ``cd``), not relative: it is
  held to ``atol = 1e-6 * max|cd|`` beside the ``rtol``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

RTOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _assert_bitwise(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _mk(seed, nq, nd, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    dd = rng.normal(loc=0.5, size=(nd, d)).astype(np.float32)
    qv = rng.random(nq) > 0.1
    dv = rng.random(nd) > 0.1
    qv[0] = dv[0] = True
    return q, dd, qv, dv


def _mk_grid(seed, B, S, N=7, d=2):
    rng = np.random.default_rng(seed)
    oq = rng.normal(size=(B, N, d)).astype(np.float32)
    od = rng.normal(size=(S, N, d)).astype(np.float32)
    rq = rng.uniform(0, 1, (B, N)).astype(np.float32)
    rd = rng.uniform(0, 1, (S, N)).astype(np.float32)
    qok = rng.random((B, N)) > 0.2
    dok = rng.random((S, N)) > 0.2
    qok[:, 0] = dok[:, 0] = True
    return oq, rq, qok, od, rd, dok


LEVELS7 = ((0, 1), (1, 3), (3, 7))
SHAPES = [(10, 20, 2), (37, 130, 2), (24, 100, 3), (64, 257, 2)]
GRIDS = [(1, 7), (3, 5), (4, 17), (1, 128), (8, 128)]


@pytest.mark.parametrize("nq,nd,d", SHAPES)
def test_sq_dists_bitwise_vs_eager_ref(nq, nd, d):
    q, dd, _, dv = _mk(nq + nd + d, nq, nd, d)
    _assert_bitwise(ref.unrolled_sq_dists(_t(q)[:, None], _t(dd)[None]),
                    jref.unrolled_sq_dists(jnp.asarray(q)[:, None],
                                           jnp.asarray(dd)[None]))
    _assert_bitwise(ref.masked_sq_dists(_t(q), _t(dd), _t(dv)),
                    jref.masked_sq_dists(jnp.asarray(q), jnp.asarray(dd),
                                         jnp.asarray(dv)))


@pytest.mark.parametrize("nq,nd,d", SHAPES)
def test_directed_hausdorff_bitwise_vs_eager_ref(nq, nd, d):
    q, dd, qv, dv = _mk(nq * nd + d, nq, nd, d)
    got = ref.directed_hausdorff(_t(q), _t(dd), _t(qv), _t(dv))
    want = jref.directed_hausdorff(*map(jnp.asarray, (q, dd, qv, dv)))
    _assert_bitwise(got, want)
    # the op routes a CPU tensor to the plain version: same bits
    _assert_bitwise(ops.directed_hausdorff(_t(q), _t(dd), _t(qv), _t(dv)),
                    got)


@pytest.mark.parametrize("B,S", GRIDS)
def test_frontier_bound_levels_bitwise_vs_eager_ref(B, S):
    args = _mk_grid(B + S, B, S)
    got = ref.frontier_bound_levels(*map(_t, args), LEVELS7)
    want = jref.frontier_bound_levels(*map(jnp.asarray, args), LEVELS7)
    for g, w in zip(got, want):
        _assert_bitwise(g, w)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("nq,nd,d", SHAPES[:3])
def test_directed_hausdorff_vs_jax_ops(nq, nd, d, use_kernel):
    q, dd, qv, dv = _mk(nq + 2 * nd + d, nq, nd, d)
    got = ops.directed_hausdorff(_t(q), _t(dd), _t(qv), _t(dv))
    want = jops.directed_hausdorff(*map(jnp.asarray, (q, dd, qv, dv)),
                                   use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("nq,nd", [(24, 100), (32, 130)])
def test_hausdorff_grid_vs_jax_ops(nq, nd, use_kernel):
    rng = np.random.default_rng(nq + nd)
    B, C = 2, 3
    q = rng.normal(size=(B, nq, 2)).astype(np.float32)
    ds = rng.normal(size=(B, C, nd, 2)).astype(np.float32)
    qv = rng.random((B, nq)) > 0.1
    dv = rng.random((B, C, nd)) > 0.3
    got = ops.directed_hausdorff_grid(_t(q), _t(ds), _t(qv), _t(dv))
    want = jops.directed_hausdorff_grid(*map(jnp.asarray, (q, ds, qv, dv)),
                                        use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    # inside the port the slab loop equals the per-pair op bitwise
    for b in range(B):
        for c in range(C):
            _assert_bitwise(
                got[b, c], ops.directed_hausdorff(_t(q[b]), _t(ds[b, c]),
                                                  _t(qv[b]), _t(dv[b, c])))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("B,S", GRIDS)
def test_bound_grid_vs_jax_ops(B, S, use_kernel):
    args = _mk_grid(B + S, B, S)
    got = ops.bound_grid(*map(_t, args), levels=LEVELS7)
    want = jops.bound_grid(*map(jnp.asarray, args), levels=LEVELS7,
                           use_kernel=use_kernel)
    oq, od = args[0], args[3]
    cd_max = float(np.sqrt(((oq[:, None, :, None, :]
                             - od[None, :, None, :, :]) ** 2).sum(-1)).max())
    lb, ub = (g.numpy() for g in got)
    np.testing.assert_allclose(lb, np.asarray(want[0]), rtol=RTOL,
                               atol=1e-6 * cd_max)
    np.testing.assert_allclose(ub, np.asarray(want[1]), rtol=RTOL)


def test_plain_routes_book_no_launches():
    """A CPU tensor takes the plain version and counts no launch."""
    ops.reset_launches()
    q, dd, qv, dv = _mk(5, 12, 30, 2)
    ops.directed_hausdorff(_t(q), _t(dd), _t(qv), _t(dv))
    ops.directed_hausdorff_grid(_t(q)[None], _t(dd)[None, None],
                                _t(qv)[None], _t(dv)[None, None])
    ops.bound_grid(*map(_t, _mk_grid(1, 2, 3)), levels=LEVELS7)
    ops.nn_distance(_t(q), _t(dd), _t(qv), _t(dv))
    ops.bound_matrices(*map(_t, _mk_frontiers(2, 4, 6, P=1)))
    sig = _t(_mk_sigs(1, 3, 2).astype(np.int64))
    ops.set_intersect_counts(sig, sig)
    assert all(n == 0 for n in ops.LAUNCHES.values())


def _mk_sigs(seed, n, W):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2 ** 32, size=(n, W), dtype=np.uint64)
    s[0] = 0xFFFFFFFF                      # every bit set
    s[1 % n] = 0
    return s.astype(np.uint32)


SIG_SHAPES = [(1, 7, 1), (5, 33, 32), (32, 300, 32), (9, 17, 3)]


@pytest.mark.parametrize("na,nb,W", SIG_SHAPES)
def test_set_intersect_count_exact(na, nb, W):
    """Integer counts: equal to eager JAX, to both jitted JAX routes and to
    a numpy bit count."""
    sa, sb = _mk_sigs(na + W, na, W), _mk_sigs(nb + W, nb, W)
    got = ops.set_intersect_counts(_t(sa.astype(np.int64)),
                                   _t(sb.astype(np.int64))).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, np.asarray(jref.set_intersect_count(jnp.asarray(sa),
                                                 jnp.asarray(sb))))
    for use_kernel in (True, False):
        np.testing.assert_array_equal(got, np.asarray(
            jops.set_intersect_counts(jnp.asarray(sa), jnp.asarray(sb),
                                      use_kernel=use_kernel)))
    both = sa[:, None, :] & sb[None, :, :]
    want = np.unpackbits(both.view(np.uint8), axis=-1).reshape(
        na, nb, -1).sum(-1)
    np.testing.assert_array_equal(got, want)


def test_popcount64_all_bits():
    """The SWAR count covers all 64 bits, sign bit included."""
    rng = np.random.default_rng(3)
    x = rng.integers(-2 ** 63, 2 ** 63 - 1, size=4096, dtype=np.int64)
    x[:3] = (-1, -2 ** 63, 0)
    want = np.unpackbits(x.view(np.uint8)).reshape(-1, 64).sum(-1)
    np.testing.assert_array_equal(ref.popcount64(_t(x)).numpy(), want)


@pytest.mark.parametrize("nq,nd,d", SHAPES)
def test_nn_distance_bitwise_vs_eager_ref(nq, nd, d):
    q, dd, qv, dv = _mk(3 * nq + nd + d, nq, nd, d)
    dd[nd // 2] = dd[0]                    # a tie: the first index wins
    got_d, got_i = ops.nn_distance(_t(q), _t(dd), _t(qv), _t(dv))
    want_d, want_i = jref.nn_distance(*map(jnp.asarray, (q, dd, qv, dv)))
    _assert_bitwise(got_d, want_d)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert (got_i.numpy()[~qv] == -1).all()
    assert (got_d.numpy()[~qv] == 0.0).all()


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("nq,nd,d", SHAPES[:3])
def test_nn_distance_vs_jax_ops(nq, nd, d, use_kernel):
    """Against jitted JAX: distances to RTOL (FMA contraction), indices
    exactly wherever the nearest and second-nearest distances differ by
    more than that."""
    q, dd, qv, dv = _mk(nq + 3 * nd + d, nq, nd, d)
    got_d, got_i = ops.nn_distance(_t(q), _t(dd), _t(qv), _t(dv))
    want_d, want_i = jops.nn_distance(*map(jnp.asarray, (q, dd, qv, dv)),
                                      use_kernel=use_kernel)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=RTOL)
    d2 = np.sort(np.where(dv[None], ((q[:, None] - dd[None]) ** 2).sum(-1),
                          np.inf), axis=1)
    clear = d2[:, 1] > d2[:, 0] * (1 + 4 * RTOL)
    np.testing.assert_array_equal(got_i.numpy()[clear],
                                  np.asarray(want_i)[clear])


def _mk_frontiers(seed, nq, nd, d=2, P=None):
    rng = np.random.default_rng(seed)
    lead = () if P is None else (P,)
    return (rng.normal(size=lead + (nq, d)).astype(np.float32),
            rng.uniform(0, 1, lead + (nq,)).astype(np.float32),
            rng.normal(size=lead + (nd, d)).astype(np.float32),
            rng.uniform(0, 1, lead + (nd,)).astype(np.float32))


@pytest.mark.parametrize("nq,nd", [(1, 1), (8, 16), (37, 130), (256, 256)])
def test_bound_matrix_bitwise_vs_eager_ref(nq, nd):
    args = _mk_frontiers(nq + nd, nq, nd)
    got = ops.bound_matrices(*[_t(a)[None] for a in args])
    want = jref.bound_matrix(*map(jnp.asarray, args))
    for g, w in zip(got, want):
        _assert_bitwise(g[0], w)


def test_bound_matrix_batched_equals_per_pair():
    """The leading pair axis changes no bit."""
    args = _mk_frontiers(5, 16, 24, P=3)
    lb, ub = ops.bound_matrices(*map(_t, args))
    for p in range(3):
        lb_p, ub_p = ops.bound_matrices(*[_t(a[p:p + 1]) for a in args])
        _assert_bitwise(lb[p], lb_p[0])
        _assert_bitwise(ub[p], ub_p[0])


@pytest.mark.parametrize("use_kernel", [True, False])
def test_bound_matrix_vs_jax_ops(use_kernel):
    """Against jitted JAX: ub to RTOL, lb to RTOL with an absolute ulp of
    the center distance (max(cd - rd, 0) cancels), as for bound_grid."""
    args = _mk_frontiers(11, 37, 130)
    lb, ub = (x[0] for x in ops.bound_matrices(*[_t(a)[None]
                                                   for a in args]))
    want = jops.bound_matrices(*map(jnp.asarray, args),
                               use_kernel=use_kernel)
    cd_max = float(np.sqrt(((args[0][:, None] - args[2][None]) ** 2)
                           .sum(-1)).max())
    np.testing.assert_allclose(lb.numpy(), np.asarray(want[0]), rtol=RTOL,
                               atol=1e-6 * cd_max)
    np.testing.assert_allclose(ub.numpy(), np.asarray(want[1]), rtol=RTOL)

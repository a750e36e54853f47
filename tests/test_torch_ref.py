"""The port's plain kernel versions against the JAX package's.

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
    assert all(n == 0 for n in ops.LAUNCHES.values())

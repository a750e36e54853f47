"""Phase 2's lane op and its layout helpers, on the CPU.

``ops.directed_hausdorff_lanes`` evaluates the live lanes of an ExactHaus
phase-2 chunk over query rows compacted once per search and the resident
corpus read by slot id.  Its plain version (the CPU route, and what the
CUDA kernel is held to on the card) must equal, BITWISE, the pair-grid
plain version ``directed_hausdorff_grid_plain`` on the gathered, uncompacted
inputs, and within ``rtol=1e-6`` the JAX package's
``repro.kernels.ops.directed_hausdorff_grid`` (jitted XLA:CPU may contract
``d0*d0 + d1*d1`` into an FMA, about one ulp).

Inputs are numpy arrays made from a seed: random (non-prefix) query masks,
corpus slots whose valid points form a prefix with holes inside it, as
outlier removal leaves them, dead lanes, and shapes that are not multiples
of the plain slab (128) or the kernel's tiles (256).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import search
from repro_torch.core.index import DatasetIndex
from repro_torch.kernels import hausdorff, ops
from repro_torch.kernels.ref import BIG

RTOL = 1e-6


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _mk(seed, B, C, nq, S, nd, W, live_p=0.6):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, nq, W)).astype(np.float32)
    qv = rng.random((B, nq)) < 0.7
    qv[:, 0] = True
    pts = rng.normal(loc=0.5, size=(S, nd, W)).astype(np.float32)
    n_valid = rng.integers(1, nd + 1, S)
    pv = np.arange(nd)[None, :] < n_valid[:, None]
    pv &= rng.random((S, nd)) > 0.15
    pv[:, 0] = True
    ids = rng.integers(0, S, (B, C))
    live = rng.random((B, C)) < live_p
    return q, qv, pts, pv, ids, live


def _lanes(q, qv, pts, pv, ids, live):
    q_c, n_q = hausdorff.compact_rows(torch.from_numpy(q),
                                      torch.from_numpy(qv))
    pv_t = torch.from_numpy(pv)
    return ops.directed_hausdorff_lanes(
        q_c, n_q, torch.from_numpy(pts), pv_t, hausdorff.valid_extent(pv_t),
        torch.from_numpy(ids), torch.from_numpy(live)).numpy()


SHAPES = [(1, 1, 1, 1, 1, 2), (2, 3, 24, 5, 100, 2), (2, 4, 300, 6, 257, 2),
          (3, 2, 130, 4, 129, 1), (2, 2, 70, 3, 90, 3)]


@pytest.mark.parametrize("B,C,nq,S,nd,W", SHAPES)
def test_lanes_plain_equals_grid_plain(B, C, nq, S, nd, W):
    """Bitwise the pair-grid plain version on the gathered slots (live
    lanes), BIG on dead lanes."""
    q, qv, pts, pv, ids, live = _mk(B * C + nq + nd + W, B, C, nq, S, nd, W)
    got = _lanes(q, qv, pts, pv, ids, live)
    want = ops.directed_hausdorff_grid_plain(
        torch.from_numpy(q), torch.from_numpy(pts[ids]),
        torch.from_numpy(qv), torch.from_numpy(pv[ids])).numpy()
    np.testing.assert_array_equal(_bits(got[live]), _bits(want[live]))
    assert (got[~live] == np.float32(BIG)).all()


@pytest.mark.parametrize("B,C,nq,S,nd,W", SHAPES[1:])
def test_lanes_vs_jax_grid(B, C, nq, S, nd, W):
    """The live lanes against the JAX package's grid op on the gathered
    slots, both of its routes."""
    q, qv, pts, pv, ids, live = _mk(7 + nq + nd, B, C, nq, S, nd, W,
                                    live_p=1.0)
    got = _lanes(q, qv, pts, pv, ids, live)
    for use_kernel in (True, False):
        want = jops.directed_hausdorff_grid(
            *map(jnp.asarray, (q, pts[ids], qv, pv[ids])),
            use_kernel=use_kernel)
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL)


def test_lanes_dead_and_empty_query():
    """Every lane dead gives BIG; a live lane of a query with no valid row
    gives -BIG, as the grid op does."""
    q, qv, pts, pv, ids, live = _mk(5, 3, 4, 50, 6, 80, 2)
    got = _lanes(q, qv, pts, pv, ids, np.zeros_like(live))
    assert (got == np.float32(BIG)).all()
    qv[1] = False
    got = _lanes(q, qv, pts, pv, ids, np.ones_like(live))
    assert (got[1] == np.float32(-BIG)).all()
    assert (got[[0, 2]] < np.float32(BIG)).all()


def test_compact_rows_keeps_each_querys_valid_rows_in_order():
    q, qv, *_ = _mk(11, 4, 1, 37, 1, 1, 2)
    qv[2] = False
    q_c, n_q = hausdorff.compact_rows(torch.from_numpy(q),
                                      torch.from_numpy(qv))
    assert n_q.dtype == torch.int32 and q_c.shape == q.shape
    for b in range(4):
        assert int(n_q[b]) == int(qv[b].sum())
        np.testing.assert_array_equal(q_c[b, :int(n_q[b])].numpy(),
                                      q[b][qv[b]])


def test_compacted_rows_give_the_uncompacted_result():
    """The grid op over compacted rows (mask = a prefix of n_q rows) equals
    it over the original rows and mask, bitwise."""
    q, qv, pts, pv, ids, _ = _mk(12, 3, 3, 140, 5, 200, 2)
    q_c, n_q = hausdorff.compact_rows(torch.from_numpy(q),
                                      torch.from_numpy(qv))
    prefix = torch.arange(q.shape[1])[None, :] < n_q[:, None]
    ds, dv = torch.from_numpy(pts[ids]), torch.from_numpy(pv[ids])
    got = ops.directed_hausdorff_grid_plain(q_c, ds, prefix, dv)
    want = ops.directed_hausdorff_grid_plain(torch.from_numpy(q), ds,
                                             torch.from_numpy(qv), dv)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_valid_extent():
    pv = np.zeros((5, 300), bool)
    pv[0, :10] = True
    pv[1, [0, 5, 299]] = True
    pv[3, 7] = True
    pv[4] = True
    for block in (4096, 2):             # one block, and several
        ext = hausdorff.valid_extent(torch.from_numpy(pv), block)
        assert ext.dtype == torch.int32
        assert ext.tolist() == [10, 300, 0, 8, 300]


def test_phase2_query_rows_cut_to_the_row_block():
    """The phase-2 rows: every query's valid rows, cut to the largest count
    rounded up to the kernel's row block, never past the padded width."""
    q, qv, *_ = _mk(13, 3, 1, 600, 1, 1, 2)
    qv[:, 300:] = False
    qv[0, :300] = True                  # 300 rows: two row blocks
    qv[1, :] = False
    z = torch.zeros(1)
    idx = DatasetIndex(torch.from_numpy(q), torch.from_numpy(qv),
                       z, z, z, z, z)
    q_c, n_q = search.phase2_query_rows(idx)
    assert q_c.shape == (3, 2 * hausdorff.ROWS_PER_BLOCK, 2)
    assert q_c.is_contiguous()
    assert n_q.tolist() == [int(qv[0].sum()), 0, int(qv[2].sum())]
    idx = idx._replace(valid=torch.ones((3, 600), dtype=torch.bool))
    assert search.phase2_query_rows(idx)[0].shape == (3, 600, 2)

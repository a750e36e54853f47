"""The pruned NNP's row bound and the GBO popcount, on the CPU.

* ``ops.bound_row_ub`` (plain version ``ref.bound_row_ub``) is exactly the
  composition the pruned NNP applied to ``ops.bound_matrices`` before it
  had its own kernel, ``amin(where(d_ok, ub, BIG))``, and exactly the JAX
  package's (``repro.core.point_search.nnp_pruned_core`` on eager
  ``repro.kernels.ref.bound_matrix``): BITWISE.
* A numpy emulation of the ``bound_row_ub`` kernel's order (occupied nodes
  compacted in any order and in chunks, a min of ``cd2 + rd * rd`` per
  lane, the lanes' minima combined, one root per row, BIG as a cap where
  the row has an unoccupied node and as the value where it has none) is
  BITWISE equal to the plain version on random frontiers and on the edge
  rows: a pair with no occupied node, one with exactly one, masked nodes
  holding inf and NaN centers and radii, tied nodes, W = 1..8.
* ``ops.bound_matrices(..., with_lb=False)`` returns (None, ub), ub the
  same bits.
* A numpy emulation of the ``set_intersect`` kernel's order (64 x 8
  output tiles, 32 words at a time, the low 32 bits counted unless the
  tile's chunk holds a set high half) equals the plain count exactly.
* ``nnp_pruned_core`` reaches the row bound through ``ops.bound_row_ub``
  once and the matrix op not at all.

The kernels themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core import point_search
from repro_torch.core.build import build_query_index
from repro_torch.kernels import ops, ref
from torch_lm_parity import one_torch_thread  # noqa: F401

BIG = np.float32(ref.BIG)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _frontiers(seed, P, nq, nd, W, p_occ=0.6):
    rng = np.random.default_rng(seed)
    oq = (rng.normal(size=(P, nq, W)) * 4).astype(np.float32)
    rq = rng.uniform(0, 2, (P, nq)).astype(np.float32)
    od = (rng.normal(size=(P, nd, W)) * 4).astype(np.float32)
    rd = rng.uniform(0, 2, (P, nd)).astype(np.float32)
    d_ok = rng.random((P, nd)) < p_occ
    return oq, rq, od, rd, d_ok


def _edge_frontiers(seed, W, nd=130):
    """Four pairs: random; no occupied node; exactly one; every node
    occupied, with ties.  Masked nodes hold inf and NaN."""
    oq, rq, od, rd, d_ok = _frontiers(seed, 4, 37, nd, W)
    d_ok[1] = False                            # the row is all BIG
    d_ok[2] = False
    d_ok[2, nd // 3] = True                    # exactly one occupied node
    d_ok[3] = True                             # no cap: no unoccupied node
    od[3, 7] = od[3, 2]                        # tied nodes: equal x_j
    rd[3, 7] = rd[3, 2]
    masked = ~d_ok
    od[masked] = np.where(np.arange(W) % 2 == 0, np.inf, np.nan)
    rd[masked] = np.nan
    od[0, np.flatnonzero(masked[0])[:1]] = -np.inf
    return oq, rq, od, rd, d_ok


def _old_composition(oq, rq, od, rd, d_ok):
    """What ``nnp_pruned_core`` did before ``ops.bound_row_ub``."""
    _, ub = ops.bound_matrices(oq, rq, od, rd)
    return torch.amin(torch.where(d_ok[:, None, :], ub, ref.BIG), dim=-1)


def emulate_row_ub(oq, rq, od, rd, d_ok, rng, lanes=8, chunk=512):
    """numpy float32 in the ``bound_row_ub`` kernel's order."""
    P, nq, W = oq.shape
    nd = od.shape[1]
    out = np.empty((P, nq), np.float32)
    for p in range(P):
        m = np.full((lanes, nq), np.inf, np.float32)
        hole, occupied = False, 0
        for c0 in range(0, nd, chunk):
            js = np.arange(c0, min(nd, c0 + chunk))
            ok = d_ok[p, js]
            hole |= not ok.all()
            staged = rng.permutation(js[ok])   # compacted in any order
            occupied += len(staged)
            for k, j in enumerate(staged):
                diff = oq[p, :, 0] - od[p, j, 0]
                acc = diff * diff
                for c in range(1, W):
                    diff = oq[p, :, c] - od[p, j, c]
                    sq = diff * diff
                    acc = acc + sq
                x = acc + rd[p, j] * rd[p, j]
                m[k % lanes] = np.minimum(m[k % lanes], x)
        off = lanes // 2
        while off:                             # the shuffle tree
            m = np.minimum(m, m[np.arange(lanes) ^ off])
            off //= 2
        if occupied == 0:
            out[p] = BIG
        else:
            v = np.sqrt(m[0]) + rq[p]
            out[p] = np.minimum(v, BIG) if hole else v
    return out


@pytest.mark.parametrize("P,nq,nd,W", [(1, 1, 1, 2), (3, 16, 130, 2),
                                       (2, 33, 700, 3), (4, 37, 130, 1),
                                       (2, 9, 20, 8)])
def test_bound_row_ub_is_the_old_composition(P, nq, nd, W):
    oq, rq, od, rd, d_ok = map(_t, _frontiers(P + nq + nd + W, P, nq, nd, W))
    d_ok[0, 0] = True
    got = ops.bound_row_ub(oq, rq, od, rd, d_ok)
    assert got.shape == (P, nq) and got.dtype == torch.float32
    want = _old_composition(oq, rq, od, rd, d_ok)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(got), _bits(ref.bound_row_ub(oq, rq, od, rd, d_ok)))


@pytest.mark.parametrize("W", [1, 2, 3])
def test_bound_row_ub_vs_eager_jax(W):
    """The JAX package's pruned NNP row bound, per pair, on eager
    ``repro.kernels.ref.bound_matrix``: bitwise."""
    args = _edge_frontiers(50 + W, W)
    got = ops.bound_row_ub(*map(_t, args)).numpy()
    for p in range(args[0].shape[0]):
        oq, rq, od, rd, d_ok = (a[p] for a in args)
        _, ub = jref.bound_matrix(*map(jnp.asarray, (oq, rq, od, rd)))
        want = jnp.min(jnp.where(jnp.asarray(d_ok)[None, :], ub, BIG), axis=1)
        np.testing.assert_array_equal(_bits(got[p]), _bits(want))


@pytest.mark.parametrize("W", [1, 2, 3, 4, 5, 6, 7, 8])
def test_row_ub_kernel_order_on_edge_rows(W):
    args = _edge_frontiers(W, W)
    want = ops.bound_row_ub(*map(_t, args)).numpy()
    assert (want[1] == BIG).all()              # no occupied node
    assert (want[0] < BIG).all() and np.isfinite(want[3]).all()
    got = emulate_row_ub(*args, np.random.default_rng(W))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed,P,nq,nd,W,p_occ", [
    (0, 3, 40, 256, 2, 0.35), (1, 2, 17, 1100, 2, 0.5),
    (2, 5, 8, 3, 2, 0.5), (3, 2, 64, 513, 3, 0.9)])
def test_row_ub_kernel_order_random(seed, P, nq, nd, W, p_occ):
    """Random frontiers, several chunks of staged nodes (nd > 512)."""
    args = _frontiers(seed, P, nq, nd, W, p_occ)
    want = ops.bound_row_ub(*map(_t, args)).numpy()
    got = emulate_row_ub(*args, np.random.default_rng(seed))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_bound_matrices_ub_only():
    oq, rq, od, rd, _ = map(_t, _frontiers(9, 3, 16, 130, 2))
    lb, ub = ops.bound_matrices(oq, rq, od, rd)
    lb0, ub0 = ops.bound_matrices(oq, rq, od, rd, with_lb=False)
    assert lb0 is None and lb is not None
    np.testing.assert_array_equal(_bits(ub0), _bits(ub))


def _popcount(x):
    """Set bits of each word of an unsigned array, all of its width."""
    return np.unpackbits(x[..., None].view(np.uint8), axis=-1).sum(
        -1, dtype=np.int64)


def emulate_intersect(sa, sb, rows=64, slots=8, words=32):
    """numpy in the ``set_intersect`` kernel's order: per block of 64
    query rows and warp of 8 slots, 32 words at a time, the low 32 bits
    of each word (the tensor cores' bit matrices) unless a high half is
    set among the chunk's words of those rows or slots."""
    na, W = sa.shape
    nb = sb.shape[0]
    sa, sb = sa.view(np.uint64), sb.view(np.uint64)
    out = np.zeros((na, nb), np.int64)
    for i0 in range(0, na, rows):
        for j0 in range(0, nb, slots):
            for w0 in range(0, W, words):
                a = sa[i0:i0 + rows, w0:w0 + words]
                b = sb[j0:j0 + slots, w0:w0 + words]
                if ((a >> 32) != 0).any() or ((b >> 32) != 0).any():
                    both = a[:, None, :] & b[None, :, :]      # all 64 bits
                else:
                    both = (a[:, None, :] & b[None, :, :]).astype(np.uint32)
                out[i0:i0 + rows, j0:j0 + slots] += _popcount(both).sum(-1)
    return out.astype(np.int32)


@pytest.mark.parametrize("na,nb,W,wide", [
    (64, 300, 32, None), (70, 130, 40, "one block"), (5, 129, 3, "row"),
    (1, 1, 1, None), (33, 200, 32, "one block")])
def test_set_intersect_kernel_order(na, nb, W, wide):
    """Signatures (uint32 values), and high halves set in the words of
    exactly one block, or a whole row of -1 as the card test feeds it."""
    rng = np.random.default_rng(na + nb + W)
    sa = rng.integers(0, 2 ** 32, (na, W))
    sb = rng.integers(0, 2 ** 32, (nb, W))
    if wide == "one block":
        sb[70, W - 1] |= 1 << 40               # slot tile 1, the last chunk
    elif wide == "row":
        sa[-1] = -1
    want = ops.set_intersect_counts(_t(sa), _t(sb)).numpy()
    np.testing.assert_array_equal(emulate_intersect(sa, sb), want)


def test_nnp_pruned_calls_the_row_bound_once(monkeypatch):
    """One ``ops.bound_row_ub`` per pruned NNP dispatch, and no matrix."""
    rng = np.random.default_rng(4)
    calls = {"bound_row_ub": 0, "bound_matrices": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counting(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counting)
    q_idx, _ = build_query_index(rng.normal(size=(150, 2)) * 10,
                                 device="cpu")
    d_idx, _ = build_query_index(rng.normal(size=(230, 2)) * 10,
                                 device="cpu")
    dists, _, _ = point_search.nnp_pruned(q_idx, d_idx)
    assert calls == {"bound_row_ub": 1, "bound_matrices": 0}
    want, _ = point_search.nnp(q_idx, d_idx)
    np.testing.assert_array_equal(_bits(dists), _bits(want))

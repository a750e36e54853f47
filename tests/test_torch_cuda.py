"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; they skip where no CUDA device is present (decided inside
the ``cuda_device`` fixture, never at import).  On a machine with a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

Every comparison is bitwise (exact for the integer outputs): the kernels
are built with ``-fmad=false`` and IEEE ``sqrtf``, and their arithmetic
order is that of the plain versions.
Shapes are small and ragged (not multiples of any tile or warp).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (bound_matrix, hausdorff, nn_distance, ops,
                                 ref, set_intersect)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _pts(rng, shape, dev):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 5).to(dev)


def _mask(rng, shape, dev, p=0.8):
    m = rng.random(shape) < p
    m[..., 0] = True
    return torch.from_numpy(m).to(dev)


@pytest.mark.parametrize("nq,nd,W", [(1, 1, 2), (37, 130, 2), (300, 257, 2),
                                     (129, 700, 3), (65, 33, 5)])
def test_min_sq_dists(cuda_device, nq, nd, W):
    rng = np.random.default_rng(nq + nd + W)
    q, d = _pts(rng, (nq, W), cuda_device), _pts(rng, (nd, W), cuda_device)
    dv = _mask(rng, (nd,), cuda_device)
    ops.reset_launches()
    got = hausdorff.min_sq_dists(q, d, dv)
    assert ops.LAUNCHES["min_sq_dists"] == 1
    assert _bits_equal(got, ref.min_sq_dists(q, d, dv))
    qv = _mask(rng, (nq,), cuda_device)
    assert _bits_equal(ops.directed_hausdorff(q, d, qv, dv),
                       ref.directed_hausdorff(q, d, qv, dv))


def test_min_sq_dists_all_invalid(cuda_device):
    rng = np.random.default_rng(1)
    q, d = _pts(rng, (20, 2), cuda_device), _pts(rng, (300, 2), cuda_device)
    dv = torch.zeros(300, dtype=torch.bool, device=cuda_device)
    got = hausdorff.min_sq_dists(q, d, dv)
    assert torch.all(got == ref.BIG)


@pytest.mark.parametrize("B,C,nq,nd,W", [(1, 1, 1, 1, 2), (3, 4, 24, 100, 2),
                                         (2, 5, 300, 513, 2),
                                         (2, 3, 4100, 70, 2),
                                         (2, 2, 50, 90, 3)])
def test_hausdorff_grid(cuda_device, B, C, nq, nd, W):
    rng = np.random.default_rng(B * C + nq + nd)
    q = _pts(rng, (B, nq, W), cuda_device)
    ds = _pts(rng, (B, C, nd, W), cuda_device)
    qv = _mask(rng, (B, nq), cuda_device)
    dv = _mask(rng, (B, C, nd), cuda_device, p=0.6)
    dv[:, :, 257:] = False           # past the extent: never read
    ops.reset_launches()
    got = hausdorff.hausdorff_grid(q, ds, qv, dv)
    assert ops.LAUNCHES["hausdorff_grid"] == 1
    assert _bits_equal(got, ops.directed_hausdorff_grid_plain(q, ds, qv, dv))


@pytest.mark.parametrize("B,S,N", [(1, 1, 1), (3, 5, 7), (4, 130, 15),
                                   (33, 257, 15), (2, 300, 31),
                                   (5, 129, 15), (7, 383, 3)])
def test_bound_grid(cuda_device, B, S, N):
    """Unoccupied corpus and query nodes, a slot with no occupied node at a
    level, a query with none, S and B not multiples of the block's slot
    and query tiles, levels wider than the nodes a thread holds at once
    (N = 31)."""
    rng = np.random.default_rng(B + S + N)
    levels = tuple(((1 << l) - 1, (1 << (l + 1)) - 1)
                   for l in range(int(np.log2(N + 1))))
    oq, od = _pts(rng, (B, N, 2), cuda_device), _pts(rng, (S, N, 2), cuda_device)
    rq = torch.from_numpy(rng.uniform(0, 3, (B, N)).astype(np.float32)).to(cuda_device)
    rd = torch.from_numpy(rng.uniform(0, 3, (S, N)).astype(np.float32)).to(cuda_device)
    qok, dok = _mask(rng, (B, N), cuda_device), _mask(rng, (S, N), cuda_device)
    a, b = levels[-1]
    dok[S // 2, a:b] = False             # no occupied node at the last level
    dok[S - 1] = False                   # a padded slot: none at all
    qok[B - 1, 1:] = False               # a query occupied at the root only
    ops.reset_launches()
    got = bound_matrix.bound_grid(oq, rq, qok, od, rd, dok, levels=levels)
    assert ops.LAUNCHES["bound_grid"] == 1
    want = ref.frontier_bound_levels(oq, rq, qok, od, rd, dok, levels)
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


@pytest.mark.parametrize("L", [1, 2, 3, 4])
def test_bound_grid_levels(cuda_device, L):
    """L = 1..4 levels of 15-node trees, as phases 0/1 ask for them."""
    rng = np.random.default_rng(40 + L)
    B, S, N = 6, 200, 15
    levels = tuple(((1 << l) - 1, (1 << (l + 1)) - 1) for l in range(L))
    oq, od = _pts(rng, (B, N, 2), cuda_device), _pts(rng, (S, N, 2), cuda_device)
    rq = torch.from_numpy(rng.uniform(0, 3, (B, N)).astype(np.float32)).to(cuda_device)
    rd = torch.from_numpy(rng.uniform(0, 3, (S, N)).astype(np.float32)).to(cuda_device)
    qok = _mask(rng, (B, N), cuda_device, p=0.6)
    dok = _mask(rng, (S, N), cuda_device, p=0.6)
    got = bound_matrix.bound_grid(oq, rq, qok, od, rd, dok, levels=levels)
    want = ref.frontier_bound_levels(oq, rq, qok, od, rd, dok, levels)
    for g, w in zip(got, want):
        assert g.shape == (L, B, S) and _bits_equal(g, w)


def _lanes_inputs(rng, dev, B, C, nq, S, nd, W, live_p=0.5):
    """Random query rows (a random, non-prefix mask), a corpus whose valid
    points form a prefix with outlier-style holes, slot ids and a live
    mask."""
    q = _pts(rng, (B, nq, W), dev)
    qv = _mask(rng, (B, nq), dev, p=0.7)
    pts = _pts(rng, (S, nd, W), dev)
    n_valid = rng.integers(1, nd + 1, S)
    pv = np.arange(nd)[None, :] < n_valid[:, None]
    pv &= rng.random((S, nd)) > 0.1             # holes inside the extent
    pv[:, 0] = True
    pv = torch.from_numpy(pv).to(dev)
    ids = torch.from_numpy(rng.integers(0, S, (B, C))).to(dev)
    live = torch.from_numpy(rng.random((B, C)) < live_p).to(dev)
    return q, qv, pts, pv, ids, live


def _check_lanes(q, qv, pts, pv, ids, live):
    q_c, n_q = hausdorff.compact_rows(q, qv)
    extent = hausdorff.valid_extent(pv)
    ops.reset_launches()
    got = hausdorff.hausdorff_lanes(q_c, n_q, pts, pv, extent, ids, live)
    assert ops.LAUNCHES["hausdorff_grid"] == 1
    want = ops.directed_hausdorff_lanes_plain(q_c, n_q, pts, pv, extent,
                                              ids, live)
    assert _bits_equal(got, want)
    # and the uncompacted grid on the gathered slots, for the live lanes
    grid = ops.directed_hausdorff_grid_plain(q, pts[ids], qv, pv[ids])
    assert _bits_equal(got[live], grid[live])
    assert torch.all(got[~live] == ref.BIG)
    return got


@pytest.mark.parametrize("B,C,nq,S,nd,W", [
    (1, 1, 1, 1, 1, 2), (3, 4, 24, 9, 100, 2), (2, 5, 300, 7, 513, 2),
    (2, 3, 1100, 5, 70, 2), (2, 2, 50, 4, 90, 1), (2, 2, 50, 4, 90, 3),
    (4, 8, 700, 40, 600, 2)])
def test_hausdorff_lanes(cuda_device, B, C, nq, S, nd, W):
    """Split rows (nq past one block's 256 rows), ragged tiles, holes,
    dead lanes, W = 1, 2, 3."""
    rng = np.random.default_rng(B * C + nq + nd + W)
    _check_lanes(*_lanes_inputs(rng, cuda_device, B, C, nq, S, nd, W))


def test_hausdorff_lanes_one_live_of_1024(cuda_device):
    rng = np.random.default_rng(3)
    q, qv, pts, pv, ids, live = _lanes_inputs(rng, cuda_device, 32, 32, 600,
                                              64, 700, 2)
    live[:] = False
    live[17, 5] = True
    got = _check_lanes(q, qv, pts, pv, ids, live)
    assert int((got < ref.BIG).sum()) == 1


def test_hausdorff_lanes_all_dead_and_empty_query(cuda_device):
    rng = np.random.default_rng(4)
    q, qv, pts, pv, ids, live = _lanes_inputs(rng, cuda_device, 4, 6, 300,
                                              10, 300, 2)
    live[:] = False
    got = _check_lanes(q, qv, pts, pv, ids, live)
    assert torch.all(got == ref.BIG)
    qv[2] = False                       # a query with no valid row: -BIG
    live[:] = True
    got = _check_lanes(q, qv, pts, pv, ids, live)
    assert torch.all(got[2] == -ref.BIG)


@pytest.mark.parametrize("na,nb,W", [(1, 1, 1), (5, 130, 32),
                                     (33, 300, 32), (17, 1000, 3)])
def test_set_intersect(cuda_device, na, nb, W):
    rng = np.random.default_rng(na + nb + W)
    sa = torch.from_numpy(rng.integers(0, 2 ** 32, (na, W))).to(cuda_device)
    sb = torch.from_numpy(rng.integers(0, 2 ** 32, (nb, W))).to(cuda_device)
    sb[0] = 0xFFFFFFFF
    sa[-1] = -1                      # all 64 bits: both versions count them
    ops.reset_launches()
    got = set_intersect.intersect_counts(sa, sb)
    assert ops.LAUNCHES["set_intersect"] == 1
    assert got.dtype == torch.int32
    assert torch.equal(got, ref.set_intersect_count(sa, sb))


@pytest.mark.parametrize("nq,nd,W", [(1, 1, 2), (37, 130, 2), (300, 257, 2),
                                     (129, 700, 3), (65, 33, 5)])
def test_nn_distance(cuda_device, nq, nd, W):
    rng = np.random.default_rng(nq + nd + W + 1)
    q, d = _pts(rng, (nq, W), cuda_device), _pts(rng, (nd, W), cuda_device)
    d[nd // 2] = d[0]                # a tie: the first index wins
    qv, dv = _mask(rng, (nq,), cuda_device), _mask(rng, (nd,), cuda_device)
    dv[128:256] = False              # a whole invalid tile
    ops.reset_launches()
    got = nn_distance.nn_distance(q, d, qv, dv)
    assert ops.LAUNCHES["nn_distance"] == 1
    want = ref.nn_distance(q, d, qv, dv)
    assert _bits_equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_nn_distance_all_invalid(cuda_device):
    """No valid D point: every valid row gets BIG's root at index 0, as the
    plain argmin over an all-BIG row gives."""
    rng = np.random.default_rng(2)
    q, d = _pts(rng, (20, 2), cuda_device), _pts(rng, (300, 2), cuda_device)
    qv = _mask(rng, (20,), cuda_device)
    dv = torch.zeros(300, dtype=torch.bool, device=cuda_device)
    got = nn_distance.nn_distance(q, d, qv, dv)
    want = ref.nn_distance(q, d, qv, dv)
    assert _bits_equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert torch.all(got[1][qv] == 0)


def _pair_inputs(rng, dev, P, nq, nd, W, shared_q=False):
    """Query rows (one set shared by every pair, or one set per pair) with
    a random mask; P datasets whose valid points form a ragged prefix with
    holes, the last of them with no valid point where P >= 3; tied points
    at indices 0, 1 and nd // 2; masked points and rows hold inf."""
    q = _pts(rng, (nq, W) if shared_q else (P, nq, W), dev)
    qv = _mask(rng, q.shape[:-1], dev, p=0.7)
    ds = _pts(rng, (P, nd, W), dev)
    n_valid = rng.integers(1, nd + 1, P)
    dv = np.arange(nd)[None, :] < n_valid[:, None]
    dv &= rng.random((P, nd)) > 0.1
    dv[:, :2] = True
    if P >= 3:
        dv[-1] = False
    dv = torch.from_numpy(dv).to(dev)
    ds[:, 1:2] = ds[:, :1]
    ds[:, nd // 2] = ds[:, 0]
    ds[~dv] = float("inf")
    q[~qv] = float("inf")
    return q, qv, ds, dv


def _check_min_pairs(q, qv, ds, dv):
    """The pair kernel against its plain version, and the Hausdorff op on
    the card against the same op on the CPU."""
    ops.reset_launches()
    got = hausdorff.min_sq_dists_pairs(q, ds, qv, dv)
    assert ops.LAUNCHES["min_sq_dists"] == 1
    assert got.shape == (ds.shape[0], q.shape[0])
    assert _bits_equal(got, ref.min_sq_dists_pairs(q, ds, qv, dv))
    ops.reset_launches()
    h = ops.directed_hausdorff_pairs(q, ds, qv, dv)
    assert ops.LAUNCHES["min_sq_dists"] == 1
    assert _bits_equal(h, ops.directed_hausdorff_pairs(
        q.cpu(), ds.cpu(), qv.cpu(), dv.cpu()).to(h.device))
    return got, h


def _check_nn_pairs(qs, qsv, ds, dv):
    ops.reset_launches()
    got = nn_distance.nn_distance_batched(qs, ds, qsv, dv)
    assert ops.LAUNCHES["nn_distance"] == 1
    want = ref.nn_distance_batched(qs, ds, qsv, dv)
    assert _bits_equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    return got


_PAIR_SHAPES = [(1, 1, 1, 2), (1, 300, 257, 2), (5, 37, 130, 2),
                (4, 129, 700, 3), (3, 200, 513, 1), (3, 65, 33, 4),
                (3, 65, 33, 5), (3, 65, 33, 6), (3, 65, 33, 7),
                (3, 65, 33, 8), (33, 130, 600, 2)]


@pytest.mark.parametrize("P,nq,nd,W", _PAIR_SHAPES)
def test_min_sq_dists_pairs(cuda_device, P, nq, nd, W):
    """P = 1 and P > 1, nq and nd off the 128-row and 256-point tiles, nd
    past one tile, W = 1..8, a pair with no valid point, ties, inf in
    masked points and rows."""
    rng = np.random.default_rng(P * nq + nd + W + 3)
    q, qv, ds, dv = _pair_inputs(rng, cuda_device, P, nq, nd, W,
                                 shared_q=True)
    got, h = _check_min_pairs(q, qv, ds, dv)
    if P >= 3:
        assert torch.all(got[-1] == ref.BIG)
    # a one-pair call equals that pair of the batch
    ops.reset_launches()
    assert _bits_equal(ops.directed_hausdorff(q, ds[0], qv, dv[0]), h[0])
    assert ops.LAUNCHES["min_sq_dists"] == 1


def test_min_sq_dists_pairs_no_valid_row(cuda_device):
    """A query set with no valid row: BIG rows and -BIG distances."""
    rng = np.random.default_rng(5)
    q, qv, ds, dv = _pair_inputs(rng, cuda_device, 4, 300, 400, 2,
                                 shared_q=True)
    qv[:] = False
    got, h = _check_min_pairs(q, qv, ds, dv)
    assert torch.all(got == ref.BIG) and torch.all(h == -ref.BIG)


@pytest.mark.parametrize("P,nq,nd,W", _PAIR_SHAPES)
def test_nn_distance_batched(cuda_device, P, nq, nd, W):
    """As ``test_min_sq_dists_pairs``, with a query set per pair, one of
    which has no valid row; tied points: the first index wins."""
    rng = np.random.default_rng(P * nq + nd + W + 4)
    qs, qsv, ds, dv = _pair_inputs(rng, cuda_device, P, nq, nd, W)
    if P >= 3:
        qsv[-2] = False
    dist, idx = _check_nn_pairs(qs, qsv, ds, dv)
    if P >= 3:
        assert torch.all(idx[-2] == -1) and torch.all(dist[-2] == 0)
        # no valid point: BIG's root at index 0
        assert torch.all(idx[-1][qsv[-1]] == 0)
    assert not torch.any(idx[qsv] == 1)        # 0 comes first, 1 ties it
    ops.reset_launches()
    one = ops.nn_distance(qs[0], ds[0], qsv[0], dv[0])
    assert ops.LAUNCHES["nn_distance"] == 1
    assert _bits_equal(one[0], dist[0]) and torch.equal(one[1], idx[0])


@pytest.mark.parametrize("W", [1, 2])
def test_pair_kernels_overflow(cuda_device, W):
    """Squares near and past BIG (coordinates near 1e19): pair 0 has every
    point valid and, for W = 2, every distance infinite (NN: infinity at
    the first valid index); pair 1 the same with holes (NN: BIG at the
    first invalid index); pair 2 some points near the queries; pair 3 no
    valid point.  Masked points hold inf."""
    rng = np.random.default_rng(40 + W)
    P, nq, nd = 4, 70, 300
    dev = cuda_device
    qs = torch.from_numpy(-rng.uniform(0.8e19, 1e19, (P, nq, W))
                          .astype(np.float32)).to(dev)
    ds = torch.from_numpy(rng.uniform(0.8e19, 1e19, (P, nd, W))
                          .astype(np.float32)).to(dev)
    ds[2, 100:110] = qs[2, :10] + 1.0
    qsv = torch.ones((P, nq), dtype=torch.bool, device=dev)
    qsv[:, -3:] = False
    dv = torch.ones((P, nd), dtype=torch.bool, device=dev)
    dv[1, 7::5] = False
    dv[2, 200:] = False
    dv[3] = False
    ds[~dv] = float("inf")
    dist, idx = _check_nn_pairs(qs, qsv, ds, dv)
    if W == 2:
        assert torch.all(idx[0][qsv[0]] == 0)
        assert torch.all(torch.isinf(dist[0][qsv[0]]))
        assert torch.all(idx[1][qsv[1]] == 7)
    assert torch.all(idx[3][qsv[3]] == 0)
    _check_min_pairs(qs[2], qsv[2], ds, dv)
    _check_min_pairs(qs[0], qsv[0], ds, dv)


@pytest.mark.parametrize("P,nq,nd,W", [(1, 1, 1, 2), (3, 16, 130, 2),
                                       (5, 256, 256, 2), (2, 33, 300, 3)])
def test_bound_matrices(cuda_device, P, nq, nd, W):
    rng = np.random.default_rng(P + nq + nd + W)
    oq, od = _pts(rng, (P, nq, W), cuda_device), _pts(rng, (P, nd, W),
                                                       cuda_device)
    rq, rd = (torch.from_numpy(rng.uniform(0, 3, (P, n)).astype(np.float32))
              .to(cuda_device) for n in (nq, nd))
    ops.reset_launches()
    got = bound_matrix.bound_matrices(oq, rq, od, rd)
    assert ops.LAUNCHES["bound_matrices"] == 1
    for g, w in zip(got, ref.bound_matrix(oq, rq, od, rd)):
        assert _bits_equal(g, w)
    # a batch of one pair equals that pair in the larger batch
    lb0, ub0 = ops.bound_matrices(oq[:1], rq[:1], od[:1], rd[:1])
    assert _bits_equal(lb0, got[0][:1]) and _bits_equal(ub0, got[1][:1])


def _frontiers(rng, dev, P, nq, nd, W):
    oq, od = _pts(rng, (P, nq, W), dev), _pts(rng, (P, nd, W), dev)
    rq, rd = (torch.from_numpy(rng.uniform(0, 3, (P, n)).astype(np.float32))
              .to(dev) for n in (nq, nd))
    return oq, rq, od, rd


@pytest.mark.parametrize("P,nq,nd,W", [(1, 1, 1, 2), (3, 16, 130, 2),
                                       (5, 256, 256, 2), (2, 33, 300, 3)])
def test_bound_matrices_ub_only(cuda_device, P, nq, nd, W):
    """A null lb: the kernel writes ub only, the same bits."""
    rng = np.random.default_rng(P + nq + nd + W + 7)
    args = _frontiers(rng, cuda_device, P, nq, nd, W)
    ops.reset_launches()
    lb, ub = bound_matrix.bound_matrices(*args, with_lb=False)
    assert lb is None and ops.LAUNCHES["bound_matrices"] == 1
    assert _bits_equal(ub, ref.bound_matrix(*args)[1])


def _row_ub_edges(rng, dev, P, nq, nd, W):
    """Random frontiers whose last pairs hold the edge rows: no occupied
    node, exactly one, every node occupied with a tied pair; masked nodes
    hold inf and NaN centers and radii."""
    oq, rq, od, rd = _frontiers(rng, dev, P, nq, nd, W)
    d_ok = torch.from_numpy(rng.random((P, nd)) < 0.5).to(dev)
    if P >= 4:
        d_ok[P - 3] = False
        d_ok[P - 2] = False
        d_ok[P - 2, nd // 2] = True
        d_ok[P - 1] = True
        od[P - 1, -1], rd[P - 1, -1] = od[P - 1, 0], rd[P - 1, 0]
    od[~d_ok] = float("nan")
    od[..., 0] = torch.where(d_ok, od[..., 0], float("inf"))
    rd[~d_ok] = float("nan")
    return oq, rq, od, rd, d_ok


@pytest.mark.parametrize("P,nq,nd,W", [
    (1, 1, 1, 2), (4, 37, 130, 2), (5, 256, 256, 2), (6, 33, 700, 2),
    (4, 17, 19, 1), (4, 9, 41, 3), (4, 9, 41, 4), (4, 9, 41, 5),
    (4, 9, 41, 6), (4, 9, 41, 7), (4, 9, 41, 8), (130, 40, 1100, 2)])
def test_bound_row_ub(cuda_device, P, nq, nd, W):
    """Ragged P, nq and nd (nd past one staged chunk of 512 nodes, and not
    a multiple of it), W = 1..8, and the edge rows."""
    rng = np.random.default_rng(P * nq + nd + W)
    args = _row_ub_edges(rng, cuda_device, P, nq, nd, W)
    ops.reset_launches()
    got = bound_matrix.bound_row_ub(*args)
    assert ops.LAUNCHES["bound_row_ub"] == 1
    assert got.shape == (P, nq)
    want = ref.bound_row_ub(*args)
    assert _bits_equal(got, want)
    if P >= 4:
        assert torch.all(got[P - 3] == ref.BIG)
        assert torch.all(got[P - 1] < ref.BIG)


@pytest.mark.parametrize("na,nb,W", [(64, 16384, 32), (65, 1000, 33),
                                     (3, 127, 5), (130, 70, 64)])
def test_set_intersect_tiles(cuda_device, na, nb, W):
    """The path's shape, and ragged tiles and word chunks."""
    rng = np.random.default_rng(na * nb + W)
    sa = torch.from_numpy(rng.integers(0, 2 ** 32, (na, W))).to(cuda_device)
    sb = torch.from_numpy(rng.integers(0, 2 ** 32, (nb, W))).to(cuda_device)
    ops.reset_launches()
    got = set_intersect.intersect_counts(sa, sb)
    assert ops.LAUNCHES["set_intersect"] == 1
    assert torch.equal(got, ref.set_intersect_count(sa, sb))


def test_set_intersect_high_half_in_one_block(cuda_device):
    """Set high halves in the slot words of one block (slots 128..191,
    words 32..39): that block counts the chunk with all 64 bits, every
    other block with 32."""
    rng = np.random.default_rng(12)
    sa = torch.from_numpy(rng.integers(0, 2 ** 32, (64, 40))).to(cuda_device)
    sb = torch.from_numpy(rng.integers(0, 2 ** 32, (300, 40))).to(cuda_device)
    sa[:, 32:] |= 0xFFFF                 # low bits the wide words meet
    sb[130, 35] |= 1 << 40
    sb[131, 36] = -1                     # all 64 bits, the sign bit too
    got = set_intersect.intersect_counts(sa, sb)
    assert torch.equal(got, ref.set_intersect_count(sa, sb))


def test_kernel_refuses_bad_input(cuda_device):
    q = torch.zeros((4, 2), device=cuda_device)
    v = torch.ones(4, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        hausdorff.min_sq_dists(q.t().contiguous().t(), q, v)
    with pytest.raises(ValueError, match="float32"):
        hausdorff.min_sq_dists(q.double(), q, v)
    with pytest.raises(ValueError, match="int64"):
        set_intersect.intersect_counts(v[None].int(), v[None].long())
    i32 = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        hausdorff.hausdorff_lanes(q[None], i32.long(), q[None], v[None], i32,
                                  i32[None].long(), v[None, :1])
    with pytest.raises(ValueError, match="shapes"):
        hausdorff.hausdorff_lanes(q[None], i32, q[None], v[None, :3], i32,
                                  i32[None].long(), v[None, :1])
    with pytest.raises(ValueError, match="shapes"):
        nn_distance.nn_distance(q, q, v[:3], v)
    with pytest.raises(ValueError, match="shapes"):
        hausdorff.min_sq_dists_pairs(q, q[None], v[:3], v[None])
    with pytest.raises(ValueError, match="shapes"):
        nn_distance.nn_distance_batched(q[None], q[None, :3], v[None],
                                        v[None])
    with pytest.raises(ValueError, match="shapes"):
        bound_matrix.bound_matrices(q[None], v[None].float(), q[None],
                                    v[None, :3].float())
    with pytest.raises(ValueError, match="shapes"):
        bound_matrix.bound_row_ub(q[None], v[None].float(), q[None],
                                  v[None].float(), v[None, :3])
    with pytest.raises(ValueError, match="bool"):
        bound_matrix.bound_row_ub(q[None], v[None].float(), q[None],
                                  v[None].float(), v[None].float())


def _plain_intersect(sa, sb, rows=64):
    """The plain counts in row blocks: one call's (na, nb, W) int64
    temporary is gigabytes at the coverage bound's shape."""
    return torch.cat([ref.set_intersect_count(sa[i:i + rows], sb)
                      for i in range(0, sa.shape[0], rows)])


@pytest.mark.parametrize("na,nb,W", [
    (32, 16384, 32),                 # overlap bound: B x S x 32
    (416, 16384, 32),                # coverage bound: (B * P) x S x 32
    (32, 32, 512),                   # overlap refine: B x chunk x 512
    (416, 32, 512),                  # coverage refine: (B * P) x chunk x 512
    (413, 29, 512), (7, 31, 500)])   # ragged rows, slots and words
def test_set_intersect_join_shapes(cuda_device, na, nb, W):
    """The joinable ops' shapes: one launch each, exact."""
    rng = np.random.default_rng(na + nb + W)
    sa = torch.from_numpy(rng.integers(0, 2 ** 32, (na, W))).to(cuda_device)
    sb = torch.from_numpy(rng.integers(0, 2 ** 32, (nb, W))).to(cuda_device)
    sa[:, ::3] = 0                   # sparse words, as histogram planes are
    ops.reset_launches()
    got = set_intersect.intersect_counts(sa, sb)
    assert ops.LAUNCHES["set_intersect"] == 1
    assert torch.equal(got, _plain_intersect(sa, sb))


def test_plane_weighted_intersect(cuda_device):
    """(B, P, W) planes against (S, W) signatures: one launch of (B * P)
    rows, equal to the CPU's plain path."""
    rng = np.random.default_rng(3)
    planes = torch.from_numpy(rng.integers(0, 2 ** 32, (5, 13, 512)))
    sigs = torch.from_numpy(rng.integers(0, 2 ** 32, (29, 512)))
    ops.reset_launches()
    got = ops.plane_weighted_intersect(planes.to(cuda_device),
                                       sigs.to(cuda_device))
    assert ops.LAUNCHES["set_intersect"] == 1
    assert torch.equal(got.cpu(), ops.plane_weighted_intersect(planes, sigs))


def _join_repos(cuda_device):
    """One small repository on the CPU and the same index on the card."""
    from repro_torch import bridge
    from repro_torch.core.build import build_repository

    rng = np.random.default_rng(9)
    datasets = [(rng.uniform(-50, 50, 2)
                 + rng.normal(size=(int(rng.integers(30, 120)), 2)) * 3
                 ).astype(np.float32) for _ in range(45)]
    cpu, _ = build_repository(datasets, leaf_capacity=16, theta=5,
                              remove_outliers=False, device="cpu")
    card = bridge.repository_to_torch(bridge.to_numpy(cpu), device=cuda_device)
    return datasets, cpu, card


def test_join_search_on_card(cuda_device):
    """Both joinable ops and the dataset -> dataset pipeline on the card
    equal the CPU's plain path: vals, ids and stats."""
    from repro_torch.engine import Pipeline, Query, QueryEngine

    datasets, cpu, card = _join_repos(cuda_device)
    qs = [datasets[i][:70] for i in (0, 5, 17)]
    lo, hi = qs[0].min(axis=0) - 5, qs[0].max(axis=0) + 5
    items = ([Query(op=op, q=q, k=4) for op in ("topk_overlap",
                                                "topk_coverage") for q in qs]
             + [Pipeline(Query(op="topk_ia", r_lo=lo, r_hi=hi, k=6),
                         Query(op="topk_coverage", q=qs[0], k=3))])
    want = QueryEngine(cpu, result_cache_size=0, default_chunk=8).search(
        items)
    ops.reset_launches()
    got = QueryEngine(card, result_cache_size=0, default_chunk=8).search(
        items)
    assert ops.LAUNCHES["set_intersect"] > 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.vals, w.vals)
        np.testing.assert_array_equal(g.ids, w.ids)
        assert g.stats == w.stats


def test_server_on_card(cuda_device):
    """The server's dispatcher thread drives the card; each response
    equals a direct search of its item."""
    from repro_torch.engine import QueryEngine
    from repro_torch.launch import serve_search

    datasets, _, card = _join_repos(cuda_device)
    engine = QueryEngine(card)
    server = serve_search.SearchServer(engine, max_batch=32)
    traffic = serve_search.make_traffic(card.space_lo, card.space_hi,
                                        datasets, 36, seed=1)
    server.start()
    try:
        futures = [server.submit(op, **p) for op, p in traffic]
        got = [f.result(timeout=300) for f in futures]
    finally:
        server.stop()
    direct = QueryEngine(card, result_cache_size=0)
    for (op, p), res in zip(traffic, got):
        want = serve_search._legacy_result(
            direct.search([serve_search._to_query(op, p)])[0])
        if op == "pipeline":
            res, want = (res.vals, res.ids, res.mask), (want.vals, want.ids,
                                                        want.mask)
        for a, b in zip(res if isinstance(res, tuple) else (res,),
                        want if isinstance(want, tuple) else (want,)):
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


def test_live_repository_on_card(cuda_device):
    """The live repository on the card: after ingests (one crossing the
    tier), a replace, a delete and a coalesced group, the resident
    repository equals ``build_frozen`` bit for bit, and a mixed batch with
    every op equals a cold engine over it (vals, ids, masks)."""
    from repro_torch.engine import LiveRepository, Query, QueryEngine

    rng = np.random.default_rng(12)

    def mk(n):
        return (rng.uniform(-40, 40, 2)
                + rng.normal(size=(n, 2)) * 3).astype(np.float32)

    live = LiveRepository([mk(int(n)) for n in rng.integers(20, 60, 12)],
                          leaf_capacity=8, point_capacity=64,
                          result_cache_size=64)
    assert live.repo.device.type == "cuda" and live.n_slots == 16
    for _ in range(5):
        live.ingest(mk(40))
    live.replace(3, mk(50))
    live.delete(5)
    live.publish_group(live.prepare_group(
        [("ingest", None, mk(30)), ("replace", 0, mk(20)),
         ("delete", 7, None), ("replace", 0, mk(25))]))
    assert live.n_slots == 32 and live.engine.dispatch.repo_epoch == 1
    frozen = live.frozen_repository()
    for a, b in zip(bridge_leaves(live.repo), bridge_leaves(frozen)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    q = mk(24)
    lo, hi = q.min(axis=0) - 5, q.max(axis=0) + 5
    items = [Query(op="range_search", r_lo=lo, r_hi=hi),
             Query(op="topk_ia", r_lo=lo, r_hi=hi, k=4),
             Query(op="topk_gbo", q_sig=np.zeros(32, np.uint32), k=3),
             Query(op="topk_hausdorff_approx", q=q, k=3, eps=1.0),
             Query(op="topk_hausdorff", q=q, k=3),
             Query(op="range_points", ds_id=2, r_lo=lo, r_hi=hi),
             Query(op="nnp", ds_id=4, q=q),
             Query(op="topk_overlap", q=q, k=3),
             Query(op="topk_coverage", q=q, k=3)]
    ops.reset_launches()
    got = live.search(items)
    assert ops.LAUNCHES["hausdorff_grid"] > 0
    assert ops.LAUNCHES["set_intersect"] > 0
    want = QueryEngine(frozen, leaf_capacity=8).search(items)
    for g, w in zip(got, want):
        for f in ("vals", "ids", "mask"):
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def bridge_leaves(repo):
    from repro_torch import bridge

    def leaves(x):
        if isinstance(x, tuple):
            for y in x:
                yield from leaves(y)
        else:
            yield x

    return list(leaves(tuple(bridge.to_numpy(repo))))


def test_sharded_engines_on_card(cuda_device):
    """The sharded (3 shards) and replicated (2 x 2) engines with every
    shard on the one card: every op and pipeline kind bitwise equal to the
    local engine on the card, the kernels launched per shard."""
    from repro_torch.core.build import build_repository
    from repro_torch.engine import (QueryEngine, ReplicatedQueryEngine,
                                    ShardedQueryEngine, data_mesh,
                                    replica_mesh)
    from test_torch_sharded import (assert_results_bitwise, every_op_batch,
                                    make_env)

    env = make_env()
    env.repo, _ = build_repository(env.datasets, leaf_capacity=16, theta=5,
                                   remove_outliers=False, device=cuda_device)
    batch = every_op_batch(env)
    want = QueryEngine(env.repo, result_cache_size=0).search(batch)
    for engine in (
            ShardedQueryEngine(env.repo, mesh=data_mesh(
                devices=[cuda_device] * 3), result_cache_size=0),
            ReplicatedQueryEngine(env.repo, mesh=replica_mesh(
                2, 2, [cuda_device] * 4), result_cache_size=0)):
        ops.reset_launches()
        assert_results_bitwise(engine.search(batch), want)
        for name in ("bound_grid", "hausdorff_grid", "set_intersect",
                     "bound_row_ub"):
            assert ops.LAUNCHES[name] > 0, name


def test_graphed_row_build_equals_eager(cuda_device):
    """On the card every row stage replays a CUDA graph captured at its
    first call: at T-Drive's row shape (4,096 points) each row, and the
    whole ``init_live`` repository, equal the eager stages bit for bit,
    also for a row built on a second thread while the first one queues
    work."""
    import threading

    from repro_torch.core import repo_mutate
    from repro_torch.data import synthetic

    datasets = synthetic.trajectory_repository(24, seed=5,
                                               n_points=(100, 2800))
    repo, geom = repo_mutate.init_live(datasets, leaf_capacity=16, theta=5,
                                       point_capacity=4096,
                                       device=cuda_device)
    assert geom.point_capacity == 4096 and geom.r_prime is not None

    rows = [_eager_row(ds, geom, cuda_device) for ds in datasets]
    for ds, want in zip(datasets[:8], rows):
        got = repo_mutate.build_row(ds, geom, device=cuda_device)
        for a, b in zip(leaves(got), leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    cold = repo_mutate.assemble(*repo_mutate._scatter_rows(
        repo_mutate._cat_rows([r[0] for r in rows]),
        torch.cat([r[1] for r in rows]), np.arange(len(rows)), geom), geom)
    for a, b in zip(leaves(repo), leaves(cold)):
        assert a.dtype == b.dtype and torch.equal(a, b)

    side = {}
    thread = threading.Thread(target=lambda: side.update(
        row=repo_mutate.build_row(datasets[3], geom, device=cuda_device)))
    thread.start()
    x = torch.rand(2048, 2048, device=cuda_device)
    for _ in range(8):
        x = x @ x.T / 2048
    thread.join(timeout=300)
    assert not thread.is_alive()
    for a, b in zip(leaves(side["row"]), leaves(rows[3])):
        assert torch.equal(a, b)


def _eager_row(ds, geom, dev):
    """One row built by calling the three row stages eagerly."""
    from repro_torch.core import repo_mutate

    pts, val = repo_mutate._host_pad(ds, geom)
    tree = repo_mutate._tree_stage(geom.bottom_depth, pts.to(dev),
                                   val.to(dev))
    tree = repo_mutate._outlier_stage(geom.r_prime, *tree)
    return tree, repo_mutate._signature_stage(
        geom.theta, tree.points, tree.valid, *geom.space_bounds(dev))


def test_graphed_stages_key_on_shape_and_own_their_operands(cuda_device):
    """Two geometries with one bottom depth and different leaf capacities
    (so different row shapes) each replay their own graph, and a replay
    after the grid bounds' cache is cleared and its memory handed out
    again still equals the eager stages bit for bit: a stage's graph
    reads only tensors it owns."""
    from repro_torch.core import repo_mutate
    from repro_torch.data import synthetic

    datasets = synthetic.trajectory_repository(10, seed=9,
                                               n_points=(60, 500))
    kw = dict(theta=5, device=cuda_device)
    geoms = [repo_mutate.init_live(datasets, leaf_capacity=16,
                                   point_capacity=1024, **kw)[1],
             repo_mutate.init_live(datasets, leaf_capacity=8,
                                   point_capacity=512, **kw)[1]]
    assert geoms[0].bottom_depth == geoms[1].bottom_depth
    assert geoms[0].point_capacity != geoms[1].point_capacity

    def check():
        for geom in geoms:
            for ds in datasets[:3]:
                got = repo_mutate.build_row(ds, geom, device=cuda_device)
                want = _eager_row(ds, geom, cuda_device)
                for a, b in zip(leaves(got), leaves(want)):
                    assert a.dtype == b.dtype and torch.equal(a, b)

    check()
    repo_mutate._bounds.cache_clear()
    # blocks of the bounds' size, so the freed ones are handed out again
    junk = [torch.full((2,), 1e9, device=cuda_device) for _ in range(4096)]
    check()
    del junk


def leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    else:
        for y in x:
            yield from leaves(y)


@pytest.mark.parametrize("grid", [(1, 3), (2, 2)])
def test_live_mesh_on_card(cuda_device, grid):
    """The live repository on a mesh of the one card (3 shards, and a
    (2, 2) replica grid): after ingests (one crossing the tier), a
    replace, a delete and a coalesced group, every shard equals
    ``shard_repository(build_frozen(...))`` bit for bit, and a batch of
    every op equals the local live engine on the card (vals, ids,
    masks), with the kernels launched per shard."""
    from repro_torch.core.distributed import DATA_AXIS, Mesh
    from repro_torch.engine import (LiveRepository, Query, data_mesh,
                                    replica_mesh)
    from repro_torch.engine.sharded import shard_repository

    R, D = grid
    mesh = (data_mesh(devices=[cuda_device] * D) if R == 1
            else replica_mesh(R, D, [cuda_device] * (R * D)))
    rng = np.random.default_rng(21)

    def mk(n):
        return (rng.uniform(-40, 40, 2)
                + rng.normal(size=(n, 2)) * 3).astype(np.float32)

    init = [mk(int(n)) for n in rng.integers(20, 60, 12)]
    kw = dict(leaf_capacity=8, point_capacity=64, result_cache_size=64,
              device=cuda_device)
    live = LiveRepository(init, mesh=mesh, **kw)
    local = LiveRepository(init, **kw)
    later = [mk(40) for _ in range(5)] + [mk(50), mk(30), mk(20), mk(25)]
    for lv in (live, local):
        for pts in later[:5]:
            lv.ingest(pts)
        lv.replace(3, later[5])
        lv.delete(5)
        lv.publish_group(lv.prepare_group(
            [("ingest", None, later[6]), ("replace", 0, later[7]),
             ("delete", 7, None), ("replace", 0, later[8])]))
    assert live.n_slots == 32 and live.engine.dispatch.repo_epoch == 1
    frozen = live.frozen_repository()
    rows = ([Mesh(r, (DATA_AXIS,)) for r in mesh.devices] if R > 1
            else [mesh])
    for L, row in zip(live.engine.dispatch.layouts, rows):
        want, _ = shard_repository(frozen, row)
        for got, w in zip(L.shards, want):
            for a, b in zip(leaves(got), leaves(w)):
                assert a.dtype == b.dtype and torch.equal(a, b)
    q = mk(24)
    lo, hi = q.min(axis=0) - 5, q.max(axis=0) + 5
    items = [Query(op="range_search", r_lo=lo, r_hi=hi),
             Query(op="topk_ia", r_lo=lo, r_hi=hi, k=4),
             Query(op="topk_gbo", q_sig=np.zeros(32, np.uint32), k=3),
             Query(op="topk_hausdorff_approx", q=q, k=3, eps=1.0),
             Query(op="topk_hausdorff", q=q, k=3),
             Query(op="range_points", ds_id=2, r_lo=lo, r_hi=hi),
             Query(op="nnp", ds_id=4, q=q),
             Query(op="topk_overlap", q=q, k=3),
             Query(op="topk_coverage", q=q, k=3)]
    ops.reset_launches()
    got = live.search(items)
    for name in ("bound_grid", "set_intersect", "bound_row_ub"):
        assert ops.LAUNCHES[name] >= D, name
    assert ops.LAUNCHES["hausdorff_grid"] > 0
    for g, w in zip(got, local.search(items)):
        for f in ("vals", "ids", "mask"):
            a, b = getattr(g, f), getattr(w, f)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()

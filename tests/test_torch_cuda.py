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


@pytest.mark.parametrize("P,nq,nd", [(1, 256, 128), (1, 129, 256),
                                     (10357, 8, 8), (700, 4, 16),
                                     (2 * 65535 + 3, 1, 4)])
def test_bound_matrices_pair_and_frontier_shapes(cuda_device, P, nq, nd):
    """The shapes of ``hausdorff_pair_exact`` (P = 1, leaf frontiers) and
    of ``frontier_bounds`` (one pair a slot, a level's nodes each side,
    the query frontier repeated on the pair axis); past the grid's
    65,535 pairs, one launch for each 65,535."""
    rng = np.random.default_rng(P + nq + nd)
    oq, rq, od, rd = _frontiers(rng, cuda_device, P, nq, nd, 2)
    if P > 1:
        oq, rq = oq[:1].expand(P, -1, -1).contiguous(), rq[:1].expand(
            P, -1).contiguous()
    ops.reset_launches()
    got = bound_matrix.bound_matrices(oq, rq, od, rd)
    launches = -(-P // bound_matrix.MAX_GRID_YZ)
    assert ops.LAUNCHES["bound_matrices"] == launches
    for g, w in zip(got, ref.bound_matrix(oq, rq, od, rd)):
        assert _bits_equal(g, w)


def _pair_repos(cuda_device):
    """A small repository and a query tree on the CPU, and the same
    indexes on the card."""
    from repro_torch import bridge
    from repro_torch.core.build import build_query_index, build_repository

    rng = np.random.default_rng(13)
    datasets = [(rng.uniform(-50, 50, 2)
                 + rng.normal(size=(int(rng.integers(30, 300)), 2)) * 3
                 ).astype(np.float32) for _ in range(40)]
    cpu, _ = build_repository(datasets, leaf_capacity=16, theta=5,
                              remove_outliers=False, device="cpu")
    card = bridge.repository_to_torch(bridge.to_numpy(cpu), device=cuda_device)
    q_cpu, sig = build_query_index(datasets[3][:200] + 1.5, theta=5,
                                   space_lo=cpu.space_lo,
                                   space_hi=cpu.space_hi, device="cpu")
    q_card = bridge.index_to_torch(bridge.to_numpy(q_cpu), cuda_device)
    return cpu, card, (q_cpu, sig), (q_card, sig.to(cuda_device))


def test_pair_ops_on_card(cuda_device):
    """``frontier_bounds`` is bitwise level l of ``bound_grid``, one
    ``bound_matrices`` launch a call; ``hausdorff_pair_exact`` makes one
    launch a call and, like the pair approximation and the GBO traversal
    stats, equals the CPU's plain path."""
    from repro_torch.core import search
    from repro_torch.core.index import DatasetIndex

    cpu, card, (q_cpu, sig_cpu), (q_card, sig_card) = _pair_repos(cuda_device)
    batch = DatasetIndex(*[x[None] for x in q_card])
    LBs, UBs = search._frontier_bound_all_levels(batch, card.ds_index, 3)
    for level in range(4):
        ops.reset_launches()
        LB, UB = search.frontier_bounds(q_card, card.ds_index, level, level)
        assert ops.LAUNCHES["bound_matrices"] == 1
        assert _bits_equal(LB, LBs[level, 0]) and _bits_equal(UB, UBs[level, 0])
    for j in (0, 3, 17, 39):
        row = lambda r: DatasetIndex(*[x[j] for x in r.ds_index])  # noqa
        ops.reset_launches()
        h, pruned = search.hausdorff_pair_exact(q_card, row(card))
        assert ops.LAUNCHES["bound_matrices"] == 1
        wh, wp = search.hausdorff_pair_exact(q_cpu, row(cpu))
        assert _bits_equal(h.cpu(), wh) and _bits_equal(pruned.cpu(), wp)
        a = search.hausdorff_pair_approx(q_card, row(card), 2.0)
        assert _bits_equal(a.cpu(), search.hausdorff_pair_approx(
            q_cpu, row(cpu), 2.0))
    ops.reset_launches()
    stats = search.gbo_frontier_stats(card, sig_card, 5)
    assert ops.LAUNCHES["set_intersect"] == 1
    assert stats == search.gbo_frontier_stats(cpu, sig_cpu, 5)


def test_topk_emd_on_card(cuda_device):
    """Histograms bitwise the CPU's; the top-k values within 1e-4 of the
    CPU's (the matrix products sum in another order), ids equal where
    neighbouring values differ by more; full FP32 products."""
    from repro_torch.core import emd

    assert torch.get_float32_matmul_precision() == "highest"
    cpu, card, _, _ = _pair_repos(cuda_device)
    for i in (0, 7, 21):
        for prefilter in (0, 16):
            want = emd.topk_emd(cpu, cpu.ds_index.points[i],
                                cpu.ds_index.valid[i], 10, prefilter=prefilter)
            got = emd.topk_emd(card, card.ds_index.points[i],
                               card.ds_index.valid[i], 10, prefilter=prefilter)
            gv, gi = (x.cpu().numpy() for x in got)
            wv, wi = (x.numpy() for x in want)
            np.testing.assert_allclose(gv, wv, rtol=1e-4)
            assert gi[0] == wi[0] == i
            gaps = np.abs(np.diff(wv)) > 1e-4 * np.abs(wv[1:])
            sure = np.concatenate([[True], gaps]) & np.concatenate([gaps,
                                                                    [True]])
            np.testing.assert_array_equal(gi[sure], wi[sure])
    idx = card.ds_index
    h = emd.cell_histogram(idx.points, idx.valid, card.space_lo,
                           card.space_hi, 4)
    want = emd.cell_histogram(cpu.ds_index.points, cpu.ds_index.valid,
                              cpu.space_lo, cpu.space_hi, 4)
    assert _bits_equal(h.cpu(), want)


# -- launch-shape variants (repro_torch.kernels.autotune) --------------------

@pytest.mark.parametrize("v", range(4))
@pytest.mark.parametrize("B,C,nq,S,nd,W", [(1, 1, 1, 1, 1, 2),
                                           (3, 5, 300, 40, 513, 2),
                                           (2, 3, 1100, 9, 70, 2),
                                           (2, 4, 50, 30, 1500, 3),
                                           (1, 2, 8, 4, 20, 8)])
def test_hausdorff_lanes_variants(cuda_device, v, B, C, nq, S, nd, W):
    """Every launch shape of the lanes kernel is bitwise the plain version:
    row counts past one and several row blocks of each shape, more points
    than a tile, W = 8 (the most shared memory)."""
    from repro_torch.kernels import autotune
    cfg = autotune.VARIANTS["hausdorff_grid"][v]
    rng = np.random.default_rng(100 * v + B + C + nq + nd)
    q, qv, pts, pv, ids, live = _lanes_inputs(rng, cuda_device, B, C, nq,
                                              S, nd, W)
    q_c, n_q = hausdorff.compact_rows(q, qv)
    extent = hausdorff.valid_extent(pv)
    ops.reset_launches()
    got = ops.directed_hausdorff_lanes(q_c, n_q, pts, pv, extent, ids, live,
                                       config=cfg)
    assert ops.LAUNCHES["hausdorff_grid"] == 1
    want = ops.directed_hausdorff_lanes_plain(q_c, n_q, pts, pv, extent,
                                              ids, live)
    assert _bits_equal(got, want)


@pytest.mark.parametrize("v", range(4))
@pytest.mark.parametrize("P,nq,nd,W", [(1, 1, 1, 2), (3, 37, 130, 2),
                                       (32, 300, 2100, 2), (2, 129, 700, 3),
                                       (2, 65, 33, 8)])
def test_min_sq_dists_variants(cuda_device, v, P, nq, nd, W):
    from repro_torch.kernels import autotune
    cfg = autotune.VARIANTS["min_sq_dists"][v]
    rng = np.random.default_rng(100 * v + P + nq + nd)
    q = _pts(rng, (nq, W), cuda_device)
    ds = _pts(rng, (P, nd, W), cuda_device)
    qv = _mask(rng, (nq,), cuda_device, p=0.7)
    dv = _mask(rng, (P, nd), cuda_device, p=0.6)
    ops.reset_launches()
    got = ops.min_sq_dists_pairs(q, ds, qv, dv, config=cfg)
    assert ops.LAUNCHES["min_sq_dists"] == 1
    assert _bits_equal(got, ref.min_sq_dists_pairs(q, ds, qv, dv))
    got = hausdorff.min_sq_dists_pairs(q, ds, None, dv, config=cfg)
    assert _bits_equal(got, ref.min_sq_dists_pairs(
        q, ds, torch.ones_like(qv), dv))


@pytest.mark.parametrize("v", range(4))
@pytest.mark.parametrize("B,S,N,W", [(1, 1, 1, 2), (3, 130, 7, 2),
                                     (33, 257, 15, 2), (5, 300, 31, 2),
                                     (9, 65, 15, 8)])
def test_bound_grid_variants(cuda_device, v, B, S, N, W):
    from repro_torch.kernels import autotune
    cfg = autotune.VARIANTS["bound_grid"][v]
    rng = np.random.default_rng(100 * v + B + S + N)
    levels = tuple(((1 << l) - 1, (1 << (l + 1)) - 1)
                   for l in range(int(np.log2(N + 1))))
    oq, od = _pts(rng, (B, N, W), cuda_device), _pts(rng, (S, N, W),
                                                     cuda_device)
    rq = torch.from_numpy(rng.uniform(0, 3, (B, N)).astype(np.float32)).to(
        cuda_device)
    rd = torch.from_numpy(rng.uniform(0, 3, (S, N)).astype(np.float32)).to(
        cuda_device)
    qok, dok = _mask(rng, (B, N), cuda_device), _mask(rng, (S, N),
                                                      cuda_device)
    dok[S - 1] = False
    ops.reset_launches()
    got = ops.bound_grid(oq, rq, qok, od, rd, dok, levels=levels, config=cfg)
    assert ops.LAUNCHES["bound_grid"] == 1
    want = ref.frontier_bound_levels(oq, rq, qok, od, rd, dok, levels)
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


def test_unbuilt_launch_shape_is_refused(cuda_device):
    from repro_torch.kernels import autotune
    rng = np.random.default_rng(0)
    q = _pts(rng, (10, 2), cuda_device)
    v = torch.ones(10, dtype=torch.bool, device=cuda_device)
    ops.reset_launches()
    with pytest.raises(ValueError, match="no variant"):
        ops.min_sq_dists_pairs(q, q[None], v, v[None],
                               config=autotune.KernelConfig(warps=16, rows=2,
                                                            acc=2))
    assert ops.LAUNCHES["min_sq_dists"] == 0


def test_engine_tune_on_card(cuda_device):
    """tune() installs a gated launch shape per swept kernel for this card
    and a chunk; ExactHaus is bitwise the untuned engine's afterwards."""
    from repro_torch.core.build import build_repository
    from repro_torch.data import synthetic
    from repro_torch.engine import Query, QueryEngine
    from repro_torch.kernels import autotune

    datasets = synthetic.trajectory_repository(200, seed=1,
                                               n_points=(30, 600))
    q_sets = synthetic.trajectory_repository(12, seed=7, n_points=(30, 600))
    repo, _ = build_repository(datasets, leaf_capacity=16, theta=5,
                               device=cuda_device)
    engine = QueryEngine(repo, result_cache_size=0)
    items = [Query(op="topk_hausdorff", q=q, k=5) for q in q_sets]
    autotune.clear()
    try:
        want = engine.search(items)
        e0 = autotune.epoch()
        report = engine.tune(repeats=2)
        assert autotune.epoch() > e0
        assert report["device"] == ["cuda", torch.cuda.get_device_name(0)]
        rows = [report["min_sq_dists"], report["hausdorff_grid"],
                *report["bound_grid"].values()]
        for row in rows:
            assert not row["plain_only"] and len(row["timings_s"]) >= 1
            assert row["candidates_rejected_bitwise"] == 0
        assert len(autotune.report()["entries"]) == len(rows)
        assert engine.default_chunk in (16, 32, 64)
        got = engine.search(items)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.vals.view(np.uint32),
                                          w.vals.view(np.uint32))
            np.testing.assert_array_equal(g.ids, w.ids)
    finally:
        autotune.clear()


def test_lm_on_card(cuda_device):
    """The reduced trajectory LM on the card against the same weights on
    the CPU (logits to 0.03, as the CPU parity tests hold the port to the
    JAX package), decode after prefill against forward at the reference's
    bounds, and greedy generation with both caches."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models.model import LanguageModel

    cfg = configs.get_reduced("spadas_trajlm")
    card = LanguageModel(cfg, device=cuda_device, seed=3)
    cpu = LanguageModel(cfg, device="cpu", seed=3)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 40)))
    full, _ = card(toks.to(cuda_device))
    assert full.device.type == "cuda" and full.dtype == torch.float32
    np.testing.assert_allclose(full.cpu().numpy(), cpu(toks)[0].numpy(),
                               atol=0.03, rtol=0)
    for kv, atol, rtol in (("bf16", 0.15, 0.05), ("int8", 0.2, 0.1)):
        _, caches, n = card.prefill(toks[:, :-1], 48, kv)
        lg, _ = card.decode_step(toks[:, -1:], caches, n)
        torch.testing.assert_close(lg[:, 0], full[:, -1], atol=atol,
                                   rtol=rtol)
        out = serve.generate(card, toks[:, :16], 8, kv)
        want = serve.generate(cpu, toks[:, :16], 8, kv)
        assert out.tokens.shape == (4, 8) and out.tokens.is_cuda
        np.testing.assert_allclose(out.logits[0].cpu().numpy(),
                                   want.logits[0].numpy(), atol=0.03, rtol=0)


# ---------------------------------------------------------------------------
# the LM's MoE, Mamba-2, hybrid, cross-attention and embedding-input kinds
# (plain PyTorch on the card: no kernel of repro_torch.kernels)
# ---------------------------------------------------------------------------

LM_KIND_ARCHS = ("grok_1_314b", "arctic_480b", "mamba2_780m",
                 "jamba_v0_1_52b", "llama3_2_vision_11b", "musicgen_medium")


def _smooth(cfg):
    """Routing made continuous (every expert chosen, no token dropped), so
    that the card and the CPU cannot pick other experts on a near tie."""
    import dataclasses
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg, top_k_experts=cfg.n_experts,
                               capacity_factor=1.0)


def test_moe_combine_on_card_is_the_cpus(cuda_device):
    """The scatter-add back to the tokens (``index_add_`` in bf16, atomics
    on the card) with at most two nonzero terms a token: bitwise the CPU's,
    in either order of the slots, on every run."""
    from repro_torch.models import moe

    rng = np.random.default_rng(5)
    b, E, C, S, d = 4, 8, 40, 64, 256
    gi = np.stack([np.stack([rng.permutation(S)[:C] for _ in range(E)])
                   for _ in range(b)])
    ye = rng.standard_normal((b, E, C, d), np.float32)
    seen = np.zeros((b, S), int)
    for bi, e, c in np.ndindex(b, E, C):
        seen[bi, gi[bi, e, c]] += 1
        if seen[bi, gi[bi, e, c]] > 2:
            ye[bi, e, c] = 0
    ye_h = torch.from_numpy(ye).bfloat16()
    gi_h = torch.from_numpy(gi)
    want = moe.combine(ye_h, gi_h, S)
    ye_c, gi_c = ye_h.to(cuda_device), gi_h.to(cuda_device)
    for _ in range(3):
        assert torch.equal(moe.combine(ye_c, gi_c, S).cpu(), want)
    assert torch.equal(moe.combine(ye_c.flip(1), gi_c.flip(1), S).cpu(),
                       want)


def test_moe_and_mamba_blocks_on_card(cuda_device):
    """``moe`` (reduced grok-1, tokens dropped at capacity) and
    ``mamba_block`` (reduced jamba: a 32-token prefill, then three decode
    steps) on the card against the CPU on the same weights and inputs:
    outputs within a bf16 ulp of their largest magnitude (MoE) or 0.03
    (Mamba), aux loss to 1e-5, SSM states to 1e-4."""
    from repro_torch import configs
    from repro_torch.models import moe, ssm

    cfg = configs.get_reduced("grok_1_314b")
    w = moe.MoE(cfg, torch.Generator().manual_seed(1)).requires_grad_(False)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 64, cfg.d_model), np.float32)).bfloat16()
    y, aux = moe.moe(w, x, cfg)
    wc = moe.MoE(cfg, torch.Generator().manual_seed(1)).requires_grad_(
        False).to(cuda_device)
    yc, auxc = moe.moe(wc, x.to(cuda_device), cfg)
    assert yc.is_cuda and yc.dtype == torch.bfloat16
    torch.testing.assert_close(yc.cpu().float(), y.float(), rtol=0,
                               atol=2.0 ** -7 * float(y.abs().max()))
    torch.testing.assert_close(float(auxc), float(aux), rtol=1e-5, atol=0)

    cfg = configs.get_reduced("jamba_v0_1_52b")
    m = ssm.Mamba(cfg, torch.Generator().manual_seed(2)).requires_grad_(False)
    mc = ssm.Mamba(cfg, torch.Generator().manual_seed(2)).requires_grad_(
        False).to(cuda_device)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 35, cfg.d_model), np.float32)).bfloat16()
    y, (s, c) = ssm.mamba_block(m, x[:, :32], cfg)
    yc, (sc, cc) = ssm.mamba_block(mc, x[:, :32].to(cuda_device), cfg)
    for i in range(32, 35):
        torch.testing.assert_close(yc.cpu().float(), y.float(), atol=0.03,
                                   rtol=0)
        torch.testing.assert_close(sc.cpu(), s, atol=1e-4, rtol=1e-4)
        y, (s, c) = ssm.mamba_block(m, x[:, i:i + 1], cfg, state=s,
                                    conv_state=c)
        yc, (sc, cc) = ssm.mamba_block(mc, x[:, i:i + 1].to(cuda_device),
                                       cfg, state=sc, conv_state=cc)


@pytest.mark.parametrize("arch", LM_KIND_ARCHS)
def test_lm_kind_on_card(cuda_device, arch):
    """Each new family's reduced config on the card against the same
    weights on the CPU (the MoE configs with continuous routing; the
    vision gate at 0.5, since at its init value 0 the cross path is
    silent): forward logits within 0.03 (0.12 on the 8-layer hybrid, the
    CPU parity tests' bounds), decode after a one-chunk prefill against
    forward at the reference's bounds, and ``generate`` with both caches
    (its prefill logits within the same bound)."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models.model import LanguageModel

    cfg = _smooth(configs.get_reduced(arch))
    card = LanguageModel(cfg, device=cuda_device, seed=3)
    cpu = LanguageModel(cfg, device="cpu", seed=3)
    with torch.no_grad():
        for m in (*card.modules(), *cpu.modules()):
            if hasattr(m, "xgate"):
                m.xgate.fill_(0.5)
    inp, ctx, steps = serve.request_inputs(cfg, 2, 64, 4, seed=6)
    inp_t = torch.as_tensor(inp)
    ctx_t = None if ctx is None else torch.as_tensor(ctx)
    ctx_c = None if ctx_t is None else ctx_t.to(cuda_device)
    bound = 0.12 if arch == "jamba_v0_1_52b" else 0.03
    full, aux = card(inp_t.to(cuda_device), ctx_c)
    assert full.is_cuda and full.dtype == torch.float32
    want, waux = cpu(inp_t, ctx_t)
    torch.testing.assert_close(full.cpu(), want, atol=bound, rtol=0)
    torch.testing.assert_close(float(aux), float(waux), rtol=1e-5, atol=0)
    for kv, atol, rtol in (("bf16", 0.15, 0.05), ("int8", 0.2, 0.1)):
        _, caches, n = card.prefill(inp_t[:, :32].to(cuda_device), 40, kv,
                                    ctx=ctx_c)
        lg, _ = card.decode_step(inp_t[:, 32:33].to(cuda_device), caches, n,
                                 ctx=ctx_c)
        torch.testing.assert_close(lg[:, 0], full[:, 32], atol=atol,
                                   rtol=rtol)
        out = serve.generate(card, inp[:, :32], 4, kv, ctx=ctx,
                             step_embeds=steps)
        ref = serve.generate(cpu, inp[:, :32], 4, kv, ctx=ctx,
                             step_embeds=steps)
        assert out.tokens.shape == (2, 4) and out.tokens.is_cuda
        torch.testing.assert_close(out.logits[0].cpu(), ref.logits[0],
                                   atol=bound, rtol=0)


# ---------------------------------------------------------------------------
# training (autograd over the eager modules, the optimizer, checkpoints;
# no kernel of repro_torch.kernels)
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ("spadas_trajlm", "llama3_8b", "grok_1_314b", "arctic_480b",
               "mamba2_780m", "jamba_v0_1_52b", "llama3_2_vision_11b",
               "musicgen_medium")
#: card against CPU after one step, the CPU tests' bounds for the port
#: against the JAX package (tests/torch_train_parity.py), jamba's 8 hybrid
#: layers at its looser ones: loss, grad norm (relative), parameters in
#: units of lr, the share of elements past 0.1 lr, the first moments'
#: relative gap
TRAIN_STEP_BOUNDS = {"default": (2e-3, 0.02, 2.002, 0.015, 0.05),
                     "jamba_v0_1_52b": (2e-3, 0.02, 2.002, 0.06, 0.2)}


def _train_batch(cfg, B, S, seed=5):
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, cfg.vocab_size, (B, S))}
    b["labels"][0, :5] = -1
    if cfg.embed_input:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S))
    else:
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model), np.float32)
    if cfg.vision_tokens:
        b["image_embeds"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model), np.float32)
    return b


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_card(cuda_device, arch):
    """One train step of each family's reduced config (MoE routing made
    continuous, the vision gates at 0.5) on the card against the same
    weights on the CPU, float32 states, lr 1e-3 after one warm-up step."""
    from repro_torch import configs
    from repro_torch.train import optimizer, train_step

    cfg = _smooth(configs.get_reduced(arch))
    opt = optimizer.OptConfig(lr=1e-3, warmup_steps=1)
    states, metrics = [], []
    for dev in (cuda_device, torch.device("cpu")):
        st = train_step.init_train_state(cfg, opt, device=dev, seed=3)
        with torch.no_grad():
            for m in st.params.modules():
                if hasattr(m, "xgate"):
                    m.xgate.fill_(0.5)
        st, m = train_step.make_train_step(cfg, opt)(
            st, _train_batch(cfg, 2, 64))
        states.append(st)
        metrics.append({k: float(v) for k, v in m.items()})
    loss_atol, gn_rtol, lr_bound, over_share, m_rel = TRAIN_STEP_BOUNDS.get(
        arch, TRAIN_STEP_BOUNDS["default"])
    card, cpu = metrics
    assert abs(card["loss"] - cpu["loss"]) <= loss_atol
    assert abs(card["grad_norm"] / cpu["grad_norm"] - 1) <= gn_rtol
    np.testing.assert_allclose(card["aux"], cpu["aux"], rtol=1e-5)
    cpu_p = dict(states[1].params.named_parameters())
    over = n = 0
    num = den = 0.0
    for name, p in states[0].params.named_parameters():
        assert p.is_cuda and torch.isfinite(p).all()
        gap = (p.detach().cpu().double() - cpu_p[name].detach().double()
               ).abs() / 1e-3
        assert float(gap.max()) <= lr_bound, name
        over += int((gap > 0.1).sum())
        n += gap.numel()
        a = states[0].opt.m[name].cpu().double()
        b = states[1].opt.m[name].double()
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
    assert over / n <= over_share and (num / den) ** 0.5 <= m_rel


def test_quantize_on_card_is_the_cpus(cuda_device):
    """The int8 quantizers on the card give the CPU's bits (the divisions
    are true divisions there too, no reciprocal)."""
    from repro_torch.train import compression, optimizer

    rng = np.random.default_rng(8)
    for shape in ((5,), (64, 256), (3, 40, 70), (2, 1, 513)):
        x = torch.from_numpy((rng.standard_normal(shape)
                              * rng.uniform(1e-3, 10)).astype(np.float32))
        for block in (64, 256):
            want = optimizer._quantize(x, block)
            got = optimizer._quantize(x.to(cuda_device), block)
            assert torch.equal(got.codes.cpu(), want.codes)
            assert _bits_equal(got.scales.cpu(), want.scales)
            assert _bits_equal(optimizer._dequantize(got).cpu(),
                               optimizer._dequantize(want))
        codes, scales = compression.quantize_int8(x.to(cuda_device))
        wc, ws = compression.quantize_int8(x)
        assert torch.equal(codes.cpu(), wc) and _bits_equal(scales.cpu(), ws)


def test_async_snapshot_from_card(cuda_device, tmp_path):
    """An AsyncSaver snapshot of a state on the card: two more steps are
    taken at once, yet the checkpoint holds the step-2 values, and it
    restores onto the card and onto the CPU."""
    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.models import convert
    from repro_torch.train import optimizer, train_step

    cfg = configs.get_reduced("spadas_trajlm")
    opt = optimizer.OptConfig(lr=1e-3, warmup_steps=1, state_dtype="int8",
                              q_block=64)
    st = train_step.init_train_state(cfg, opt, device=cuda_device, seed=2,
                                     compress=True)
    step = train_step.make_train_step(cfg, opt, compress=True)
    batch = _train_batch(cfg, 2, 64)
    for _ in range(2):
        st, _ = step(st, batch)

    def host(leaves):
        return {k: ((v.codes.cpu().clone(), v.scales.cpu().clone())
                    if isinstance(v, optimizer.QTensor)
                    else v.detach().cpu().clone()) for k, v in leaves.items()}

    want = host(convert.state_leaves(st))
    saver = ckpt.AsyncSaver()
    saver.save(tmp_path, 2, st, extra={"step": 2})
    for _ in range(2):
        st, _ = step(st, batch)
    saver.wait()
    for dev in (cuda_device, torch.device("cpu")):
        fresh = train_step.init_train_state(cfg, opt, device="cpu", seed=9,
                                            compress=True)
        restored, extra = ckpt.restore(tmp_path, fresh, devices=dev)
        assert extra == {"step": 2}
        assert restored.params.device.type == dev.type
        got = host(convert.state_leaves(restored))
        assert got.keys() == want.keys()
        for k, w in want.items():
            for a, b in zip(got[k] if isinstance(w, tuple) else (got[k],),
                            w if isinstance(w, tuple) else (w,)):
                assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# training on a mesh: ZeRO-3 storage with data-parallel compute, every
# coordinate on the one card
# ---------------------------------------------------------------------------


def _mesh_state(cfg, opt, mesh, compress=False, seed=0):
    from repro_torch.launch import sharding
    from repro_torch.train import train_step

    st = train_step.init_train_state(cfg, opt, device=mesh.lead, seed=seed,
                                     compress=compress)
    p_shard = sharding.param_shardings(dict(st.params.named_parameters()),
                                       mesh)
    return train_step.shard_state(st, p_shard), p_shard


def _state_close_on_card(got: dict, want: dict):
    """The new moments and error feedback of two card states stepped from
    the same state, under ``test_torch_train_mesh._state_close``'s
    bounds: m and v (dequantized where int8) with at most 0.1 % of the
    elements past 5 % of the leaf's largest magnitude; the error feedback
    (an int8 quantization residual) by its largest magnitude in each
    block of 256, within 5 % for all but 10 % of the blocks."""
    import torch.nn.functional as F

    from repro_torch.train import optimizer

    def dense(v):
        return (optimizer._dequantize(v) if hasattr(v, "codes")
                else v).detach().double().cpu()

    def block_max(x):
        f = x.abs().reshape(-1)
        return F.pad(f, (0, (-f.numel()) % 256)).reshape(-1, 256).amax(1)

    over = {".m": [0, 0], ".v": [0, 0], ".err": [0, 0]}
    for k, w in want.items():
        if k.startswith((".opt/.m/", ".opt/.v/")):
            a, b = dense(got[k]), dense(w)
            gap = (a - b).abs() > 5e-2 * b.abs().max()
            c = over[k.split("/")[1]]
        elif k.startswith(".err/"):
            a, b = block_max(dense(got[k])), block_max(dense(w))
            gap = (a - b).abs() > 5e-2 * b
            c = over[".err"]
        else:
            continue
        c[0] += int(gap.sum())
        c[1] += gap.numel()
    for kind, (n_over, n) in over.items():
        share = 0.1 if kind == ".err" else 1e-3
        assert not n or n_over / n <= share, (kind, n_over / n)


@pytest.mark.parametrize("opt_kw,compress", [
    ({}, False), ({"state_dtype": "int8"}, True),
    ({"state_dtype": "int8", "q_block": 64}, True)],
    ids=["fp32", "int8_256_compress", "int8_64_compress"])
def test_mesh_step_data1_is_the_one_device_step_on_card(cuda_device, opt_kw,
                                                        compress):
    """A data = 1 mesh, (1, 2) over two entries of the card, computing on
    the model axis, against the one-device step on the card, each of 3
    steps from the same state (the mesh state's, gathered): loss and ce
    within 2e-4 and the gradient norm within 1e-2 (relative), the params
    after it with at most 1 % (float32 states) or 5 % (int8 states with
    compression) of the elements past 0.1 lr, and the new moments and
    error feedback (``_state_close_on_card``), as the CPU test
    ``test_data1_mesh_is_the_one_device_step`` holds them; with float32
    states the step-3 params of the two runs taken on their own keep the
    1 % rule too."""
    from repro_torch import configs
    from repro_torch.core import distributed
    from repro_torch.models import convert
    from repro_torch.train import optimizer, train_step

    cfg = configs.get_reduced("spadas_trajlm")
    opt = optimizer.OptConfig(lr=1e-3, warmup_steps=5, **opt_kw)
    mesh = distributed.grid_mesh((1, 2), ("data", "model"), ["cuda:0"] * 2,
                                 "test")
    ms, p_shard = _mesh_state(cfg, opt, mesh, compress)
    assert train_step.computes_on_model_axis(cfg, mesh)
    s1 = train_step.make_train_step(cfg, opt, compress=compress)
    s2 = train_step.make_train_step(cfg, opt, compress=compress,
                                    param_shardings=p_shard)
    share = 0.05 if opt_kw else 0.01

    def params_over(a, w):
        over = n = 0
        for k in a:
            if k.startswith(".params/"):
                gap = (a[k].cpu().double() - w[k].cpu().double()).abs() / 1e-3
                over += int((gap > 0.1).sum())
                n += gap.numel()
        return over / n

    alone = train_step.unshard_state(ms)            # float32: its own run
    for i in range(3):
        b = _train_batch(cfg, 8, 64, seed=i)
        one, m1 = s1(train_step.unshard_state(ms), b)
        ms, m2 = s2(ms, b)
        for k in ("loss", "ce"):
            assert abs(float(m2[k]) / float(m1[k]) - 1) <= 2e-4, k
        assert abs(float(m2["grad_norm"]) / float(m1["grad_norm"]) - 1) \
            <= 1e-2
        a, w = convert.state_leaves(ms), convert.state_leaves(one)
        assert params_over(a, w) <= share, i
        _state_close_on_card(a, w)
        if not opt_kw:
            alone, _ = s1(alone, b)
    if not opt_kw:
        assert params_over(convert.state_leaves(ms),
                           convert.state_leaves(alone)) <= share


def test_mesh_step_4x2_on_card(cuda_device):
    """The test mesh (4, 2) over eight entries of the card against the
    one-device step on the card, 3 steps of 8 x 64, lr 1e-3: losses
    within 2e-3, at most 1.5 % of the parameters past 0.1 lr (phase 19's
    card-against-CPU bounds), each coordinate holding its blocks."""
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import convert
    from repro_torch.train import optimizer, train_step

    cfg = configs.get_reduced("spadas_trajlm")
    opt = optimizer.OptConfig(lr=1e-3, warmup_steps=5)
    mesh = mesh_lib.make_test_mesh(devices=["cuda:0"] * 8)
    one = train_step.init_train_state(cfg, opt, device=cuda_device)
    ms, p_shard = _mesh_state(cfg, opt, mesh)
    assert all(s.is_cuda for x in ms.params.tensors.values()
               for s in x.shards)
    s1 = train_step.make_train_step(cfg, opt)
    s2 = train_step.make_train_step(cfg, opt, param_shardings=p_shard)
    for i in range(3):
        b = _train_batch(cfg, 8, 64, seed=i)
        one, m1 = s1(one, b)
        ms, m2 = s2(ms, b)
        assert abs(float(m1["loss"]) - float(m2["loss"])) <= 2e-3
    a, b = convert.state_leaves(ms), convert.state_leaves(one)
    over = n = 0
    for k in a:
        if k.startswith(".params/"):
            gap = (a[k].cpu().double() - b[k].cpu().double()).abs() / 1e-3
            over += int((gap > 0.1).sum())
            n += gap.numel()
    assert over / n <= 0.015
    per = train_step.state_device_bytes(ms)
    assert len(per) == 8 and len(set(per)) == 1
    assert per[0] * 8 < 3 * sum(4 * p.numel()
                                for p in one.params.parameters()) * 2


@pytest.mark.parametrize("opt_kw,compress,shape", [
    ({}, False, (1, 1)), ({}, False, (4, 2)),
    ({"state_dtype": "int8"}, True, (4, 2))],
    ids=["fp32_1x1", "fp32_4x2", "int8_compress_4x2"])
def test_dryrun_bytes_and_peak_on_card(cuda_device, monkeypatch, opt_kw,
                                       compress, shape):
    """Phase 21's checks at the reduced spadas_trajlm, 8 x 64: the meta
    record's per-coordinate argument bytes against the resident bytes of
    the same state placed on ``["cuda:0"] * n``, plus the batch block
    (and the 0-d count and step on the lead); on one device the record's
    predicted peak against one step's on the card, within phase 21's
    bounds (10 %, or 1 MiB below 10 MiB)."""
    import dataclasses
    import math

    from repro_torch import configs
    from repro_torch.core import distributed
    from repro_torch.launch import dryrun, sharding, specs
    from repro_torch.train import optimizer, train_step

    opt = optimizer.OptConfig(**opt_kw)
    monkeypatch.setattr(specs, "_opt_cfg", lambda cfg: opt)
    cfg = dataclasses.replace(configs.get_reduced("spadas_trajlm"),
                              remat=False)
    n = math.prod(shape)
    mesh = distributed.grid_mesh(shape, ("data", "model"), ["cuda:0"] * n,
                                 "test")
    B, S = 8, 64
    plan = specs.make_plan(cfg, "cell", mesh, compress=compress,
                           shapes={"cell": ("train", B, S)})
    rec = dryrun.record(plan, cfg, "spadas_trajlm", "cell", "test", B, S)
    st = train_step.init_train_state(cfg, opt, device=cuda_device,
                                     compress=compress)
    rows = B // plan.compute["groups"]
    batch_block = 2 * rows * S * 4
    if n == 1:
        held = (sum(p.numel() * p.element_size()
                    for p in st.params.parameters())
                + sum(x.size_bytes() if hasattr(x, "codes")
                      else x.numel() * x.element_size()
                      for tree in (st.opt.m, st.opt.v) for x in tree.values()))
        want = [held + batch_block + 8]
    else:
        p_shard = sharding.param_shardings(
            dict(st.params.named_parameters()), mesh)
        placed = train_step.shard_state(st, p_shard)
        want = [r + batch_block + (8 if i == 0 else 0) for i, r in
                enumerate(train_step.state_device_bytes(placed))]
    assert rec["memory"]["argument_bytes_per_coordinate"] == want
    if n == 1:
        rng = np.random.default_rng(0)
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                              dtype=torch.int32, device=cuda_device)
        batch = {"tokens": tok, "labels": tok.roll(-1, 1)}
        step = train_step.make_train_step(cfg, opt)
        st, _ = step(st, batch)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        st, _ = step(st, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        pred = rec["memory"]["temp_bytes"]
        print(f"predicted peak {pred} B, the card's {peak} B")
        assert abs(peak - pred) <= max(0.10 * pred, 1 << 20), (peak, pred)

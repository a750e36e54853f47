"""Point-granularity search (paper Section VI-B): RangeP and NNP.

Counterpart of ``repro.core.point_search``.

RangeP (Def. 11): all points of a chosen dataset inside a query rectangle;
                  leaves that miss it are pruned, leaves inside it are taken
                  whole, and only boundary leaves test their points.
NNP (Def. 12):    the nearest neighbour in D of every point of Q.  The
                  pruned form bounds every Q leaf by its least Eq. 4 upper
                  bound over the occupied D leaves (``ops.bound_row_ub``)
                  and scans only the D leaves that can hold a nearest
                  neighbour; ``nnp`` scans all of D
                  (``ops.nn_distance``) and is the oracle, and
                  ``nnp_batched`` does so for a batch of pairs in one
                  call (``ops.nn_distance_batched``).

The ``*_core`` functions take a leading batch axis of (query, dataset)
pairs: the engine's one-dispatch form.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import geometry
from repro_torch.core.index import DatasetIndex
from repro_torch.kernels import ops
from repro_torch.kernels.ref import BIG, ieee_sqrt, unrolled_sq_dists

#: elements of the largest (pairs, Q points, D points) distance block the
#: leaf scan materialises at once
SCAN_BLOCK = 1 << 26


class PointStats(NamedTuple):
    nodes_evaluated: int
    leaves_scanned: int
    pruned_fraction: float


def _batched(idx: DatasetIndex) -> DatasetIndex:
    return DatasetIndex(*[x[None] for x in idx])


def range_points_core(d_idx: DatasetIndex, r_lo, r_hi):
    """RangeP for B (dataset, box) requests: d_idx a (B, ...) batch of
    trees, r_lo / r_hi (B, d).  Returns (take (B, n_pad), scanned-leaf mask
    (B, n_leaves))."""
    sl = d_idx.level_slice(d_idx.depth)
    lo_q, hi_q = r_lo[:, None, :], r_hi[:, None, :]
    leaf_lo = d_idx.box_lo[:, sl]
    leaf_hi = d_idx.box_hi[:, sl]
    overlap = geometry.box_overlaps(leaf_lo, leaf_hi, lo_q, hi_q)
    contained = torch.all((leaf_lo >= lo_q) & (leaf_hi <= hi_q), dim=-1)
    live = overlap & (d_idx.counts[:, sl] > 0)

    pts = d_idx.points
    inside = geometry.box_contains(lo_q, hi_q, pts)
    leaf_of = torch.arange(pts.shape[1], device=pts.device) // d_idx.leaf_size
    take = (torch.where(contained[:, leaf_of], True, inside)
            & live[:, leaf_of] & d_idx.valid)
    return take, live & ~contained


def range_points(d_idx: DatasetIndex, r_lo, r_hi):
    """Mask of the points of one dataset tree inside [r_lo, r_hi], plus
    traversal stats."""
    take, scanned = range_points_core(_batched(d_idx), r_lo[None], r_hi[None])
    take, scanned = take[0], scanned[0]
    n_leaves = scanned.shape[0]
    n_scanned = scanned.sum()
    stats = PointStats(
        nodes_evaluated=n_leaves,
        leaves_scanned=int(n_scanned),
        # float32, as the JAX package computes it
        pruned_fraction=float(1.0 - n_scanned / max(n_leaves, 1)))
    return take, stats


def nnp(q_idx: DatasetIndex, d_idx: DatasetIndex):
    """NN in D for every valid point of Q, over all of D:
    (dists (nq,), idx (nq,))."""
    return ops.nn_distance(q_idx.points, d_idx.points, q_idx.valid,
                           d_idx.valid)


def nnp_batched(q_idx: DatasetIndex, d_idx: DatasetIndex):
    """``nnp`` for P (query, dataset) pairs, both (P, ...) batches, in one
    ``ops.nn_distance_batched`` call: (dists (P, nq), idx (P, nq))."""
    return ops.nn_distance_batched(q_idx.points.contiguous(),
                                   d_idx.points.contiguous(),
                                   q_idx.valid.contiguous(),
                                   d_idx.valid.contiguous())


def _leaf_frontier(idx: DatasetIndex):
    sl = idx.level_slice(idx.depth)
    return idx.centers[:, sl], idx.radii[:, sl], idx.counts[:, sl]


def nnp_pruned_core(q_idx: DatasetIndex, d_idx: DatasetIndex):
    """Tree-pruned NNP for P (query, dataset) pairs, both (P, ...) batches.
    Returns (dists (P, nq), idx (P, nq) int32, pair_live
    (P, q leaves, d leaves))."""
    oq, rq, cq = _leaf_frontier(q_idx)
    od, rd, cd = _leaf_frontier(d_idx)
    d_ok = cd > 0
    row_ub = ops.bound_row_ub(oq.contiguous(), rq.contiguous(),
                              od.contiguous(), rd.contiguous(),
                              d_ok.contiguous())
    d_ok = d_ok[:, None, :]
    # per-point lower bound: a Q point at the leaf's edge can be r_q closer
    # than Eq. 4's lb, so a D leaf is dropped only when cd - r_q - r_d
    # exceeds the Q leaf's worst-case NN bound row_ub
    cdm = geometry.pairwise_center_dist(oq, od)
    plb = torch.clamp_min(cdm - rq[..., None] - rd[:, None, :], 0.0)
    plb = torch.where(d_ok, plb, BIG)
    pair_live = (plb <= row_ub[..., None]) & d_ok & (cq > 0)[..., None]

    P, nq, W = q_idx.points.shape
    nd = d_idx.points.shape[1]
    fq, fd = q_idx.leaf_size, d_idx.leaf_size
    nlq, nld = nq // fq, nd // fd
    step = max(1, SCAN_BLOCK // (nq * nd))
    dists, idxs = [], []
    for p0 in range(0, P, step):
        p1 = min(P, p0 + step)
        qp = q_idx.points[p0:p1].reshape(-1, nlq, fq, 1, 1, W)
        dp = d_idx.points[p0:p1].reshape(-1, 1, 1, nld, fd, W)
        d2 = unrolled_sq_dists(qp, dp)          # (p, nlq, fq, nld, fd)
        ok = (d_idx.valid[p0:p1].reshape(-1, 1, 1, nld, fd)
              & pair_live[p0:p1, :, None, :, None])
        d2 = torch.where(ok, d2, BIG).reshape(p1 - p0, nq, nd)
        # the first index of the minimum: that of the first live leaf
        # holding it, as the per-leaf scan finds it
        m, ix = torch.amin(d2, dim=-1), torch.argmin(d2, dim=-1)
        qv = q_idx.valid[p0:p1]
        dists.append(torch.where(qv, ieee_sqrt(torch.clamp_max(m, BIG)), 0.0))
        idxs.append(torch.where(qv, ix.to(torch.int32), -1))
    return torch.cat(dists), torch.cat(idxs), pair_live


def nnp_pruned(q_idx: DatasetIndex, d_idx: DatasetIndex):
    """Tree-pruned NNP for one (query, dataset) pair: per Q leaf, only the
    D leaves whose per-point lower bound beats the leaf's best upper bound
    are scanned.  Returns (dists, idx, PointStats)."""
    dists, idxs, pair_live = nnp_pruned_core(_batched(q_idx),
                                             _batched(d_idx))
    pair_live = pair_live[0]
    n_live = pair_live.sum()
    stats = PointStats(
        nodes_evaluated=pair_live.numel(),
        leaves_scanned=int(n_live),
        pruned_fraction=float(1.0 - n_live / pair_live.numel()))
    return dists[0], idxs[0], stats

"""Bottom-level unified index (paper Section V-A): flat balanced ball trees.

Counterpart of ``repro.core.index``.  Per dataset, a left-balanced binary
tree over a permutation of the points, padded to ``n_pad = f * 2**depth``
slots with a validity mask, built level by level: at level ``l`` the
permutation is cut into ``2**l`` segments, each segment picks its widest
dimension and is ordered on that coordinate by one stable sort (invalid
slots last).  Node (l, j) covers slab ``[j * (n_pad >> l), ...)`` and its
statistics live at flat position ``2**l - 1 + j``.

Every function takes an explicit leading dataset axis: the batch build is
one set of tensor ops over all datasets, never a loop over them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.ref import ieee_sqrt


class DatasetIndex(NamedTuple):
    """Flat balanced ball trees over a batch of B datasets.

      points   (B, n_pad, d)   points permuted into tree order
      valid    (B, n_pad)      slot validity (padding and removed outliers)
      centers  (B, n_nodes, d) ball centers, level-major
      radii    (B, n_nodes)    ball radii
      box_lo   (B, n_nodes, d) node MBRs
      box_hi   (B, n_nodes, d)
      counts   (B, n_nodes)    live points under each node (int32)

    ``n_nodes = 2**(depth+1) - 1``.  A single row (no batch axis) is what a
    ``Query(q_index=...)`` carries.
    """

    points: torch.Tensor
    valid: torch.Tensor
    centers: torch.Tensor
    radii: torch.Tensor
    box_lo: torch.Tensor
    box_hi: torch.Tensor
    counts: torch.Tensor

    @property
    def depth(self) -> int:
        return int(math.log2(self.centers.shape[-2] + 1)) - 1

    @property
    def n_leaves(self) -> int:
        return 1 << self.depth

    @property
    def leaf_size(self) -> int:
        return self.points.shape[-2] // self.n_leaves

    def level_slice(self, level: int) -> slice:
        start = (1 << level) - 1
        return slice(start, start + (1 << level))


def depth_for(n: int, leaf_capacity: int) -> int:
    """Tree depth so that leaves hold <= leaf_capacity points."""
    return max(0, math.ceil(math.log2(max(1, n) / leaf_capacity)))


def pad_points(points: torch.Tensor, leaf_capacity: int,
               depth: int | None = None):
    """Pad (n, d) points to (f * 2**depth, d) plus a validity mask."""
    n, d = points.shape
    if depth is None:
        depth = depth_for(n, leaf_capacity)
    n_pad = leaf_capacity * (1 << depth)
    if n_pad < n:
        raise ValueError(f"n_pad {n_pad} < n {n}")
    pts = torch.zeros((n_pad, d), dtype=points.dtype, device=points.device)
    pts[:n] = points
    valid = torch.zeros((n_pad,), dtype=torch.bool, device=points.device)
    valid[:n] = True
    return pts, valid, depth


def _split_level(points: torch.Tensor, valid: torch.Tensor, perm: torch.Tensor,
                 level: int) -> torch.Tensor:
    """One level of the build: order every segment on its widest dimension.

    points (B, n_pad, d), valid (B, n_pad), perm (B, n_pad) int64.  Returns
    the refined permutation.  Invalid slots sort to segment ends, so
    padding accumulates in the rightmost leaves."""
    B, n_pad, d = points.shape
    nseg = 1 << level
    seg = n_pad >> level
    p = torch.gather(points, 1, perm[..., None].expand(B, n_pad, d))
    p = p.reshape(B, nseg, seg, d)
    v = torch.gather(valid, 1, perm).reshape(B, nseg, seg)

    inf = float("inf")
    lo = torch.amin(torch.where(v[..., None], p, inf), dim=2)   # (B, 2^l, d)
    hi = torch.amax(torch.where(v[..., None], p, -inf), dim=2)
    width = torch.where(torch.isfinite(lo) & torch.isfinite(hi), hi - lo,
                        -inf)
    d_split = torch.argmax(width, dim=-1)                         # first max

    keys = torch.gather(p, 3, d_split[:, :, None, None].expand(B, nseg, seg, 1))
    keys = torch.where(v, keys[..., 0], inf)                      # pad last
    order = torch.sort(keys, dim=-1, stable=True).indices
    return torch.gather(perm.reshape(B, nseg, seg), 2, order).reshape(B, n_pad)


def _node_stats(points: torch.Tensor, valid: torch.Tensor, depth: int):
    """Ball and box statistics of every node of every level (points in tree
    order, batched over B)."""
    B, n_pad, d = points.shape
    inf = float("inf")
    centers, radii, blos, bhis, counts = [], [], [], [], []
    for level in range(depth + 1):
        nseg = 1 << level
        seg = n_pad >> level
        p = points.reshape(B, nseg, seg, d)
        v = valid.reshape(B, nseg, seg)
        w = v.to(points.dtype)
        cnt = w.sum(dim=2)
        o = (p * w[..., None]).sum(dim=2) / torch.clamp_min(cnt, 1.0)[..., None]
        diff = p - o[:, :, None, :]
        d2 = (diff * diff).sum(dim=-1)
        r = ieee_sqrt(torch.amax(torch.where(v, d2, 0.0), dim=2))
        lo = torch.amin(torch.where(v[..., None], p, inf), dim=2)
        hi = torch.amax(torch.where(v[..., None], p, -inf), dim=2)
        # empty nodes: neutralised so the bound math prunes them
        empty = cnt == 0
        o = torch.where(empty[..., None], 0.0, o)
        r = torch.where(empty, 0.0, r)
        lo = torch.where(empty[..., None], inf, lo)
        hi = torch.where(empty[..., None], -inf, hi)
        centers.append(o)
        radii.append(r)
        blos.append(lo)
        bhis.append(hi)
        counts.append(cnt.to(torch.int32))
    return (torch.cat(centers, dim=1), torch.cat(radii, dim=1),
            torch.cat(blos, dim=1), torch.cat(bhis, dim=1),
            torch.cat(counts, dim=1))


def build_index_batch(points: torch.Tensor, valid: torch.Tensor,
                      depth: int) -> DatasetIndex:
    """Balanced ball trees for B equally padded datasets.

    points (B, n_pad, d) with n_pad = f * 2**depth, valid (B, n_pad)."""
    B, n_pad, d = points.shape
    # stable: valid slots first, each group in slot order
    perm = torch.sort((~valid).to(torch.uint8), dim=-1, stable=True).indices
    for level in range(depth):
        perm = _split_level(points, valid, perm, level)
    pts = torch.gather(points, 1, perm[..., None].expand(B, n_pad, d))
    val = torch.gather(valid, 1, perm)
    return DatasetIndex(pts, val, *_node_stats(pts, val, depth))


def build_index(points: torch.Tensor, valid: torch.Tensor,
                depth: int) -> DatasetIndex:
    """The tree of one padded dataset: points (n_pad, d), valid (n_pad,)."""
    idx = build_index_batch(points[None], valid[None], depth)
    return DatasetIndex(*[x[0] for x in idx])


def recompute_stats(idx: DatasetIndex) -> DatasetIndex:
    """Re-derive every node statistic from (points, valid): the paper's
    `RefineBottomUp` after outlier removal."""
    stats = _node_stats(idx.points, idx.valid, idx.depth)
    return DatasetIndex(idx.points, idx.valid, *stats)


def leaf_radii(idx: DatasetIndex) -> torch.Tensor:
    return idx.radii[..., idx.level_slice(idx.depth)]


def leaf_counts(idx: DatasetIndex) -> torch.Tensor:
    return idx.counts[..., idx.level_slice(idx.depth)]

"""Parameter-free outlier removal (paper Alg. 1 `OutlierRemoval`, Eq. 3).

Counterpart of ``repro.core.outliers``.  Leaf balls that hold outliers have
anomalously large radii: the leaf radii of the whole repository are sorted
descending, the knee of that curve (Kneedle-style gap statistic, Eq. 3)
gives the threshold ``r'``, points farther than ``r'`` from their leaf
center are dropped, and every node statistic is recomputed.
"""
from __future__ import annotations

import torch

from repro_torch.core import index as index_lib
from repro_torch.core.index import DatasetIndex
from repro_torch.kernels.ref import ieee_sqrt


def kneedle_threshold(radii: torch.Tensor,
                      valid: torch.Tensor | None = None) -> torch.Tensor:
    """Paper Eq. 3 over the descending-sorted radii: the scalar r'.

    radii (m,) in any order; valid (m,) masks padded or empty leaves."""
    if valid is None:
        valid = torch.ones(radii.shape, dtype=torch.bool, device=radii.device)
    # sort descending; invalid leaves sink to the end with radius 0
    r = torch.where(valid, radii, 0.0)
    phi = -torch.sort(-r).values
    n = phi.shape[0]
    m = torch.clamp_min(valid.sum(), 2)
    first = phi[0]
    last = phi[torch.clamp(m - 1, 0, n - 1)]
    i = torch.arange(n, dtype=phi.dtype, device=phi.device)
    # g_i = phi[0] - i * (phi[0] - phi[-1]) / |phi| - phi[i]
    mf = torch.clamp_min(m.to(phi.dtype), 1.0)
    gap = first - i * (first - last) / mf - phi
    gap = torch.where(i < m, gap, -float("inf"))
    gap[0] = -float("inf")                  # the knee is interior
    pos = torch.argmax(gap)
    # paper line 41: r' = phi[pos - 1]
    return phi[torch.clamp_min(pos - 1, 0)]


def remove_outliers(idx: DatasetIndex, r_prime: torch.Tensor | None = None):
    """Drop points farther than r' from their leaf center and re-tighten
    every node; ``idx`` is batched (B, ...).  The threshold comes from the
    leaf radii of the whole batch, pooled as the paper pools them across the
    repository.  Returns (refined index, r_prime)."""
    leaf_r = index_lib.leaf_radii(idx)                      # (B, 2^depth)
    if r_prime is None:
        r_prime = kneedle_threshold(leaf_r.reshape(-1),
                                    index_lib.leaf_counts(idx).reshape(-1) > 0)
    f = idx.leaf_size
    B, n_pad, d = idx.points.shape
    centers_leaf = idx.centers[:, idx.level_slice(idx.depth), :]
    diff = idx.points.reshape(B, -1, f, d) - centers_leaf.reshape(B, -1, 1, d)
    d2 = (diff * diff).sum(dim=-1).reshape(B, n_pad)
    wide = torch.repeat_interleave(leaf_r, f, dim=-1)      # (B, n_pad)
    # only leaves with radius > r' are refined; inside them, points with
    # ||o, p|| > r' are dropped
    drop = (wide > r_prime) & (ieee_sqrt(d2) > r_prime)
    refined = index_lib.recompute_stats(idx._replace(valid=idx.valid & ~drop))
    return refined, r_prime

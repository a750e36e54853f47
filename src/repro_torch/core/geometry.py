"""Geometric primitives of the search layer.

Counterpart of the parts of ``repro.core.geometry`` that the dataset and
point ops call: the box algebra behind RangeS (Def. 9), IA (Def. 6) and
RangeP (Def. 11), and the two pairwise distance forms.  Every function
broadcasts over leading axes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import ieee_sqrt, unrolled_sq_dists


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Inner products of (..., n, W) and (..., m, W) rows -> (..., n, m),
    the products added in coordinate order.  Not ``torch.matmul``: on the
    card that goes through cuBLAS with a summation order of its own."""
    acc = None
    for c in range(x.shape[-1]):
        p = x[..., :, None, c] * y[..., None, :, c]
        acc = p if acc is None else acc + p
    return acc


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    acc = None
    for c in range(x.shape[-1]):
        sq = x[..., c] * x[..., c]
        acc = sq if acc is None else acc + sq
    return acc


def sq_dist_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances in the |x|^2 + |y|^2 - 2 x.y form, as
    the JAX package computes them (there the inner product goes to the
    matrix unit), clamped at 0 against cancellation.  (..., n, W) x
    (..., m, W) -> (..., n, m)."""
    d2 = (_sq_norm(x)[..., :, None] + _sq_norm(y)[..., None, :]
          - 2.0 * _dot(x, y))
    return torch.clamp_min(d2, 0.0)


def pairwise_center_dist(cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """Distances between two sets of ball centers, (..., n, W) x (..., m, W)
    -> (..., n, m), in the cancelling |x|^2 - 2xy + |y|^2 form."""
    return ieee_sqrt(sq_dist_matrix(cx, cy))


def pairwise_dist_exact(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise distances by broadcast subtraction, (..., n, W) x
    (..., m, W) -> (..., n, m): the squares added in coordinate order, no
    cancellation."""
    return ieee_sqrt(unrolled_sq_dists(x[..., :, None, :], y[..., None, :, :]))


def box_overlaps(lo_a, hi_a, lo_b, hi_b) -> torch.Tensor:
    """Do the boxes overlap?  Broadcasts over leading axes."""
    return torch.all((lo_a <= hi_b) & (lo_b <= hi_a), dim=-1)


def intersect_area(lo_a, hi_a, lo_b, hi_b) -> torch.Tensor:
    """Def. 6 IA: the product of the overlap lengths of the first two
    coordinates (0 if disjoint).  Broadcasts."""
    ln = torch.minimum(hi_a, hi_b) - torch.maximum(lo_a, lo_b)
    ln = torch.clamp_min(ln, 0.0)
    return ln[..., 0] * ln[..., 1]


def box_contains(lo, hi, p) -> torch.Tensor:
    """Are the points p (..., W) inside the box [lo, hi]?"""
    return torch.all((p >= lo) & (p <= hi), dim=-1)

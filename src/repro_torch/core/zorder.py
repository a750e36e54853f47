"""z-order signatures (Defs. 4/5) as fixed-width bitsets.

Counterpart of ``repro.core.zorder``.  A dataset's signature is a bitset
over the ``4**theta`` Morton cells of the space grid, stored as 32-bit
words.  The words are held in int64 tensors (values in [0, 2**32)): the
CPU build of PyTorch has no shift or reduction for uint32, and the int64
value of each word is exactly the uint32 one.  ``repro_torch.bridge``
converts to and from ``numpy.uint32``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import popcount64

WORD_BITS = 32


def num_cells(theta: int) -> int:
    return 1 << (2 * theta)


def num_words(theta: int) -> int:
    return max(1, num_cells(theta) // WORD_BITS)


def _part1by1(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of x so there is a 0 between each bit."""
    x = x.to(torch.int64) & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def morton2(ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """Interleave two <= 16-bit integer grids into a Morton code."""
    return _part1by1(ix) | (_part1by1(iy) << 1)


def quantize(points: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
             theta: int) -> torch.Tensor:
    """Map points (..., d >= 2) to integer grid coordinates on [lo, hi]."""
    span = torch.clamp_min(hi - lo, 1e-30)
    nbins = (1 << theta) - 1
    g = (points[..., :2] - lo) / span * float(nbins + 1)
    return torch.clamp(g.to(torch.int32), 0, nbins)


def cell_ids(points: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
             theta: int) -> torch.Tensor:
    """Morton cell id per point (Def. 4), in [0, 4**theta)."""
    g = quantize(points, lo, hi, theta)
    return morton2(g[..., 0], g[..., 1])


def signature(points: torch.Tensor, valid: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor, theta: int) -> torch.Tensor:
    """z-order signatures (Def. 5) of B datasets: points (B, n, d), valid
    (B, n) -> (B, W) words (int64 holding uint32 values).  Invalid points
    contribute nothing."""
    n_cells = num_cells(theta)
    ids = torch.where(valid, cell_ids(points, lo, hi, theta), n_cells)
    B = ids.shape[0]
    # one overflow cell takes the invalid points
    occ = torch.zeros((B, n_cells + 1), dtype=torch.int64, device=ids.device)
    occ.scatter_(1, ids, 1)
    occ = occ[:, :n_cells].reshape(B, num_words(theta), WORD_BITS)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=ids.device)
    # bits are distinct, so the sum is the bitwise OR
    return (occ << shifts).sum(dim=-1)


def sig_intersect_count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GBO (Def. 7): |z(A) AND z(B)| by popcount, int32.  Broadcasts over
    the leading dims and reduces the trailing word axis."""
    return popcount64(a & b).sum(dim=-1).to(torch.int32)


def sig_count(a: torch.Tensor) -> torch.Tensor:
    """Occupied cells of each signature, int32 (reduces the word axis)."""
    return popcount64(a).sum(dim=-1).to(torch.int32)


def default_epsilon(lo: torch.Tensor, hi: torch.Tensor,
                    theta: int) -> torch.Tensor:
    """Paper Eq. 8: cell width of the x-extent at resolution theta."""
    return (hi[0] - lo[0]) / (1 << theta)

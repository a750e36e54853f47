"""Top-k EMD exemplar search (the paper's companion metric [67]).

Counterpart of ``repro.core.emd``.  Each dataset is a mass histogram over
the ``4**theta`` Morton cells of the space grid (the grid the signatures
use), and EMD is approximated by entropy-regularised Sinkhorn iterations
on the cell-center cost matrix, batched over every slot of the repository
at once: each iteration is two float32 matrix products of (slots, cells)
by (cells, cells).  The products run in full float32
(``torch.get_float32_matmul_precision() == "highest"``, no TF32).

The histograms are integer counts (below 2**24) divided by their total,
so they are exact in float32 whatever order the counts are added in, and
bitwise equal on the CPU and on the card.  The Sinkhorn products are not:
the two devices sum them in different orders.
"""
from __future__ import annotations

import torch

from repro_torch.core import zorder
from repro_torch.core.repo_index import Repository
from repro_torch.kernels.ref import ieee_sqrt, unrolled_sq_dists

#: mass floor of the Sinkhorn scalings, as in the JAX package
SINKHORN_EPS = 1e-9
#: top-k EMD's entropic regularisation, in grid cells, and its Sinkhorn
#: iterations (the JAX package's defaults)
REG_CELLS = 0.5
SINKHORN_ITERS = 100


def cell_histogram(points, valid, lo, hi, theta: int) -> torch.Tensor:
    """Normalised mass histograms over the Morton cells: points
    (..., n, d) / valid (..., n) -> (..., 4**theta) float32, one per
    leading index (a whole repository in one pass)."""
    n_cells = zorder.num_cells(theta)
    ids = torch.where(valid, zorder.cell_ids(points, lo, hi, theta), n_cells)
    lead = ids.shape[:-1]
    ids = ids.reshape(-1, ids.shape[-1])
    # one overflow cell takes the invalid points
    h = torch.zeros((ids.shape[0], n_cells + 1), dtype=torch.float32,
                    device=ids.device)
    h.scatter_add_(1, ids, torch.ones((), device=ids.device).expand(ids.shape))
    h = h[:, :n_cells]
    h = h / torch.clamp_min(h.sum(dim=-1, keepdim=True), 1.0)
    return h.reshape(*lead, n_cells)


def _compact1by1(x: torch.Tensor) -> torch.Tensor:
    """The even bits of x, packed: the inverse of ``zorder._part1by1``."""
    x = x & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    return (x | (x >> 8)) & 0x0000FFFF


def cell_centers(lo, hi, theta: int) -> torch.Tensor:
    """(4**theta, 2) coordinates of the cell centers, in Morton order.  The
    de-interleave runs on int64 (the CPU build of PyTorch lacks uint32
    shifts)."""
    n = 1 << theta
    ids = torch.arange(zorder.num_cells(theta), dtype=torch.int64,
                       device=lo.device)
    x, y = _compact1by1(ids), _compact1by1(ids >> 1)
    span = hi - lo
    cx = lo[0] + (x.to(torch.float32) + 0.5) / n * span[0]
    cy = lo[1] + (y.to(torch.float32) + 0.5) / n * span[1]
    return torch.stack([cx, cy], dim=-1)


def cost_matrix(lo, hi, theta: int) -> torch.Tensor:
    """(4**theta, 4**theta) distances between cell centers, over the
    diagonal of the space: the EMD ground cost."""
    centers = cell_centers(lo, hi, theta)
    scale = ieee_sqrt(unrolled_sq_dists(hi, lo))
    return ieee_sqrt(unrolled_sq_dists(centers[:, None], centers[None])) / scale


def sinkhorn_emd(a, b, cost, *, reg: float = 0.05,
                 iters: int = SINKHORN_ITERS) -> torch.Tensor:
    """Entropy-regularised EMD between histogram a (n,) and histogram b
    (n,), or each row of a batch b (S, n), over ``cost`` (n, n).

    Returns the transport cost <P, C>, 0-dim or (S,).  Masses are
    renormalised; empty histograms give 0."""
    a = a / torch.clamp_min(a.sum(dim=-1, keepdim=True), SINKHORN_EPS)
    b = b / torch.clamp_min(b.sum(dim=-1, keepdim=True), SINKHORN_EPS)
    K = torch.exp(-cost / reg)
    v = torch.ones_like(b)
    for _ in range(iters):
        # row-wise K @ v and K.T @ u
        u = a / torch.clamp_min(v @ K.T, SINKHORN_EPS)
        v = b / torch.clamp_min(u @ K, SINKHORN_EPS)
    # <P, C> with P = diag(u) K diag(v)
    return ((v @ (K * cost).T) * u).sum(dim=-1)


def topk_emd_hists(q_hist, hists, ds_valid, cost, k: int, *, theta: int,
                   prefilter: int = 0):
    """The top-k of :func:`topk_emd` from the histograms: q_hist (n,)
    against the slots' hists (S, n), ds_valid (S,).  With ``prefilter``
    (0 < prefilter < S) only the slots with the largest ``hists @ q_hist``
    run Sinkhorn; the others score inf.  Ties go to the smaller slot id.
    Returns (vals (k,), ids (k,))."""
    reg = REG_CELLS / (1 << theta)
    S = hists.shape[0]
    if prefilter and prefilter < S:
        scores = torch.where(ds_valid, hists @ q_hist, -1.0)
        cand = torch.sort(scores, descending=True, stable=True).indices
        cand = cand[:prefilter]
        emds = torch.full((S,), float("inf"), device=hists.device)
        emds[cand] = sinkhorn_emd(q_hist, hists[cand], cost, reg=reg)
    else:
        emds = sinkhorn_emd(q_hist, hists, cost, reg=reg)
    emds = torch.where(ds_valid, emds, float("inf"))
    vals, ids = torch.sort(emds, stable=True)
    return vals[:k], ids[:k]


def topk_emd(repo: Repository, q_pts, q_valid, k: int, *, theta: int = 4,
             prefilter: int = 0):
    """Top-k datasets by (Sinkhorn-approximate) EMD to the query q_pts
    (n, d) / q_valid (n,), on the repository's device.

    ``theta`` is the histogram resolution (4**theta bins; keep it <= 5 so
    the (4**theta)**2 cost matrix stays small).  ``prefilter``: evaluate
    EMD on the top-``prefilter`` datasets by histogram overlap only (0 =
    all), the signature filter of [67].  Returns (vals (k,), ids (k,));
    unscored and padded slots are inf."""
    lo, hi = repo.space_lo, repo.space_hi
    q_hist = cell_histogram(q_pts, q_valid, lo, hi, theta)
    hists = cell_histogram(repo.ds_index.points, repo.ds_index.valid, lo, hi,
                           theta)
    return topk_emd_hists(q_hist, hists, repo.ds_valid,
                          cost_matrix(lo, hi, theta), k, theta=theta,
                          prefilter=prefilter)

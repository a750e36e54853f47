"""Public kernel ops: the CUDA kernel for a CUDA tensor, the plain PyTorch
version for a CPU tensor.

Counterpart of ``repro.kernels.ops``, one op for each of the six kernels,
and two for ``min_sq_dists`` and ``nn_distance`` (the JAX package's
one-pair ops and their pair axis, one launch for a chunk of pairs), for
``hausdorff_grid`` (the JAX package's grid op and phase 2's lane op) and
for ``bound_matrices`` (the JAX package's matrix op and the pruned NNP's
``bound_row_ub``, its masked row min fused in); the joinable ops'
``plane_weighted_intersect`` is one ``set_intersect`` call, and the ring
Hausdorff's per-hop ``min_sq_dists_pairs`` the row minima under
``directed_hausdorff_pairs``.  There is no
size-based routing and no autotune table: a CUDA tensor always launches
the kernel (or raises), a CPU tensor always takes the plain version, and
the two are bitwise equal.  ``LAUNCHES[name]`` counts kernel
launches; the plain versions book none.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (_build, bound_matrix, hausdorff, ref,
                                 set_intersect)
from repro_torch.kernels import nn_distance as nn_distance_kernel
from repro_torch.kernels.ref import BIG

LAUNCHES = _build.LAUNCHES
reset_launches = _build.reset_launches

#: D-axis slab width of the plain pair-grid evaluator
TILE = 128


def _route(name: str, t: torch.Tensor) -> bool:
    """True to launch the kernel, False for the plain version."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain path for {t.device}")


def directed_hausdorff(q, d, q_valid, d_valid) -> torch.Tensor:
    """H(Q -> D), masked; a 0-dim float32 tensor: one pair of
    ``directed_hausdorff_pairs``."""
    return directed_hausdorff_pairs(q, d[None], q_valid, d_valid[None])[0]


def directed_hausdorff_pairs(q, ds, q_valid, ds_valid) -> torch.Tensor:
    """H(Q -> D_p) for one query set q (nq, W) / q_valid (nq,) against P
    datasets ds (P, nd, W) / ds_valid (P, nd): (P,) float32, -BIG where Q
    has no valid row.  The counterpart of the JAX oracle's
    ``vmap(lambda dp, dv: directed_hausdorff(q, dp, q_valid, dv))``; one
    ``min_sq_dists`` launch on the card, the root, row mask and max in
    torch."""
    mins = min_sq_dists_pairs(q, ds, q_valid, ds_valid)
    nnd = torch.where(q_valid, ref.ieee_sqrt(mins), -BIG)
    return torch.amax(nnd, dim=-1)


def min_sq_dists_pairs(q, ds, q_valid, ds_valid) -> torch.Tensor:
    """Per-row min squared distance of one query set q (nq, W) / q_valid
    (nq,) to each of P datasets ds (P, nd, W) / ds_valid (P, nd): (P, nq)
    float32, BIG where D_p has no valid point and on invalid rows; one
    ``min_sq_dists`` launch on the card."""
    if _route("min_sq_dists_pairs", q):
        return hausdorff.min_sq_dists_pairs(q, ds, q_valid, ds_valid)
    return ref.min_sq_dists_pairs(q, ds, q_valid, ds_valid)


def directed_hausdorff_grid_plain(q, ds, q_valid, ds_valid) -> torch.Tensor:
    """Plain H(Q_b -> D_{b,c}) over a (B, C) grid: the D point axis is
    streamed in ``TILE``-wide slabs with a running minimum, so the
    intermediate is (B, C, nq, TILE) rather than (B, C, nq, nd)."""
    B, C, nd, _ = ds.shape
    nq = q.shape[1]
    mins = torch.full((B, C, nq), BIG, dtype=torch.float32, device=q.device)
    for t0 in range(0, nd, TILE):
        dp = ds[:, :, t0:t0 + TILE]
        dv = ds_valid[:, :, t0:t0 + TILE]
        d2 = ref.unrolled_sq_dists(q[:, None, :, None, :],
                                   dp[:, :, None, :, :])
        d2 = torch.where(dv[:, :, None, :], d2, BIG)
        mins = torch.minimum(mins, torch.amin(d2, dim=-1))
    nnd = ref.ieee_sqrt(mins)
    nnd = torch.where(q_valid[:, None, :], nnd, -BIG)
    return torch.amax(nnd, dim=-1)


def directed_hausdorff_grid(q, ds, q_valid, ds_valid) -> torch.Tensor:
    """H(Q_b -> D_{b,c}) for q (B, nq, W) against per-query candidate
    stacks ds (B, C, nd, W): (B, C).  The JAX package's signature; on the
    card one call into the lanes kernel."""
    if not _route("directed_hausdorff_grid", q):
        return directed_hausdorff_grid_plain(q, ds, q_valid, ds_valid)
    return hausdorff.hausdorff_grid(q, ds, q_valid, ds_valid)


def directed_hausdorff_lanes_plain(q_c, n_q, pts, pts_valid, extent, ids,
                                   live) -> torch.Tensor:
    """Plain ``directed_hausdorff_lanes``: gather the lanes' slots, run the
    slab loop, and set dead lanes to BIG.  ``extent`` only bounds where
    valid points lie, so the plain version, which reads every point, has
    no use for it."""
    nqp = q_c.shape[1]
    rows = torch.arange(nqp, device=q_c.device)
    q_valid = rows[None, :] < n_q[:, None]
    hs = directed_hausdorff_grid_plain(q_c, pts[ids], q_valid,
                                       pts_valid[ids])
    return torch.where(live, hs, BIG)


def directed_hausdorff_lanes(q_c, n_q, pts, pts_valid, extent, ids,
                             live) -> torch.Tensor:
    """H(Q_b -> D_{ids[b, c]}) for the live lanes of an ExactHaus phase-2
    chunk: (B, C), BIG on dead lanes, -BIG where query b has no valid row.

    q_c (B, nqp, W) holds each query's valid rows first and n_q (B,) int32
    their counts (``hausdorff.compact_rows``); pts (S, nd, W) and
    pts_valid (S, nd) are the resident corpus, read by slot id, never
    gathered; extent (S,) int32 bounds each slot's valid points
    (``hausdorff.valid_extent``); ids (B, C) int64, live (B, C) bool."""
    if not _route("directed_hausdorff_lanes", q_c):
        return directed_hausdorff_lanes_plain(q_c, n_q, pts, pts_valid,
                                              extent, ids, live)
    return hausdorff.hausdorff_lanes(q_c, n_q, pts, pts_valid, extent, ids,
                                     live)


def bound_grid(oq, rq, q_ok, od, rd, d_ok, *, levels):
    """Fused multi-level (B, S) frontier bounds: (LB, UB), each
    (len(levels), B, S).  See ``ref.frontier_bound_levels``."""
    levels = tuple(levels)
    if not _route("bound_grid", oq):
        return ref.frontier_bound_levels(oq, rq, q_ok, od, rd, d_ok, levels)
    return bound_matrix.bound_grid(oq, rq, q_ok, od, rd, d_ok, levels=levels)


def set_intersect_counts(sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """GBO count matrix (na, nb) int32 between signature stacks (na, W) and
    (nb, W) of int64 words."""
    if not _route("set_intersect_counts", sa):
        return ref.set_intersect_count(sa, sb)
    return set_intersect.intersect_counts(sa, sb)


def plane_weighted_intersect(planes: torch.Tensor,
                             sigs: torch.Tensor) -> torch.Tensor:
    """Weighted popcounts of histogram bit planes: planes (B, P, W) and
    signatures (S, W) -> (B, S) int32 of sum_p 2**p * |plane_p AND sig|,
    the joinable coverage form.  One ``set_intersect_counts`` call of
    (B * P, S) rows, so the whole batch is one launch on the card."""
    b, p, w = planes.shape
    cnt = set_intersect_counts(planes.reshape(b * p, w), sigs)
    cnt = cnt.reshape(b, p, sigs.shape[0])
    weights = 1 << torch.arange(p, dtype=torch.int32, device=cnt.device)
    return (cnt * weights[None, :, None]).sum(dim=1, dtype=torch.int32)


def nn_distance(q, d, q_valid, d_valid):
    """Per-Q-point NN distance and D index: (dists (nq,), idx (nq,)), one
    pair of ``nn_distance_batched``."""
    dist, idx = nn_distance_batched(q[None], d[None], q_valid[None],
                                    d_valid[None])
    return dist[0], idx[0]


def nn_distance_batched(qs, ds, qs_valid, ds_valid):
    """Per-point NN for P (query, dataset) pairs: qs (P, nq, W), ds
    (P, nd, W), qs_valid (P, nq), ds_valid (P, nd) -> (dists (P, nq),
    idx (P, nq) int32).  The counterpart of
    ``repro.kernels.ops.nn_distance_batched``; one launch on the card."""
    if not _route("nn_distance_batched", qs):
        return ref.nn_distance_batched(qs, ds, qs_valid, ds_valid)
    return nn_distance_kernel.nn_distance_batched(qs, ds, qs_valid, ds_valid)


def bound_matrices(oq, rq, od, rd, *, with_lb=True):
    """Eq. 4 (lb, ub) matrices for P pairs of node frontiers: oq (P, nq, W)
    / rq (P, nq) against od (P, nd, W) / rd (P, nd) -> each (P, nq, nd).
    With ``with_lb=False`` lb is None (the kernel then writes ub only)."""
    if not _route("bound_matrices", oq):
        lb, ub = ref.bound_matrix(oq, rq, od, rd)
        return (lb if with_lb else None), ub
    return bound_matrix.bound_matrices(oq, rq, od, rd, with_lb=with_lb)


def bound_row_ub(oq, rq, od, rd, d_ok):
    """Row upper bounds of the pruned NNP, (P, nq): the min over corpus
    nodes j of ``d_ok[p, j] ? ub[p, i, j] : BIG``, one launch on the card
    (the (P, nq, nd) matrix is never stored).  See ``ref.bound_row_ub``."""
    if not _route("bound_row_ub", oq):
        return ref.bound_row_ub(oq, rq, od, rd, d_ok)
    return bound_matrix.bound_row_ub(oq, rq, od, rd, d_ok)

"""Plain PyTorch versions of the kernels (counterpart of ``repro.kernels.ref``).

Each function runs as separate eager PyTorch ops, so no multiply is ever
contracted with an add into an FMA: the results are the uncontracted IEEE
float32 values, bitwise equal to eager ``repro.kernels.ref`` and numpy, and
to the CUDA kernels (built with ``-fmad=false``).  They materialise the full
distance tensors the kernels avoid, so they are for tests, the CPU path and
the on-card comparisons in ``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np
import torch

#: masked-distance sentinel; the float32 value of 3.4e38, held as a Python
#: float that float32 represents exactly
BIG = float(np.float32(3.4e38))

#: elements of the largest (pairs, nq, nd) distance block a plain pair
#: version materialises at once
PAIR_BLOCK = 1 << 26


def ieee_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as the kernels' ``sqrtf``.

    PyTorch's vectorised CPU ``sqrt`` can be one ulp off (seen with
    torch 2.13 on x86), so on the CPU the root is taken in float64 and
    rounded once to float32, which is correctly rounded for every float32
    input.  On the card ``torch.sqrt`` is already IEEE."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def unrolled_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_c (a[..., c] - b[..., c])**2, the coordinate axis unrolled: the
    first square, then each further square added in coordinate order.

    ``a`` and ``b`` broadcast against each other up to the trailing
    coordinate axis.  This is the one accumulation every bit-sensitive
    distance in the port shares, kernels included."""
    d2 = None
    for c in range(a.shape[-1]):
        diff = a[..., c] - b[..., c]
        sq = diff * diff
        d2 = sq if d2 is None else d2 + sq
    return d2


def masked_sq_dists(q: torch.Tensor, d: torch.Tensor,
                    d_valid: torch.Tensor) -> torch.Tensor:
    """(..., nq, nd) squared distances with invalid D columns masked to BIG:
    q (..., nq, W) against d (..., nd, W) / d_valid (..., nd), the leading
    axes broadcast (a batch of pairs, or one query set against many D)."""
    d2 = unrolled_sq_dists(q[..., :, None, :], d[..., None, :, :])
    return torch.where(d_valid[..., None, :], d2, BIG)


def min_sq_dists(q: torch.Tensor, d: torch.Tensor,
                 d_valid: torch.Tensor) -> torch.Tensor:
    """(..., nq) per-row min squared distance to a valid D row, from BIG
    (so BIG where there is none, or where every square overflowed past
    it): the plain version of the ``min_sq_dists`` kernel."""
    return torch.clamp_max(torch.amin(masked_sq_dists(q, d, d_valid), dim=-1),
                           BIG)


def _pair_blocks(P: int, n: int):
    """Slices of the pair axis that keep a plain version's (pairs, nq, nd)
    intermediates to about ``PAIR_BLOCK`` elements (n = nq * nd); pairs
    are independent, so the blocking changes no bit."""
    step = max(1, PAIR_BLOCK // max(n, 1))
    return [slice(p0, p0 + step) for p0 in range(0, P, step)]


def min_sq_dists_pairs(q: torch.Tensor, ds: torch.Tensor,
                       q_valid: torch.Tensor,
                       ds_valid: torch.Tensor) -> torch.Tensor:
    """(P, nq) ``min_sq_dists`` of one query set q (nq, W) against each of
    P datasets ds (P, nd, W) / ds_valid (P, nd), BIG on the rows that
    q_valid (nq,) masks: the plain version of the pair-axis kernel."""
    mins = torch.cat([min_sq_dists(q, ds[s], ds_valid[s])
                      for s in _pair_blocks(ds.shape[0],
                                            q.shape[0] * ds.shape[1])])
    return torch.where(q_valid, mins, BIG)


def directed_hausdorff(q: torch.Tensor, d: torch.Tensor,
                       q_valid: torch.Tensor,
                       d_valid: torch.Tensor) -> torch.Tensor:
    """H(Q -> D) = max_{p in Q} min_{p' in D} ||p - p'|| with masks (0-dim)."""
    d2 = masked_sq_dists(q, d, d_valid)
    nnd = ieee_sqrt(torch.amin(d2, dim=1))
    nnd = torch.where(q_valid, nnd, -BIG)
    return torch.amax(nnd)


def frontier_bound_levels(oq, rq, q_ok, od, rd, d_ok, levels):
    """Fused multi-level (B, S) frontier bounds (paper Eq. 4 plus the
    min/max frontier collapse), every level in one pass.

    oq (B, N, W) / rq, q_ok (B, N): query-tree node centers, radii and
    occupancy over the node range [0, N); od (S, N, W) / rd, d_ok (S, N):
    the corpus trees.  ``levels`` is a tuple of (start, stop) node slices,
    applied to both node axes.  Returns (LB, UB), each (L, B, S):

        LB[l, b, s] = max_{i in q_ok} min_{j in d_ok} lb(i, j)

    over nodes i, j in [start, stop), and likewise UB, with
    lb = max(cd - rd, 0) and ub = sqrt(cd^2 + rd^2) + rq.  ``rd`` is
    squared at its own (S, N) shape before the broadcast, as in the JAX
    reference and the kernel.
    """
    cd2 = unrolled_sq_dists(oq[:, None, :, None, :], od[None, :, None, :, :])
    cd = ieee_sqrt(cd2)                                   # (B, S, N, N)
    rd2 = (rd * rd)[None, :, None, :]
    lb = torch.clamp_min(cd - rd[None, :, None, :], 0.0)
    ub = ieee_sqrt(cd2 + rd2) + rq[:, None, :, None]
    dok = d_ok[None, :, None, :]
    lb = torch.where(dok, lb, BIG)
    ub = torch.where(dok, ub, BIG)
    ok = q_ok[:, None, :]
    LBs, UBs = [], []
    for a, b in levels:
        okl = ok[..., a:b]
        row_lb = torch.amin(lb[:, :, a:b, a:b], dim=-1)
        row_ub = torch.amin(ub[:, :, a:b, a:b], dim=-1)
        LBs.append(torch.amax(torch.where(okl, row_lb, -BIG), dim=-1))
        UBs.append(torch.amax(torch.where(okl, row_ub, -BIG), dim=-1))
    return torch.stack(LBs), torch.stack(UBs)


def nn_distance(q: torch.Tensor, d: torch.Tensor, q_valid: torch.Tensor,
                d_valid: torch.Tensor):
    """Per-Q-point nearest neighbour in D: q (..., nq, W), d (..., nd, W),
    q_valid (..., nq), d_valid (..., nd) -> (dists (..., nq) float32, idx
    (..., nq) int32).  ``torch.argmin`` returns the first index on ties, as
    ``jnp.argmin`` does; invalid Q rows get distance 0.0 and index -1.
    The plain version of the ``nn_distance`` kernel."""
    d2 = masked_sq_dists(q, d, d_valid)
    idx = torch.argmin(d2, dim=-1).to(torch.int32)
    dist = ieee_sqrt(torch.amin(d2, dim=-1))
    dist = torch.where(q_valid, dist, 0.0)
    idx = torch.where(q_valid, idx, -1)
    return dist, idx


def nn_distance_batched(qs: torch.Tensor, ds: torch.Tensor,
                        qs_valid: torch.Tensor, ds_valid: torch.Tensor):
    """``nn_distance`` for P (query, dataset) pairs: qs (P, nq, W), ds
    (P, nd, W), qs_valid (P, nq), ds_valid (P, nd) -> (dists (P, nq), idx
    (P, nq)), a block of pairs at a time.  The plain version of the
    ``nn_distance`` kernel's pair axis."""
    parts = [nn_distance(qs[s], ds[s], qs_valid[s], ds_valid[s])
             for s in _pair_blocks(qs.shape[0], qs.shape[1] * ds.shape[1])]
    return (torch.cat([d for d, _ in parts]),
            torch.cat([i for _, i in parts]))


def bound_matrix(oq: torch.Tensor, rq: torch.Tensor, od: torch.Tensor,
                 rd: torch.Tensor):
    """Paper Eq. 4 bound matrices between two node frontiers:
    oq (..., nq, W), rq (..., nq), od (..., nd, W), rd (..., nd) ->
    (lb, ub), each (..., nq, nd), with lb = max(cd - rd, 0) and
    ub = sqrt(cd^2 + rd^2) + rq.  ``rd`` is squared at its own shape before
    the broadcast.  Leading axes (a batch of frontier pairs) broadcast; the
    plain version of the ``bound_matrices`` kernel."""
    cd2 = unrolled_sq_dists(oq[..., :, None, :], od[..., None, :, :])
    cd = ieee_sqrt(cd2)
    lb = torch.clamp_min(cd - rd[..., None, :], 0.0)
    ub = ieee_sqrt(cd2 + (rd * rd)[..., None, :]) + rq[..., :, None]
    return lb, ub


def bound_row_ub(oq: torch.Tensor, rq: torch.Tensor, od: torch.Tensor,
                 rd: torch.Tensor, d_ok: torch.Tensor) -> torch.Tensor:
    """The pruned NNP's row upper bounds: for each query node, the least
    Eq. 4 ub over the corpus nodes, with unoccupied ones (``d_ok`` False)
    counted as BIG.  oq (..., nq, W), rq (..., nq), od (..., nd, W),
    rd, d_ok (..., nd) -> (..., nq).  ``bound_matrix``'s ub, masked and
    reduced as the JAX package's ``nnp_pruned_core`` does; the plain
    version of the ``bound_row_ub`` kernel."""
    _, ub = bound_matrix(oq, rq, od, rd)
    return torch.amin(torch.where(d_ok[..., None, :], ub, BIG), dim=-1)


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 word (all 64 bits), by the SWAR bit trick:
    PyTorch has no popcount op.  Every mask clears bit 63, so the
    arithmetic right shifts of int64 act as logical ones, and the byte sums
    are folded with shifts, so nothing overflows."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def set_intersect_count(sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """GBO counts between two signature stacks: sa (na, W), sb (nb, W)
    int64 words holding uint32 values -> (na, nb) int32 totals of
    popcount(sa[i, w] & sb[j, w]) over the words.  The plain version of the
    ``set_intersect`` kernel."""
    both = sa[:, None, :] & sb[None, :, :]
    return popcount64(both).sum(dim=-1).to(torch.int32)

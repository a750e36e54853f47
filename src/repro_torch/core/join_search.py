"""Joinable dataset search: grid-cell overlap and coverage over the repository.

Counterpart of ``repro.core.join_search``.  The resemblance
ops rank datasets by how similar they are to the query; the joinable ops
rank them by how well they join with it on a shared spatial grid:

  overlap(Q, D)  = |cells(Q) ∩ cells(D)|, the distinct grid cells both
                   datasets occupy;
  coverage(Q, D) = |{p ∈ Q : cell(p) ∈ cells(D)}|, the query points that
                   land in cells D occupies.

Both are exact integers, so every route (kernel or plain popcount) gives
the same counts, and the port equals the JAX package exactly.

Scores live on a fine grid at ``theta_f = theta_c + FINE_DELTA``, where
``theta_c`` is the resolution of the resident coarse signatures.  Fine
signatures are never stored: each refine chunk builds them from the
resident points.  Upper bounds come from the coarse signatures:
``min(R2 * |coarse(Q) ∩ coarse(D)|, |fine(Q)|)`` for overlap (each coarse
cell holds ``R2 = 4**FINE_DELTA`` fine cells) and the query's coarse
per-cell histogram dotted with D's coarse occupancy for coverage.  The same
bounds on the upper tree's OR-union node signatures bound every slot
beneath a node; they feed the ``nodes_evaluated`` accounting.

Coverage rides the popcount kernel through bit planes: the per-cell count
histogram of Q is cut into ``P = bit_length(n)`` planes packed like
signatures, and ``coverage = sum_p 2**p * |plane_p(Q) ∩ occ(D)|``, so one
(B * P, S) ``set_intersect`` launch answers the batch
(``ops.plane_weighted_intersect``).

On the card, one search makes ``2 + n_chunks`` ``set_intersect`` launches:
the slot bounds, the upper tree's node bounds (every level in one launch;
the JAX package's ``_plane_dot`` and ``sig_intersect_count`` per level are
this launch's plain version), and one per refine chunk.  The refine is a
Python loop over device tensors with one host read per chunk, the
counterpart of the JAX package's ``lax.while_loop``.  Its sharded form
(the JAX package's ``axis=``) is ``topk_join_scores_shards``: the same
loop in lockstep over the shards of a repository, which the local engine
runs with one shard.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import distributed, zorder
from repro_torch.core.repo_index import Repository
from repro_torch.core.search import SearchStats
from repro_torch.kernels import ops

#: fine grid refinement below the stored coarse resolution:
#: theta_f = theta_c + FINE_DELTA, R2 = 4**FINE_DELTA fine cells per coarse
FINE_DELTA = 2

MODES = ("overlap", "coverage")

#: slots whose cell ids the host oracle computes at once
HOST_BLOCK = 1024


def theta_of_words(n_words: int) -> int:
    """Grid resolution theta whose signature packs into ``n_words`` words."""
    return int(math.log2(n_words * zorder.WORD_BITS)) // 2


def join_thetas(repo: Repository) -> tuple[int, int]:
    """(coarse, fine) grid resolutions for joinable scoring on ``repo``."""
    theta_c = theta_of_words(repo.ds_sigs.shape[-1])
    return theta_c, theta_c + FINE_DELTA


def num_planes(n_points: int) -> int:
    """Bit planes needed for per-cell counts of an n-point histogram."""
    return max(1, int(n_points).bit_length())


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown join mode {mode!r}; modes: {MODES}")


def hist_planes(points, valid, lo, hi, theta: int, n_planes: int):
    """Per-cell point-count histograms of B point sets, packed as bit
    planes: points (B, n, d), valid (B, n) -> (B, n_planes, W) words
    (int64 holding uint32 values), where word-bit (p, c) is bit p of the
    number of valid points in grid cell c, packed like a signature."""
    n_cells = zorder.num_cells(theta)
    ids = torch.where(valid, zorder.cell_ids(points, lo, hi, theta), n_cells)
    B = ids.shape[0]
    dev = ids.device
    # one overflow cell takes the padding
    hist = torch.zeros((B, n_cells + 1), dtype=torch.int64, device=dev)
    hist.scatter_add_(1, ids, torch.ones_like(ids))
    planes = torch.arange(n_planes, dtype=torch.int64, device=dev)
    bits = (hist[:, None, :n_cells] >> planes[None, :, None]) & 1
    bits = bits.reshape(B, n_planes, zorder.num_words(theta), zorder.WORD_BITS)
    shifts = torch.arange(zorder.WORD_BITS, dtype=torch.int64, device=dev)
    # bits are distinct, so the sum is the bitwise OR
    return (bits << shifts).sum(dim=-1)


def query_features(q_pts, q_val, lo, hi, theta_c: int, theta_f: int,
                   mode: str) -> dict:
    """Per-query grid features of a (B, n, d) batch: coarse and fine
    signatures ``csig``/``fsig`` (B, W), the fine cell count ``fcnt`` (B,)
    int32, and for coverage the histogram planes ``cplanes``/``fplanes``
    (B, P, W) at both resolutions."""
    feats = {"csig": zorder.signature(q_pts, q_val, lo, hi, theta_c),
             "fsig": zorder.signature(q_pts, q_val, lo, hi, theta_f)}
    feats["fcnt"] = zorder.sig_count(feats["fsig"])
    if mode == "coverage":
        n_p = num_planes(q_pts.shape[-2])
        feats["cplanes"] = hist_planes(q_pts, q_val, lo, hi, theta_c, n_p)
        feats["fplanes"] = hist_planes(q_pts, q_val, lo, hi, theta_f, n_p)
    return feats


def _join_bounds(feats: dict, sigs, mode: str, r2: int):
    """Upper bounds of every query against coarse signatures sigs (N, W):
    (B, N) int32, one ``set_intersect`` launch on the card.  Slot
    signatures bound their slot; the upper tree's union signatures bound
    every slot beneath the node."""
    if mode == "overlap":
        ub = ops.set_intersect_counts(feats["csig"], sigs) * r2
        return torch.minimum(ub, feats["fcnt"][:, None])
    return ops.plane_weighted_intersect(feats["cplanes"], sigs)


def _slot_bounds(repo: Repository, feats: dict, mode: str, r2: int):
    """Per-slot upper bounds from the resident coarse signatures: (B, S)
    int32 with -1 in invalid slots."""
    ub = _join_bounds(feats, repo.ds_sigs, mode, r2)
    return torch.where(repo.ds_valid[None, :], ub, -1)


def _node_frontier(repo: Repository, feats: dict, tau, mode: str, r2: int):
    """Multi-level accounting: per query, the upper-tree nodes a
    bound-driven frontier descent at threshold tau would expand, (B,)
    int32.  The bounds of every level come from one launch."""
    up = repo.repo
    ub = _join_bounds(feats, up.sigs, mode, r2)                # (B, nodes)
    floor = torch.clamp_min(tau, 0)[:, None]
    occupied = (up.counts > 0)[None, :]
    active = torch.ones((tau.shape[0], 1), dtype=torch.bool,
                        device=tau.device)
    nodes = torch.zeros(tau.shape, dtype=torch.int32, device=tau.device)
    for level in range(up.depth + 1):
        sl = up.level_slice(level)
        live = active & (ub[:, sl] >= floor) & occupied[:, sl]
        nodes += live.sum(dim=-1, dtype=torch.int32)
        if level < up.depth:
            active = live.repeat_interleave(2, dim=1)
    return nodes


def slot_fine_sigs(points, valid, lo, hi, theta_f: int):
    """Fine signatures of a batch of resident slot point sets."""
    return zorder.signature(points, valid, lo, hi, theta_f)


def topk_join_scores(repo: Repository, q_pts, q_val, k: int, mode: str,
                     chunk: int):
    """Bound phase and shared-order chunked exact refine for a (B, n, d)
    query batch: :func:`topk_join_scores_shards` with one shard.

    Slots are refined in one order for the whole batch, descending
    max-over-queries upper bound, ``chunk`` at a time: each chunk's fine
    signatures are built once and scored against every query.  Query b
    keeps tau_b, the kth largest exact score seen once k are known; a
    chunk runs while some query's best remaining bound reaches its tau.

    Returns ``(exact, nodes, cand_after, evaluated)``: exact (B, S) int32,
    the join score or -1 where the slot is invalid or was pruned; nodes
    (B,) the frontier accounting at the final tau; cand_after (B,) the
    slots whose bound survives it; evaluated (B,) the exact evaluations.
    """
    exacts, nodes, cand, evaluated = topk_join_scores_shards(
        [repo], q_pts, q_val, k, mode, chunk)
    return exacts[0], nodes, cand, evaluated


def _kth_largest(exacts, k: int):
    """Each query's kth-largest exact score over the shards (ints: any
    selection is exact); with one shard the local ``topk``."""
    if len(exacts) == 1:
        e = exacts[0]
        return torch.topk(e, min(k, e.shape[-1]), dim=-1).values[:, -1]
    return -distributed.global_kth_smallest([-e for e in exacts], k)


def topk_join_scores_shards(shards, q_pts, q_val, k: int, mode: str,
                            chunk: int):
    """The joinable bound phase and refine over a repository split into
    shards (a list of :class:`Repository`, the upper tree and space bounds
    on every shard's device; the local engine passes one), in lockstep.

    Each shard orders its own slots (descending max-over-queries bound)
    and refines its own chunks.  After every step each query's integer
    tau is the kth largest exact score over all shards
    (``distributed.global_kth_smallest`` of the negated scores, as the
    JAX package's sharded form does) and each shard re-tests its own
    remaining bounds: one host read per step for the whole mesh.  Query
    features are built once, on the first shard's device (q_pts / q_val
    live there).  Scores are exact ints, so the merged top-k is the same
    under any split; only ``evaluated`` depends on it.  Shard-padded
    slots are invalid, bound -1 and are never evaluated.

    Returns (per-shard exact (B, S_shard), nodes (B,), cand_after (B,),
    evaluated (B,)), the counters summed over the shards."""
    _check_mode(mode)
    lead = shards[0]
    theta_c, theta_f = join_thetas(lead)
    r2 = 1 << (2 * FINE_DELTA)
    B = q_pts.shape[0]
    feats = query_features(q_pts, q_val, lead.space_lo, lead.space_hi,
                           theta_c, theta_f, mode)

    states = []
    for sh in shards:
        dev = sh.device
        f = {name: x.to(dev) for name, x in feats.items()}
        ub = _slot_bounds(sh, f, mode, r2)                     # (B, S)
        S = sh.n_slots
        # one shared order for the batch, descending max-over-queries
        # bound (stable: ties keep slot order), padded with slot 0
        order = torch.sort(-ub.amax(dim=0), stable=True).indices
        n_chunks = max(1, -(-S // chunk))
        s_pad = n_chunks * chunk
        order_p = F.pad(order, (0, s_pad - S))
        in_range = torch.arange(s_pad, device=dev) < S
        ub_sorted = torch.where(in_range[None, :], ub[:, order_p], -1)
        chunk_max = ub_sorted.reshape(B, n_chunks, chunk).amax(dim=-1)
        # suffix max over chunks: the best bound any later slot can offer
        suff = torch.flip(torch.cummax(torch.flip(chunk_max, [1]),
                                       dim=1).values, [1])  # (B, chunks)
        states.append({
            "sh": sh, "f": f, "ub": ub, "S": S, "n_chunks": n_chunks,
            "order": order_p, "suff": suff, "pos": 0,
            "lanes": torch.arange(chunk, device=dev),
            "exact": torch.full((B, S), -1, dtype=torch.int32, device=dev),
            "evaluated": torch.zeros((B,), dtype=torch.int32, device=dev)})

    def need(st, tau_c):
        # valid slots have bounds >= 0, so flooring tau at 0 both skips
        # invalid-only suffixes and keeps every unpruned valid slot
        dev = st["exact"].device
        if st["pos"] >= st["n_chunks"]:
            return torch.zeros((B,), dtype=torch.bool, device=dev)
        return st["suff"][:, st["pos"]] >= torch.clamp_min(tau_c.to(dev), 0)

    tau = torch.full((B,), -1, dtype=torch.int32, device=q_pts.device)
    nbs = [need(st, tau) for st in states]
    while True:
        flags = distributed.any_per_shard(nbs)   # one host read per chunk
        if not any(flags):
            break
        for st, nb, flag in zip(states, nbs, flags):
            if not flag:
                continue
            sh, pos, f = st["sh"], st["pos"], st["f"]
            ids = st["order"][pos * chunk:(pos + 1) * chunk]
            sigs = slot_fine_sigs(sh.ds_index.points[ids],
                                  sh.ds_index.valid[ids], sh.space_lo,
                                  sh.space_hi, theta_f)
            if mode == "overlap":
                sc = ops.set_intersect_counts(f["fsig"], sigs)
            else:
                sc = ops.plane_weighted_intersect(f["fplanes"], sigs)
            live = ((((pos * chunk + st["lanes"]) < st["S"])
                     & sh.ds_valid[ids])[None, :] & nb[:, None])
            sc = torch.where(live, sc, -1)
            # a max merge: the padded tail names slot 0 again with -1
            st["exact"].scatter_reduce_(1, ids[None, :].expand(B, chunk), sc,
                                        "amax", include_self=True)
            st["evaluated"] += live.sum(dim=-1, dtype=torch.int32)
            st["pos"] = pos + 1
        # only a full top-k of true scores may raise tau: the kth largest
        # of an evaluated subset is <= the true kth value
        exacts = [st["exact"] for st in states]
        kth = _kth_largest(exacts, k)
        n_fin = distributed.psum_int([(e >= 0).sum(dim=-1) for e in exacts])
        tau = torch.maximum(tau, torch.where(n_fin >= k, kth, -1))
        nbs = [need(st, tau) for st in states]

    cand = distributed.psum_int([
        ((st["ub"] >= torch.clamp_min(tau.to(st["ub"].device), 0)[:, None])
         & (st["ub"] >= 0)).sum(dim=-1, dtype=torch.int32)
        for st in states])
    nodes = _node_frontier(lead, feats, tau, mode, r2)
    evaluated = distributed.psum_int([st["evaluated"] for st in states])
    return [st["exact"] for st in states], nodes, cand, evaluated


def pair_scores(repo: Repository, d_points, d_valid, q_pts, q_val,
                mode: str):
    """Row-wise exact join score between query row t and slot points row
    t, (T,) int32.  The dataset -> dataset pipeline stage re-scores its
    stage-1 winners with it."""
    _check_mode(mode)
    lo, hi = repo.space_lo, repo.space_hi
    _, theta_f = join_thetas(repo)
    d_sigs = slot_fine_sigs(d_points, d_valid, lo, hi, theta_f)
    if mode == "overlap":
        q_sigs = zorder.signature(q_pts, q_val, lo, hi, theta_f)
        return zorder.sig_intersect_count(q_sigs, d_sigs)
    n_p = num_planes(q_pts.shape[-2])
    planes = hist_planes(q_pts, q_val, lo, hi, theta_f, n_p)
    cnt = zorder.sig_intersect_count(planes, d_sigs[:, None, :])   # (T, P)
    weights = 1 << torch.arange(n_p, dtype=torch.int32, device=cnt.device)
    return (cnt * weights[None, :]).sum(dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# host oracle
# ---------------------------------------------------------------------------


def topk_join_host(repo: Repository, pointsets, k: int, mode: str):
    """Brute-force joinable top-k over the resident repository.

    Scores every valid slot with Python set arithmetic on the fine-grid
    cell ids (computed on the repository's device, read back in blocks of
    ``HOST_BLOCK`` slots), ranks descending with ties toward the smaller
    slot id, and puts -1 sentinels past the valid supply.  Returns
    (vals (B, k), ids (B, k)) int32 numpy arrays."""
    _check_mode(mode)
    lo, hi = repo.space_lo, repo.space_hi
    _, theta_f = join_thetas(repo)
    slot_valid = repo.ds_valid.cpu().numpy()
    S = slot_valid.shape[0]
    d_cells = []
    for s0 in range(0, S, HOST_BLOCK):
        idx = repo.ds_index
        cells = zorder.cell_ids(idx.points[s0:s0 + HOST_BLOCK], lo, hi,
                                theta_f).cpu().numpy()
        valid = idx.valid[s0:s0 + HOST_BLOCK].cpu().numpy()
        d_cells += [set(c[v].tolist()) if slot_valid[s0 + i] else set()
                    for i, (c, v) in enumerate(zip(cells, valid))]

    vals = np.full((len(pointsets), k), -1, np.int32)
    ids = np.full((len(pointsets), k), -1, np.int32)
    for b, q in enumerate(pointsets):
        q = torch.as_tensor(np.asarray(q, np.float32), device=lo.device)
        qc = zorder.cell_ids(q, lo, hi, theta_f).cpu().numpy()
        q_cells = set(qc.tolist())
        # coverage: the query's points per cell, summed over D's cells
        cells_u, counts_u = np.unique(qc, return_counts=True)
        per_cell = list(zip(cells_u.tolist(), counts_u.tolist()))
        scores = np.full((S,), -1, np.int64)
        for s in range(S):
            if not slot_valid[s]:
                continue
            if mode == "overlap":
                scores[s] = len(q_cells & d_cells[s])
            else:
                scores[s] = sum(n for c, n in per_cell if c in d_cells[s])
        top = np.argsort(-scores, kind="stable")[:k]
        t = len(top)
        vals[b, :t] = scores[top]
        ids[b, :t] = np.where(vals[b, :t] < 0, -1, top)
    return vals, ids


def join_stats_host(n_valid: int, evaluated, nodes, cand) -> list:
    """Per-query SearchStats from host counters: the pruned fraction is the
    share of valid slots never exact-scored."""
    return [SearchStats(int(n), int(c), int(e),
                        float(1.0 - int(e) / max(n_valid, 1)))
            for e, n, c in zip(evaluated, nodes, cand)]

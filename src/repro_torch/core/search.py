"""Search layer (paper Section VI): the dataset-granularity operations.

Counterpart of ``repro.core.search``:

  * RangeS          (Def. 9)  level-synchronous traversal of the upper tree;
  * top-k IA        (Def. 6)  one dense box-algebra pass plus a top-k;
  * top-k GBO       (Def. 7)  one popcount(AND) matrix
                              (``ops.set_intersect_counts``) plus a top-k;
  * ApproHaus       (Lemma 1) center-distance frontier scores at the first
                              level whose node radii are all below eps;
  * ExactHaus       (Def. 8)  branch-and-bound over the unified index, for
                              a batch of B queries at once:

      phases 0/1  one fused Eq. 4 bound pass over every (query, slot) pair
                  and tree level (``ops.bound_grid``), then level-synchronous
                  tightening of each query's candidate set under its own
                  threshold tau (the kth-smallest upper bound);
      phase 2     exact Hausdorff on the candidates in ascending lower-bound
                  order, one chunk per query per step
                  (``ops.directed_hausdorff_lanes`` for the live lanes of
                  the (B, chunk) grid), tau re-derived from the k smallest
                  exact values after every chunk.

JAX's ``lax.while_loop`` becomes a Python loop over device tensors with one
host sync per chunk (the "any query has work" test).  Both phases take a
repository split into shards (``bound_phases_shards``, ``phase2_shards``:
the sharded engine's lockstep form, the counterpart of the JAX package's
``axis=`` forms); the local engine passes one shard and runs the same
code.  ``topk_hausdorff_host``
keeps the host-chunked loop, one (Q, D) pair per kernel call, as the
oracle: the batched pipeline must equal it bitwise.  ``lax.top_k`` (largest
first, ties toward the smaller index) is a stable sort here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import distributed, geometry
from repro_torch.core.index import DatasetIndex
from repro_torch.core.repo_index import Repository
from repro_torch.kernels import hausdorff, ops
from repro_torch.kernels.ref import BIG

# ExactHaus prune guard: a candidate survives while LB <= tau * TAU_GUARD,
# which admits candidates within ~100 ulps of the threshold so that ulp-level
# drift of the bounds can never flip a prune decision that matters; extra
# exact evaluations are > H_k and never enter the top-k (superset rule).
# One float32 multiply, identical on device and on the host.
TAU_GUARD = np.float32(1.0 + 1e-5)
_GUARD = float(TAU_GUARD)


class SearchStats(NamedTuple):
    nodes_evaluated: int
    candidates_after_bounds: int
    exact_evaluations: int
    pruned_fraction: float


def _topk_largest(vals: torch.Tensor, k: int):
    """The k largest along the last axis, ties toward the smallest index
    (``lax.top_k`` order): a stable descending sort."""
    s, i = torch.sort(vals, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def _topk_smallest(vals: torch.Tensor, k: int):
    """The k smallest along the last axis, ties toward the smallest index
    (``lax.top_k(-vals)`` order): a stable ascending sort."""
    s, i = torch.sort(vals, dim=-1, stable=True)
    return s[..., :k], i[..., :k]


# ---------------------------------------------------------------------------
# RangeS (Def. 9)
# ---------------------------------------------------------------------------


def range_search(repo: Repository, r_lo, r_hi):
    """All datasets whose MBR overlaps [r_lo, r_hi] (one (d,) box).
    Returns (mask over dataset slots, SearchStats)."""
    mask, live_nodes, nodes_evaluated = _range_search_core(
        repo, r_lo[None], r_hi[None])
    live = int(live_nodes[0])
    stats = SearchStats(nodes_evaluated, int(mask.sum()), 0,
                        1.0 - live / max(nodes_evaluated, 1))
    return mask[0], stats


def _range_search_core(repo: Repository, r_lo, r_hi):
    """RangeS for B query boxes r_lo, r_hi (B, d): (masks (B, B_pad),
    live_nodes (B,), total_nodes).

    Level-synchronous traversal of the upper tree; pruned subtrees stay
    masked.  ``total_nodes`` is a Python int (tree lanes touched);
    ``live_nodes`` counts the lanes still active at each level, the nodes a
    pointer-chasing traversal would visit, on the device."""
    up = repo.repo
    depth = up.depth
    lo_q, hi_q = r_lo[:, None, :], r_hi[:, None, :]
    B = r_lo.shape[0]
    active = torch.ones((B, 1), dtype=torch.bool, device=r_lo.device)
    nodes_evaluated = 0
    live_nodes = torch.zeros((B,), dtype=torch.int32, device=r_lo.device)
    for level in range(depth + 1):
        sl = up.level_slice(level)
        hit = (geometry.box_overlaps(up.box_lo[sl], up.box_hi[sl], lo_q, hi_q)
               & (up.counts[sl] > 0))
        active = active & hit
        nodes_evaluated += active.shape[1]
        live_nodes = live_nodes + active.sum(dim=1).to(torch.int32)
        if level < depth:
            active = active.repeat_interleave(2, dim=1)
    # leaf segments -> dataset slots (tree order), then each dataset's MBR
    f_up = up.ds_valid.shape[0] // (1 << depth)
    ds_active_tree = active.repeat_interleave(f_up, dim=1)
    _, _, lo_r, hi_r = repo.roots()
    hit_ds = geometry.box_overlaps(lo_r[up.order], hi_r[up.order], lo_q, hi_q)
    mask_tree = ds_active_tree & hit_ds & up.ds_valid
    mask = torch.zeros_like(mask_tree)
    mask[:, up.order] = mask_tree
    return mask, live_nodes, nodes_evaluated


# ---------------------------------------------------------------------------
# top-k IA (Def. 6) and top-k GBO (Def. 7)
# ---------------------------------------------------------------------------


def topk_ia(repo: Repository, q_lo, q_hi, k: int):
    """Top-k datasets by intersecting area with Q's MBR.  Padded slots
    score -1 and surface, past the valid count, with id -1."""
    _, _, lo, hi = repo.roots()
    ia = geometry.intersect_area(lo, hi, q_lo, q_hi)
    ia = torch.where(repo.ds_valid, ia, -1.0)
    vals, ids = _topk_largest(ia, k)
    return vals, torch.where(vals < 0, -1, ids)


def topk_gbo(repo: Repository, q_sig, k: int):
    """Top-k datasets by z-order signature overlap (q_sig: (W,) int64
    words).  Padded slots score -1 and surface with id -1."""
    counts = ops.set_intersect_counts(q_sig[None, :], repo.ds_sigs)[0]
    counts = torch.where(repo.ds_valid, counts, -1)
    vals, ids = _topk_largest(counts, k)
    return vals, torch.where(vals < 0, -1, ids)


# ---------------------------------------------------------------------------
# ExactHaus
# ---------------------------------------------------------------------------


def _frontier_bound_all_levels(q_idx: DatasetIndex, ds_index: DatasetIndex,
                               max_level: int):
    """Every (query, slot) pair's per-level (LB, UB) frontier scalars for
    levels 0..max_level in one ``ops.bound_grid`` call.  q_idx is a (B, ...)
    batch, ds_index the (S, ...) corpus.  Returns (LB, UB), each
    (max_level + 1, B, S)."""
    n_nodes = q_idx.level_slice(max_level).stop
    levels = tuple((q_idx.level_slice(l).start, q_idx.level_slice(l).stop)
                   for l in range(max_level + 1))
    return ops.bound_grid(
        q_idx.centers[:, :n_nodes].contiguous(),
        q_idx.radii[:, :n_nodes].contiguous(),
        (q_idx.counts[:, :n_nodes] > 0).contiguous(),
        ds_index.centers[:, :n_nodes].contiguous(),
        ds_index.radii[:, :n_nodes].contiguous(),
        (ds_index.counts[:, :n_nodes] > 0).contiguous(),
        levels=levels)


def _as_query_batch(q_idx: DatasetIndex):
    """Promote a single-query index to a (1, ...) batch; returns
    (batched index, was_single)."""
    if q_idx.points.ndim == 2:
        return DatasetIndex(*[x[None] for x in q_idx]), True
    return q_idx, False


def _hausdorff_bound_phases(repo: Repository, q_idx: DatasetIndex, k: int,
                            refine_levels: int):
    """Phases 0 + 1 of ExactHaus for a (B, ...) query batch (a single query
    is promoted and squeezed on return): :func:`bound_phases_shards` with
    one shard.

    Returns (LB (B, S), tau (B,), cand (B, S), nodes_evaluated (B,),
    cand_after_bounds (B,)), all device tensors."""
    q_idx, single = _as_query_batch(q_idx)
    LBs, tau, cands, nodes, cand_after = bound_phases_shards(
        [repo], [q_idx], k, refine_levels, repo.n_slots)
    out = (LBs[0], tau, cands[0], nodes, cand_after)
    if single:
        out = tuple(x[0] for x in out)
    return out


def bound_phases_shards(shards, q_shards, k: int, refine_levels: int,
                        n_slots_total: int):
    """Phases 0 + 1 of ExactHaus over a repository whose slots are split
    into shards (a list of :class:`Repository`, one extent each; the
    local engine passes one).

    ``q_shards`` holds the (B, ...) query batch on each shard's device.
    Each shard runs one ``ops.bound_grid`` launch over its slots; the
    bounds of a slot do not depend on the others, so slicing changes no
    value.  The two repository-wide quantities are collectives over the
    shards: each query's tau, the kth-smallest UB
    (``distributed.global_kth_smallest``), and the counters
    (``distributed.psum_int``).  Slots from ``n_slots_total`` on are
    shard padding: they never count as candidates, even when tau is BIG
    (k past the valid count), and the phase-0 node count is
    ``n_slots_total``, so the counters equal the local engine's.

    Returns (LBs, tau (B,), cands, nodes_evaluated (B,), cand_after
    (B,)): LBs and cands per-shard lists of (B, S_shard), the rest on the
    first shard's device."""
    max_level = min(q_shards[0].depth, shards[0].ds_index.depth,
                    refine_levels)
    lvls = [_frontier_bound_all_levels(q, sh.ds_index, max_level)
            for sh, q in zip(shards, q_shards)]
    valids = [sh.ds_valid[None, :] for sh in shards]

    def count(mask):
        return mask.sum(dim=-1).to(torch.int32)

    def prune(cands, LBs, tau):
        return [c & (lb <= (tau.to(lb.device) * _GUARD)[:, None])
                for c, lb in zip(cands, LBs)]

    # phase 0: root-granularity Eq. 4 bounds for every slot
    LBs = [torch.where(v, lb[0], BIG) for v, (lb, _) in zip(valids, lvls)]
    UBs = [torch.where(v, ub[0], BIG) for v, (_, ub) in zip(valids, lvls)]
    tau = distributed.global_kth_smallest(UBs, k)
    cands = [lb <= (tau.to(lb.device) * _GUARD)[:, None] for lb in LBs]
    base = 0
    for i, lb in enumerate(LBs):
        if base + lb.shape[1] > n_slots_total:      # shard padding
            gid = base + torch.arange(lb.shape[1], device=lb.device)
            cands[i] = cands[i] & (gid < n_slots_total)[None, :]
        base += lb.shape[1]
    nodes_evaluated = torch.full((LBs[0].shape[0],), n_slots_total,
                                 dtype=torch.int32, device=LBs[0].device)

    # phase 1: level-synchronous refinement (bounds only tighten)
    for level in range(1, max_level + 1):
        LBs = [torch.where(c, torch.maximum(lb, lv[level]), lb)
               for c, lb, (lv, _) in zip(cands, LBs, lvls)]
        UBs = [torch.where(c, torch.minimum(ub, uv[level]), ub)
               for c, ub, (_, uv) in zip(cands, UBs, lvls)]
        tau = distributed.global_kth_smallest(
            [torch.where(v, ub, BIG) for v, ub in zip(valids, UBs)], k)
        cands = prune(cands, LBs, tau)
        nodes_evaluated = nodes_evaluated + distributed.psum_int(
            [count(c) for c in cands]) * (1 << level)

    cand_after = distributed.psum_int([count(c) for c in cands])
    return LBs, tau, cands, nodes_evaluated, cand_after


def phase2_query_rows(q_idx: DatasetIndex):
    """Phase 2's query rows for a (B, ...) batch: each query's valid rows
    first, cut to the largest count rounded up to the kernel's row block
    (one host read per search).  Returns (q_c (B, nqp, W), n_q (B,))."""
    q_c, n_q = hausdorff.compact_rows(q_idx.points, q_idx.valid)
    grain = hausdorff.ROWS_PER_BLOCK
    nqp = min(-(-max(int(n_q.max()), 1) // grain) * grain, q_c.shape[1])
    return q_c[:, :nqp].contiguous(), n_q


def _phase2_exact_loop(LB, cand, tau, q_idx: DatasetIndex,
                       ds_index: DatasetIndex, k: int, chunk: int):
    """Phase 2 of ExactHaus for a (B, ...) query batch (a single query is
    promoted and squeezed): :func:`phase2_shards` with one shard.
    Returns (exact_vals (B, S) with BIG where not evaluated, evaluated
    (B,))."""
    single = LB.ndim == 1
    if single:
        LB, cand, tau = LB[None], cand[None], tau[None]
    q_idx, _ = _as_query_batch(q_idx)
    vals, evaluated = phase2_shards([LB], [cand], tau, q_idx, [ds_index],
                                    k, chunk)
    if single:
        return vals[0][0], evaluated[0]
    return vals[0], evaluated


def phase2_shards(LBs, cands, tau, q_idx: DatasetIndex, ds_indexes, k: int,
                  chunk: int):
    """Phase 2 of ExactHaus in lockstep over the shards of a repository:
    one loop over a shared (query, candidate-chunk) work frontier.

    Each shard keeps its own ascending-LB order over its own slots.  A
    step evaluates, on every shard with work, the next chunk of each
    query that still has work there in one
    ``ops.directed_hausdorff_lanes`` launch (the live lanes only, read
    from the shard's resident corpus by slot id, over the query rows
    compacted once before the loop).  Then each query's tau is re-derived
    from its k smallest exact values over all shards
    (``distributed.global_kth_smallest``) and every shard re-tests its
    own work: one host read per step for the whole mesh.  A query or
    shard without work idles and may resume when a raised tau lets it,
    as in the JAX package's sharded loop, so with one shard each query
    follows exactly the trajectory of its solo host loop.

    Exactness under any split: tau is always >= the true kth-smallest
    H_k, so a skipped candidate has H >= LB > H_k and cannot enter the
    top-k, ties included.  Only ``evaluated`` depends on the split.
    Returns (per-shard exact values (B, S_shard) with BIG where not
    evaluated, evaluated (B,) summed over the shards)."""
    q_c, n_q = phase2_query_rows(q_idx)
    tau_c = tau.to(torch.float32)
    states = []
    for LB, cand, ds in zip(LBs, cands, ds_indexes):
        B, S = LB.shape
        dev = LB.device
        lb_masked = torch.where(cand, LB, BIG)
        # stable: LB ties keep slot order
        lb_sorted, order = torch.sort(lb_masked, dim=-1, stable=True)
        n_pad = -(-S // chunk) * chunk
        states.append({
            "S": S, "n_pad": n_pad,
            # pad ids are 0 with BIG lanes: their amin writes change nothing
            "order": F.pad(order, (0, n_pad - S)),
            "lb": F.pad(lb_sorted, (0, n_pad - S), value=BIG),
            "q_c": q_c.to(dev), "n_q": n_q.to(dev),
            # the corpus is read in place by slot id
            "pts": ds.points, "valid": ds.valid,
            "extent": hausdorff.valid_extent(ds.valid),
            "lanes": torch.arange(chunk, dtype=torch.int64, device=dev),
            "pos": torch.zeros((B,), dtype=torch.int64, device=dev),
            "vals": torch.full((B, S), BIG, dtype=torch.float32, device=dev),
            "evaluated": torch.zeros((B,), dtype=torch.int32, device=dev)})

    def has_work(st, tau_c):
        # candidates remain and the head is not pruned (guarded)
        pos, n_pad = st["pos"], st["n_pad"]
        tau_s = tau_c.to(pos.device)
        lb0 = torch.gather(st["lb"], 1, pos.clamp(max=n_pad - 1)[:, None])[:, 0]
        return (pos < st["S"]) & (lb0 < BIG / 2) & (lb0 <= tau_s * _GUARD)

    gos = [has_work(st, tau_c) for st in states]
    while True:
        flags = distributed.any_per_shard(gos)
        if not any(flags):
            break
        for st, go, flag in zip(states, gos, flags):
            if not flag:
                continue
            pos = st["pos"]
            idx = (pos[:, None] + st["lanes"][None, :]).clamp(
                max=st["n_pad"] - 1)
            ids = torch.gather(st["order"], 1, idx)
            lbs = torch.gather(st["lb"], 1, idx)
            live = (lbs < BIG / 2) & go[:, None]
            # dead lanes come back BIG and change nothing in the amin
            hs = ops.directed_hausdorff_lanes(st["q_c"], st["n_q"], st["pts"],
                                              st["valid"], st["extent"], ids,
                                              live)
            st["vals"].scatter_reduce_(1, ids, hs, "amin", include_self=True)
            st["evaluated"] += live.sum(dim=-1).to(torch.int32)
            st["pos"] = torch.where(go, pos + chunk, pos)
        # per-query threshold tightening from the k finite exacts
        finite = [st["vals"] < BIG / 2 for st in states]
        kth = distributed.global_kth_smallest(
            [torch.where(f, st["vals"], BIG) for f, st in zip(finite, states)],
            k)
        n_fin = distributed.psum_int([f.sum(dim=-1) for f in finite])
        tau_c = torch.where(n_fin >= k, kth, tau_c)
        gos = [has_work(st, tau_c) for st in states]
    evaluated = distributed.psum_int([st["evaluated"] for st in states])
    return [st["vals"] for st in states], evaluated


def _topk_hausdorff_device_batched(repo: Repository, q_batch: DatasetIndex,
                                   k: int, refine_levels: int, chunk: int):
    """Batched ExactHaus on the device: B queries, phases 0/1 then the
    shared phase-2 loop.  Per-query results are bitwise those of the host
    loop ``topk_hausdorff_host``.

    Returns (vals (B, k), ids (B, k), nodes (B,), cand_after (B,),
    evaluated (B,))."""
    LB, tau, cand, nodes_evaluated, cand_after = _hausdorff_bound_phases(
        repo, q_batch, k, refine_levels)
    exact_vals, evaluated = _phase2_exact_loop(
        LB, cand, tau, q_batch, repo.ds_index, k, chunk)
    vals = torch.where(repo.ds_valid[None, :], exact_vals, BIG)
    top_vals, top_ids = _topk_smallest(vals, k)
    return top_vals, top_ids, nodes_evaluated, cand_after, evaluated


def topk_hausdorff(repo: Repository, q_idx: DatasetIndex, k: int, *,
                   refine_levels: int = 3, chunk: int = 32):
    """ExactHaus: the k datasets with the smallest directed Hausdorff
    H(Q -> D), for one query index row.  Returns (vals (k,), ids (k,),
    SearchStats)."""
    q_batch, _ = _as_query_batch(q_idx)
    vals, ids, nodes, cand_after, evaluated = _topk_hausdorff_device_batched(
        repo, q_batch, k, refine_levels, chunk)
    n_valid = max(int(repo.ds_valid.sum()), 1)
    ev = int(evaluated[0])
    stats = SearchStats(int(nodes[0]), int(cand_after[0]), ev,
                        1.0 - ev / n_valid)
    return vals[0], ids[0], stats


def topk_hausdorff_host(repo: Repository, q_idx: DatasetIndex, k: int, *,
                        refine_levels: int = 3, chunk: int = 32):
    """ExactHaus with the host-chunked phase 2 (reference semantics): the
    oracle the batched pipeline is held to.  Each chunk of candidates is
    gathered from the corpus and evaluated by one
    ``ops.directed_hausdorff_pairs`` call (one ``min_sq_dists`` launch on
    the card), then read back: one host sync per chunk.  It never calls
    ``ops.directed_hausdorff_lanes`` or any kernel of
    ``csrc/hausdorff_grid.cu``, so it stays an independent check of phase
    2's kernel.
    Returns (vals (k,), ids (k,), SearchStats)."""
    S = repo.n_slots
    valid = repo.ds_valid
    LB, tau, cand, nodes_dev, _ = _hausdorff_bound_phases(
        repo, q_idx, k, refine_levels)
    nodes_evaluated = int(nodes_dev)
    cand_after_bounds = int(cand.sum())

    # phase 2: exact evaluation in ascending-LB order on the host; stable,
    # so LB ties evaluate in slot order as on the device
    lb_np = torch.where(cand, LB, BIG).cpu().numpy()
    order = np.argsort(lb_np, kind="stable")
    exact_vals = np.full((S,), np.float32(BIG))
    tau_f = float(tau)
    evaluated = 0

    q_pts, q_val = q_idx.points, q_idx.valid
    d_pts_all, d_val_all = repo.ds_index.points, repo.ds_index.valid

    pos = 0
    while pos < S:
        ids = order[pos:pos + chunk]
        ids = ids[lb_np[ids] < BIG / 2]
        if ids.size == 0:
            break
        if lb_np[ids[0]] > np.float32(tau_f) * TAU_GUARD:
            break  # everything remaining is pruned (guarded)
        ids_t = torch.from_numpy(ids).to(d_pts_all.device)
        hs = ops.directed_hausdorff_pairs(q_pts, d_pts_all[ids_t], q_val,
                                          d_val_all[ids_t])
        exact_vals[ids] = hs.cpu().numpy()
        evaluated += int(ids.size)
        finite = exact_vals[exact_vals < BIG / 2]
        if finite.size >= k:
            tau_f = float(np.sort(finite)[k - 1])
        pos += chunk

    # final ranking: exact values where evaluated, everything else pruned
    vals = torch.where(valid, torch.from_numpy(exact_vals).to(valid.device),
                       BIG)
    top_vals, top_ids = _topk_smallest(vals, k)
    stats = SearchStats(nodes_evaluated, cand_after_bounds, evaluated,
                        1.0 - evaluated / max(int(valid.sum()), 1))
    return top_vals, top_ids, stats


# ---------------------------------------------------------------------------
# ApproHaus (Lemma 1)
# ---------------------------------------------------------------------------

#: elements of the largest (queries, slots, q nodes, d nodes) distance block
#: the frontier scorer materialises at once
SCORE_BLOCK = 1 << 26


def _level_arrays(idx: DatasetIndex, level: int):
    sl = idx.level_slice(level)
    return idx.centers[..., sl, :], idx.radii[..., sl], idx.counts[..., sl]


def _levels_ok(radii, counts, depth: int, eps) -> torch.Tensor:
    """(..., depth + 1) bool: does level l meet Lemma 1's stopping rule
    (every live node radius < eps)?  Reduces over the node axis only."""
    oks = []
    for level in range(depth + 1):
        sl = slice((1 << level) - 1, (1 << (level + 1)) - 1)
        r = torch.where(counts[..., sl] > 0, radii[..., sl], 0.0)
        oks.append(torch.all(r < eps, dim=-1))
    return torch.stack(oks, dim=-1)


def _level_for_eps(oks: torch.Tensor, depth: int) -> torch.Tensor:
    """The first level that meets the stopping rule, else the leaf level,
    on the device: (...) int64 from the (..., depth + 1) ``_levels_ok``."""
    first = torch.argmax(oks.to(torch.uint8), dim=-1)
    return torch.where(oks.any(dim=-1), first, depth)


def approx_level(idx: DatasetIndex, eps: float) -> int:
    """Smallest level where every live node radius < eps, over every tree
    of ``idx`` (the leaf level if none): one host read."""
    oks = _levels_ok(idx.radii, idx.counts, idx.depth, eps)
    oks = oks.reshape(-1, idx.depth + 1).all(dim=0)
    return int(_level_for_eps(oks, idx.depth))


def frontier_scores(oq, q_ok, od, d_ok) -> torch.Tensor:
    """ApproHaus scores max_{i in q_ok} min_{j in d_ok} |oq_i - od_j| for B
    query frontiers oq (B, nq, W) / q_ok (B, nq) against S dataset
    frontiers od (S, nd, W) / d_ok (S, nd): (B, S) float32.

    Slots go in blocks, so that no distance block exceeds ``SCORE_BLOCK``
    elements; min and max are exact, so the blocking changes no bit."""
    B, nq = q_ok.shape
    S, nd = d_ok.shape
    step = max(1, SCORE_BLOCK // max(B * nq * nd, 1))
    out = []
    for s0 in range(0, S, step):
        cdm = geometry.pairwise_dist_exact(oq[:, None], od[None, s0:s0 + step])
        cdm = torch.where(d_ok[None, s0:s0 + step, None, :], cdm, BIG)
        row = torch.amin(cdm, dim=-1)
        out.append(torch.amax(torch.where(q_ok[:, None, :], row, -BIG),
                              dim=-1))
    return torch.cat(out, dim=1)


def topk_hausdorff_approx(repo: Repository, q_idx: DatasetIndex, k: int,
                          eps: float):
    """ApproHaus (Lemma 1): top-k with error <= 2 eps, by center distances
    at the first level of both trees where every node radius < eps.
    Returns (vals (k,), ids (k,), (lq, ld, eps_eff)); eps_eff is the
    guarantee actually met when a tree bottoms out first."""
    lq = approx_level(q_idx, eps)
    ld = approx_level(repo.ds_index, eps)
    oq, rq, cq = _level_arrays(q_idx, lq)
    od, rd, cd = _level_arrays(repo.ds_index, ld)
    vals = frontier_scores(oq[None], (cq > 0)[None], od, cd > 0)[0]
    vals = torch.where(repo.ds_valid, vals, BIG)
    top_vals, top_ids = _topk_smallest(vals, k)
    r_q = float(torch.amax(torch.where(cq > 0, rq, 0.0)))
    r_d = float(torch.amax(torch.where(cd > 0, rd, 0.0)))
    return top_vals, top_ids, (lq, ld, max(eps, r_q, r_d))

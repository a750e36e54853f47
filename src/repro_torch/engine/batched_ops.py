"""Batched (multi-query) forms of the search ops: the engine's hot paths.

Counterpart of ``repro.engine.batched_ops``.
Each function answers B queries in one dispatch; JAX's ``vmap`` over a
leading query axis is a batch axis written out.  Results are elementwise
those of the single-query ops in ``core``.  Query batches arrive padded to a
shape bucket by the QueryEngine; rows past the caller's batch are padding
and are sliced off by the engine.
"""
from __future__ import annotations

import torch

from repro_torch.core import geometry, join_search, point_search, search
from repro_torch.core.index import DatasetIndex
from repro_torch.core.repo_index import Repository
from repro_torch.kernels import ops
from repro_torch.kernels.ref import BIG

# ---------------------------------------------------------------------------
# dataset granularity
# ---------------------------------------------------------------------------


def range_search_batched(repo: Repository, r_lo, r_hi):
    """RangeS for B query boxes: (masks (B, B_pad), live_nodes (B,))."""
    masks, live, _ = search._range_search_core(repo, r_lo, r_hi)
    return masks, live


def topk_ia_batched(repo: Repository, q_lo, q_hi, k: int):
    """Top-k IA for B query boxes: one dense (B, B_pad) box-algebra pass
    and a row-wise top-k.  Returns (vals (B, k), ids (B, k))."""
    _, _, lo, hi = repo.roots()
    ia = geometry.intersect_area(lo[None], hi[None], q_lo[:, None],
                                 q_hi[:, None])
    ia = torch.where(repo.ds_valid[None, :], ia, -1.0)
    vals, ids = search._topk_largest(ia, k)
    return vals, torch.where(vals < 0, -1, ids)


def topk_gbo_batched(repo: Repository, q_sigs, k: int):
    """Top-k GBO for B query signatures (B, W) of int64 words: one
    popcount(AND) matrix launch.  Returns (vals (B, k), ids (B, k))."""
    counts = ops.set_intersect_counts(q_sigs, repo.ds_sigs)   # (B, B_pad)
    counts = torch.where(repo.ds_valid[None, :], counts, -1)
    vals, ids = search._topk_largest(counts, k)
    return vals, torch.where(vals < 0, -1, ids)


def topk_join_batched(repo: Repository, q_pts, q_val, k: int, mode: str,
                      chunk: int):
    """Joinable top-k (grid overlap or coverage) for B raw query point sets
    (B, n, d) / (B, n): the coarse-signature bound phase, then the
    shared-order chunked exact refine (``core.join_search``).  Returns
    (vals (B, k), ids (B, k), nodes (B,), cand_after (B,), evaluated (B,))
    with -1 sentinels past the valid or unpruned supply."""
    exact, nodes, cand, evaluated = join_search.topk_join_scores(
        repo, q_pts, q_val, k, mode, chunk)
    vals, ids = search._topk_largest(exact, k)
    return vals, torch.where(vals < 0, -1, ids), nodes, cand, evaluated


# ---------------------------------------------------------------------------
# ApproHaus, batched with per-query stopping levels
# ---------------------------------------------------------------------------


def _gather_frontier(centers, radii, counts, level, n: int):
    """Each row's level-``level[b]`` node frontier, gathered into a fixed
    (B, n) buffer with an in-frontier mask, n >= 2**max(level).  Node
    (l, j) lives at flat slot 2**l - 1 + j."""
    width = torch.ones_like(level) << level                    # (B,)
    j = torch.arange(n, device=level.device)
    node = torch.clamp_max((width - 1)[:, None] + j, centers.shape[-2] - 1)
    idx_c = node[..., None].expand(-1, -1, centers.shape[-1])
    return (torch.gather(centers, 1, idx_c), torch.gather(radii, 1, node),
            torch.gather(counts, 1, node), j < width[:, None])


def topk_hausdorff_approx_batched(repo: Repository, q_batch: DatasetIndex,
                                  k: int, eps):
    """ApproHaus (Lemma 1) for a (B, ...) batch of query indexes.

    The dataset side stops at one level for every slot, as in the
    single-query op; each query stops at its own level.  The levels are
    chosen on the device and read back in one host read, so that the query
    frontiers are gathered only as wide as the deepest chosen level and the
    dataset frontier is sliced at its level: the distance blocks stay
    (B, slots, 2**lq, 2**ld) instead of the (B, slots, n_leaves, n_leaves)
    of fixed-width buffers.  Returns (vals (B, k), ids (B, k),
    eps_eff (B,))."""
    dq, dd = q_batch.depth, repo.ds_index.depth
    ds_ok = search._levels_ok(repo.ds_index.radii, repo.ds_index.counts,
                              dd, eps).all(dim=0)
    q_oks = search._levels_ok(q_batch.radii, q_batch.counts, dq, eps)
    lq = search._level_for_eps(q_oks, dq)                      # (B,)
    ld_lq_max = torch.stack([search._level_for_eps(ds_ok, dd), lq.max()])
    ld, lq_max = ld_lq_max.tolist()                            # one read

    od, rd, cd = search._level_arrays(repo.ds_index, ld)
    d_ok = cd > 0
    r_d = torch.amax(torch.where(d_ok, rd, 0.0))
    oq, rq, cq, in_frontier = _gather_frontier(
        q_batch.centers, q_batch.radii, q_batch.counts, lq, 1 << lq_max)
    q_ok = (cq > 0) & in_frontier
    vals = search.frontier_scores(oq, q_ok, od, d_ok)
    vals = torch.where(repo.ds_valid[None, :], vals, BIG)
    top_vals, top_ids = search._topk_smallest(vals, k)
    r_q = torch.amax(torch.where(q_ok, rq, 0.0), dim=-1)
    eps_eff = torch.maximum(torch.tensor(eps, dtype=torch.float32,
                                         device=r_q.device),
                            torch.maximum(r_q, r_d))
    return top_vals, top_ids, eps_eff


# ---------------------------------------------------------------------------
# ExactHaus, batched branch-and-bound
# ---------------------------------------------------------------------------


def topk_hausdorff_batched(repo: Repository, q_batch: DatasetIndex, k: int,
                           refine_levels: int = 3, chunk: int = 32):
    """ExactHaus for a (B, ...) batch of query indexes: phases 0/1 for all B
    queries in one bound-grid launch, then one shared phase-2 loop.
    Per-query (vals, ids) are bitwise those of ``search.topk_hausdorff_host``
    and, with the same ``chunk``, so are the per-query counters.

    Returns (vals (B, k), ids (B, k), nodes (B,), cand_after (B,),
    evaluated (B,))."""
    return search._topk_hausdorff_device_batched(
        repo, q_batch, k=k, refine_levels=refine_levels, chunk=chunk)


# ---------------------------------------------------------------------------
# point granularity
# ---------------------------------------------------------------------------


def _select_datasets(repo: Repository, ds_ids) -> DatasetIndex:
    """One bottom-level tree per request (requests in a batch may target
    different datasets)."""
    return DatasetIndex(*[x[ds_ids] for x in repo.ds_index])


def range_points_batched(repo: Repository, ds_ids, r_lo, r_hi):
    """RangeP for B (dataset id, box) requests:
    (take (B, n_pad), scanned (B, n_leaves))."""
    return point_search.range_points_core(_select_datasets(repo, ds_ids),
                                          r_lo, r_hi)


def nnp_pruned_batched(repo: Repository, ds_ids, q_batch: DatasetIndex):
    """Tree-pruned NNP for B (query index, dataset id) requests.
    Returns (dists (B, nq), idx (B, nq), pair_live (B, q leaves,
    d leaves))."""
    return point_search.nnp_pruned_core(q_batch,
                                        _select_datasets(repo, ds_ids))

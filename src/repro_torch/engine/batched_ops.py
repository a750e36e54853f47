"""Batched (multi-query) forms of the search ops: the engine's hot paths.

Counterpart of ``repro.engine.batched_ops``; ExactHaus only so far.  Query
batches arrive padded to a shape bucket by the QueryEngine; rows past the
caller's batch are padding and are sliced off by the engine.
"""
from __future__ import annotations

from repro_torch.core import search
from repro_torch.core.index import DatasetIndex
from repro_torch.core.repo_index import Repository


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

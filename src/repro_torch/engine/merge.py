"""O(k) result merges for the sharded engine.

Counterpart of ``repro.engine.merge``.  When the repository's dataset
slots are split over shards, every dataset-granularity top-k op scores
each shard's slots and merges the per-shard candidate lists into the
global top-k: each shard keeps min(k, shard slots) candidates, so the
gather is O(k) per shard whatever the repository size.

Exactness: per-shard lists taken by a stable descending sort over
contiguous ascending global-id ranges, concatenated in shard order and
merged by one more stable sort, equal a stable sort of the whole score
vector, ties included: equal values keep their order, and the (shard,
local rank) order of equal values is ascending global id.  ``torch.topk``
gives no such guarantee, so the port never uses it for a top-k.

``merge_topk`` / ``local_topk`` / ``sentinel_ids`` act on one tensor;
``all_gather_topk`` / ``shard_topk`` take per-shard lists
(``core.distributed``).
"""
from __future__ import annotations

import torch

from repro_torch.core.distributed import all_gather
from repro_torch.core.search import _topk_largest


def merge_topk(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Global top-k of per-shard descending lists laid out in shard order
    along the last axis (..., M), M >= k: (vals (..., k), ids (..., k))."""
    top, pos = _topk_largest(vals, k)
    return top, torch.gather(ids, -1, pos)


def local_topk(scores: torch.Tensor, k: int, base: int):
    """One shard's candidate list: its top-min(k, shard) scores and their
    global ids (``base`` is the shard's first global slot id)."""
    vals, ids = _topk_largest(scores, min(k, scores.shape[-1]))
    return vals, ids + base


def sentinel_ids(vals: torch.Tensor, ids: torch.Tensor,
                 sentinel: int = -1) -> torch.Tensor:
    """Ids of negative-scored (padded or invalid) slots become
    ``sentinel``; it depends only on the value riding with each id, so it
    commutes with the merge."""
    return torch.where(vals < 0, sentinel, ids)


def all_gather_topk(vals, gids, k: int):
    """The O(k) merge of per-shard (vals, global ids) lists (..., k'):
    gathered in shard order on the first shard's device, then one more
    stable top-k."""
    return merge_topk(all_gather(vals), all_gather(gids), k)


def shard_topk(scores, k: int):
    """Sharded top-k over per-shard (..., shard_slots) score slices of one
    extent: local top-k with global ids, then the O(k) merge."""
    lists = [local_topk(s, k, i * s.shape[-1]) for i, s in enumerate(scores)]
    return all_gather_topk([v for v, _ in lists], [g for _, g in lists], k)

"""QueryEngine: the batched multi-query execution engine.

Counterpart of ``repro.engine.engine`` for one device.  The engine owns a
resident :class:`Repository` (on the card, or on the CPU when it was built
with ``device="cpu"``) and answers declarative batches through
:meth:`QueryEngine.search`:

  * **shape bucketing** — a dispatch of B queries is padded, by replicating
    its first row, up to the smallest bucket >= B; the padding rows are
    sliced off;
  * **result cache** — an LRU keyed by (op, statics, query content digest);
    repeated rows short-circuit before bucketing, duplicate rows inside one
    batch ride their twin's dispatch, and both are booked as result-cache
    hits (``result_cache_size=0`` turns it off);
  * **one dispatch per group** — each (op, statics, query shape) group of a
    batch runs as one batched call; ExactHaus answers B queries with one
    bound-grid launch and one shared phase-2 loop.

The JAX engine also keeps an executable cache, one compiled program per
(op, bucket, k) key.  Eager PyTorch compiles nothing, so there is nothing
to cache and that part is not ported; ``EngineStats`` keeps the query,
dispatch and result-cache counters.  The sharded and replicated
dispatchers, the live repository and every op but ``topk_hausdorff`` are
later slices: ``search`` raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import index as index_lib
from repro_torch.core import search
from repro_torch.core.build import pad_batch
from repro_torch.core.index import DatasetIndex
from repro_torch.core.repo_index import Repository
from repro_torch.engine import batched_ops
from repro_torch.engine import plan as plan_lib

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
DEFAULT_RESULT_CACHE = 256
#: ExactHaus phase-2 chunk for queries that leave ``chunk`` unset
DEFAULT_CHUNK = 32


def _digest(*parts) -> bytes:
    """Content digest of query-side payload arrays (result-cache key)."""
    h = hashlib.blake2b(digest_size=16)
    for p in parts:
        a = np.asarray(p)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.digest()


def _take_tree_rows(tree: DatasetIndex, sel) -> DatasetIndex:
    if sel is None:
        return tree
    idx = torch.as_tensor(sel, device=tree.points.device)
    return DatasetIndex(*[x[idx] for x in tree])


@dataclass
class EngineStats:
    """Cumulative engine counters.

    ``queries`` counts answered client queries (cache hits included) and
    ``dispatches`` batched device dispatches (query-index builds included,
    booked as ``internal``).  ``result_cache_hits`` counts rows answered
    from the LRU or by an in-batch twin, ``result_cache_misses`` rows that
    went through a dispatch.  ``per_op`` keeps the breakdown per op, with
    the summed ExactHaus counters of :meth:`record_search`."""
    queries: int = 0
    dispatches: int = 0
    padded_queries: int = 0          # bucket padding rows actually computed
    result_cache_hits: int = 0
    result_cache_misses: int = 0
    plan_groups: int = 0             # dispatch groups formed by search()
    per_op: dict = field(default_factory=dict)

    def _per(self, op: str) -> dict:
        return self.per_op.setdefault(op, {"queries": 0, "dispatches": 0})

    def count(self, op: str, batch: int, bucket: int, *,
              internal: bool = False) -> None:
        """Record one dispatch of ``batch`` rows padded to ``bucket``.
        ``internal`` dispatches (query-index builds) do not count as
        answered queries."""
        if not internal:
            self.queries += batch
            self.padded_queries += bucket - batch
        self.dispatches += 1
        per = self._per(op)
        per["queries"] += batch
        per["dispatches"] += 1

    def count_result_cache(self, op: str, hits: int, misses: int) -> None:
        """Record one result-cache pass: ``hits`` rows served without a
        dispatch (they count as answered queries here), ``misses`` rows that
        go on to dispatch (counted by :meth:`count`)."""
        self.result_cache_hits += hits
        self.result_cache_misses += misses
        self.queries += hits
        per = self._per(op)
        per["queries"] += hits
        per["result_hits"] = per.get("result_hits", 0) + hits
        per["result_misses"] = per.get("result_misses", 0) + misses

    def record_search(self, op: str, stats: list) -> None:
        """Fold one dispatch's per-query SearchStats into ``per_op[op]``:
        summed counters, the dispatch's mean pruned fraction."""
        if not stats:
            return
        per = self._per(op)
        for name in ("nodes_evaluated", "candidates_after_bounds",
                     "exact_evaluations"):
            per[name] = per.get(name, 0) + sum(getattr(s, name)
                                               for s in stats)
        per["pruned_fraction"] = (sum(s.pruned_fraction for s in stats)
                                  / len(stats))


class LocalDispatcher:
    """Single-device dispatch over the resident repository."""

    def __init__(self, repo: Repository):
        self.repo = repo

    def topk_hausdorff(self, q_batch: DatasetIndex, *, k: int,
                       refine_levels: int, chunk: int):
        return batched_ops.topk_hausdorff_batched(
            self.repo, q_batch, k=k, refine_levels=refine_levels, chunk=chunk)


class QueryEngine:
    """Batched search over a resident repository (see module docstring).
    The engine runs on the device its repository lives on."""

    def __init__(self, repo: Repository, *, leaf_capacity: int = 16,
                 result_cache_size: int = DEFAULT_RESULT_CACHE):
        self.buckets = DEFAULT_BUCKETS
        self.leaf_capacity = leaf_capacity
        self.stats = EngineStats()
        self.result_cache_size = result_cache_size
        self._result_cache: OrderedDict = OrderedDict()
        self._n_valid = int(repo.ds_valid.sum())
        self.dispatch = LocalDispatcher(repo)
        self.repo = repo

    @property
    def device(self) -> torch.device:
        return self.repo.device

    # -- bucketing ---------------------------------------------------------

    def bucket_for(self, batch: int) -> int:
        for b in self.buckets:
            if b >= batch:
                return b
        b = self.buckets[-1]
        while b < batch:          # beyond the ladder: grow geometrically
            b *= 2
        return b

    @staticmethod
    def _pad_rows(x: torch.Tensor, bucket: int) -> torch.Tensor:
        """Pad a (B, ...) tensor to (bucket, ...) by replicating row 0:
        padding rows recompute a real query, so nothing needs masking."""
        b = x.shape[0]
        if b == bucket:
            return x
        reps = x[:1].expand((bucket - b,) + tuple(x.shape[1:]))
        return torch.cat([x, reps], dim=0)

    def _pad_tree(self, tree: DatasetIndex, bucket: int) -> DatasetIndex:
        return DatasetIndex(*[self._pad_rows(x, bucket) for x in tree])

    # -- result cache ------------------------------------------------------

    def _cache_insert(self, keys, rows) -> None:
        for key, row in zip(keys, rows):
            self._result_cache[key] = row           # inserts at MRU end
        while len(self._result_cache) > self.result_cache_size:
            self._result_cache.popitem(last=False)

    def _serve_cached(self, op: str, keys, dispatch, split, join):
        """Serve per-row results through the LRU.

        ``dispatch(sel)`` runs the op for row positions ``sel`` (all rows
        when None) as one batch; ``split`` cuts its output into per-row
        entries and ``join`` puts rows back together.  Only distinct miss
        rows are dispatched; a cold batch of distinct rows returns the
        dispatch output unchanged."""
        out_rows = [None] * len(keys)
        miss: list = []
        hits = 0
        for i, key in enumerate(keys):
            row = self._result_cache.get(key)
            if row is None:
                miss.append(i)
            else:
                self._result_cache.move_to_end(key)
                out_rows[i] = row
                hits += 1
        uniq_pos: dict = {}            # key -> row index in the sub-batch
        uniq: list = []
        for i in miss:
            if keys[i] not in uniq_pos:
                uniq_pos[keys[i]] = len(uniq)
                uniq.append(i)
        self.stats.count_result_cache(
            op, hits + (len(miss) - len(uniq)), len(uniq))
        if not hits and len(uniq) == len(keys):    # all-distinct cold batch
            raw = dispatch(None)
            self._cache_insert(keys, split(raw))
            return raw
        if uniq:
            rows = split(dispatch(uniq))
            self._cache_insert([keys[i] for i in uniq], rows)
            for i in miss:
                out_rows[i] = rows[uniq_pos[keys[i]]]
        return join(out_rows)

    # -- query construction ------------------------------------------------

    def build_queries(self, pointsets: Sequence[np.ndarray]) -> DatasetIndex:
        """Index a ragged list of query point sets as one (B, ...) batch:
        point counts are padded to the next power-of-two multiple of the
        leaf capacity and the B trees are built in one batched build."""
        n_max = max(int(p.shape[0]) for p in pointsets)
        n_bucket = self.leaf_capacity
        while n_bucket < n_max:
            n_bucket *= 2
        depth = index_lib.depth_for(n_bucket, self.leaf_capacity)
        pts, val, depth = pad_batch(pointsets, self.leaf_capacity, depth,
                                    device=self.device)
        q_batch = index_lib.build_index_batch(pts, val, depth)
        self.stats.count("build_queries", len(pointsets), len(pointsets),
                         internal=True)
        return q_batch

    # -- declarative entry point ------------------------------------------

    def search(self, queries: Sequence) -> list:
        """Answer a declarative batch of :class:`Query` rows; one
        :class:`SearchResult` per input, in input order.  Ops and Pipelines
        that are not ported raise ``NotImplementedError`` before anything
        runs."""
        return plan_lib.execute(self, queries)

    # -- ExactHaus executor ------------------------------------------------

    def _exec_topk_hausdorff(self, q_batch: DatasetIndex, k: int,
                             refine_levels: int = 3,
                             chunk: int | None = None):
        """ExactHaus for a (B, ...) query-index batch -> (vals (B, k),
        ids (B, k), list[SearchStats]).  ``chunk=None`` means
        ``DEFAULT_CHUNK``; chunk never changes vals or ids."""
        if chunk is None:
            chunk = DEFAULT_CHUNK
        if not self.result_cache_size:
            return self._topk_hausdorff_dispatch(q_batch, k, refine_levels,
                                                 chunk)
        pts = q_batch.points.cpu().numpy()
        val = q_batch.valid.cpu().numpy()
        # the depth is in the key: another tree over the same points
        # changes the SearchStats
        keys = [("exact_haus", k, refine_levels, chunk, q_batch.depth,
                 _digest(pts[i], val[i])) for i in range(pts.shape[0])]
        return self._serve_cached(
            "topk_hausdorff", keys,
            lambda sel: self._topk_hausdorff_dispatch(
                _take_tree_rows(q_batch, sel), k, refine_levels, chunk),
            split=lambda raw: [(raw[0][i], raw[1][i], raw[2][i])
                               for i in range(len(raw[2]))],
            join=lambda rows: (torch.stack([r[0] for r in rows]),
                               torch.stack([r[1] for r in rows]),
                               [r[2] for r in rows]))

    def _topk_hausdorff_dispatch(self, q_batch: DatasetIndex, k: int,
                                 refine_levels: int, chunk: int):
        """One batched ExactHaus dispatch plus per-query SearchStats."""
        B = q_batch.points.shape[0]
        bucket = self.bucket_for(B)
        vals, ids, nodes, cand_after, evaluated = self.dispatch.topk_hausdorff(
            self._pad_tree(q_batch, bucket), k=k, refine_levels=refine_levels,
            chunk=chunk)
        self.stats.count("topk_hausdorff", B, bucket)
        counters = torch.stack([nodes[:B], cand_after[:B], evaluated[:B]])
        nodes, cand_after, evaluated = counters.cpu().numpy().tolist()
        stats = [
            search.SearchStats(nodes[i], cand_after[i], evaluated[i],
                               1.0 - evaluated[i] / max(self._n_valid, 1))
            for i in range(B)
        ]
        self.stats.record_search("topk_hausdorff", stats)
        return vals[:B], ids[:B], stats

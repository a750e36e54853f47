"""QueryEngine: the batched multi-query execution engine.

Counterpart of ``repro.engine.engine``.  The engine owns a
resident :class:`Repository` (on the card, or on the CPU when it was built
with ``device="cpu"``) and answers declarative batches through
:meth:`QueryEngine.search`:

  * **shape bucketing** — a dispatch of B queries is padded, by replicating
    its first row, up to the smallest bucket >= B; the padding rows are
    sliced off;
  * **result cache** — an LRU keyed as in the JAX package (op, data epoch,
    statics, query content digest; point ops by target slot and its
    epoch); repeated rows short-circuit before bucketing, duplicate rows
    inside one batch ride their twin's dispatch, and both are booked as
    result-cache hits (``result_cache_size=0`` turns it off).  A
    :class:`~repro_torch.engine.live.LiveRepository` moves the epochs
    (:meth:`QueryEngine.set_repo_epoch`), which purges the retired rows;
  * **one dispatch per group** — each (op, statics, query shape) group of a
    batch runs as one batched call through the dispatcher.

``default_chunk`` is the refine chunk of ExactHaus queries that leave
``chunk`` unset and of the joinable ops; chunk never changes a result.
The JAX engine also keeps an executable cache, one compiled program per
(op, bucket, k) key.  Eager PyTorch compiles nothing, so there is nothing
to cache and that part is not ported; ``EngineStats`` keeps the query,
dispatch, result-cache, planner and publish counters.  The dispatcher's
layout epoch (``LocalDispatcher.repo_epoch``, bumped by a live tier
growth) keys no cache here; it is kept so that growth reads the same
values as in the JAX package.

``QueryEngine(repo, mesh=...)`` selects the dispatcher: without a mesh the
:class:`LocalDispatcher`; a 2-D (replica, data) mesh
(``core.distributed.Mesh``) the replica-parallel one
(:mod:`repro_torch.engine.replicated`), a 1-D data mesh the data-sharded
one (:mod:`repro_torch.engine.sharded`).  Every layer above the dispatcher is
shared, and the results are bitwise the local engine's.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import index as index_lib
from repro_torch.core import join_search, point_search, search
from repro_torch.core.build import pad_batch
from repro_torch.core.index import DatasetIndex
from repro_torch.core.repo_index import Repository
from repro_torch.engine import batched_ops
from repro_torch.engine import plan as plan_lib

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
DEFAULT_RESULT_CACHE = 256


def _digest(*parts) -> bytes:
    """Content digest of query-side payload arrays (result-cache key)."""
    h = hashlib.blake2b(digest_size=16)
    for p in parts:
        a = np.asarray(p)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.digest()


def _take_rows(x, sel):
    """Row subset for a miss sub-batch (``sel`` None: all rows)."""
    if sel is None:
        return x
    return x[torch.as_tensor(sel, device=x.device)]


def _take_tree_rows(tree: DatasetIndex, sel) -> DatasetIndex:
    if sel is None:
        return tree
    return DatasetIndex(*[_take_rows(x, sel) for x in tree])


def _split_rows(raw):
    """Per-row entries of a dispatch output, a tuple of (B, ...) tensors
    and per-row stats lists (device slices: splitting for the cache never
    syncs)."""
    return [tuple(a[i] for a in raw) for i in range(len(raw[0]))]


def _join_rows(rows):
    """Rows back into a dispatch output: tensors stacked, stats listed."""
    return tuple(torch.stack(c) if isinstance(c[0], torch.Tensor)
                 else list(c) for c in zip(*rows))


@dataclass
class EngineStats:
    """Cumulative engine counters.

    ``queries`` counts answered client queries (cache hits included) and
    ``dispatches`` batched device dispatches (query-index builds included,
    booked as ``internal``).  ``result_cache_hits`` counts rows answered
    from the LRU or by an in-batch twin, ``result_cache_misses`` rows that
    went through a dispatch.  ``per_op`` keeps the breakdown per op, with
    the summed search counters of :meth:`record_search` and
    :meth:`record_point_search`.

    The planner books its own counters (:meth:`count_group`):
    ``plan_groups`` and ``group_counts[op]`` count the dispatch groups a
    ``search()`` call formed (op groups and pipeline stage-2 groups alike),
    ``pipeline_stage1`` / ``pipeline_stage2`` the pipelines whose stage ran,
    and :meth:`record_latency` each group's wall time.  Under a replicated
    dispatcher a group's rows span up to R replica row-blocks:
    ``replica_subgroups`` and ``group_counts[op]`` count those, so
    ``plan_groups <= replica_subgroups``, equal off a replica mesh.

    Under a live repository, rows cached at a retired epoch are purged on
    every epoch install and counted in ``epoch_invalidations``; a repeat
    of the same query then books a miss.  :meth:`record_publish` books
    each mutation publish."""
    queries: int = 0
    dispatches: int = 0
    padded_queries: int = 0          # bucket padding rows actually computed
    result_cache_hits: int = 0
    result_cache_misses: int = 0
    epoch_invalidations: int = 0     # result rows retired by a repo epoch
    mutations_coalesced: int = 0     # mutations that shared another's publish
    prepare_overlap_seconds: float = 0.0   # prepare host time under serving
    publish_seconds: list = field(default_factory=list)  # per-publish wall s
    plan_groups: int = 0             # dispatch groups formed by search()
    replica_subgroups: int = 0       # replica row-blocks those groups spanned
    pipeline_stage1: int = 0         # pipelines whose dataset stage ran
    pipeline_stage2: int = 0         # pipelines whose point stage ran
    group_counts: dict = field(default_factory=dict)   # op -> groups
    per_op: dict = field(default_factory=dict)
    latency_ewma: dict = field(default_factory=dict)   # op -> EWMA seconds
    op_seconds: dict = field(default_factory=dict)     # op -> total seconds

    #: EWMA smoothing of the per-op group latency
    EWMA_ALPHA = 0.2

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

    def record_publish(self, seconds: float, coalesced: int = 0) -> None:
        """Book one mutation publish (the slot write, the upper-tree
        rebuild and the swap of a group of prepared mutations): its wall
        time, and ``coalesced`` mutations beyond the first that shared it."""
        self.publish_seconds.append(seconds)
        self.mutations_coalesced += coalesced

    def publish_percentile_ms(self, p: float, since: int = 0) -> float:
        """p-th percentile of per-publish wall time, in ms, over the
        publishes from index ``since`` on (0 if none)."""
        window = self.publish_seconds[since:]
        if not window:
            return 0.0
        return 1e3 * float(np.percentile(np.asarray(window), p))

    @property
    def publish_p50_ms(self) -> float:
        return self.publish_percentile_ms(50.0)

    @property
    def publish_p99_ms(self) -> float:
        return self.publish_percentile_ms(99.0)

    def record_latency(self, op: str, seconds: float) -> None:
        """Book one dispatch group's wall time: the sum ``op_seconds[op]``
        and an EWMA ``latency_ewma[op]`` (the first sample seeds it)."""
        self.op_seconds[op] = self.op_seconds.get(op, 0.0) + seconds
        prev = self.latency_ewma.get(op)
        self.latency_ewma[op] = (
            seconds if prev is None
            else prev + self.EWMA_ALPHA * (seconds - prev))

    def count_group(self, op: str, subgroups: int = 1) -> None:
        """Record one dispatch group formed by the planner (an op group, or
        a pipeline stage-2 group under its point op's name) spanning
        ``subgroups`` replica row-blocks (1 off a replica mesh)."""
        self.plan_groups += 1
        self.replica_subgroups += subgroups
        self.group_counts[op] = self.group_counts.get(op, 0) + subgroups

    def _fold_stats(self, op: str, stats: list, fields: tuple) -> None:
        """Fold one dispatch's per-query stats into ``per_op[op]``: the
        named counters summed, ``pruned_fraction`` the dispatch's mean."""
        if not stats:
            return
        per = self._per(op)
        for name in fields:
            per[name] = per.get(name, 0) + sum(getattr(s, name)
                                               for s in stats)
        per["pruned_fraction"] = (sum(s.pruned_fraction for s in stats)
                                  / len(stats))

    def record_point_search(self, op: str, stats: list) -> None:
        """Fold one point-op dispatch's PointStats into ``per_op[op]``."""
        self._fold_stats(op, stats, ("nodes_evaluated", "leaves_scanned"))

    def record_search(self, op: str, stats: list) -> None:
        """Fold one dispatch's SearchStats into ``per_op[op]``."""
        self._fold_stats(op, stats, ("nodes_evaluated",
                                     "candidates_after_bounds",
                                     "exact_evaluations"))


class LocalDispatcher:
    """Single-device dispatch over the resident repository.

    Each ``build_*`` returns a callable that takes only the query-side
    operands and reads ``self.repo`` when it is called, as the JAX
    package's late-bound builders do: a live publish swaps ``self.repo``
    and the next call reads the successor, while a call already running
    keeps the tensors it read.

    ``repo_epoch`` is the layout epoch, bumped by a live tier growth."""

    repo_epoch = 0

    def __init__(self, repo: Repository):
        self.repo = repo
        self.n_slots = repo.n_slots

    @property
    def device(self) -> torch.device:
        return self.repo.device

    def _bind(self, impl, **statics):
        def call(*args, **kw):
            return impl(self.repo, *args, **statics, **kw)

        return call

    def build_range_search(self):
        return self._bind(batched_ops.range_search_batched)

    def build_topk_ia(self, k: int):
        return self._bind(batched_ops.topk_ia_batched, k=k)

    def build_topk_gbo(self, k: int):
        return self._bind(batched_ops.topk_gbo_batched, k=k)

    def build_topk_hausdorff_approx(self, k: int):
        return self._bind(batched_ops.topk_hausdorff_approx_batched, k=k)

    def build_topk_hausdorff(self, k: int, refine_levels: int, chunk: int):
        return self._bind(batched_ops.topk_hausdorff_batched, k=k,
                          refine_levels=refine_levels, chunk=chunk)

    def build_range_points(self):
        return self._bind(batched_ops.range_points_batched)

    def build_nnp(self):
        return self._bind(batched_ops.nnp_pruned_batched)

    def build_topk_overlap(self, k: int, chunk: int):
        return self._bind(batched_ops.topk_join_batched, k=k,
                          mode="overlap", chunk=chunk)

    def build_topk_coverage(self, k: int, chunk: int):
        return self._bind(batched_ops.topk_join_batched, k=k,
                          mode="coverage", chunk=chunk)

    def build_join_rerank(self, mode: str):
        # dataset -> dataset pipeline stage 2: row-wise exact join score of
        # the stage-1 winner slots (gathered by id on the device) against
        # the query rows
        def impl(repo, ds_ids, q_pts, q_val):
            return join_search.pair_scores(
                repo, repo.ds_index.points[ds_ids],
                repo.ds_index.valid[ds_ids], q_pts, q_val, mode)

        return self._bind(impl)


class QueryEngine:
    """Batched search over a resident repository (see module docstring).

    The engine runs on the device its repository lives on or, given a
    ``mesh``, on the mesh's devices, taking queries and returning results
    on its lead device.  A sharded engine keeps no whole repository:
    ``repo`` is then None and the shards are ``dispatch.shards`` (or each
    replica group's, ``dispatch.groups[r].shards``)."""

    def __init__(self, repo: Repository, *, leaf_capacity: int = 16,
                 result_cache_size: int = DEFAULT_RESULT_CACHE,
                 default_chunk: int = 32, mesh=None):
        self.buckets = DEFAULT_BUCKETS
        self.leaf_capacity = leaf_capacity
        self.default_chunk = default_chunk
        self.stats = EngineStats()
        self.result_cache_size = result_cache_size
        self._result_cache: OrderedDict = OrderedDict()
        self._n_valid = int(repo.ds_valid.sum())
        if mesh is None:
            self.dispatch = LocalDispatcher(repo)
        elif len(mesh.axis_names) == 2:
            from repro_torch.engine.replicated import ReplicatedDispatcher
            self.dispatch = ReplicatedDispatcher(repo, mesh)
        else:
            from repro_torch.engine.sharded import ShardedDispatcher
            self.dispatch = ShardedDispatcher(repo, mesh)
        self.repo = getattr(self.dispatch, "repo", None)
        # the data epoch and the per-slot epoch table of the result-cache
        # keys; a live repository installs them (set_repo_epoch)
        self._repo_epoch = 0
        self._slot_epochs = None

    # -- repository epochs (live mutations) -------------------------------

    @property
    def repo_epoch(self) -> int:
        """The data epoch of the resident repository (0 on a frozen
        engine; bumped by every live publish)."""
        return self._repo_epoch

    def slot_epoch(self, ds_id) -> int:
        """Mutation epoch of dataset slot ``ds_id`` (0 on a frozen engine):
        the component point-op keys carry, so rows cached for untouched
        datasets survive mutations elsewhere."""
        se = self._slot_epochs
        return 0 if se is None else int(se[int(ds_id)])

    def set_repo_epoch(self, epoch: int, slot_epochs=None,
                       touched=None) -> None:
        """Install a new repository epoch after a live publish.

        ``epoch`` must not decrease; ``slot_epochs`` (an int array indexed
        by slot) replaces the per-slot table.  Result rows keyed at a
        retired epoch are purged now and counted in
        ``stats.epoch_invalidations``.  ``touched``, the slots this publish
        wrote, makes the sweep precise: point-op rows of other slots are
        not even inspected.  Dataset-op rows retire on any data-epoch move,
        since any slot write can change a whole-repository answer."""
        if epoch < self._repo_epoch:
            raise ValueError(
                f"repository epoch must be monotone: {epoch} < "
                f"{self._repo_epoch}")
        self._repo_epoch = int(epoch)
        if slot_epochs is not None:
            self._slot_epochs = slot_epochs
        stale = []
        for key in list(self._result_cache):
            if key[0] in ("range_points", "nnp"):
                # (op, ds_id, slot_epoch, ...)
                if touched is not None and key[1] not in touched:
                    continue
                if key[2] != self.slot_epoch(key[1]):
                    stale.append(key)
            elif key[1] != self._repo_epoch:
                # (op, repo_epoch, ...)
                stale.append(key)
        for key in stale:
            self._result_cache.pop(key, None)
        self.stats.epoch_invalidations += len(stale)

    @property
    def device(self) -> torch.device:
        return self.dispatch.device

    # -- bucketing ---------------------------------------------------------

    def bucket_for(self, batch: int) -> int:
        for b in self.buckets:
            if b >= batch:
                return b
        b = self.buckets[-1]
        while b < batch:          # beyond the ladder: grow geometrically
            b *= 2
        return b

    def _plan_subgroups(self, batch: int) -> int:
        """Replica row-blocks a ``batch``-row dispatch group spans under
        this engine's dispatcher (1 unless it splits rows over replica
        groups): what the planner books through ``count_group``."""
        f = getattr(self.dispatch, "row_subgroups", None)
        return 1 if f is None else f(batch, self.bucket_for(batch))

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

    # -- per-op group executors (one batched dispatch path each) ----------

    def _upload(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _exec_range_search(self, r_lo, r_hi):
        """RangeS for B query boxes (host (B, d) rows) -> masks
        (B, B_pad)."""
        lo_np = np.atleast_2d(np.asarray(r_lo, np.float32))
        hi_np = np.atleast_2d(np.asarray(r_hi, np.float32))
        lo, hi = self._upload(lo_np, torch.float32), self._upload(
            hi_np, torch.float32)
        if not self.result_cache_size:
            return self._range_search_dispatch(lo, hi)
        keys = [("range_search", self._repo_epoch,
                 _digest(lo_np[i], hi_np[i])) for i in range(lo_np.shape[0])]
        return self._serve_cached(
            "range_search", keys,
            lambda sel: self._range_search_dispatch(_take_rows(lo, sel),
                                                    _take_rows(hi, sel)),
            split=list, join=torch.stack)

    def _range_search_dispatch(self, r_lo, r_hi):
        B = r_lo.shape[0]
        bucket = self.bucket_for(B)
        masks, _ = self.dispatch.build_range_search()(
            self._pad_rows(r_lo, bucket), self._pad_rows(r_hi, bucket))
        self.stats.count("range_search", B, bucket)
        return masks[:B]

    def _exec_topk_ia(self, q_lo, q_hi, k: int):
        """Top-k IA for B query boxes -> (vals, ids), each (B, k)."""
        lo_np = np.atleast_2d(np.asarray(q_lo, np.float32))
        hi_np = np.atleast_2d(np.asarray(q_hi, np.float32))
        lo, hi = self._upload(lo_np, torch.float32), self._upload(
            hi_np, torch.float32)
        if not self.result_cache_size:
            return self._topk_ia_dispatch(lo, hi, k)
        keys = [("topk_ia", self._repo_epoch, k, _digest(lo_np[i], hi_np[i]))
                for i in range(lo_np.shape[0])]
        return self._serve_cached(
            "topk_ia", keys,
            lambda sel: self._topk_ia_dispatch(_take_rows(lo, sel),
                                               _take_rows(hi, sel), k),
            split=_split_rows, join=_join_rows)

    def _topk_ia_dispatch(self, q_lo, q_hi, k: int):
        B = q_lo.shape[0]
        bucket = self.bucket_for(B)
        vals, ids = self.dispatch.build_topk_ia(k)(
            self._pad_rows(q_lo, bucket), self._pad_rows(q_hi, bucket))
        self.stats.count("topk_ia", B, bucket)
        return vals[:B], ids[:B]

    def _exec_topk_gbo(self, q_sigs, k: int):
        """Top-k GBO for B query signatures -> (vals, ids), each (B, k).
        The uint32 words become int64 words here, once."""
        sigs_np = np.asarray(q_sigs)
        if sigs_np.ndim == 1:
            sigs_np = sigs_np[None, :]
        sigs = self._upload(sigs_np.astype(np.int64), torch.int64)
        if not self.result_cache_size:
            return self._topk_gbo_dispatch(sigs, k)
        keys = [("topk_gbo", self._repo_epoch, k, _digest(sigs_np[i]))
                for i in range(sigs_np.shape[0])]
        return self._serve_cached(
            "topk_gbo", keys,
            lambda sel: self._topk_gbo_dispatch(_take_rows(sigs, sel), k),
            split=_split_rows, join=_join_rows)

    def _topk_gbo_dispatch(self, q_sigs, k: int):
        B = q_sigs.shape[0]
        bucket = self.bucket_for(B)
        vals, ids = self.dispatch.build_topk_gbo(k)(
            self._pad_rows(q_sigs, bucket))
        self.stats.count("topk_gbo", B, bucket)
        return vals[:B], ids[:B]

    def _exec_topk_hausdorff_approx(self, q_batch: DatasetIndex, k: int,
                                    eps):
        """ApproHaus for a (B, ...) query-index batch -> (vals, ids,
        eps_eff)."""
        if not self.result_cache_size:
            return self._topk_hausdorff_approx_dispatch(q_batch, k, eps)
        pts = q_batch.points.cpu().numpy()
        val = q_batch.valid.cpu().numpy()
        keys = [("approx_haus", self._repo_epoch, k, float(eps),
                 q_batch.depth, _digest(pts[i], val[i]))
                for i in range(pts.shape[0])]
        return self._serve_cached(
            "topk_hausdorff_approx", keys,
            lambda sel: self._topk_hausdorff_approx_dispatch(
                _take_tree_rows(q_batch, sel), k, eps),
            split=_split_rows, join=_join_rows)

    def _topk_hausdorff_approx_dispatch(self, q_batch: DatasetIndex, k: int,
                                        eps):
        B = q_batch.points.shape[0]
        bucket = self.bucket_for(B)
        vals, ids, eps_eff = self.dispatch.build_topk_hausdorff_approx(k)(
            self._pad_tree(q_batch, bucket), eps=float(eps))
        self.stats.count("topk_hausdorff_approx", B, bucket)
        return vals[:B], ids[:B], eps_eff[:B]

    def _exec_topk_hausdorff(self, q_batch: DatasetIndex, k: int,
                             refine_levels: int = 3,
                             chunk: int | None = None):
        """ExactHaus for a (B, ...) query-index batch -> (vals (B, k),
        ids (B, k), list[SearchStats]).  ``chunk=None`` means
        ``default_chunk``; chunk never changes vals or ids."""
        if chunk is None:
            chunk = self.default_chunk
        if not self.result_cache_size:
            return self._topk_hausdorff_dispatch(q_batch, k, refine_levels,
                                                 chunk)
        pts = q_batch.points.cpu().numpy()
        val = q_batch.valid.cpu().numpy()
        # the depth is in the key: another tree over the same points
        # changes the SearchStats
        keys = [("exact_haus", self._repo_epoch, k, refine_levels, chunk,
                 q_batch.depth, _digest(pts[i], val[i]))
                for i in range(pts.shape[0])]
        return self._serve_cached(
            "topk_hausdorff", keys,
            lambda sel: self._topk_hausdorff_dispatch(
                _take_tree_rows(q_batch, sel), k, refine_levels, chunk),
            split=_split_rows, join=_join_rows)

    def _topk_hausdorff_dispatch(self, q_batch: DatasetIndex, k: int,
                                 refine_levels: int, chunk: int):
        """One batched ExactHaus dispatch plus per-query SearchStats."""
        B = q_batch.points.shape[0]
        bucket = self.bucket_for(B)
        vals, ids, nodes, cand_after, evaluated = (
            self.dispatch.build_topk_hausdorff(k, refine_levels, chunk)(
                self._pad_tree(q_batch, bucket)))
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

    def _exec_topk_join(self, op: str, q_pts, q_val, k: int):
        """Joinable top-k (``topk_overlap`` / ``topk_coverage``) for B raw
        query point sets, host (B, n, d) points and (B, n) validity ->
        (vals (B, k), ids (B, k), list[SearchStats]).  Cache keys carry the
        data epoch: the bounds read the resident signatures and the refine
        the resident points."""
        pts_np = np.asarray(q_pts, np.float32)
        val_np = np.asarray(q_val, bool)
        pts = self._upload(pts_np, torch.float32)
        val = self._upload(val_np, torch.bool)
        if not self.result_cache_size:
            return self._topk_join_dispatch(op, pts, val, k)
        keys = [(op, self._repo_epoch, k, _digest(pts_np[i], val_np[i]))
                for i in range(pts_np.shape[0])]
        return self._serve_cached(
            op, keys,
            lambda sel: self._topk_join_dispatch(
                op, _take_rows(pts, sel), _take_rows(val, sel), k),
            split=_split_rows, join=_join_rows)

    def _topk_join_dispatch(self, op: str, q_pts, q_val, k: int):
        """One batched joinable dispatch plus per-query SearchStats."""
        B = q_pts.shape[0]
        bucket = self.bucket_for(B)
        build = getattr(self.dispatch, "build_" + op)
        vals, ids, nodes, cand_after, evaluated = build(
            k, self.default_chunk)(self._pad_rows(q_pts, bucket),
                                   self._pad_rows(q_val, bucket))
        self.stats.count(op, B, bucket)
        counters = torch.stack([nodes[:B], cand_after[:B], evaluated[:B]])
        nodes, cand_after, evaluated = counters.cpu().numpy()
        stats = join_search.join_stats_host(self._n_valid, evaluated, nodes,
                                            cand_after)
        self.stats.record_search(op, stats)
        return vals[:B], ids[:B], stats

    def _exec_join_rerank(self, op: str, ds_ids, q_pts, q_val):
        """Stage 2 of a dataset -> dataset pipeline: the exact join score
        of winner slot ``ds_ids[t]`` against query row t, (T,) int32 on
        the device.  The ids arrive on the device, so, as for the point
        stages, this path bypasses the result cache."""
        mode = "overlap" if op == "topk_overlap" else "coverage"
        T = ds_ids.shape[0]
        bucket = self.bucket_for(T)
        scores = self.dispatch.build_join_rerank(mode)(
            self._pad_rows(ds_ids, bucket), self._pad_rows(q_pts, bucket),
            self._pad_rows(q_val, bucket))
        # one row per stage-1 winner, as the point stages count them
        self.stats.count(op, T, bucket)
        return scores[:T]

    def _exec_range_points(self, ds_ids, r_lo, r_hi):
        """RangeP for B (dataset id, box) requests on the host ->
        (take masks (B, n_pad), list[PointStats]).  A pipeline's stage 2
        hands its winner ids over as a device tensor and calls
        :meth:`_range_points_device` itself: host keys there would sync in
        the middle of the pipeline, so that path bypasses the cache."""
        lo_np = np.atleast_2d(np.asarray(r_lo, np.float32))
        hi_np = np.atleast_2d(np.asarray(r_hi, np.float32))
        lo, hi = self._upload(lo_np, torch.float32), self._upload(
            hi_np, torch.float32)
        ids_np = np.atleast_1d(np.asarray(ds_ids, np.int64))
        ids = self._upload(ids_np, torch.int64)
        if not self.result_cache_size:
            return self._range_points_dispatch(ids, lo, hi)
        keys = [("range_points", int(ids_np[i]), self.slot_epoch(ids_np[i]),
                 _digest(lo_np[i], hi_np[i])) for i in range(ids_np.shape[0])]
        return self._serve_cached(
            "range_points", keys,
            lambda sel: self._range_points_dispatch(
                _take_rows(ids, sel), _take_rows(lo, sel),
                _take_rows(hi, sel)),
            split=_split_rows, join=_join_rows)

    def _range_points_device(self, ds_ids, r_lo, r_hi):
        """One batched RangeP dispatch, left on the device: (take
        (B, n_pad), scanned leaves per row (B,), leaves per dataset)."""
        B = ds_ids.shape[0]
        bucket = self.bucket_for(B)
        take, scanned = self.dispatch.build_range_points()(
            self._pad_rows(ds_ids, bucket), self._pad_rows(r_lo, bucket),
            self._pad_rows(r_hi, bucket))
        self.stats.count("range_points", B, bucket)
        return take[:B], scanned[:B].sum(dim=1), int(scanned.shape[1])

    def _range_points_dispatch(self, ds_ids, r_lo, r_hi):
        take, scanned, n_leaves = self._range_points_device(ds_ids, r_lo,
                                                            r_hi)
        return take, self._point_stats("range_points", n_leaves,
                                       scanned.cpu().tolist())

    def _point_stats(self, op: str, n_total: int, counts) -> list:
        """Per-row PointStats from host counts (RangeP: scanned leaves of
        ``n_total``; NNP: live leaf pairs of ``n_total``), booked into
        ``stats.per_op[op]``."""
        stats = [point_search.PointStats(n_total, c,
                                         1.0 - c / max(n_total, 1))
                 for c in counts]
        self.stats.record_point_search(op, stats)
        return stats

    def _exec_nnp(self, ds_ids, q_batch: DatasetIndex):
        """Tree-pruned NNP for B (query, dataset id) requests on the host ->
        (dists (B, nq), idx (B, nq), list[PointStats]).  Stage 2 calls
        :meth:`_nnp_device` itself, as for RangeP."""
        ids_np = np.atleast_1d(np.asarray(ds_ids, np.int64))
        ids = self._upload(ids_np, torch.int64)
        if not self.result_cache_size:
            return self._nnp_dispatch(ids, q_batch)
        pts = q_batch.points.cpu().numpy()
        val = q_batch.valid.cpu().numpy()
        keys = [("nnp", int(ids_np[i]), self.slot_epoch(ids_np[i]),
                 q_batch.depth, _digest(pts[i], val[i]))
                for i in range(ids_np.shape[0])]
        return self._serve_cached(
            "nnp", keys,
            lambda sel: self._nnp_dispatch(_take_rows(ids, sel),
                                           _take_tree_rows(q_batch, sel)),
            split=_split_rows, join=_join_rows)

    def _nnp_device(self, ds_ids, q_batch: DatasetIndex):
        """One batched NNP dispatch through ``nnp_pruned_core``, left on the
        device: (dists (B, nq), idx (B, nq), live leaf pairs per row (B,),
        leaf pairs per row)."""
        B = ds_ids.shape[0]
        bucket = self.bucket_for(B)
        dists, idxs, pair_live = self.dispatch.build_nnp()(
            self._pad_rows(ds_ids, bucket), self._pad_tree(q_batch, bucket))
        self.stats.count("nnp", B, bucket)
        pairs = int(pair_live.shape[1] * pair_live.shape[2])
        return dists[:B], idxs[:B], pair_live[:B].sum(dim=(1, 2)), pairs

    def _nnp_dispatch(self, ds_ids, q_batch: DatasetIndex):
        dists, idxs, live, pairs = self._nnp_device(ds_ids, q_batch)
        return dists, idxs, self._point_stats("nnp", pairs,
                                              live.cpu().tolist())

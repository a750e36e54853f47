"""Planner for `QueryEngine.search`: mixed declarative batches -> dispatches.

Counterpart of ``repro.engine.plan``.  ``execute`` groups a mixed
``list[Query | Pipeline]`` by (op, static params, query shape) in
first-seen order, runs each group through the engine's per-op executor
(``engine._exec_<op>``) as one batched dispatch, and scatters the results
back into input order.

Pipelines run in two stages:

  * **stage 1** — each pipeline's ``dataset_stage`` is planned as an
    ordinary row of its op's dispatch group, so pipeline stage-1 queries
    and standalone queries of the same (op, statics) share one dispatch;
  * **stage 2** — the winning dataset ids feed ``range_points`` / ``nnp``
    with the id handoff staying on the device (the planner slices the ids
    out of the stage-1 dispatch output before anything reaches the host;
    ``-1`` sentinel winners are clamped to slot 0 for the gather and
    masked out of the result).  Stage-2 rows group across pipelines by
    (point op, statics, built query capacity), so P pipelines with
    compatible point stages cost one dispatch of ``sum(k_p)`` rows.  A
    joinable stage 2 (``topk_overlap`` / ``topk_coverage``, the dataset ->
    dataset pipeline) takes the same handoff: the winner slots are
    gathered by id on the device and exactly re-scored against the
    stage's query set in one grouped dispatch, then re-ranked on the host
    to the stage's top-k (descending score, ties keeping stage-1 rank;
    sentinel winners score -1 and stay sentinels).

Every op of ``engine.query.OPS`` is ported.  ``execute`` still checks the
whole batch before anything runs, and would raise ``NotImplementedError``
naming the ROADMAP item of an op missing from ``PORTED_OPS``.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import index as index_lib
from repro_torch.core.index import DatasetIndex
from repro_torch.engine.query import (DATASET_RERANK_OPS, Pipeline, Query,
                                      SearchResult)

PORTED_OPS = ("range_search", "topk_ia", "topk_gbo", "topk_hausdorff_approx",
              "topk_hausdorff", "range_points", "nnp", "topk_overlap",
              "topk_coverage")

#: op -> the ROADMAP.md item (queue 1) that ports it, for ops not ported
ROADMAP_ITEM: dict = {}


@dataclass
class DispatchGroup:
    """Rows of one batched dispatch: same op, same statics, same query
    shape signature.  ``rows`` are positions in the caller's input list."""

    op: str
    statics: tuple
    shape_sig: tuple
    rows: list = field(default_factory=list)
    queries: list = field(default_factory=list)


def _check(item) -> None:
    """Refuse what ``execute`` cannot run, before anything runs."""
    if isinstance(item, Pipeline):
        for q in (item.dataset_stage, item.point_stage):
            if q.op not in PORTED_OPS:
                raise NotImplementedError(
                    f"Pipeline({item.dataset_stage.op} -> "
                    f"{item.point_stage.op}) is not ported to repro_torch "
                    f"yet (ROADMAP.md queue 1 item {ROADMAP_ITEM[q.op]})")
        return
    if not isinstance(item, Query):
        raise TypeError(f"search() takes Query/Pipeline items, "
                        f"got {type(item)!r}")
    if item.op not in PORTED_OPS:
        raise NotImplementedError(
            f"Query(op={item.op!r}) is not ported to repro_torch yet "
            f"(ROADMAP.md queue 1 item {ROADMAP_ITEM[item.op]})")
    # only a Pipeline's point stage may leave ds_id to its stage 1
    if item.op in ("range_points", "nnp") and item.ds_id is None:
        raise ValueError(f"Query(op={item.op!r}) requires ds_id outside a "
                         f"Pipeline point stage")


def plan(items, leaf_capacity: int = 16) -> list[DispatchGroup]:
    """Group a mixed batch into stage-1 dispatch groups (first-seen order;
    a Pipeline contributes its ``dataset_stage`` here)."""
    groups: "OrderedDict[tuple, DispatchGroup]" = OrderedDict()
    for pos, item in enumerate(items):
        q = item.dataset_stage if isinstance(item, Pipeline) else item
        key = (q.op, q.statics(), q.query_shape_sig(leaf_capacity))
        g = groups.get(key)
        if g is None:
            g = groups[key] = DispatchGroup(q.op, key[1], key[2])
        g.rows.append(pos)
        g.queries.append(q)
    return list(groups.values())


def count_groups(items, leaf_capacity: int = 16) -> int:
    """Dispatch groups ``execute`` would form for a batch: stage-1 op
    groups plus distinct pipeline stage-2 groups.  Host-side only, so an
    observer (the serving front end) can count groups without reading the
    engine's shared counters."""
    s2 = {_stage2_key(it.point_stage, leaf_capacity)
          for it in items if isinstance(it, Pipeline)}
    return len(plan(items, leaf_capacity)) + len(s2)


def execute(engine, items) -> list:
    """Run a mixed batch through the engine; one SearchResult per input."""
    items = list(items)
    for it in items:
        _check(it)
    results: list = [None] * len(items)
    stage1: dict = {}          # input pos -> stage-1 SearchResult
    handoffs: dict = {}        # input pos -> device (k,) winner-id row
    for g in plan(items, engine.leaf_capacity):
        # subgroups: the replica row-blocks the group's rows span
        engine.stats.count_group(g.op, engine._plan_subgroups(len(g.rows)))
        t0 = time.perf_counter()
        rows, ids_dev = _run_group(engine, g)
        engine.stats.record_latency(g.op, time.perf_counter() - t0)
        for j, (pos, res) in enumerate(zip(g.rows, rows)):
            if isinstance(items[pos], Pipeline):
                stage1[pos] = res
                handoffs[pos] = ids_dev[j]      # device slice: the handoff
            else:
                results[pos] = res
    if stage1:
        engine.stats.pipeline_stage1 += len(stage1)
        _run_stage2(engine, items, stage1, handoffs, results)
    return results


# ---------------------------------------------------------------------------
# stage 1 / plain groups
# ---------------------------------------------------------------------------


def _stack_boxes(queries, attr):
    """(B, d) operand from per-query host rows: one numpy stack (the
    executor uploads it once)."""
    return np.stack([np.asarray(getattr(q, attr), np.float32)
                     for q in queries])


def _split(x: torch.Tensor) -> list:
    """Materialise a dispatch output once and split it into numpy rows."""
    a = x.cpu().numpy()
    return [a[i] for i in range(a.shape[0])]


def _fetch(*xs: torch.Tensor) -> list:
    """Bring several tensors of one device to the host in one copy, as
    numpy arrays: their bytes are packed into one buffer (widest element
    type first, so every part stays aligned), copied once and cut apart."""
    order = sorted(range(len(xs)), key=lambda i: -xs[i].element_size())
    parts = [xs[i].contiguous().reshape(-1).view(torch.uint8) for i in order]
    host = torch.cat(parts).cpu().numpy()
    out: list = [None] * len(xs)
    off = 0
    for i, part in zip(order, parts):
        n = part.numel()
        dtype = torch.empty(0, dtype=xs[i].dtype).numpy().dtype
        out[i] = host[off:off + n].view(dtype).reshape(xs[i].shape)
        off += n
    return out


def _group_q_batch(engine, queries) -> DatasetIndex:
    """The group's (B, ...) query-index batch: pre-built rows are stacked
    (the group key guarantees equal capacity and depth), raw point sets go
    through one grouped ``build_queries``."""
    if queries[0].q_index is not None:
        return _stack_index_rows([q.q_index for q in queries], engine.device)
    return engine.build_queries([np.asarray(q.q) for q in queries])


def _stack_index_rows(rows, device) -> DatasetIndex:
    return DatasetIndex(*[
        torch.stack([torch.as_tensor(x, device=device) for x in xs])
        for xs in zip(*rows)])


def _run_group(engine, g: DispatchGroup):
    """Run one dispatch group; returns (per-row SearchResults, the device
    top-k id batch or None).  The id batch is kept unsplit on the device so
    that a pipeline's stage 2 can slice it without a host round trip."""
    op, qs = g.op, g.queries
    if op == "range_search":
        masks = engine._exec_range_search(_stack_boxes(qs, "r_lo"),
                                          _stack_boxes(qs, "r_hi"))
        return [SearchResult(op=op, mask=m) for m in _split(masks)], None
    if op == "topk_ia":
        vals, ids = engine._exec_topk_ia(
            _stack_boxes(qs, "r_lo"), _stack_boxes(qs, "r_hi"), qs[0].k)
        return [SearchResult(op=op, vals=v, ids=i)
                for v, i in zip(_split(vals), _split(ids))], ids
    if op == "topk_gbo":
        sigs = np.stack([np.asarray(q.q_sig) for q in qs])
        vals, ids = engine._exec_topk_gbo(sigs, qs[0].k)
        return [SearchResult(op=op, vals=v, ids=i)
                for v, i in zip(_split(vals), _split(ids))], ids
    if op == "topk_hausdorff_approx":
        q_batch = _group_q_batch(engine, qs)
        vals, ids, eps_eff = engine._exec_topk_hausdorff_approx(
            q_batch, qs[0].k, qs[0].eps)
        return [SearchResult(op=op, vals=v, ids=i, extras={"eps_eff": e})
                for v, i, e in zip(_split(vals), _split(ids),
                                   _split(eps_eff))], ids
    if op == "topk_hausdorff":
        q_batch = _group_q_batch(engine, qs)
        vals, ids, stats = engine._exec_topk_hausdorff(
            q_batch, qs[0].k, qs[0].refine_levels, qs[0].chunk)
        return [SearchResult(op=op, vals=v, ids=i, stats=s)
                for v, i, s in zip(_split(vals), _split(ids), stats)], ids
    if op == "range_points":
        ds = np.asarray([q.ds_id for q in qs], np.int64)
        take, stats = engine._exec_range_points(
            ds, _stack_boxes(qs, "r_lo"), _stack_boxes(qs, "r_hi"))
        return [SearchResult(op=op, mask=m, stats=s)
                for m, s in zip(_split(take), stats)], None
    if op == "nnp":
        ds = np.asarray([q.ds_id for q in qs], np.int64)
        q_batch = _group_q_batch(engine, qs)
        dists, idxs, stats = engine._exec_nnp(ds, q_batch)
        return [SearchResult(op=op, vals=d, ids=i, mask=m, stats=s)
                for d, i, m, s in zip(*_fetch(dists, idxs, q_batch.valid),
                                      stats)], None
    if op in DATASET_RERANK_OPS:
        pts, val = _stack_pointsets(
            [q.q for q in qs],
            max(q.built_capacity(engine.leaf_capacity) for q in qs))
        vals, ids, stats = engine._exec_topk_join(op, pts, val, qs[0].k)
        return [SearchResult(op=op, vals=v, ids=i, stats=s)
                for v, i, s in zip(*_fetch(vals, ids), stats)], ids
    raise ValueError(f"unplannable op {op!r}")  # pragma: no cover


def _stack_pointsets(pointsets, cap: int):
    """(B, cap, d) points and (B, cap) validity from raw per-query sets, one
    numpy stack (the joinable ops score on the grid, so no tree is built).
    Padding rows are invalid and land in the grid's overflow cell, so any
    two groupings of one query give the same scores."""
    sets = [np.asarray(ps, np.float32) for ps in pointsets]
    pts = np.zeros((len(sets), cap, sets[0].shape[-1]), np.float32)
    val = np.zeros((len(sets), cap), bool)
    for i, s in enumerate(sets):
        pts[i, :s.shape[0]] = s
        val[i, :s.shape[0]] = True
    return pts, val


# ---------------------------------------------------------------------------
# stage 2: pipeline point queries over the stage-1 winners
# ---------------------------------------------------------------------------


def _stage2_key(ps: Query, leaf_capacity: int) -> tuple:
    """Grouping key of a pipeline's point stage (host-side shape math only),
    so that pipelines share one stage-2 dispatch whenever their built query
    trees have one shape."""
    if ps.op == "nnp":
        cap = ps.built_capacity(leaf_capacity)
        if ps.q_index is not None:
            depth = ps.q_index.depth
        else:
            depth = index_lib.depth_for(cap, leaf_capacity)
        return (ps.op, ps.statics(), cap, depth)
    if ps.op in DATASET_RERANK_OPS:
        # joinable re-rank rows stack raw padded point sets: the key pins
        # the padded capacity, so the group's stack is shape-exact
        return (ps.op, ps.statics(), ps.built_capacity(leaf_capacity))
    return (ps.op, ps.statics())


def _run_stage2(engine, items, stage1, handoffs, results) -> None:
    groups: "OrderedDict[tuple, list[int]]" = OrderedDict()
    for pos in stage1:
        groups.setdefault(
            _stage2_key(items[pos].point_stage, engine.leaf_capacity),
            []).append(pos)
    for key, poss in groups.items():
        pop = key[0]
        ks = [items[pos].dataset_stage.k for pos in poss]
        engine.stats.count_group(pop, engine._plan_subgroups(int(sum(ks))))
        t0 = time.perf_counter()
        # winner ids, handed over on the device; -1 sentinels (k past the
        # valid dataset count) are clamped to slot 0 for the gather and
        # masked out below.  One cat, compare and where for the group, and
        # one host copy of everything the results need.
        w_flat = torch.cat([handoffs[pos] for pos in poss])
        valid_flat = w_flat >= 0
        ds_flat = torch.where(valid_flat, w_flat, 0)
        offs = np.concatenate([[0], np.cumsum(ks)])
        if pop == "range_points":
            def _tile_box(pos, k, attr):
                b = np.asarray(getattr(items[pos].point_stage, attr),
                               np.float32)
                return np.broadcast_to(b[None], (k,) + b.shape)

            lo = np.concatenate([_tile_box(pos, k, "r_lo")
                                 for pos, k in zip(poss, ks)])
            hi = np.concatenate([_tile_box(pos, k, "r_hi")
                                 for pos, k in zip(poss, ks)])
            take, scanned, n_leaves = engine._range_points_device(
                ds_flat, engine._upload(lo, torch.float32),
                engine._upload(hi, torch.float32))
            valid_np, take_np, sc = _fetch(valid_flat, take, scanned)
            stats = engine._point_stats(pop, n_leaves, sc.tolist())
            for pos, k, o in zip(poss, ks, offs):
                v = valid_np[o:o + k]
                results[pos] = SearchResult(
                    op="pipeline", mask=take_np[o:o + k] & v[:, None],
                    stats=stats[o:o + k],
                    extras={"stage1": stage1[pos],
                            "ds_ids": stage1[pos].ids, "valid": v})
        elif pop in DATASET_RERANK_OPS:
            _stage2_rerank(engine, items, stage1, results, key, poss, ks,
                           valid_flat, ds_flat)
        else:  # nnp
            rows = _stage2_nnp_rows(engine, items, poss)
            reps = torch.as_tensor(ks, device=engine.device)
            q_flat = DatasetIndex(*[
                x.repeat_interleave(reps, dim=0, output_size=int(offs[-1]))
                for x in rows])
            dists, idxs, live, pairs = engine._nnp_device(ds_flat, q_flat)
            valid_np, d_np, i_np, qv_np, live_np = _fetch(
                valid_flat, dists, idxs, q_flat.valid, live)
            stats = engine._point_stats(pop, pairs, live_np.tolist())
            for pos, k, o in zip(poss, ks, offs):
                v = valid_np[o:o + k]
                results[pos] = SearchResult(
                    op="pipeline", vals=d_np[o:o + k], ids=i_np[o:o + k],
                    mask=v[:, None] & qv_np[o:o + k], stats=stats[o:o + k],
                    extras={"stage1": stage1[pos],
                            "ds_ids": stage1[pos].ids, "valid": v})
        engine.stats.record_latency(pop, time.perf_counter() - t0)
        engine.stats.pipeline_stage2 += len(poss)


def _stage2_rerank(engine, items, stage1, results, key, poss, ks,
                   valid_flat, ds_flat) -> None:
    """Dataset -> dataset stage 2: the exact join score of each winner slot
    against its pipeline's query set (one grouped dispatch, the ids on the
    device), then a host re-rank to the stage's top-k.  Sentinel winners
    were clamped to slot 0; their rows score -1 here, so a pipeline with
    no surviving winner gives all-sentinel output instead of ranking slot
    0."""
    pop, cap = key[0], key[2]
    pts, val = _stack_pointsets([items[pos].point_stage.q for pos in poss],
                                cap)
    total = int(sum(ks))
    reps = torch.as_tensor(ks, device=engine.device)
    pts_rep = engine._upload(pts, torch.float32).repeat_interleave(
        reps, dim=0, output_size=total)
    val_rep = engine._upload(val, torch.bool).repeat_interleave(
        reps, dim=0, output_size=total)
    scores = engine._exec_join_rerank(pop, ds_flat, pts_rep, val_rep)
    valid_np, s_np = _fetch(valid_flat, scores)
    off = 0
    for pos, k in zip(poss, ks):
        k2 = items[pos].point_stage.k
        v = valid_np[off:off + k]
        seg = np.where(v, s_np[off:off + k], -1).astype(np.int32)
        win = stage1[pos].ids
        # descending score; the stable sort keeps stage-1 rank on ties
        order = np.argsort(-seg, kind="stable")[:k2]
        vals = np.full((k2,), -1, np.int32)
        ids = np.full((k2,), -1, np.int32)
        vals[:len(order)] = seg[order]
        ids[:len(order)] = np.where(vals[:len(order)] < 0, -1, win[order])
        results[pos] = SearchResult(
            op="pipeline", vals=vals, ids=ids, mask=vals >= 0,
            extras={"stage1": stage1[pos], "ds_ids": stage1[pos].ids,
                    "valid": v})
        off += k


def _stage2_nnp_rows(engine, items, poss) -> DatasetIndex:
    """One query-index row per pipeline of the group, as a (P, ...) batch.

    Raw point sets are built in one grouped ``build_queries`` call; the
    group key pins the built capacity to what a solo build would give, so
    each row equals its solo build.  Pre-built rows are stacked as they
    are."""
    raw = [pos for pos in poss if items[pos].point_stage.q_index is None]
    built = None
    if raw:
        built = engine.build_queries(
            [np.asarray(items[pos].point_stage.q) for pos in raw])
    raw_row = {pos: i for i, pos in enumerate(raw)}
    rows = []
    for pos in poss:
        ps = items[pos].point_stage
        if ps.q_index is None:
            rows.append(DatasetIndex(*[x[raw_row[pos]] for x in built]))
        else:
            rows.append(ps.q_index)
    return _stack_index_rows(rows, engine.device)

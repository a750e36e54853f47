"""Planner for `QueryEngine.search`: a declarative batch -> dispatch groups.

Counterpart of ``repro.engine.plan``.  ``execute`` groups a
``list[Query | Pipeline]`` by (op, static params, query shape) in
first-seen order, runs each group through the engine's per-op executor as
one batched dispatch, and scatters the results back into input order.

Only ``topk_hausdorff`` is ported.  Every other op, and every Pipeline,
raises ``NotImplementedError`` naming the ROADMAP item that ports it; the
whole batch is checked before anything runs.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.index import DatasetIndex
from repro_torch.engine.query import Pipeline, Query, SearchResult

PORTED_OPS = ("topk_hausdorff",)

#: op -> the ROADMAP.md item (queue 1) that ports it
ROADMAP_ITEM = {
    "range_search": 6, "topk_ia": 6, "topk_gbo": 6,
    "topk_hausdorff_approx": 6, "range_points": 7, "nnp": 7,
    "topk_overlap": 8, "topk_coverage": 8,
}


@dataclass
class DispatchGroup:
    """Rows of one batched dispatch: same op, same statics, same query
    shape signature.  ``rows`` are positions in the caller's input list."""

    op: str
    statics: tuple
    shape_sig: tuple
    rows: list = field(default_factory=list)
    queries: list = field(default_factory=list)


def _check_ported(item) -> None:
    if isinstance(item, Pipeline):
        n = ROADMAP_ITEM[item.point_stage.op]
        raise NotImplementedError(
            f"Pipeline({item.dataset_stage.op} -> {item.point_stage.op}) is "
            f"not ported to repro_torch yet (ROADMAP.md queue 1 item {n})")
    if not isinstance(item, Query):
        raise TypeError(f"search() takes Query/Pipeline items, "
                        f"got {type(item)!r}")
    if item.op not in PORTED_OPS:
        raise NotImplementedError(
            f"Query(op={item.op!r}) is not ported to repro_torch yet "
            f"(ROADMAP.md queue 1 item {ROADMAP_ITEM[item.op]})")


def plan(items, leaf_capacity: int = 16) -> list[DispatchGroup]:
    """Group a batch into dispatch groups (first-seen order)."""
    groups: "OrderedDict[tuple, DispatchGroup]" = OrderedDict()
    for pos, q in enumerate(items):
        key = (q.op, q.statics(), q.query_shape_sig(leaf_capacity))
        g = groups.get(key)
        if g is None:
            g = groups[key] = DispatchGroup(q.op, key[1], key[2])
        g.rows.append(pos)
        g.queries.append(q)
    return list(groups.values())


def execute(engine, items) -> list:
    """Run a batch through the engine; one SearchResult per input."""
    items = list(items)
    for it in items:
        _check_ported(it)
    results: list = [None] * len(items)
    for g in plan(items, engine.leaf_capacity):
        engine.stats.plan_groups += 1
        for pos, res in zip(g.rows, _run_group(engine, g)):
            results[pos] = res
    return results


def _split(x: torch.Tensor) -> list:
    """Materialise a dispatch output once and split it into numpy rows."""
    a = x.cpu().numpy()
    return [a[i] for i in range(a.shape[0])]


def _group_q_batch(engine, queries) -> DatasetIndex:
    """The group's (B, ...) query-index batch: pre-built rows are stacked
    (the group key guarantees equal capacity and depth), raw point sets go
    through one grouped ``build_queries``."""
    if queries[0].q_index is not None:
        dev = engine.device
        return DatasetIndex(*[
            torch.stack([torch.as_tensor(x, device=dev) for x in xs])
            for xs in zip(*[q.q_index for q in queries])])
    return engine.build_queries([np.asarray(q.q) for q in queries])


def _run_group(engine, g: DispatchGroup) -> list:
    """Run one dispatch group; returns its per-row SearchResults."""
    qs = g.queries
    if g.op == "topk_hausdorff":
        q_batch = _group_q_batch(engine, qs)
        vals, ids, stats = engine._exec_topk_hausdorff(
            q_batch, qs[0].k, qs[0].refine_levels, qs[0].chunk)
        return [SearchResult(op=g.op, vals=v, ids=i, stats=s)
                for v, i, s in zip(_split(vals), _split(ids), stats)]
    raise ValueError(f"unplannable op {g.op!r}")  # pragma: no cover

"""Declarative query spec for the unified `QueryEngine.search` entry point.

A copy of ``repro.engine.query`` (numpy only), kept in the port so that it
imports nothing of the JAX package.  The spec covers every op of the
system, and the port's engine answers each of them
(``repro_torch.engine.plan``).

A client builds frozen :class:`Query` values (an op tag plus typed params)
— or a two-stage :class:`Pipeline` (dataset-level top-k feeding a
point-level op inside the winners) — and hands a list of them to
``engine.search``; every result comes back as a uniform
:class:`SearchResult` in input order.  Validation happens at construction
(`__post_init__`); planning and dispatch live in
:mod:`repro_torch.engine.plan`.  Nothing here touches a device.

Op tags and their required params:

    =====================  ==========================================
    op                     params
    =====================  ==========================================
    range_search           r_lo, r_hi
    topk_ia                q_lo=r_lo, q_hi=r_hi, k
    topk_gbo               q_sig, k
    topk_hausdorff_approx  q (raw points) or q_index, k, eps
    topk_hausdorff         q or q_index, k [, refine_levels, chunk]
    range_points           ds_id, r_lo, r_hi
    nnp                    ds_id, q or q_index
    topk_overlap           q (raw points), k
    topk_coverage          q (raw points), k
    =====================  ==========================================

The joinable ops (``topk_overlap`` / ``topk_coverage``) rank repository
datasets by grid-cell joinability with the query point set (see
``repro.core.join_search``); they take RAW points only — the scoring
grid needs no ball tree.  They may drive a Pipeline's first stage like
any dataset top-k, and uniquely may also serve as its SECOND stage
(a dataset→dataset pipeline: stage-1 winners re-ranked by joinability
with the stage-2 query set, the id handoff staying on device).

Index-consuming ops accept either a raw ``(n, d)`` point array (``q``) —
the planner batches the ball-tree builds per dispatch group — or a
pre-built single-query :class:`~repro_torch.core.index.DatasetIndex` row
(``q_index``), which is what the legacy batch methods pass through.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

OPS = (
    "range_search", "topk_ia", "topk_gbo", "topk_hausdorff_approx",
    "topk_hausdorff", "range_points", "nnp", "topk_overlap",
    "topk_coverage",
)
#: joinable dataset ops (grid overlap / coverage) — dataset-granularity
#: top-k ops that can also RE-RANK a pipeline's stage-1 winners
DATASET_RERANK_OPS = ("topk_overlap", "topk_coverage")
#: dataset-granularity ops returning a top-k id list — the only ops that can
#: drive a Pipeline's first stage (RangeS returns a mask, not ranked ids)
DATASET_TOPK_OPS = (
    "topk_ia", "topk_gbo", "topk_hausdorff_approx", "topk_hausdorff",
) + DATASET_RERANK_OPS
#: ops a Pipeline's second stage may run: point ops inside each winner, or
#: a joinable op re-ranking the winners themselves (dataset→dataset)
POINT_OPS = ("range_points", "nnp")

# params that must be present (not None) per op; ds_id is checked separately
# because a Pipeline's point stage legitimately leaves it None
_REQUIRED = {
    "range_search": ("r_lo", "r_hi"),
    "topk_ia": ("r_lo", "r_hi", "k"),
    "topk_gbo": ("q_sig", "k"),
    "topk_hausdorff_approx": ("k", "eps"),
    "topk_hausdorff": ("k",),
    "range_points": ("r_lo", "r_hi"),
    "nnp": (),
    "topk_overlap": ("q", "k"),
    "topk_coverage": ("q", "k"),
}
_NEEDS_QUERY_SET = ("topk_hausdorff_approx", "topk_hausdorff", "nnp")


@dataclass(frozen=True)
class Query:
    """One declarative search request (see module docstring for the op
    table).  Frozen: a Query is immutable once constructed, so the planner
    may regroup/reorder freely and the result cache can trust its content.
    """

    op: str
    r_lo: Any = None          # (d,) box corner — RangeS/IA/RangeP
    r_hi: Any = None
    q_sig: Any = None         # (w,) z-order signature — GBO
    q: Any = None             # raw (n, d) query point set
    q_index: Any = None       # pre-built single-query DatasetIndex row
    ds_id: Any = None         # target dataset — RangeP/NNP (None in a
                              # Pipeline's point stage: filled from stage 1)
    k: int | None = None
    eps: float | None = None
    refine_levels: int = 3    # ExactHaus static params
    chunk: int | None = None  # None -> the engine's default_chunk

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown op {self.op!r}; valid ops: {OPS}")
        for name in _REQUIRED[self.op]:
            if getattr(self, name) is None:
                raise ValueError(f"Query(op={self.op!r}) requires {name!r}")
        if self.op in _NEEDS_QUERY_SET:
            if self.q is None and self.q_index is None:
                raise ValueError(
                    f"Query(op={self.op!r}) requires q or q_index")
            if self.q is not None and self.q_index is not None:
                raise ValueError(
                    f"Query(op={self.op!r}): pass q OR q_index, not both")
            if self.q_index is not None and not (
                    hasattr(self.q_index, "points")
                    and hasattr(self.q_index, "depth")):
                raise ValueError(
                    f"Query(op={self.op!r}): q_index must be a built "
                    f"DatasetIndex row (got {type(self.q_index)!r}); "
                    f"pass raw points as q= instead")
        if self.op in DATASET_RERANK_OPS and self.q_index is not None:
            raise ValueError(
                f"Query(op={self.op!r}) scores on the shared grid — pass "
                f"raw points as q=, not a built index row")

    # -- planning keys -----------------------------------------------------

    def statics(self) -> tuple:
        """The static (compile-relevant / shared-scalar) part of the query:
        two queries may share one device dispatch iff their op AND statics
        agree — the same compatibility rule serve_search grouped by."""
        if (self.op == "topk_ia" or self.op == "topk_gbo"
                or self.op in DATASET_RERANK_OPS):
            return (self.k,)
        if self.op == "topk_hausdorff_approx":
            return (self.k, float(self.eps))
        if self.op == "topk_hausdorff":
            return (self.k, self.refine_levels, self.chunk)
        return ()

    def query_shape_sig(self, leaf_capacity: int) -> tuple:
        """Shape signature of the query point set, for grouping: raw sets
        group together (the grouped `build_queries` pads them to one
        capacity, exactly like the serving front-end always did), while
        pre-built index rows group by their actual (capacity, depth) so
        stacking them is shape-exact."""
        if self.op not in _NEEDS_QUERY_SET:
            return ()
        if self.q_index is not None:
            return ("idx", int(self.q_index.points.shape[-2]),
                    self.q_index.depth)
        return ("raw",)

    def built_capacity(self, leaf_capacity: int) -> int:
        """Point capacity `build_queries` would pad this query's set to if
        built ALONE — the stage-2 grouping key for pipelines (host-side,
        no device sync)."""
        if self.q_index is not None:
            return int(self.q_index.points.shape[-2])
        n = int(np.asarray(self.q).shape[0])
        cap = leaf_capacity
        while cap < n:
            cap *= 2
        return cap


@dataclass(frozen=True)
class Pipeline:
    """The paper's multi-granularity case study as ONE first-class query:
    ``dataset_stage`` (a top-k dataset op) selects the k winning dataset
    ids, which feed ``point_stage`` (RangeP or NNP) restricted to those
    datasets — one point query per winner, the id handoff staying on
    device.  Planned as two engine dispatches: stage 1 rides the mixed-op
    groups alongside ordinary queries; stage 2 groups across pipelines.

    ``point_stage`` may instead be a joinable op (``topk_overlap`` /
    ``topk_coverage``): a dataset→dataset pipeline where the stage-1
    winners are exactly re-scored against the stage's own query set and
    re-ranked to its top-``k`` (ties keep stage-1 rank order); the winner
    ids still never leave the device before stage-2 scoring.
    """

    dataset_stage: Query
    point_stage: Query

    def __post_init__(self):
        if self.dataset_stage.op not in DATASET_TOPK_OPS:
            raise ValueError(
                f"Pipeline dataset_stage must be a top-k dataset op "
                f"{DATASET_TOPK_OPS}, got {self.dataset_stage.op!r}")
        if (self.point_stage.op not in POINT_OPS
                and self.point_stage.op not in DATASET_RERANK_OPS):
            raise ValueError(
                f"Pipeline point_stage must be a point op {POINT_OPS} or "
                f"a joinable re-rank op {DATASET_RERANK_OPS}, "
                f"got {self.point_stage.op!r}")
        if self.point_stage.ds_id is not None:
            raise ValueError(
                "Pipeline point_stage.ds_id must be None — the ids come "
                "from the dataset stage's top-k")


@dataclass(frozen=True)
class SearchResult:
    """Uniform per-query result of ``engine.search`` (input order).

    Field population by op:

      * ``range_search``          — ``mask`` (B_pad,) dataset hit mask
      * ``topk_ia`` / ``topk_gbo``— ``vals``/``ids`` (k,)
      * ``topk_hausdorff_approx`` — ``vals``/``ids`` (k,),
        ``extras['eps_eff']``
      * ``topk_hausdorff``        — ``vals``/``ids`` (k,), ``stats``
        (:class:`~repro_torch.core.search.SearchStats`)
      * ``range_points``          — ``mask`` (n_pad,) point take mask,
        ``stats`` (PointStats)
      * ``nnp``                   — ``vals`` NN dists / ``ids`` NN indices
        (nq,), ``mask`` query-point validity, ``stats`` (PointStats)
      * ``pipeline``              — stage-2 outputs stacked over the k
        winners (``mask`` (k, n_pad) takes for RangeP; ``vals``/``ids``
        (k, nq) for NNP), ``extras['stage1']`` the full stage-1
        SearchResult, ``extras['ds_ids']`` the winner ids and
        ``extras['valid']`` their >= 0 mask (k past the valid dataset
        count yields -1 sentinels whose stage-2 rows are masked out).

    Array fields are materialized numpy row views of the group's dispatch
    output (one materialization per dispatch, free per-row slicing — a
    per-row device op would cost more than a small dispatch); ``stats``
    entries are host values.  Inside a Pipeline the stage-1 -> stage-2 id
    handoff does NOT go through these views: the planner slices the ids
    from the device-resident dispatch output directly.
    """

    op: str
    vals: Any = None
    ids: Any = None
    mask: Any = None
    stats: Any = None
    extras: dict = field(default_factory=dict)

"""Search serving front end: a request queue and continuous micro-batching.

    PYTHONPATH=src python -m repro_torch.launch.serve_search [--requests 256]
    PYTHONPATH=src python -m repro_torch.launch.serve_search --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_search --device cpu \
        --live --mutate-every 8 --requests 64 --datasets 32
    PYTHONPATH=src python -m repro_torch.launch.serve_search --sharded
    PYTHONPATH=src python -m repro_torch.launch.serve_search --device cpu \
        --replicas 2 --data-shards 2

Counterpart of ``repro.launch.serve_search``.  Clients
submit single queries of mixed kinds (RangeS, top-k IA / GBO, ApproHaus,
ExactHaus, joinable overlap and coverage, RangeP, NNP, and dataset -> point
and dataset -> dataset pipelines) into a queue; a dispatcher thread drains
it continuously and hands each whole mixed drain to ``QueryEngine.search``
as one declarative batch, whose planner groups compatible requests into
shared dispatches.  Under load a drain grows toward ``max_batch`` on its
own.

``submit(op=..., **payload)`` builds the :class:`Query` / :class:`Pipeline`
at submission; ``submit_query`` enqueues a ready-made spec.  The
dispatcher's clock is injectable (``clock=``): latency accounting and the
static drain deadline read ``self.clock()``, so tests drive virtual time.

Live serving (``SearchServer(live=...)``, ``--live``): the server fronts a
:class:`~repro_torch.engine.live.LiveRepository` and takes mutations on the
same queue (``submit_mutation("ingest" | "delete" | "replace", ...)``), so
a mutation takes effect at its position in the stream.  A drain closes at
the first mutation -> query transition, so it is one query segment and a
tail run of mutations: the segment is one engine call, the run one
coalesced publish, whose prepare runs on a side thread while the segment
is served.  Every query behind a mutation is answered at the
post-mutation epoch.

The server runs on the device its engine lives on, ``cuda`` unless it is
given ``device="cpu"``.  Multi-device serving (``--sharded``, ``--replicas
R``, ``--data-shards D``): the engine is a ``ShardedQueryEngine`` or a
``ReplicatedQueryEngine`` over the visible cards, one shard each; with
``--device cpu`` there are no cards to count, so the mesh is D CPU shards
per replica group (D defaults to ``CPU_SHARDS``).  ``--live`` composes
with each of them: the live repository is then built over the mesh
(``LiveRepository(mesh=...)``) and the mutation lane publishes through its
owner writes.
"""
from __future__ import annotations

import argparse
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.core import zorder
from repro_torch.device import resolve_device
from repro_torch.engine import Pipeline, Query, QueryEngine, SearchResult
from repro_torch.engine import plan as plan_lib

#: data shards per replica group of a ``--device cpu`` mesh without
#: ``--data-shards``
CPU_SHARDS = 2

# ops the submit() shim wraps into a Query / Pipeline; any mix of them may
# share one queue drain
OPS = (
    "range_search", "topk_ia", "topk_gbo", "topk_hausdorff_approx",
    "topk_hausdorff", "range_points", "nnp", "topk_overlap",
    "topk_coverage", "pipeline",
)

#: mutation kinds the live lane accepts (LiveRepository methods)
MUTATION_OPS = ("ingest", "delete", "replace")


def _to_query(op: str, payload: dict):
    """The submit() shim: an (op, payload) request -> declarative spec."""
    if op == "pipeline":
        dataset = payload["dataset"]
        point = payload["point"]
        return Pipeline(
            dataset_stage=(dataset if isinstance(dataset, Query)
                           else _to_query(dataset["op"], dataset)),
            point_stage=(point if isinstance(point, Query)
                         else _to_query(point["op"], point)))
    if op == "range_search":
        return Query(op=op, r_lo=payload["r_lo"], r_hi=payload["r_hi"])
    if op == "topk_ia":
        # request naming: q_lo/q_hi; pipeline specs may say r_lo/r_hi
        lo = payload.get("q_lo", payload.get("r_lo"))
        hi = payload.get("q_hi", payload.get("r_hi"))
        return Query(op=op, r_lo=lo, r_hi=hi, k=payload["k"])
    if op == "topk_gbo":
        return Query(op=op, q_sig=payload["q_sig"], k=payload["k"])
    if op == "topk_hausdorff_approx":
        return Query(op=op, q=payload["q"], k=payload["k"],
                     eps=payload["eps"])
    if op == "topk_hausdorff":
        return Query(op=op, q=payload["q"], k=payload["k"])
    if op == "range_points":
        return Query(op=op, ds_id=payload.get("ds_id"),
                     r_lo=payload["r_lo"], r_hi=payload["r_hi"])
    if op == "nnp":
        return Query(op=op, ds_id=payload.get("ds_id"), q=payload["q"])
    if op == "topk_overlap" or op == "topk_coverage":
        return Query(op=op, q=payload["q"], k=payload["k"])
    raise ValueError(f"unknown op {op!r}; serving ops: {OPS}")


def _legacy_result(res: SearchResult):
    """Shape a SearchResult like the per-op responses of the JAX server:
    masks for the range ops, (vals, ids) for IA, GBO and NNP, with eps_eff
    for ApproHaus and SearchStats for ExactHaus and the joinable ops; a
    pipeline's response is the full SearchResult."""
    if res.op == "range_search" or res.op == "range_points":
        return res.mask
    if res.op == "topk_ia" or res.op == "topk_gbo" or res.op == "nnp":
        return (res.vals, res.ids)
    if res.op == "topk_hausdorff_approx":
        return (res.vals, res.ids, res.extras["eps_eff"])
    if res.op in ("topk_hausdorff", "topk_overlap", "topk_coverage"):
        return (res.vals, res.ids, res.stats)
    return res                              # pipeline: the full result


@dataclass
class Request:
    op: str
    query: Any                              # Query | Pipeline
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.perf_counter)


@dataclass
class Mutation:
    """One mutation riding the request queue, applied at its position in
    the stream: queries drained before it see the old epoch, queries after
    it the new one."""
    op: str                                 # ingest | delete | replace
    ds_id: int | None = None
    points: Any = None
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.perf_counter)


@dataclass
class ServerStats:
    requests: int = 0
    batches: int = 0                        # dispatch groups planned
    batch_size_sum: int = 0
    latency_sum: float = 0.0
    latencies: list = field(default_factory=list)   # per-request seconds
    op_ewma: dict = field(default_factory=dict)     # op -> EWMA latency s
    mutations: int = 0                      # mutation-lane ops applied
    mutation_latency_sum: float = 0.0
    mutation_latencies: list = field(default_factory=list)

    #: the smoothing of ``EngineStats.EWMA_ALPHA``
    EWMA_ALPHA = 0.2

    @property
    def mean_batch(self) -> float:
        return self.batch_size_sum / max(self.batches, 1)

    @property
    def mean_latency_ms(self) -> float:
        return 1e3 * self.latency_sum / max(self.requests, 1)

    def record(self, op: str, seconds: float) -> None:
        """Book one answered request's submit -> result latency."""
        self.requests += 1
        self.latency_sum += seconds
        self.latencies.append(seconds)
        prev = self.op_ewma.get(op)
        self.op_ewma[op] = (seconds if prev is None
                            else prev + self.EWMA_ALPHA * (seconds - prev))

    def record_mutation(self, seconds: float) -> None:
        """Book one applied mutation's submit -> publish latency, apart from
        the query latencies."""
        self.mutations += 1
        self.mutation_latency_sum += seconds
        self.mutation_latencies.append(seconds)

    @property
    def mean_mutation_ms(self) -> float:
        return 1e3 * self.mutation_latency_sum / max(self.mutations, 1)

    def percentile_ms(self, p: float) -> float:
        """p-th percentile of per-request latency, in ms (0 if empty)."""
        if not self.latencies:
            return 0.0
        return 1e3 * float(np.percentile(np.asarray(self.latencies), p))

    @property
    def p50_ms(self) -> float:
        return self.percentile_ms(50.0)

    @property
    def p99_ms(self) -> float:
        return self.percentile_ms(99.0)


class SearchServer:
    """Continuous micro-batching dispatcher over a QueryEngine.

    Two batching policies:

    * **adaptive** (default): the dispatcher takes every request already
      queued; when the queue runs dry it waits one straggler window, and
      every arrival renews it, so the batch fills while traffic flows and
      ships once a full window passes with nothing new.  The window is
      ``min(max_wait, 0.5 x EWMA dispatch latency)`` of the ops in the
      batch (``EngineStats.latency_ewma``).  When the backlog is deeper
      than ``max_batch``, a drain may take up to ``OVERFILL x max_batch``.
    * **static** (``adaptive=False``): after the first request, keep taking
      requests until a fixed ``max_wait`` deadline or ``max_batch``.
    """

    #: adaptive drains may grow to this multiple of ``max_batch`` when the
    #: queue is already deeper than ``max_batch``
    OVERFILL = 4

    def __init__(
        self,
        engine: QueryEngine | None = None,
        *,
        live=None,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        adaptive: bool = True,
        clock=time.perf_counter,
        device=None,
    ):
        if engine is None:
            if live is None:
                raise ValueError("SearchServer needs an engine or a live "
                                 "repository")
            engine = live.engine
        elif live is not None and live.engine is not engine:
            raise ValueError("live.engine and engine disagree: pass one")
        dev = resolve_device(device)
        if engine.device.type != dev.type:
            raise ValueError(f"SearchServer on {dev} was given an engine on "
                             f"{engine.device}")
        self.engine = engine
        self.live = live
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.adaptive = adaptive
        self.clock = clock
        self.stats = ServerStats()
        self._queue: "queue.Queue[Request | Mutation | None]" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._running = False
        # 1-worker pool for the prepare stage of the next mutation run,
        # started on first use; the segment it overlaps serves the published
        # snapshot, which a prepare never touches
        self._prep_pool: ThreadPoolExecutor | None = None
        self._segment_span = (0.0, 0.0)
        # the first request past a mutation run, carried to the next drain
        # so a publish always lands at a drain's tail
        self._carry: Request | Mutation | None = None

    # -- client API --------------------------------------------------------

    def submit(self, op: str, **payload: Any) -> Future:
        """Enqueue one query; returns a Future with the op's result.  The
        (op, **payload) call becomes a Query / Pipeline here (validation
        included)."""
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}; serving ops: {OPS}")
        if not self._running:
            raise RuntimeError("server is not running (start() it first)")
        return self.submit_query(_to_query(op, payload), op=op)

    def submit_query(self, query, *, op: str | None = None) -> Future:
        """Enqueue a ready-made Query / Pipeline spec."""
        if not isinstance(query, (Query, Pipeline)):
            raise TypeError(f"submit_query takes Query/Pipeline, "
                            f"got {type(query)!r}")
        if not self._running:
            raise RuntimeError("server is not running (start() it first)")
        if op is None:
            op = "pipeline" if isinstance(query, Pipeline) else query.op
        req = Request(op, query, t_submit=self.clock())
        self._queue.put(req)
        if not self._running and not req.future.done():
            # lost the race with a concurrent stop(): its drain may have
            # passed this request already, so fail the future here
            try:
                req.future.set_exception(
                    RuntimeError("server stopped before request ran"))
            except Exception:           # the drain got there first
                pass
        return req.future

    def submit_mutation(self, op: str, *, ds_id: int | None = None,
                        points=None) -> Future:
        """Enqueue one live-repository mutation.  The Future resolves to the
        slot id (ingest, replace) or None (delete) once the mutation is
        published; every query drained behind it sees the new epoch."""
        if self.live is None:
            raise RuntimeError("mutation lane needs a live repository "
                               "(SearchServer(live=...))")
        if op not in MUTATION_OPS:
            raise ValueError(f"unknown mutation {op!r}; mutation ops: "
                             f"{MUTATION_OPS}")
        if not self._running:
            raise RuntimeError("server is not running (start() it first)")
        mut = Mutation(op, ds_id=ds_id, points=points, t_submit=self.clock())
        self._queue.put(mut)
        return mut.future

    def start(self) -> "SearchServer":
        self._running = True
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        self._queue.put(None)          # wake the dispatcher
        self._thread.join(timeout=30)
        # fail anything still queued or carried, so no client Future waits
        # forever
        if self._carry is not None and not self._carry.future.done():
            self._carry.future.set_exception(
                RuntimeError("server stopped before request ran"))
        self._carry = None
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None and not req.future.done():
                req.future.set_exception(
                    RuntimeError("server stopped before request ran"))
        if self._prep_pool is not None:
            self._prep_pool.shutdown(wait=True)
            self._prep_pool = None

    # -- dispatcher --------------------------------------------------------

    def _straggler_window(self, batch: list[Request]) -> float:
        """Adaptive wait once the queue runs dry: half the EWMA dispatch
        latency of the ops in the batch, capped by max_wait; before any
        latency has been measured, the static window."""
        ew = self.engine.stats.latency_ewma
        vals = [ew[r.op] for r in batch if r.op in ew]
        if not vals:
            vals = list(ew.values())
        if not vals:
            return self.max_wait
        return min(self.max_wait, 0.5 * max(vals))

    def _drain(self) -> list:
        """Block for the first request, then fill the batch: greedy takes,
        renewing straggler windows and a depth-scaled bound when adaptive;
        a fixed max_wait deadline up to max_batch when static.

        A drain closes at the first mutation -> query transition and carries
        that query to the next drain, so it is at most one query segment
        and a tail run of mutations: a segment split in two would pay a
        second round of group dispatches."""
        if self._carry is not None:
            first, self._carry = self._carry, None
        else:
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                return []
            if first is None:
                return []
        batch = [first]
        if self.adaptive:
            limit = self.max_batch
            if self._queue.qsize() > self.max_batch:
                limit = self.OVERFILL * self.max_batch
            waited = False
            while len(batch) < limit:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    if waited:
                        break
                    waited = True
                    try:
                        req = self._queue.get(
                            timeout=self._straggler_window(batch))
                    except queue.Empty:
                        break
                if req is None:
                    break
                if (isinstance(batch[-1], Mutation)
                        and not isinstance(req, Mutation)):
                    self._carry = req
                    break
                batch.append(req)
                # every arrival renews the straggler budget
                waited = False
            # absorb the run of mutations just past the drain bound (the
            # first query after them is carried): their publish rides this
            # drain's tail and their prepare overlaps this drain's segment
            if not isinstance(batch[-1], Mutation) and self._carry is None:
                while True:
                    try:
                        req = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if req is None:
                        break
                    if not isinstance(req, Mutation):
                        self._carry = req
                        break
                    batch.append(req)
            return batch
        deadline = self.clock() + self.max_wait
        while len(batch) < self.max_batch:
            timeout = deadline - self.clock()
            try:
                req = self._queue.get(timeout=max(timeout, 0.0))
            except queue.Empty:
                break
            if req is None:
                break
            if (isinstance(batch[-1], Mutation)
                    and not isinstance(req, Mutation)):
                self._carry = req
                break
            batch.append(req)
        return batch

    def _prepare_ahead(self, muts: list[Mutation]):
        """Start the prepare stage (row builds, payload uploads) of the next
        mutation run on the side thread, to overlap the query segment about
        to be served.  Its launches go to the device's default stream, the
        one the dispatcher thread uses, so stream order keeps them apart."""
        if self._prep_pool is None:
            self._prep_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="mutation-prepare")

        def work():
            t0 = self.clock()
            group = self.live.prepare_group(
                [(m.op, m.ds_id, m.points) for m in muts])
            return group, t0, self.clock()

        return self._prep_pool.submit(work)

    def _publish_run(self, muts: list[Mutation], prepared) -> None:
        """Install one coalesced run of mutations: join (or run here) its
        prepare, book the host time it spent under the preceding segment,
        publish the group as one epoch and resolve every future from the
        per-item outcomes."""
        try:
            if prepared is not None:
                group, tp0, tp1 = prepared.result()
                s0, s1 = self._segment_span
                self.engine.stats.prepare_overlap_seconds += max(
                    0.0, min(tp1, s1) - max(tp0, s0))
            else:
                group = self.live.prepare_group(
                    [(m.op, m.ds_id, m.points) for m in muts])
            outcomes = self.live.publish_group(group)
        except Exception as e:
            # the dispatcher must survive: the run's futures carry it
            for m in muts:
                if not m.future.done():
                    m.future.set_exception(e)
            return
        now = self.clock()
        for m, out in zip(muts, outcomes):
            if isinstance(out, Exception):
                if not m.future.done():
                    m.future.set_exception(out)
            else:
                self.stats.record_mutation(now - m.t_submit)
                m.future.set_result(out)

    def _serve(self, batch: list[Request]) -> None:
        """One declarative engine call for a query segment; the planner
        groups compatible rows into shared dispatches."""
        try:
            results = self.engine.search([r.query for r in batch])
        except Exception:
            # a poisoned row fails the whole mixed call: re-run per
            # request, so every healthy future still resolves and only
            # the bad rows carry the exception
            results = []
            for r in batch:
                try:
                    results.append(self.engine.search([r.query])[0])
                except Exception as e:
                    results.append(e)
        now = self.clock()
        # dispatch groups, planned here on the host, so that a client
        # sharing the engine from another thread cannot skew the count;
        # the accounting must never kill the dispatcher once results exist
        try:
            self.stats.batches += plan_lib.count_groups(
                [r.query for r in batch], self.engine.leaf_capacity)
        except Exception:
            self.stats.batches += 1
        self.stats.batch_size_sum += len(batch)
        for req, res in zip(batch, results):
            self.stats.record(req.op, now - req.t_submit)
            if isinstance(res, Exception):
                if not req.future.done():
                    req.future.set_exception(res)
            else:
                req.future.set_result(_legacy_result(res))

    def _loop(self) -> None:
        while self._running:
            batch = self._drain()
            if not batch:
                continue
            # alternating runs of queries and mutations: each query run is
            # one engine call at the epoch of its stream position; each
            # mutation run is one prepared group, prepared while the run
            # before it is served and published as one epoch
            runs: list[tuple[bool, list]] = []
            for item in batch:
                is_mut = isinstance(item, Mutation)
                if runs and runs[-1][0] == is_mut:
                    runs[-1][1].append(item)
                else:
                    runs.append((is_mut, [item]))
            prepared = None
            for i, (is_mut, items) in enumerate(runs):
                if is_mut:
                    self._publish_run(items, prepared)
                    prepared = None
                    continue
                if i + 1 < len(runs) and runs[i + 1][0]:
                    prepared = self._prepare_ahead(runs[i + 1][1])
                t0 = self.clock()
                self._serve(items)
                self._segment_span = (t0, self.clock())


# ---------------------------------------------------------------------------
# demo / load generator
# ---------------------------------------------------------------------------


def make_traffic(space_lo, space_hi, datasets, n_requests: int,
                 seed: int = 0, mutate_every: int = 0):
    """A mixed stream of (op, payload) requests of twelve kinds: the nine
    serving ops and three pipelines (top-k IA -> RangeP inside the
    winners, ApproHaus -> NNP inside the winners, and top-k IA ->
    topk_overlap re-rank).  Payloads (signatures included) are built here,
    on the host, as a client would send ready-made queries, inside the
    repository's grid bounds ``space_lo``, ``space_hi`` (tensors or float
    tuples).  The same seed gives the same stream as the JAX package's
    ``make_traffic``.

    ``mutate_every > 0`` makes every mutate_every-th position an ingest,
    delete or replace, in turn, with ids that stay valid wherever the
    stream drains: deletes take each id of [0, n_ds // 4) at most once,
    replaces rotate over [n_ds // 4, n_ds // 2), ingests are jittered
    copies (landing in freed or new slots), and point queries name ids of
    [n_ds // 4, n_ds) only."""
    rng = np.random.default_rng(seed)
    n_ds = len(datasets)
    lo_g = torch.as_tensor(space_lo, dtype=torch.float32).cpu()
    hi_g = torch.as_tensor(space_hi, dtype=torch.float32).cpu()
    eps = float(zorder.default_epsilon(lo_g, hi_g, 5))
    del_pool = list(range(n_ds // 4)) if mutate_every else []
    rep_pool = list(range(n_ds // 4, n_ds // 2)) if mutate_every else []

    def q_id():
        # with a mutation lane, never an id that may be deleted
        if mutate_every and n_ds // 4 < n_ds:
            return int(rng.integers(n_ds // 4, n_ds))
        return int(rng.integers(n_ds))

    def jittered():
        base = datasets[int(rng.integers(n_ds))]
        return (base + rng.normal(0, 0.5, base.shape)).astype(np.float32)

    def signature(q):
        pts = torch.from_numpy(np.asarray(q, np.float32))[None]
        ok = torch.ones(pts.shape[:2], dtype=torch.bool)
        return zorder.signature(pts, ok, lo_g, hi_g, 5)[0].numpy().astype(
            np.uint32)

    out = []
    n_mut = 0
    for i in range(n_requests):
        if mutate_every and i and i % mutate_every == 0:
            kind = n_mut % 3
            n_mut += 1
            if kind == 1 and del_pool:
                out.append(("delete", dict(ds_id=del_pool.pop(0))))
            elif kind == 2 and rep_pool:
                sid = rep_pool[n_mut % len(rep_pool)]
                out.append(("replace", dict(ds_id=sid, points=jittered())))
            else:
                out.append(("ingest", dict(points=jittered())))
            continue
        c = rng.uniform(20, 80, 2).astype(np.float32)
        lo, hi = c - 2.0, c + 2.0
        kind = i % 12
        if kind == 0:
            out.append(("range_search", dict(r_lo=lo, r_hi=hi)))
        elif kind == 1:
            out.append(("topk_ia", dict(q_lo=lo, q_hi=hi, k=5)))
        elif kind == 2:
            q = datasets[int(rng.integers(n_ds))]
            out.append(("topk_gbo", dict(q_sig=signature(q), k=5)))
        elif kind == 3:
            q = datasets[int(rng.integers(n_ds))][:64]
            out.append(("topk_hausdorff_approx", dict(q=q, k=5, eps=eps)))
        elif kind == 4:
            q = datasets[int(rng.integers(n_ds))][:64]
            out.append(("topk_hausdorff", dict(q=q, k=5)))
        elif kind == 5:
            out.append(("range_points", dict(ds_id=q_id(), r_lo=lo,
                                             r_hi=hi)))
        elif kind == 6:
            q = datasets[int(rng.integers(n_ds))][:64]
            out.append(("nnp", dict(ds_id=q_id(), q=q)))
        elif kind == 7:
            # dataset -> point: top-3 IA datasets, then RangeP inside each
            # winner (the ids never leave the device)
            wide_lo, wide_hi = c - 10.0, c + 10.0
            out.append(("pipeline", dict(
                dataset=dict(op="topk_ia", r_lo=wide_lo, r_hi=wide_hi, k=3),
                point=dict(op="range_points", r_lo=lo, r_hi=hi))))
        elif kind == 8:
            q = datasets[int(rng.integers(n_ds))][:32]
            out.append(("pipeline", dict(
                dataset=dict(op="topk_hausdorff_approx", q=q, k=3, eps=eps),
                point=dict(op="nnp", q=q))))
        elif kind == 9:
            q = datasets[int(rng.integers(n_ds))][:64]
            out.append(("topk_overlap", dict(q=q, k=5)))
        elif kind == 10:
            q = datasets[int(rng.integers(n_ds))][:64]
            out.append(("topk_coverage", dict(q=q, k=5)))
        else:
            # dataset -> dataset: top-5 IA winners re-ranked by grid-cell
            # overlap with the query set (the id handoff on the device)
            q = datasets[int(rng.integers(n_ds))][:64]
            wide_lo, wide_hi = c - 10.0, c + 10.0
            out.append(("pipeline", dict(
                dataset=dict(op="topk_ia", r_lo=wide_lo, r_hi=wide_hi, k=5),
                point=dict(op="topk_overlap", q=q, k=3))))
    return out


def main(argv=None):
    from repro_torch.core.build import build_repository
    from repro_torch.data import synthetic
    from repro_torch.engine.live import LiveRepository
    from repro_torch.engine.sharded import data_mesh
    from repro_torch.launch.mesh import make_serving_mesh

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--datasets", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--static-window", action="store_true",
                    help="use the fixed max-wait batching window instead "
                         "of the queue-depth-driven adaptive policy")
    ap.add_argument("--device", default=None,
                    help="device to serve from (default: cuda, which must "
                         "be present; 'cpu' runs the plain PyTorch path)")
    ap.add_argument("--sharded", action="store_true",
                    help="serve from a ShardedQueryEngine: the resident "
                         "repository split over a 1-D data mesh, one shard "
                         "per visible card")
    ap.add_argument("--replicas", type=int, default=0, metavar="R",
                    help="serve from a ReplicatedQueryEngine over an R x D "
                         "(replica x data) mesh: each drain's rows split "
                         "over the R groups")
    ap.add_argument("--data-shards", type=int, default=None, metavar="D",
                    help="data shards of the mesh (per replica group); "
                         "default: the visible cards (/ R), or "
                         f"{CPU_SHARDS} with --device cpu")
    ap.add_argument("--live", action="store_true",
                    help="serve from a mutable LiveRepository and open the "
                         "mutation lane")
    ap.add_argument("--mutate-every", type=int, default=0, metavar="N",
                    help="with --live: make every N-th request of the "
                         "measured stream an ingest/delete/replace "
                         "mutation (0 = queries only)")
    args = ap.parse_args(argv)
    on_mesh = args.sharded or args.replicas or args.data_shards is not None
    if args.mutate_every and not args.live:
        ap.error("--mutate-every requires --live")
    dev = resolve_device(args.device)
    mesh = None
    if on_mesh:
        n_rep = max(args.replicas, 1)
        pool = None                     # the visible cards
        if dev.type != "cuda":
            pool = [dev] * (n_rep * (args.data_shards or CPU_SHARDS))
        if args.replicas:
            mesh = make_serving_mesh(n_rep, args.data_shards, pool)
        else:
            mesh = data_mesh(args.data_shards, pool)

    lake = synthetic.trajectory_repository(args.datasets, seed=0)
    live = None
    if args.live:
        live = LiveRepository(lake, leaf_capacity=16, theta=5, mesh=mesh,
                              device=dev)
        engine = live.engine
        space = live.geometry.space_lo, live.geometry.space_hi
        print(f"[serve_search] live repository: {live.n_slots} slots "
              f"({len(live.live_ids)} live), mutation lane open")
    else:
        repo, _ = build_repository(lake, leaf_capacity=16, theta=5,
                                   device=dev)
        engine = QueryEngine(repo, mesh=mesh)
        space = repo.space_lo, repo.space_hi
    if mesh is not None:
        d = engine.dispatch
        print(f"[serve_search] {d.name} engine: "
              f"{getattr(d, 'n_replicas', 1)} replica group(s) x "
              f"{d.n_shards} data shard(s) of {d.shard_slots} dataset "
              f"slots on {[str(x) for x in mesh.flat]}")
    server = SearchServer(engine, live=live, max_batch=args.max_batch,
                          max_wait_ms=args.max_wait_ms,
                          adaptive=not args.static_window, device=dev)

    # warm-up: the query traffic once, queued before the dispatcher starts
    # so the warm drains are as deep as the measured ones (queries only:
    # the warm-up must not spend the stream's one-shot deletes)
    warm = [Request(op, _to_query(op, p))
            for op, p in make_traffic(*space, lake, args.requests)]
    for req in warm:
        server._queue.put(req)
    server.start()
    try:
        for req in warm:
            req.future.result(timeout=600)
        if live is not None and args.mutate_every:
            # warm the mutation path: an ingest (which may grow the tier),
            # a replace, a delete, then coalesced groups of 2 and 4 (the
            # publish buckets); every probe slot is deleted again, so the
            # measured stream starts from the live set it expects
            probe = (lake[0] + np.float32(0.25)).astype(np.float32)
            wid = live.ingest(probe)
            live.replace(wid, probe)
            live.delete(wid)
            for width in (2, 4):
                sids = live.publish_group(live.prepare_group(
                    [("ingest", None, probe + np.float32(i))
                     for i in range(width)]))
                live.publish_group(live.prepare_group(
                    [("delete", sid, None) for sid in sids]))
            live.bytes_uploaded = 0        # report the measured window only
        # the result cache is dropped, so the measured requests dispatch
        engine._result_cache.clear()
        server.stats = ServerStats()       # report the measured window only
        traffic = make_traffic(*space, lake, args.requests,
                               mutate_every=args.mutate_every)
        h0 = engine.stats.result_cache_hits
        m0 = engine.stats.result_cache_misses
        d0 = engine.stats.dispatches
        i0 = engine.stats.epoch_invalidations
        p0 = len(engine.stats.publish_seconds)
        mc0 = engine.stats.mutations_coalesced
        ov0 = engine.stats.prepare_overlap_seconds
        t0 = time.perf_counter()
        futures = [(server.submit_mutation(op, **p) if op in MUTATION_OPS
                    else server.submit(op, **p)) for op, p in traffic]
        for f in futures:
            f.result(timeout=600)
        dt = time.perf_counter() - t0
    finally:
        server.stop()

    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else str(dev))
    print(f"[serve_search] device: {where}")
    print(f"[serve_search] {args.requests} mixed requests in {dt*1e3:.1f} ms "
          f"-> {args.requests/dt:.1f} QPS")
    print(f"[serve_search] dispatch groups: {server.stats.batches}, "
          f"mean requests/group {server.stats.mean_batch:.1f}, "
          f"mean latency {server.stats.mean_latency_ms:.1f} ms "
          f"(p50 {server.stats.p50_ms:.1f} / p99 {server.stats.p99_ms:.1f}, "
          f"{'adaptive' if server.adaptive else 'static'} window)")
    print(f"[serve_search] engine dispatches: {engine.stats.dispatches - d0}, "
          f"result cache hits/misses: "
          f"{engine.stats.result_cache_hits - h0}/"
          f"{engine.stats.result_cache_misses - m0}, pipelines: "
          f"{engine.stats.pipeline_stage1}")
    if live is not None:
        st = engine.stats
        n_pub = len(st.publish_seconds) - p0
        print(f"[serve_search] mutation lane: {server.stats.mutations} "
              f"applied, mean {server.stats.mean_mutation_ms:.1f} ms; "
              f"epoch {live.epoch} (layout "
              f"{live.engine.dispatch.repo_epoch}), "
              f"{engine.stats.epoch_invalidations - i0} cached rows retired, "
              f"{live.bytes_uploaded} bytes uploaded, "
              f"{live.n_slots} slots ({len(live.live_ids)} live)")
        print(f"[serve_search] publish pipeline: {n_pub} publishes "
              f"(p50 {st.publish_percentile_ms(50, since=p0):.1f} / p99 "
              f"{st.publish_percentile_ms(99, since=p0):.1f} ms), "
              f"{engine.stats.mutations_coalesced - mc0} coalesced, "
              f"{engine.stats.prepare_overlap_seconds - ov0:.3f} s of "
              f"prepare host time under serving")
    return server.stats


if __name__ == "__main__":
    main()

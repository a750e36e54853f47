"""Search serving front end: a request queue and continuous micro-batching.

    PYTHONPATH=src python -m repro_torch.launch.serve_search [--requests 256]
    PYTHONPATH=src python -m repro_torch.launch.serve_search --device cpu

Counterpart of ``repro.launch.serve_search`` for one device.  Clients
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

The server runs on the device its engine lives on, ``cuda`` unless it is
given ``device="cpu"``.  Not ported yet: the live repository's mutation
lane (``live=``, ``submit_mutation``, ``make_traffic(mutate_every>0)``,
``--live``, ``--mutate-every``; ROADMAP.md queue 1 item 11) and the
multi-device engines (``--sharded``, ``--replicas``, ``--data-shards``;
item 12).  Each raises ``NotImplementedError`` naming its item.
"""
from __future__ import annotations

import argparse
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.core import zorder
from repro_torch.core.repo_index import Repository
from repro_torch.device import resolve_device
from repro_torch.engine import Pipeline, Query, QueryEngine, SearchResult
from repro_torch.engine import plan as plan_lib

# ops the submit() shim wraps into a Query / Pipeline; any mix of them may
# share one queue drain
OPS = (
    "range_search", "topk_ia", "topk_gbo", "topk_hausdorff_approx",
    "topk_hausdorff", "range_points", "nnp", "topk_overlap",
    "topk_coverage", "pipeline",
)

LIVE_ITEM = "ROADMAP.md queue 1 item 11"
MULTI_DEVICE_ITEM = "ROADMAP.md queue 1 item 12"


def _live_lane(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the live repository's mutation lane is not ported to "
        f"repro_torch yet ({LIVE_ITEM})")


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
class ServerStats:
    requests: int = 0
    batches: int = 0                        # dispatch groups planned
    batch_size_sum: int = 0
    latency_sum: float = 0.0
    latencies: list = field(default_factory=list)   # per-request seconds
    op_ewma: dict = field(default_factory=dict)     # op -> EWMA latency s

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
        if live is not None:
            raise _live_lane("SearchServer(live=...)")
        if engine is None:
            raise ValueError("SearchServer needs an engine")
        dev = resolve_device(device)
        if engine.device.type != dev.type:
            raise ValueError(f"SearchServer on {dev} was given an engine on "
                             f"{engine.device}")
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.adaptive = adaptive
        self.clock = clock
        self.stats = ServerStats()
        self._queue: "queue.Queue[Request | None]" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._running = False

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
        raise _live_lane("submit_mutation")

    def start(self) -> "SearchServer":
        self._running = True
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        self._queue.put(None)          # wake the dispatcher
        self._thread.join(timeout=30)
        # fail anything still queued, so no client Future waits forever
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None and not req.future.done():
                req.future.set_exception(
                    RuntimeError("server stopped before request ran"))

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

    def _drain(self) -> list[Request]:
        """Block for the first request, then fill the batch: greedy takes,
        renewing straggler windows and a depth-scaled bound when adaptive;
        a fixed max_wait deadline up to max_batch when static."""
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
                batch.append(req)
                # every arrival renews the straggler budget
                waited = False
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
            batch.append(req)
        return batch

    def _serve(self, batch: list[Request]) -> None:
        """One declarative engine call for a drain; the planner groups
        compatible rows into shared dispatches."""
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
            if batch:
                self._serve(batch)


# ---------------------------------------------------------------------------
# demo / load generator
# ---------------------------------------------------------------------------


def make_traffic(repo: Repository, datasets, n_requests: int, seed: int = 0,
                 mutate_every: int = 0):
    """A mixed stream of (op, payload) requests of twelve kinds: the nine
    serving ops and three pipelines (top-k IA -> RangeP inside the
    winners, ApproHaus -> NNP inside the winners, and top-k IA ->
    topk_overlap re-rank).  Payloads (signatures included) are built here,
    on the host, as a client would send ready-made queries.  The same seed
    gives the same stream as the JAX package's ``make_traffic``."""
    if mutate_every:
        raise _live_lane("make_traffic(mutate_every>0)")
    rng = np.random.default_rng(seed)
    n_ds = len(datasets)
    lo_g, hi_g = repo.space_lo.cpu(), repo.space_hi.cpu()
    eps = float(zorder.default_epsilon(lo_g, hi_g, 5))

    def signature(q):
        pts = torch.from_numpy(np.asarray(q, np.float32))[None]
        ok = torch.ones(pts.shape[:2], dtype=torch.bool)
        return zorder.signature(pts, ok, lo_g, hi_g, 5)[0].numpy().astype(
            np.uint32)

    out = []
    for i in range(n_requests):
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
            out.append(("range_points", dict(
                ds_id=int(rng.integers(n_ds)), r_lo=lo, r_hi=hi)))
        elif kind == 6:
            q = datasets[int(rng.integers(n_ds))][:64]
            out.append(("nnp", dict(ds_id=int(rng.integers(n_ds)), q=q)))
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
                    help=f"not ported ({MULTI_DEVICE_ITEM})")
    ap.add_argument("--replicas", type=int, default=0, metavar="R",
                    help=f"not ported ({MULTI_DEVICE_ITEM})")
    ap.add_argument("--data-shards", type=int, default=None, metavar="D",
                    help=f"not ported ({MULTI_DEVICE_ITEM})")
    ap.add_argument("--live", action="store_true",
                    help=f"not ported ({LIVE_ITEM})")
    ap.add_argument("--mutate-every", type=int, default=0, metavar="N",
                    help=f"not ported ({LIVE_ITEM})")
    args = ap.parse_args(argv)
    if args.live or args.mutate_every:
        raise _live_lane("--live / --mutate-every")
    if args.sharded or args.replicas or args.data_shards is not None:
        raise NotImplementedError(
            f"--sharded / --replicas / --data-shards: multi-device engines "
            f"are not ported to repro_torch yet ({MULTI_DEVICE_ITEM})")
    dev = resolve_device(args.device)

    lake = synthetic.trajectory_repository(args.datasets, seed=0)
    repo, _ = build_repository(lake, leaf_capacity=16, theta=5, device=dev)
    engine = QueryEngine(repo)
    server = SearchServer(engine, max_batch=args.max_batch,
                          max_wait_ms=args.max_wait_ms,
                          adaptive=not args.static_window, device=dev)

    # warm-up: the traffic once, queued before the dispatcher starts so
    # the warm drains are as deep as the measured ones; then the result
    # cache is dropped, so the measured requests run their dispatches
    warm = [Request(op, _to_query(op, p))
            for op, p in make_traffic(repo, lake, args.requests)]
    for req in warm:
        server._queue.put(req)
    server.start()
    try:
        for req in warm:
            req.future.result(timeout=600)
        engine._result_cache.clear()
        server.stats = ServerStats()       # report the measured window only
        traffic = make_traffic(repo, lake, args.requests)
        h0 = engine.stats.result_cache_hits
        m0 = engine.stats.result_cache_misses
        d0 = engine.stats.dispatches
        t0 = time.perf_counter()
        futures = [server.submit(op, **p) for op, p in traffic]
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
    return server.stats


if __name__ == "__main__":
    main()

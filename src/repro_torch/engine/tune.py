"""One-time measured tuning of the engine's launch shapes and chunk.

Counterpart of ``repro.engine.tune``.  :func:`tune_engine` measures at THIS
engine's repository shapes:

* **launch shapes** — for each swept kernel, the shapes its source is
  built at (``autotune.VARIANTS``) are timed through
  :func:`repro_torch.kernels.autotune.ensure_tuned`, each sample a CUDA
  graph of :data:`GRAPH_LAUNCHES` launches replayed, and the fastest is
  installed in the process-global table where its gain over the default
  shape, round by round, exceeds the spread of those gains
  (``autotune.pick``; else the default is installed): ``bound_grid`` at
  the engine's query-batch buckets (8 and 32 by default),
  ``min_sq_dists`` at the
  repository's point capacity (one query set against a chunk of 32, as
  the ExactHaus oracle launches it), and ``hausdorff_grid`` through
  ``ops.directed_hausdorff_lanes`` on a real phase-2 chunk (the first
  ``default_chunk`` ascending-LB candidates of a batch of repository
  sets), which is what the main path launches.
* **bitwise gate** — a candidate is admitted only if its output at the
  probe is bitwise equal to the default shape's output; the default is
  always admitted, so a sweep is never empty.  A tuned table can only
  change speed.
* **ExactHaus chunk** — the refinement chunk is swept through real
  ``engine.search`` calls (result cache off for the sweep, restored in a
  ``finally``), each call timed by ``EngineStats.op_seconds``, and the
  winner becomes ``engine.default_chunk``, by the same rule against the
  engine's chunk before the sweep.  Chunk never changes vals or ids.  The
  planner's window around a group covers the device work, because an
  ExactHaus group reads its counters to the host inside it.

On the CPU the plain versions have no launch shape: the kernel sweeps
report ``plain_only`` and install nothing, and the chunk sweep still runs.
On a mesh (sharded or replicated engine) the kernel sweeps probe the first
shard, at the per-shard shapes its kernels launch at, as the JAX tuner
probes the engine's placed repository; the table is keyed on the card's
name, so every shard on a card of that name reads the entries, and the
chunk sweep runs through the mesh engine's own ``search()``.
"""
from __future__ import annotations

import torch

from repro_torch.core import search
from repro_torch.core.index import DatasetIndex
from repro_torch.engine.query import Query
from repro_torch.kernels import autotune, hausdorff, ops
from repro_torch.kernels.ref import BIG

__all__ = ["tune_engine"]

#: the ExactHaus oracle's chunk: min_sq_dists's probe pairs
ORACLE_CHUNK = 32
#: launches one timed sample of a kernel sweep replays: a sample of a
#: 0.05 ms kernel then lasts milliseconds, far above the host clock's
#: resolution and the cost of one replay and synchronize
GRAPH_LAUNCHES = 50


def _bitwise_equal(a, b) -> bool:
    """Exact bitwise equality of two tensors or tuples of tensors (NaN-safe:
    the bytes are compared)."""
    la = list(a) if isinstance(a, (tuple, list)) else [a]
    lb = list(b) if isinstance(b, (tuple, list)) else [b]
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        xa, ya = x.detach().cpu().numpy(), y.detach().cpu().numpy()
        if xa.shape != ya.shape or xa.dtype != ya.dtype:
            return False
        if xa.tobytes() != ya.tobytes():
            return False
    return True


def _host(out):
    if isinstance(out, (tuple, list)):
        return tuple(x.detach().cpu() for x in out)
    return out.detach().cpu()


def _gate(run, candidates, default_cfg):
    """Keep the candidates whose output is bitwise the default shape's at
    the probe; the default always stays.  Returns (allowed, n_rejected)."""
    reference = _host(run(default_cfg))
    allowed, rejected = [], 0
    for cfg in candidates:
        if _bitwise_equal(run(cfg), reference):
            allowed.append(cfg)
        else:
            rejected += 1
    if default_cfg not in allowed:
        allowed.insert(0, default_cfg)
    return allowed, rejected


def _graph(run, cfg, device, n: int):
    """A CUDA graph of ``n`` back-to-back ``run(cfg)`` launches, captured
    on a side stream.  Replayed, the launches run free of the host's
    per-call cost (the wrapper's checks, the ctypes call), which is tens
    of microseconds and would otherwise set the time of a small kernel.
    Capture is begun and ended by hand: ``torch.cuda.graph`` would empty
    the allocator's cache."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        run(cfg)
        graph.capture_begin()
        for _ in range(n):
            run(cfg)
        graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(side)
    return graph


def _sweep(op, shape, device, run, *, repeats, force):
    """Gate and time every variant of ``op`` at one probe; a report row
    whether the decision was fresh or cached.  A timed sample replays
    :data:`GRAPH_LAUNCHES` launches from one CUDA graph; the report gives
    the time and spread of one launch."""
    row = {"shape": tuple(int(s) for s in shape),
           "key": list(autotune.table_key(op, shape, device))}
    if device.type != "cuda":
        # the plain version has no launch shape: nothing to tune
        row.update(plain_only=True, cached=False, timings_s=None,
                   candidates_rejected_bitwise=0)
        return row
    allowed, rejected = _gate(run, autotune.VARIANTS[op],
                              autotune.DEFAULTS[op])
    graphs = {}

    def runner(cfg):
        if cfg not in graphs:
            graphs[cfg] = _graph(run, cfg, device, GRAPH_LAUNCHES)
        graphs[cfg].replay()
        torch.cuda.synchronize(device)

    try:
        chosen, info = autotune.ensure_tuned(
            op, shape, device, runner, allowed, repeats=repeats,
            force=force)
    finally:
        graphs.clear()
    per = (None if info is None else
           {k: [t / GRAPH_LAUNCHES for t in info[k]]
            for k in ("timings_s", "spreads_s")})
    row.update(
        plain_only=False, chosen=chosen.fields(),
        variant=autotune.variant(op, chosen),
        candidates=[c.fields() for c in allowed],
        candidates_rejected_bitwise=rejected,
        timings_s=None if per is None else per["timings_s"],
        spreads_s=None if per is None else per["spreads_s"],
        cached=info is None)
    return row


def _probe_repo(engine):
    """The repository the kernel sweeps probe: the engine's own, or on a
    mesh its first shard."""
    if engine.repo is not None:
        return engine.repo
    return engine.dispatch.layouts[0].shards[0]


def _probe_sets(repo, n: int):
    """n valid point sets cycled from the repository (host arrays)."""
    pts = repo.ds_index.points.cpu().numpy()
    val = repo.ds_index.valid.cpu().numpy()
    live = [i for i in range(pts.shape[0]) if val[i].any()]
    if not live:
        raise ValueError("tune: the repository holds no dataset to probe")
    return [pts[live[i % len(live)]][val[live[i % len(live)]]]
            for i in range(n)]


def _index_rows(q_batch: DatasetIndex) -> list:
    return [DatasetIndex(*[x[i] for x in q_batch])
            for i in range(q_batch.points.shape[0])]


def tune_engine(
    engine,
    *,
    batches=(8, 32),
    chunks=(16, 32, 64),
    chunk_batch: int = 8,
    repeats: int = 5,
    force: bool = False,
) -> dict:
    """Measure and install the launch shapes and the ExactHaus chunk for
    ``engine``'s repository (see the module docstring).  Returns a report
    dict; the tuned shapes land in the process-global table (bumping its
    epoch) and the winning chunk in ``engine.default_chunk``."""
    repo = _probe_repo(engine)
    ds = repo.ds_index
    dev = ds.points.device
    report: dict = {"device": list(autotune.device_id(dev))}
    S = int(ds.radii.shape[0])
    k = max(1, min(4, int(repo.ds_valid.sum())))

    # -- fused bound grid: one probe per query-batch bucket ---------------
    max_level = min(ds.depth, 3)
    n_nodes = ds.level_slice(max_level).stop
    levels = tuple((ds.level_slice(l).start, ds.level_slice(l).stop)
                   for l in range(max_level + 1))
    od = ds.centers[:, :n_nodes].contiguous()
    rd = ds.radii[:, :n_nodes].contiguous()
    dok = (ds.counts[:, :n_nodes] > 0).contiguous()
    report["bound_grid"] = {}
    for b in batches:
        B = engine.bucket_for(int(b))
        sel = torch.arange(B, device=dev) % S
        oq, rq, qok = od[sel], rd[sel], dok[sel]

        def run_bg(cfg, oq=oq, rq=rq, qok=qok):
            return ops.bound_grid(oq, rq, qok, od, rd, dok, levels=levels,
                                  config=cfg)

        report["bound_grid"][str(B)] = _sweep(
            "bound_grid", (B, S), dev, run_bg, repeats=repeats, force=force)

    # -- the oracle's pair kernel at the repository's point capacity ------
    n_pad = int(ds.points.shape[-2])
    live_slots = torch.nonzero(repo.ds_valid).flatten()
    sel = live_slots[torch.arange(ORACLE_CHUNK, device=dev)
                     % live_slots.numel()]
    q0, qv0 = ds.points[sel[0]], ds.valid[sel[0]]
    dsp, dsv = ds.points[sel], ds.valid[sel]

    def run_msd(cfg):
        return ops.min_sq_dists_pairs(q0, dsp, qv0, dsv, config=cfg)

    report["min_sq_dists"] = _sweep(
        "min_sq_dists", (n_pad, n_pad), dev, run_msd, repeats=repeats,
        force=force)

    # -- phase 2's lanes kernel on a real chunk ---------------------------
    q_batch = engine.build_queries(
        _probe_sets(repo, engine.bucket_for(max(batches))))
    q_batch = DatasetIndex(*[x.to(dev) for x in q_batch])
    LB, _, cand, _, _ = search._hausdorff_bound_phases(repo, q_batch, k, 3)
    order = torch.sort(torch.where(cand, LB, BIG), dim=-1,
                       stable=True).indices
    ids = order[:, :engine.default_chunk].contiguous()
    live = torch.gather(cand, 1, ids)
    q_c, n_q = search.phase2_query_rows(q_batch)
    extent = hausdorff.valid_extent(ds.valid)

    def run_lanes(cfg):
        return ops.directed_hausdorff_lanes(q_c, n_q, ds.points, ds.valid,
                                            extent, ids, live, config=cfg)

    report["hausdorff_grid"] = _sweep(
        "hausdorff_grid", (n_pad, n_pad), dev, run_lanes, repeats=repeats,
        force=force)
    del LB, cand, order

    # -- ExactHaus refinement chunk, timed through EngineStats ------------
    rows = _index_rows(engine.build_queries(_probe_sets(repo, chunk_batch)))
    saved_cache = engine.result_cache_size
    engine.result_cache_size = 0      # repeats must dispatch, not memoize
    try:
        batches = [[Query(op="topk_hausdorff", q_index=row, k=k,
                          chunk=int(chunk)) for row in rows]
                   for chunk in chunks]
        for queries in batches:
            engine.search(queries)                # warm-up
        # rounds interleave the chunks, as ensure_tuned's do, so that
        # autotune.pick can judge each against the default round by round
        samples = [[] for _ in chunks]
        for _ in range(repeats):
            for queries, times in zip(batches, samples):
                before = engine.stats.op_seconds.get("topk_hausdorff", 0.0)
                engine.search(queries)
                times.append(
                    engine.stats.op_seconds["topk_hausdorff"] - before)
    finally:
        engine.result_cache_size = saved_cache
    chunks = [int(c) for c in chunks]
    default = (chunks.index(engine.default_chunk)
               if engine.default_chunk in chunks else None)
    best, timings, spreads = autotune.pick(samples, default)
    engine.default_chunk = chunks[best]
    report["chunk"] = {
        "candidates": chunks,
        "timings_s": timings,
        "spreads_s": spreads,
        "samples_s": samples,
        "chosen": engine.default_chunk,
    }
    report["table"] = autotune.report()
    return report

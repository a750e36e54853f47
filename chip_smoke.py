#!/usr/bin/env python3
"""Drive the PyTorch port's search paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

It takes no options: the sizes are fixed at T-Drive's scale, so every
kernel line it prints is at the main paths' shapes.

Phases, each of which must pass (any failure raises and exits non-zero):

  1. the card's name and power limit, and the build of the CUDA kernels
     from ``src/repro_torch/csrc`` (one nvcc per source, in parallel);
  2. the repository build on the card: 10,357 random-walk trajectories of
     100-2,800 points (~15 M points, T-Drive's scale), outlier removal on;
  3. the three ExactHaus kernels against their plain PyTorch versions on the
     card, at the main path's shapes, bitwise, with CUDA-graph times
     (``hausdorff_grid`` on the first phase-2 chunk, every lane live;
     ``min_sq_dists`` on the oracle's first chunk of 32 candidates, and
     on one pair of it);
  4. the ExactHaus path: ``QueryEngine.search`` on 32 held-out
     trajectories, ``Query(op="topk_hausdorff", k=10)``, one warm-up pass,
     which keeps the operands of every ``hausdorff_grid`` launch, then
     timed passes, with the launch counters of both path kernels read
     around one pass, then one more pass under ``torch.profiler`` for the
     device time of each kernel and the device's idle share; then every
     kept launch replayed under CUDA events (``ms_per_search``), each
     output held bitwise against the plain version, beside the least time
     of its live, valid work (``bound_ms_per_search``);
  5. the ExactHaus oracle ``topk_hausdorff_host`` (the third kernel) on 4 of
     those queries, bitwise against the engine, with one ``min_sq_dists``
     launch per evaluated chunk and no ``hausdorff_grid`` launch (or the
     phase fails), and a small repository checked against a numpy brute
     force;
  6. the dataset -> point path on the same repository: one mixed
     ``search()`` batch of 32 queries each of RangeS, top-k IA, top-k GBO
     and ApproHaus, 8 ``Pipeline(topk_hausdorff -> nnp)`` and 8
     ``Pipeline(topk_gbo -> range_points)``; one warm-up pass, which keeps
     the operands the path hands to ``set_intersect`` and
     ``bound_row_ub``, then timed passes with the launch counters read
     around one pass (one ``set_intersect`` and one ``bound_row_ub``
     launch, and no ``bound_matrices`` launch, or the phase fails);
  7. the dataset and point kernels against their plain versions:
     ``set_intersect`` and ``bound_row_ub`` on the very operands the path
     gave them (bucket padding included), the ``bound_matrices`` matrix
     form, with lb and with ub only, on the same frontiers, and
     ``nn_distance`` on the 80 pairs the next phase's NNP oracle check
     gives it, and on one of them;
  8. its gates: RangeS, IA and GBO against a numpy brute force over every
     dataset, RangeP masks against a numpy brute force, ApproHaus bitwise
     against the single-query op and within 2 eps_eff of the exact
     Hausdorff distance, and every pipeline NNP row against the unpruned
     ``point_search.nnp_batched`` over all 80 pairs (one ``nn_distance``
     launch, or the phase fails), one pair also against numpy;
  9. the join batch on the same repository: one ``search()`` of 32
     queries each of ``topk_overlap`` and ``topk_coverage`` (k = 10), 8
     ``Pipeline(topk_ia -> topk_overlap)``, 8 ``Pipeline(topk_hausdorff ->
     topk_coverage)`` and 8 ``Pipeline(topk_gbo -> range_points)``; a
     warm-up pass that keeps every ``set_intersect`` call's operands, a
     pass with the launch counters read around it, two more timed passes
     (latency: the median of the 3) and one under the profiler (idle
     share); its gates: every joinable query equal to a vectorised numpy
     brute force over every dataset at the fine grid, two of each mode
     also to ``topk_join_host``, each dataset -> dataset pipeline to its
     host re-rank, the GBO pipelines to the mixed batch's;
 10. ``set_intersect`` at each shape the join batch launched it (the slot
     bounds, the upper tree's node bounds, the refine chunks of each
     mode, and the GBO group), every kept call bitwise against the plain
     version, the first of each kind replayed in a CUDA graph and all of
     a kind together (``ms_per_search``);
 11. serving: ``SearchServer`` over the same engine, a warm-up burst and
     a measured burst of ``make_traffic(*bounds, datasets, 256, seed=0)`` at
     max_batch 64 (QPS, p50/p99, requests per dispatch group), every
     future resolved within a timeout and each response bitwise equal to
     ``engine.search`` of its item (a joinable query's counters depend on
     the batch it shared, so there its vals and ids);
 12. the live repository: ``LiveRepository`` over the same 10,357
     trajectories on the card (``init_live``, every row a batch-of-1
     build; its time beside phase 2's batched build, and the count of
     slots that differ bitwise from that build, which is information),
     64 rows built through the row stages' CUDA graphs held bitwise
     against the same stages run eagerly (the time per row of each),
     then a served stream of ``make_traffic(..., 128, seed=0,
     mutate_every=16)`` at max_batch 64 after a warm-up of its queries
     (QPS, query p50/p99, publish p50/p99, mutation latency, coalesced
     mutations, invalidations, peak memory, launches per kernel); gates:
     every future resolves within a timeout, each mutation returns the slot
     the free-list rule predicts, the uploaded bytes are one 4,096 x 9
     payload per ingest or replace, the live repository is bitwise equal
     to ``frozen_repository()``, and a batch of every op of ``OPS`` on the
     live engine is bitwise equal (vals, ids, masks) to a cold engine over
     that build;
 13. tier growth: 12 trajectories in a 16-slot tier, six ingests past it,
     a delete and a replace; the slot count doubles, the layout epoch
     reads 1, and the repository and the every-op batch are bitwise equal
     to the cold build;
 14. multi-device dispatch on the phase-2 repository, every shard on the
     one card (its device list printed first; so no multi-card speed is
     measured): ExactHaus on a 4-shard and on a 3-shard (slot-padded)
     ``data_mesh``, the mixed and join batches on the 4-shard mesh, the
     ExactHaus and mixed batches and a batch of 1 on a (2, 2)
     ``replica_mesh``, each through the path's ``search()`` as in phases
     4, 6 and 9 (a warm-up pass keeping every kernel launch's operands, a
     pass with the launch counters read around it, timed passes and one
     under the profiler; latency, busy ms and peak memory printed beside
     the local phase's, per-shard resident bytes beside total / N); gates:
     results bitwise equal to the local phase's (vals, ids, masks),
     ExactHaus's bound counters equal and ``evaluated <=
     candidates_after_bounds``, one ``bound_grid`` launch per shard, and
     every kept launch bitwise equal to its plain version at per-shard
     shapes (a ``hausdorff_grid`` launch on the queries with a live lane);
     then a served burst over the 4-shard engine (phase 11's gates), and
     ``ring_hausdorff`` / ``ring_nn_distance`` on one dataset pair at 4
     shards, bitwise equal to ``ops.directed_hausdorff_pairs`` and
     ``ops.nn_distance_batched``, one launch per hop;
 15. the live repository on a mesh of the card: ``LiveRepository`` over
     the same 10,357 trajectories on 4 shards serving phase 12's stream
     (QPS, query and publish p50/p99 beside phase 12's, init seconds,
     per-shard resident bytes, launches over the stream); gates: every
     future resolves, every mutation returns phase 12's slot, every
     response equals phase 12's at the same stream position (ExactHaus
     and joinable by vals and ids), the payload bytes equal phase 12's,
     each shard is bitwise phase 12's final live repository split 4 ways,
     and a batch of every op is bitwise phase 12's; then phase 13's
     tier-growth set on a 3-shard (slot-padded) mesh and a (2, 2) replica
     grid: 32 slots at layout epoch 1, every shard bitwise
     ``shard_repository(build_frozen(...))``, a replace that gave new slot
     tensors to its owner shard alone, and a batch of every op bitwise a
     cold engine on the same mesh.  Every kernel launch of those batches
     is kept and held bitwise against its plain version.

The second-to-last line is the kernel table as JSON (each row's
``launches`` from the local path, ``sharded_launches`` per phase-14 path
(per search) and per phase-15 path: ``live_mesh_4`` over the stream,
``live_growth_3`` and ``live_growth_2x2`` per batch), the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's ``src/`` beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM HBM3 bandwidth (NVIDIA data sheet)
PEAK_BYTES = 3.35e12
# issue rates of the pipes the kernels use, per clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), on 132 SMs at the 1.98 GHz boost clock.  Where a rate is in
# doubt the higher one is taken, so a bound stays a least time.
SM_CLOCKS = 132 * 1.98e9
RATES = {
    # FP32 add, sub, mul, min, max: 128 results.  The kernels are built
    # with -fmad=false, so no FMA pairs two of them (the data sheet's
    # 67 TFLOP/s counts an FMA as two operations)
    "fp32": 128 * SM_CLOCKS,
    # an IEEE sqrtf takes at least one MUFU instruction: 16
    "mufu": 16 * SM_CLOCKS,
    # 32-bit population counts: 16
    "popc32": 16 * SM_CLOCKS,
}

# the main path: T-Drive's 10,357 taxis, a burst of 32 held-out queries
N_DATASETS = 10357
N_QUERIES = 32
# the dataset -> point path: pipelines of each kind, and the winners each
N_PIPELINES = 8
K = 10
THETA = 5
# the join batch's re-rank stages keep this many of their K winners
K2 = 5
# the serving phase's requests
N_REQUESTS = 256
# the live phase's served stream: requests, and a mutation every this many
LIVE_REQUESTS = 128
LIVE_EVERY = 16
# rows the graphed row build is held against the eager stages on
ROW_CHECK = 64


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*a) -> None:
    print(*a, flush=True)


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls captured in one CUDA
    graph and replayed: the launches run back to back, free of the host's
    per-call cost (the wrapper's checks, the ctypes call), which is tens of
    microseconds and would otherwise set the time of a small kernel.  The
    capture is begun and ended by hand: ``torch.cuda.graph`` would empty
    the allocator's cache, and the paths timed after this would pay to
    refill it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        fn()
        graph.capture_begin()
        for _ in range(reps):
            fn()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    ms = event_ms(graph.replay, 3, 1) / reps
    del graph
    return ms


def kernel_times(fn, reps: int):
    """A kernel's (graph-replayed ms, eager ms): the second is ``event_ms``
    over back-to-back calls from Python, the method of the earlier
    records, which for a kernel of a few microseconds times the host."""
    return graph_ms(fn, reps), event_ms(fn, reps)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.contiguous(), b.contiguous()
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def least_ms(n_bytes, n_ops):
    """The least time of some work on the card: the larger of its bytes
    over the memory rate and, for each pipe, its operations over that
    pipe's rate.  Returns (ms, decider): "bytes" or the pipe's name."""
    times = {"bytes": n_bytes / PEAK_BYTES * 1e3}
    times.update({pipe: n / RATES[pipe] * 1e3 for pipe, n in n_ops.items()})
    by = max(times, key=times.get)
    return times[by], by


def kernel_row(name, source, replaces, shapes, got, want, times, plain_ms,
               n_bytes, n_ops, *, also_equal=True):
    """One line of the kernel table; ``times`` is ``kernel_times``'s pair,
    ``n_ops`` maps each issue pipe ("fp32", "mufu", "popc32") to the
    operations the work needs on it."""
    bound, by = least_ms(n_bytes, n_ops)
    err = max_abs(got, want)
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "shapes": shapes,
        "launches": None,                  # filled from the main path's run
        "bitwise": bits_equal(got, want) and also_equal,
        # one number under both names: ``max_abs_err`` is the kernel-line
        # format's key, ``max_abs_diff`` the name PERF.md and the docs use
        "max_abs_err": err, "max_abs_diff": err,
        "ms": times[0], "eager_ms": times[1], "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": "bytes" if by == "bytes" else "operations",
        "bound_pipe": by,
        "library_ms": None,
        "bytes": n_bytes, "ops": n_ops,
    }


def bound_grid_ops(bg_in, levels):
    """The operations one ``bound_grid`` call needs on these inputs, per
    pipe.  Per level, per pair of an occupied query node and an occupied
    corpus node: 3W - 1 for cd^2, cd - rd, cd^2 + rd^2, the two row mins,
    and a root (LB).  Per occupied query node and slot with an occupied
    node at that level: max(., 0), + rq, the two level maxes, and a root
    (UB; the root commutes with the row min).  Per corpus node: rd * rd."""
    oq, _, q_ok, _, _, d_ok = bg_in
    W = oq.shape[2]
    pairs = n_rows = 0
    for a, b in levels:
        q_occ = int(q_ok[:, a:b].sum())
        pairs += q_occ * int(d_ok[:, a:b].sum())
        n_rows += q_occ * int(d_ok[:, a:b].any(dim=-1).sum())
    return {"fp32": pairs * (3 * W + 3) + 4 * n_rows + d_ok.numel(),
            "mufu": pairs + n_rows}


def row_ub_ops(oq, d_ok):
    """The operations one ``bound_row_ub`` call needs on these inputs, per
    pipe: per pair of a query node and an occupied corpus node, 3W - 1 for
    cd^2, the add of rd^2 and the row min; rd * rd per occupied corpus
    node; per row of a pair with an occupied node a root, the add of rq
    and the cap."""
    P, nq, W = oq.shape
    occ = d_ok.sum(dim=-1)
    n_rows = int((occ > 0).sum()) * nq
    return {"fp32": int(occ.sum()) * (nq * (3 * W + 1) + 1) + 2 * n_rows,
            "mufu": n_rows}


def lanes_work(args, nvalid):
    """(bytes, operations per pipe) that one ``hausdorff_lanes`` launch
    needs: its live lanes' valid (row, point) pairs at 3W FP32 operations
    each (W sub, W mul, W - 1 add, 1 min), then a root and a max per live
    lane and valid row; the live lanes' points and masks up to their
    extents, the live queries' valid rows, the ids, the mask and the
    output.  ``nvalid`` (S,) counts each slot's valid points."""
    q_c, n_q, _, _, extent, ids, live = args
    W = q_c.shape[2]
    rows = n_q[:, None].expand(ids.shape)[live].double()
    slots = ids[live]
    pairs = int((rows * nvalid[slots].double()).sum())
    n_rows = int(rows.sum())
    n_bytes = (int(extent[slots].double().sum()) * (4 * W + 1)
               + int(n_q[live.any(dim=-1)].sum()) * 4 * W
               + nbytes(ids, live) + live.numel() * 4)
    return n_bytes, {"fp32": pairs * 3 * W + n_rows, "mufu": n_rows}


def pairs_work(args, outs, *, roots):
    """(bytes, operations per pipe) of one pair-axis call, ``min_sq_dists``
    (q shared, (nq, W)) or ``nn_distance`` ((P, nq, W)): each pair's valid
    rows times its valid points at 3W FP32 operations (W sub, W mul, W - 1
    add, 1 min or compare), and with ``roots`` one root per valid row of
    each pair; the inputs and outputs once."""
    q, ds, qv, dsv = args
    W = q.shape[-1]
    n_rows = qv.sum(dim=-1, dtype=torch.int64).expand(dsv.shape[0])
    n_pts = dsv.sum(dim=-1, dtype=torch.int64)
    n_ops = {"fp32": int((n_rows * n_pts).sum()) * 3 * W}
    if roots:
        n_ops["mufu"] = int(n_rows.sum())
    return nbytes(q, ds, qv, dsv, *outs), n_ops


def nnp_check_pairs(repo, q_batch, r_nnp):
    """The (query, winner) pairs of the NNP pipelines as two (P, ...)
    index batches: pipeline i's query row against each of its winners."""
    qi = [i for i, r in enumerate(r_nnp) for _ in r.extras["ds_ids"]]
    wi = [int(w) for r in r_nnp for w in r.extras["ds_ids"]]
    check(min(wi) >= 0, "NNP pipelines: sentinel winner")
    dev = q_batch.points.device
    qi, wi = torch.tensor(qi, device=dev), torch.tensor(wi, device=dev)
    return (type(q_batch)(*[x[qi] for x in q_batch]),
            type(q_batch)(*[x[wi] for x in repo.ds_index]))


def replay_lanes(calls, nvalid, hausdorff, ops):
    """The ``hausdorff_grid`` row's per-search numbers: the operands of
    every launch of one ExactHaus ``search()`` replayed under CUDA events,
    each output held bitwise against the plain version, and the least time
    of the live, valid work of each launch, summed."""
    outs = [hausdorff.hausdorff_lanes(*a) for a in calls]
    ms = event_ms(lambda: [hausdorff.hausdorff_lanes(*a) for a in calls], 3,
                  1)
    plain_ms = 0.0
    for i, (args, got) in enumerate(zip(calls, outs)):
        want, secs = sync_time(
            lambda: ops.directed_hausdorff_lanes_plain(*args))
        plain_ms += secs * 1e3
        check(bits_equal(got, want), f"hausdorff_grid: replayed launch {i} "
              f"of {len(calls)} differs from its plain version")
    bound = 0.0
    pairs = 0
    for args in calls:
        n_bytes, n_ops = lanes_work(args, nvalid)
        bound += least_ms(n_bytes, n_ops)[0]
        pairs += n_ops["fp32"]
    live = sum(int(a[6].sum()) for a in calls)
    return {"ms_per_search": ms, "plain_ms_per_search": plain_ms,
            "bound_ms_per_search": bound,
            "launches_replayed": len(calls),
            "live_lanes_per_search": live,
            "lanes_per_search": sum(a[6].numel() for a in calls),
            "fp32_ops_per_search": pairs}


def device_ms(per_name, kernel):
    """Device ms of one kernel's launches in a profile: its entry points'
    symbols hold the name (hausdorff_grid's are hausdorff_lanes_*)."""
    sym = {"hausdorff_grid": "hausdorff_lanes"}.get(kernel, kernel)
    return sum(t for e, t in per_name.items() if sym in e)


def log_row(row) -> None:
    log(f"kernel {row['name']}: bitwise={row['bitwise']} "
        f"max_abs_diff={row['max_abs_diff']} ms={row['ms']:.5f} "
        f"eager_ms={row['eager_ms']:.4f} "
        f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.6f} "
        f"({row['bound_pipe']})")


def brute_topk(datasets, q, k):
    """numpy float32 H(Q -> D) for every dataset (squares summed in
    coordinate order, no FMA), then the k smallest, ties by id."""
    h = np.empty(len(datasets), np.float32)
    for j, d in enumerate(datasets):
        d2 = None
        for c in range(q.shape[1]):
            diff = q[:, None, c] - d[None, :, c]
            sq = diff * diff
            d2 = sq if d2 is None else d2 + sq
        h[j] = np.max(np.sqrt(np.min(d2, axis=1)))
    order = np.argsort(h, kind="stable")[:k]
    return h[order], order


def device_profile(run):
    """Device time of one ``run()`` under torch.profiler: ms per kernel
    name, device busy ms, and the host wall ms of the profiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = sync_time(run)
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name] = (per_name.get(e.name, 0.0)
                                + e.time_range.elapsed_us() / 1e3)
    return per_name, sum(per_name.values()), wall * 1e3


def np_sq_dists(q, d):
    """numpy float32 squared distances, (nq, W) x (nd, W) -> (nq, nd),
    the squares added in coordinate order (no FMA)."""
    d2 = None
    for c in range(q.shape[1]):
        diff = q[:, None, c] - d[None, :, c]
        sq = diff * diff
        d2 = sq if d2 is None else d2 + sq
    return d2


def np_cells(pts, lo, hi, theta):
    """numpy z-order cell ids of (..., 2) points on the grid [lo, hi]:
    an independent copy of the repository's quantisation and Morton code."""
    span = np.maximum(hi - lo, np.float32(1e-30))
    nbins = (1 << theta) - 1
    g = ((pts[..., :2] - lo) / span * np.float32(nbins + 1)).astype(np.int32)
    g = np.clip(g, 0, nbins).astype(np.int64)

    def part1by1(x):
        x = x & 0x0000FFFF
        x = (x | (x << 8)) & 0x00FF00FF
        x = (x | (x << 4)) & 0x0F0F0F0F
        x = (x | (x << 2)) & 0x33333333
        return (x | (x << 1)) & 0x55555555

    return part1by1(g[..., 0]) | (part1by1(g[..., 1]) << 1)


def np_occupancy(pts, val, lo, hi, theta):
    """(B, 4**theta) bool: the grid cells the valid points of each set
    occupy."""
    cells = np_cells(pts, lo, hi, theta)
    occ = np.zeros((pts.shape[0], 1 << (2 * theta)), bool)
    rows = np.broadcast_to(np.arange(pts.shape[0])[:, None], val.shape)
    occ[rows[val], cells[val]] = True
    return occ


def np_topk_desc(scores, k):
    """The k largest per row, ties toward the smaller index."""
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, order, axis=1), order


def choose_eps(repo, search):
    """An ApproHaus eps whose dataset stopping level lies in 3..5: just
    above the largest live node radius of a level, tried at 4, 3, 5.
    Returns (eps, dataset level)."""
    radii, counts = repo.ds_index.radii, repo.ds_index.counts
    for level in (4, 3, 5):
        sl = repo.ds_index.level_slice(level)
        r_max = float(torch.where(counts[:, sl] > 0, radii[:, sl], 0.0).max())
        eps = float(np.nextafter(np.float32(r_max), np.float32(np.inf)))
        ld = search.approx_level(repo.ds_index, eps)
        if 3 <= ld <= 5:
            return eps, ld
    raise SmokeFailure("no eps gives a dataset stopping level in 3..5")


@contextmanager
def keep_operands(targets):
    """Within the block, each ``(module, name)`` function in ``targets``
    keeps the arguments of every call in ``calls[name]`` (the positional
    tuple, or ``(args, kwargs)`` for a call with keywords), then runs as
    before (the kernel still launches and counts).  Yields ``calls``."""
    calls = {name: [] for _, name in targets}
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def keeping(fn, name):
        def wrapper(*args, **kw):
            calls[name].append((args, kw) if kw else args)
            return fn(*args, **kw)
        return wrapper

    for mod, name, fn in saved:
        setattr(mod, name, keeping(fn, name))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def path_operands(calls, name):
    """The operands of the path's one call shape of ``name``: every call of
    one pass must have had the same shapes, or a single row could not
    stand for them."""
    check(calls[name], f"the mixed batch never called {name}")
    shapes = {tuple(tuple(a.shape) for a in args) for args in calls[name]}
    check(len(shapes) == 1, f"{name} was called at several shapes: {shapes}")
    return calls[name][0]


def new_kernel_rows(repo, q_batch, res2, calls, ref, kernels):
    """Phase 7: set_intersect, nn_distance, bound_row_ub and both forms of
    bound_matrices against their plain versions on the dataset -> point
    path's operands."""
    set_intersect, nn_distance, bound_matrix = kernels
    rows = []
    # GBO: the group's query signatures, padded to its bucket, against
    # every slot signature
    sa, sb = path_operands(calls, "intersect_counts")
    got = set_intersect.intersect_counts(sa, sb)
    want = ref.set_intersect_count(sa, sb)
    torch.cuda.synchronize()
    na, W = sa.shape
    nb = sb.shape[0]
    rows.append(kernel_row(
        "set_intersect", "src/repro_torch/csrc/set_intersect.cu",
        "src/repro/kernels/set_intersect.py:19",
        {"na": na, "nb": nb, "W": W}, got, want,
        kernel_times(lambda: set_intersect.intersect_counts(sa, sb), 50),
        event_ms(lambda: ref.set_intersect_count(sa, sb), 3, 1),
        nbytes(sa, sb, got),
        # the binary tensor cores take the popcounts; their rate is not
        # among the published ones, so the bytes bound the kernel
        {}))
    # what one 32-bit popcount per word pair would take on the popcount
    # pipe, the bound of a kernel that counts there
    rows[-1]["popc32_bound_ms"] = least_ms(0, {"popc32": na * nb * W})[0]

    # NNP oracle: the pairs the gates check, every pipeline query against
    # each of its winners, as ``point_search.nnp_batched`` hands them over
    q_pairs, d_pairs = nnp_check_pairs(
        repo, q_batch, res2[4 * N_QUERIES:4 * N_QUERIES + N_PIPELINES])
    nn_in = (q_pairs.points, d_pairs.points, q_pairs.valid, d_pairs.valid)
    got = nn_distance.nn_distance_batched(*nn_in)
    want = ref.nn_distance_batched(*nn_in)
    torch.cuda.synchronize()
    P, nq, W = q_pairs.points.shape
    row = kernel_row(
        "nn_distance", "src/repro_torch/csrc/nn_distance.cu",
        "src/repro/kernels/nn_distance.py:21",
        {"P": P, "nq": nq, "nd": d_pairs.points.shape[1], "W": W},
        got[0], want[0],
        kernel_times(lambda: nn_distance.nn_distance_batched(*nn_in), 20),
        event_ms(lambda: ref.nn_distance_batched(*nn_in), 2, 1),
        *pairs_work(nn_in, got, roots=True),
        also_equal=torch.equal(got[1], want[1]))
    one = tuple(t[:1] for t in nn_in)
    row["p1_ms"] = graph_ms(lambda: nn_distance.nn_distance_batched(*one), 50)
    row["p1_bound_ms"] = least_ms(*pairs_work(
        one, [t[:1] for t in got], roots=True))[0]
    rows.append(row)

    # pruned NNP leaf bounds: the stage-2 group's (query, winner) leaf
    # frontiers, padded to its bucket, and the winners' leaf occupancy
    oq, rq, od, rd, d_ok = path_operands(calls, "bound_row_ub")
    got = bound_matrix.bound_row_ub(oq, rq, od, rd, d_ok)
    want = ref.bound_row_ub(oq, rq, od, rd, d_ok)
    torch.cuda.synchronize()
    P, nlq, W = oq.shape
    nld = od.shape[1]
    shapes = {"P": P, "nq": nlq, "nd": nld, "W": W}
    row = kernel_row(
        "bound_row_ub", "src/repro_torch/csrc/bound_matrices.cu",
        "src/repro/kernels/bound_matrix.py:26", shapes, got, want,
        kernel_times(lambda: bound_matrix.bound_row_ub(oq, rq, od, rd, d_ok),
                     50),
        event_ms(lambda: ref.bound_row_ub(oq, rq, od, rd, d_ok), 3, 1),
        nbytes(oq, rq, od, rd, d_ok, got), row_ub_ops(oq, d_ok))
    # what the path ran before the fused launch: the matrix kernel, then
    # the masked row min as two eager passes over ub
    row["composition_ms"] = graph_ms(lambda: torch.amin(torch.where(
        d_ok[:, None, :], bound_matrix.bound_matrices(oq, rq, od, rd)[1],
        ref.BIG), dim=-1), 20)
    row["dense_bound_ms"] = least_ms(
        nbytes(oq, rq, od, rd, d_ok, got),
        {"fp32": P * nlq * nld * (3 * W + 1) + P * nld + 2 * P * nlq,
         "mufu": P * nlq})[0]
    row["occupied_corpus_nodes"] = int(d_ok.sum())
    rows.append(row)

    # the matrix form on the same frontiers, with lb and with ub only
    got = bound_matrix.bound_matrices(oq, rq, od, rd)
    want = ref.bound_matrix(oq, rq, od, rd)
    ub_only = bound_matrix.bound_matrices(oq, rq, od, rd, with_lb=False)
    torch.cuda.synchronize()
    row = kernel_row(
        "bound_matrices", "src/repro_torch/csrc/bound_matrices.cu",
        "src/repro/kernels/bound_matrix.py:26", shapes,
        torch.stack(got), torch.stack(want),
        kernel_times(lambda: bound_matrix.bound_matrices(oq, rq, od, rd), 20),
        event_ms(lambda: ref.bound_matrix(oq, rq, od, rd), 3, 1),
        nbytes(oq, rq, od, rd, *got),
        # per node pair: 3W-1 for cd^2, then sub, max, add, add, and two
        # roots; rd*rd once per corpus node
        {"fp32": P * nlq * nld * (3 * W + 3) + P * nld,
         "mufu": 2 * P * nlq * nld},
        also_equal=ub_only[0] is None and bits_equal(ub_only[1], want[1]))
    # ub only: cd^2, cd^2 + rd^2, + rq and one root per node pair
    row["ub_only_ms"] = graph_ms(lambda: bound_matrix.bound_matrices(
        oq, rq, od, rd, with_lb=False), 20)
    row["ub_only_bound_ms"], row["ub_only_bound_pipe"] = least_ms(
        nbytes(oq, rq, od, rd, ub_only[1]),
        {"fp32": P * nlq * nld * (3 * W + 1) + P * nld,
         "mufu": P * nlq * nld})
    rows.append(row)
    for r in rows:
        log_row(r)
        check(r["bitwise"], f"{r['name']}: kernel differs from its plain "
              f"version (max abs diff {r['max_abs_diff']})")
    return rows


def dataset_point_path(repo, engine, q_sets, q_batch, q_sigs_np, eps,
                       reps, Query, Pipeline, ops, wrappers):
    """Phase 6: the mixed batch through ``search()``.  Returns (items,
    results, summary, launches, lo, hi, calls): ``calls`` holds the
    operands of the warm-up pass's calls of the ``wrappers``."""
    lo = np.stack([q.min(0) for q in q_sets]).astype(np.float32)
    hi = np.stack([q.max(0) for q in q_sets]).astype(np.float32)
    row = lambda i: type(q_batch)(*[x[i] for x in q_batch])   # noqa: E731
    items = (
        [Query(op="range_search", r_lo=lo[i], r_hi=hi[i])
         for i in range(N_QUERIES)]
        + [Query(op="topk_ia", r_lo=lo[i], r_hi=hi[i], k=K)
           for i in range(N_QUERIES)]
        + [Query(op="topk_gbo", q_sig=q_sigs_np[i], k=K)
           for i in range(N_QUERIES)]
        + [Query(op="topk_hausdorff_approx", q=q_sets[i], k=K, eps=eps)
           for i in range(N_QUERIES)]
        + [Pipeline(Query(op="topk_hausdorff", q=q_sets[i], k=K,
                          refine_levels=3, chunk=32),
                    Query(op="nnp", q_index=row(i)))
           for i in range(N_PIPELINES)]
        + [Pipeline(Query(op="topk_gbo", q_sig=q_sigs_np[i], k=K),
                    Query(op="range_points", r_lo=lo[i], r_hi=hi[i]))
           for i in range(N_PIPELINES)])
    with keep_operands(wrappers) as calls:                   # warm-up
        res, warm_s = sync_time(lambda: engine.search(items))
    torch.cuda.reset_peak_memory_stats()
    secs0 = dict(engine.stats.op_seconds)
    ops.reset_launches()
    res, first_s = sync_time(lambda: engine.search(items))
    launches = dict(ops.LAUNCHES)
    times = [first_s]
    for _ in range(reps - 1):
        res2, t = sync_time(lambda: engine.search(items))
        times.append(t)
        for a, b in zip(res, res2):
            for f in ("vals", "ids", "mask"):
                x, y = getattr(a, f), getattr(b, f)
                check((x is None and y is None) or (
                    x.shape == y.shape
                    and x.tobytes() == y.tobytes()), "repeat pass differs")
    groups = {op: (engine.stats.op_seconds[op] - secs0.get(op, 0.0)) / reps
              for op in engine.stats.op_seconds}
    summary = {
        "items": len(items), "eps": eps, "warmup_s": warm_s,
        "batch_latency_s": float(np.mean(times)),
        "batch_latency_all_s": times,
        "group_latency_s": groups,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches_per_search": launches,
    }
    return items, res, summary, launches, lo, hi, calls


def dataset_point_gates(repo, res, lo, hi, q_batch, eps, search,
                        point_search, ops):
    """Phase 8: the gates of the dataset -> point path.  Returns the
    nn_distance launches of the NNP oracle check."""
    n = N_DATASETS
    pts = repo.ds_index.points[:n].cpu().numpy()
    val = repo.ds_index.valid[:n].cpu().numpy()
    lo_d = np.where(val[..., None], pts, np.float32(np.inf)).min(axis=1)
    hi_d = np.where(val[..., None], pts, np.float32(-np.inf)).max(axis=1)
    Q = N_QUERIES
    r_range, r_ia = res[:Q], res[Q:2 * Q]
    r_gbo, r_apx = res[2 * Q:3 * Q], res[3 * Q:4 * Q]
    r_nnp = res[4 * Q:4 * Q + N_PIPELINES]
    r_rp = res[4 * Q + N_PIPELINES:]

    # RangeS: dataset MBR overlaps the query box
    want = ((lo_d[None] <= hi[:, None]) & (lo[:, None] <= hi_d[None])).all(-1)
    for i, r in enumerate(r_range):
        check(np.array_equal(r.mask[:n], want[i]) and not r.mask[n:].any(),
              f"range_search {i}: mask differs from the numpy brute force")
    # IA: the product of the clamped overlap lengths, float32
    ln = (np.minimum(hi_d[None], hi[:, None])
          - np.maximum(lo_d[None], lo[:, None]))
    ln = np.maximum(ln, np.float32(0))
    bv, bi = np_topk_desc(ln[..., 0] * ln[..., 1], K)
    for i, r in enumerate(r_ia):
        check(np.array_equal(r.vals.view(np.uint32), bv[i].view(np.uint32))
              and np.array_equal(r.ids, bi[i]),
              f"topk_ia {i}: differs from the numpy brute force")
    # GBO: shared grid cells, counted from the points themselves
    g_lo = repo.space_lo.cpu().numpy()
    g_hi = repo.space_hi.cpu().numpy()
    occ_d = np_occupancy(pts, val, g_lo, g_hi, THETA).astype(np.float32)
    occ_q = np_occupancy(q_batch.points.cpu().numpy(),
                         q_batch.valid.cpu().numpy(), g_lo, g_hi,
                         THETA).astype(np.float32)
    counts = (occ_q @ occ_d.T).astype(np.int64)     # exact below 2**24
    bv, bi = np_topk_desc(counts, K)
    for i, r in enumerate(r_gbo):
        check(np.array_equal(r.vals, bv[i]) and np.array_equal(r.ids, bi[i]),
              f"topk_gbo {i}: differs from the numpy brute force")
    for i, r in enumerate(r_rp):           # stage 1 of the GBO pipelines
        s1 = r.extras["stage1"]
        check(np.array_equal(s1.vals, bv[i]) and np.array_equal(s1.ids, bi[i]),
              f"pipeline gbo {i}: stage 1 differs from the brute force")
    log(f"gates: range_search, topk_ia, topk_gbo ({Q} queries each) equal "
        f"to the numpy brute force over {n} datasets")

    # RangeP: the winners' valid points inside the box
    n_rows = 0
    for i, r in enumerate(r_rp):
        for j, w in enumerate(r.extras["ds_ids"]):
            check(w >= 0, "range_points pipeline: sentinel winner")
            inside = ((pts[w] >= lo[i]) & (pts[w] <= hi[i])).all(-1)
            check(np.array_equal(r.mask[j], val[w] & inside),
                  f"range_points pipeline {i}, winner {j}: mask differs "
                  f"from the numpy brute force")
            n_rows += 1
    log(f"gates: {n_rows} range_points rows equal to the numpy brute force")

    # ApproHaus: the single-query op, and Lemma 1 against exact distances
    worst = 0.0
    for i, r in enumerate(r_apx):
        row = type(q_batch)(*[x[i] for x in q_batch])
        v, ids, (lq, ld, eps_eff) = search.topk_hausdorff_approx(
            repo, row, K, eps)
        v, ids = v.cpu().numpy(), ids.cpu().numpy()
        check(np.array_equal(v.view(np.uint32), r.vals.view(np.uint32))
              and np.array_equal(ids, r.ids),
              f"ApproHaus {i}: batched differs from the single-query op")
        check(np.float32(eps_eff) == r.extras["eps_eff"],
              f"ApproHaus {i}: eps_eff differs")
        for vv, j in zip(v, ids):
            h = float(ops.directed_hausdorff(
                row.points, repo.ds_index.points[j], row.valid,
                repo.ds_index.valid[j]))
            err = abs(float(vv) - h)
            worst = max(worst, err / (2 * eps_eff))
            check(err <= 2 * eps_eff + 1e-4,
                  f"ApproHaus {i}: |{vv} - H {h}| > 2 eps_eff {eps_eff}")
    log(f"gates: ApproHaus {Q} queries bitwise equal to the single-query op; "
        f"worst |approx - exact| / (2 eps_eff) = {worst:.4f}")

    # NNP: every pipeline row against the unpruned oracle (nn_distance).
    # Distances bitwise; indices equal, except where the pruned scan found
    # another point at the same squared distance: duplicate points (the
    # random walks pile up where they are clipped to the space's edge) can
    # sit in a leaf that the per-point bound, rounded, prunes.  Both are
    # nearest neighbours; such rows are counted.
    q_pairs, d_pairs = nnp_check_pairs(repo, q_batch, r_nnp)
    ops.reset_launches()
    (d_all, x_all), nnp_s = sync_time(
        lambda: point_search.nnp_batched(q_pairs, d_pairs))
    nn_launches = ops.LAUNCHES["nn_distance"]
    check(nn_launches == 1, f"the NNP oracle launched nn_distance "
          f"{nn_launches} times for {d_all.shape[0]} pairs, not once")
    d_all, x_all = d_all.cpu().numpy(), x_all.cpu().numpy()
    n_pairs = n_ties = 0
    for i, r in enumerate(r_nnp):
        row = type(q_batch)(*[x[i] for x in q_batch])
        qv = row.valid.cpu().numpy()
        qp = row.points.cpu().numpy()
        for j, w in enumerate(r.extras["ds_ids"]):
            d, x = d_all[n_pairs], x_all[n_pairs]
            check(np.array_equal(r.vals[j].view(np.uint32),
                                 d.view(np.uint32)),
                  f"pipeline nnp {i}, winner {j}: dists not bitwise equal "
                  f"to nnp")
            differ = qv & (r.ids[j] != x)
            if differ.any():
                a = np_sq_dists(qp[differ], pts[w][r.ids[j][differ]])
                b = np_sq_dists(qp[differ], pts[w][x[differ]])
                check(np.array_equal(np.diagonal(a), np.diagonal(b))
                      and val[w][r.ids[j][differ]].all(),
                      f"pipeline nnp {i}, winner {j}: ids differ from nnp "
                      f"at points that are not tied")
                n_ties += int(differ.sum())
            n_pairs += 1
    # one pair against numpy
    row = type(q_batch)(*[x[0] for x in q_batch])
    w = int(r_nnp[0].extras["ds_ids"][0])
    qp, qv = row.points.cpu().numpy(), row.valid.cpu().numpy()
    d2 = np.where(val[w][None], np_sq_dists(qp, pts[w]), np.float32(3.4e38))
    bi = np.argmin(d2, axis=1)
    bd = np.sqrt(np.min(d2, axis=1))
    x = r_nnp[0].ids[0]
    check(np.array_equal(r_nnp[0].vals[0][qv].view(np.uint32),
                         bd[qv].view(np.uint32))
          and np.array_equal(d2[np.arange(len(x)), x][qv],
                             d2[np.arange(len(x)), bi][qv]),
          "pipeline nnp 0: differs from the numpy brute force")
    log(f"gates: {n_pairs} pipeline nnp rows bitwise equal to the unpruned "
        f"nnp_batched (nn_distance launches {nn_launches}, {nnp_s * 1e3:.3f} "
        f"ms); {n_ties} query points took another of several tied nearest "
        f"points; one pair equal to numpy")
    return nn_launches


def join_items(q_sets, q_sigs_np, lo, hi, Query, Pipeline):
    """Phase 9's batch: 32 queries each of top-k overlap and coverage (the
    32 query sets, k = 10), 8 ``Pipeline(topk_ia -> topk_overlap)``, 8
    ``Pipeline(topk_hausdorff -> topk_coverage)`` and 8
    ``Pipeline(topk_gbo -> range_points)``, the re-rank stages keeping
    ``K2`` of their 10 winners."""
    P = N_PIPELINES
    return (
        [Query(op="topk_overlap", q=q_sets[i], k=K) for i in range(N_QUERIES)]
        + [Query(op="topk_coverage", q=q_sets[i], k=K)
           for i in range(N_QUERIES)]
        + [Pipeline(Query(op="topk_ia", r_lo=lo[i], r_hi=hi[i], k=K),
                    Query(op="topk_overlap", q=q_sets[i], k=K2))
           for i in range(P)]
        + [Pipeline(Query(op="topk_hausdorff", q=q_sets[i], k=K,
                          refine_levels=3, chunk=32),
                    Query(op="topk_coverage", q=q_sets[i], k=K2))
           for i in range(P)]
        + [Pipeline(Query(op="topk_gbo", q_sig=q_sigs_np[i], k=K),
                    Query(op="range_points", r_lo=lo[i], r_hi=hi[i]))
           for i in range(P)])


def join_call_kind(args, repo, B, n_planes):
    """Which join-path launch a ``set_intersect`` call is, from its shape:
    the slot bounds (overlap: B rows, coverage: B * P), the upper tree's
    node bounds, a refine chunk (fine words), or the GBO group's."""
    sa, sb = args
    na, W = sa.shape
    mode = {B: "overlap", B * n_planes: "coverage"}.get(na)
    if sb.shape[0] == repo.n_slots and W == repo.ds_sigs.shape[1]:
        return f"{mode}_bound" if mode else "gbo"
    if sb.shape[0] == repo.repo.sigs.shape[0]:
        return f"{mode}_nodes"
    return f"{mode}_refine"


def join_path(engine, items, reps, ops, set_intersect):
    """Phase 9: the join batch through ``search()``: a warm-up pass that
    keeps every ``set_intersect`` call's operands, a pass with the launch
    counters read around it, two more timed passes, and one under the
    profiler.  Returns (results, summary, launches, calls)."""
    with keep_operands([(set_intersect, "intersect_counts")]) as calls:
        res, warm_s = sync_time(lambda: engine.search(items))
    torch.cuda.reset_peak_memory_stats()
    secs0 = dict(engine.stats.op_seconds)
    ops.reset_launches()
    res, first_s = sync_time(lambda: engine.search(items))
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    times = [first_s]
    for _ in range(reps - 1):
        again, t = sync_time(lambda: engine.search(items))
        times.append(t)
        for a, b in zip(res, again):
            for f in ("vals", "ids", "mask"):
                x, y = getattr(a, f), getattr(b, f)
                check((x is None and y is None) or (
                    x.shape == y.shape and x.tobytes() == y.tobytes()),
                    "join batch: repeat pass differs")
    check(len(calls["intersect_counts"]) == launches["set_intersect"],
          f"join batch: the warm-up made {len(calls['intersect_counts'])} "
          f"set_intersect calls, the counted pass "
          f"{launches['set_intersect']} launches")
    summary = {
        "items": len(items), "warmup_s": warm_s,
        "batch_latency_median_s": float(np.median(times)),
        "batch_latency_all_s": times,
        "group_latency_s": {
            op: (engine.stats.op_seconds[op] - secs0.get(op, 0.0)) / reps
            for op in engine.stats.op_seconds
            if engine.stats.op_seconds[op] > secs0.get(op, 0.0)},
        "max_memory_allocated": peak,
        "launches_per_search": launches,
    }
    per_name, busy_ms, wall_ms = device_profile(lambda: engine.search(items))
    if per_name:
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
        summary.update({
            "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "set_intersect_device_ms": device_ms(per_name, "set_intersect"),
            "top_device_ms": [(e[:100], t) for e, t in top]})
    else:
        summary["device_profile"] = "not measured (no device work seen)"
    return res, summary, launches, calls["intersect_counts"]


def join_kernel_rows(calls, repo, B, n_planes, set_intersect, ref):
    """Phase 10: ``set_intersect`` at each shape the join batch launched it,
    on the operands the path handed it.  Every kept call is held bitwise
    against the plain version (in row blocks: one call's (na, nb, W) int64
    temporary is gigabytes at the coverage bound's shape); the first call
    of each kind is replayed in a CUDA graph, and all calls of a kind
    together (``ms_per_search``)."""
    def plain(sa, sb, rows=64):
        return torch.cat([ref.set_intersect_count(sa[i:i + rows], sb)
                          for i in range(0, sa.shape[0], rows)])

    kinds = {}
    for args in calls:
        kinds.setdefault(join_call_kind(args, repo, B, n_planes),
                         []).append(args)
    rows = []
    for kind in ("overlap_bound", "coverage_bound", "overlap_nodes",
                 "coverage_nodes", "overlap_refine", "coverage_refine",
                 "gbo"):
        check(kind in kinds, f"the join batch launched no set_intersect "
              f"for {kind}")
        group = kinds[kind]
        for i, (sa, sb) in enumerate(group):
            check(torch.equal(set_intersect.intersect_counts(sa, sb),
                              plain(sa, sb)),
                  f"set_intersect {kind}: call {i} of {len(group)} differs "
                  f"from its plain version")
        sa, sb = group[0]
        got = set_intersect.intersect_counts(sa, sb)
        want = plain(sa, sb)
        torch.cuda.synchronize()
        na, W = sa.shape
        nb = sb.shape[0]
        row = kernel_row(
            f"set_intersect:{kind}", "src/repro_torch/csrc/set_intersect.cu",
            "src/repro/kernels/set_intersect.py:19",
            {"na": na, "nb": nb, "W": W}, got, want,
            kernel_times(lambda: set_intersect.intersect_counts(sa, sb), 20),
            event_ms(lambda: plain(sa, sb), 3, 1), nbytes(sa, sb, got), {})
        row["popc32_bound_ms"] = least_ms(0, {"popc32": na * nb * W})[0]
        row["launches"] = len(group)
        row["ms_per_search"] = graph_ms(lambda: [
            set_intersect.intersect_counts(*a) for a in group], 1)
        row["bound_ms_per_search"] = sum(
            least_ms(nbytes(a, b) + a.shape[0] * b.shape[0] * 4, {})[0]
            for a, b in group)
        rows.append(row)
        log_row(row)
        log(f"  {kind}: {len(group)} launches per search, "
            f"{row['ms_per_search']:.5f} ms per search (bound "
            f"{row['bound_ms_per_search']:.6f})")
    for r in rows:
        check(r["bitwise"], f"{r['name']}: kernel differs from its plain "
              f"version")
    return rows


def join_gates(repo, res, q_sets, lo, hi, res_exact, res_mixed, join_search):
    """Phase 9's gates: every joinable query's vals and ids equal a
    vectorised numpy brute force over every dataset at the fine grid, two
    queries of each mode also ``topk_join_host``; each dataset -> dataset
    pipeline equals its host re-rank of stage-1 winners that equal the
    brute force (IA) or the ExactHaus path (Hausdorff); the GBO pipelines
    equal the mixed batch's."""
    n, Q, P = N_DATASETS, N_QUERIES, N_PIPELINES
    _, theta_f = join_search.join_thetas(repo)
    g_lo = repo.space_lo.cpu().numpy()
    g_hi = repo.space_hi.cpu().numpy()
    pts = repo.ds_index.points[:n].cpu().numpy()
    val = repo.ds_index.valid[:n].cpu().numpy()
    occ_d = np_occupancy(pts, val, g_lo, g_hi, theta_f).astype(np.float32)
    hist_q = np.stack([np.bincount(np_cells(q, g_lo, g_hi, theta_f),
                                   minlength=occ_d.shape[1]) for q in q_sets])
    # exact below 2**24 in float32
    full = {"overlap": ((hist_q > 0).astype(np.float32) @ occ_d.T),
            "coverage": hist_q.astype(np.float32) @ occ_d.T}
    scores = {}
    for mode, f in full.items():
        s = np.full((Q, repo.n_slots), -1, np.int64)
        s[:, :n] = f.astype(np.int64)
        scores[mode] = s
    r_ov, r_cv = res[:Q], res[Q:2 * Q]
    r_p_ov = res[2 * Q:2 * Q + P]
    r_p_cv = res[2 * Q + P:2 * Q + 2 * P]
    r_p_rp = res[2 * Q + 2 * P:]
    for mode, rs in (("overlap", r_ov), ("coverage", r_cv)):
        bv, bi = np_topk_desc(scores[mode], K)
        for i, r in enumerate(rs):
            check(np.array_equal(r.vals, bv[i]) and np.array_equal(r.ids, bi[i]),
                  f"topk_{mode} {i}: differs from the numpy brute force")
            check(r.stats.exact_evaluations > 0, f"topk_{mode} {i}: stats")
        hv, hi_ = join_search.topk_join_host(repo, q_sets[:2], K, mode)
        for i in range(2):
            check(np.array_equal(hv[i], rs[i].vals)
                  and np.array_equal(hi_[i], rs[i].ids),
                  f"topk_{mode} {i}: differs from topk_join_host")
    log(f"gates: topk_overlap, topk_coverage ({Q} queries each) equal to the "
        f"numpy brute force over {n} datasets at theta {theta_f}; 2 of each "
        f"equal to topk_join_host")

    # stage 1 of the IA pipelines: the IA brute force
    lo_d = np.where(val[..., None], pts, np.float32(np.inf)).min(axis=1)
    hi_d = np.where(val[..., None], pts, np.float32(-np.inf)).max(axis=1)
    ln = (np.minimum(hi_d[None], hi[:P, None])
          - np.maximum(lo_d[None], lo[:P, None]))
    ln = np.maximum(ln, np.float32(0))
    ia_v, ia_i = np_topk_desc(ln[..., 0] * ln[..., 1], K)
    for i in range(P):
        for mode, r, s1v, s1i in (
                ("overlap", r_p_ov[i], ia_v[i], ia_i[i]),
                ("coverage", r_p_cv[i], res_exact[i].vals, res_exact[i].ids)):
            s1 = r.extras["stage1"]
            check(np.array_equal(s1.vals.view(np.uint32), s1v.view(np.uint32))
                  and np.array_equal(s1.ids, s1i),
                  f"pipeline -> {mode} {i}: stage 1 differs")
            ids1 = np.asarray(r.extras["ds_ids"])
            sc = scores[mode][i, ids1]
            order = np.argsort(-sc, kind="stable")[:K2]
            check(np.array_equal(r.vals, sc[order])
                  and np.array_equal(r.ids, ids1[order])
                  and r.mask.all(),
                  f"pipeline -> {mode} {i}: differs from its host re-rank")
    mixed_rp = res_mixed[4 * Q + P:]
    for i, (a, b) in enumerate(zip(r_p_rp, mixed_rp)):
        check(np.array_equal(a.mask, b.mask)
              and np.array_equal(a.extras["ds_ids"], b.extras["ds_ids"]),
              f"pipeline gbo {i}: differs from the mixed batch's")
    log(f"gates: {P} pipelines each of IA -> overlap and ExactHaus -> "
        f"coverage equal their host re-rank; {P} GBO -> range_points equal "
        f"to the mixed batch's")


def same_response(a, b) -> bool:
    """Two served responses bit for bit: arrays by bytes, stats by value,
    pipeline results field by field."""
    if isinstance(b, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if hasattr(b, "extras"):
        return (all(same_response(getattr(a, f), getattr(b, f))
                    for f in ("vals", "ids", "mask"))
                and same_response(a.extras["ds_ids"], b.extras["ds_ids"]))
    if isinstance(b, tuple) and not hasattr(b, "_fields"):
        return len(a) == len(b) and all(same_response(x, y)
                                        for x, y in zip(a, b))
    return a == b


def check_served(i, op, p, res, engine, serve_search,
                 what="engine.search of the same item") -> None:
    """Served request ``i`` bitwise equal to ``engine.search`` of its item
    alone.  A joinable query's counters depend on the batch it shared (the
    refine order is the batch's, so in the JAX package) and are only
    bounded; its vals and ids are held bitwise."""
    want = serve_search._legacy_result(
        engine.search([serve_search._to_query(op, p)])[0])
    if op in ("topk_overlap", "topk_coverage"):
        s = res[2]
        check(0 < s.candidates_after_bounds <= s.exact_evaluations
              <= engine._n_valid,
              f"served request {i} ({op}): stats {s}")
        res, want = res[:2], want[:2]
    check(same_response(res, want), f"served request {i} ({op}) differs "
          f"from {what}")


def serving_phase(engine, repo, datasets, ops, serve_search,
                  label="serving"):
    """Phase 11: ``SearchServer`` over the same engine, 256 requests of
    ``make_traffic(*bounds, datasets, 256, seed=0)`` at max_batch 64: one
    warm-up burst, then a measured burst with the launch counters read
    around it.  Every future resolves within a timeout, and each response
    is bitwise equal to ``engine.search`` of its item.  Phase 14 runs it
    again over a sharded engine, under another ``label``."""
    traffic = serve_search.make_traffic(
        repo.space_lo, repo.space_hi, datasets, N_REQUESTS, seed=0)
    server = serve_search.SearchServer(engine, max_batch=64)
    server.start()
    try:
        for f in [server.submit(op, **p) for op, p in traffic]:
            f.result(timeout=600)
        server.stats = serve_search.ServerStats()
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        futures = [server.submit(op, **p) for op, p in traffic]
        got = [f.result(timeout=600) for f in futures]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
    finally:
        server.stop()
    check(not server._thread.is_alive(), "the dispatcher thread outlived stop()")
    st = server.stats
    summary = {"requests": N_REQUESTS, "max_batch": 64, "seconds": dt,
               "qps": N_REQUESTS / dt, "p50_ms": st.p50_ms,
               "p99_ms": st.p99_ms, "mean_latency_ms": st.mean_latency_ms,
               "dispatch_groups": st.batches,
               "mean_batch": st.mean_batch, "launches": launches}
    log(f"{label}: " + json.dumps(summary))
    for name in ("set_intersect", "bound_grid", "hausdorff_grid",
                 "bound_row_ub"):
        check(launches[name] > 0, f"{label} launched no {name}")
    for i, ((op, p), res) in enumerate(zip(traffic, got)):
        check_served(i, op, p, res, engine, serve_search)
    log(f"gates ({label}): {N_REQUESTS} served responses bitwise equal to "
        f"engine.search of each item (joinable: vals and ids)")
    return summary


def repo_leaves(repo):
    """Every tensor of a repository, in field order."""
    def walk(x):
        if isinstance(x, torch.Tensor):
            yield x
        else:
            for y in x:
                yield from walk(y)
    return list(walk(repo))


def repos_bitwise(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(x.contiguous().view(torch.uint8),
                               y.contiguous().view(torch.uint8))
               for x, y in zip(repo_leaves(a), repo_leaves(b)))


def slots_differing(a, b):
    """Slots whose bottom tree or signature differ in any bit between two
    repositories of the same layout: (count, count per field)."""
    bad = torch.zeros(a.n_slots, dtype=torch.bool, device=a.device)
    per = {}
    names = [*a.ds_index._fields, "ds_sigs", "ds_valid"]
    for name, x, y in zip(names, [*a.ds_index, a.ds_sigs, a.ds_valid],
                          [*b.ds_index, b.ds_sigs, b.ds_valid]):
        x = x.contiguous().view(torch.uint8).reshape(a.n_slots, -1)
        y = y.contiguous().view(torch.uint8).reshape(b.n_slots, -1)
        row = (x != y).any(dim=1)
        per[name] = int(row.sum())
        bad |= row
    return int(bad.sum()), per


def predicted_slots(traffic, live_ids, n_slots):
    """The outcome each mutation of a stream must return, by the free-list
    rule: an ingest takes the smallest free slot (reserved at prepare, a
    tier at a time past the end), a delete frees its slot when its run
    publishes (runs of adjacent mutations publish together), a replace
    keeps its id."""
    import heapq

    free = sorted(set(range(n_slots)) - set(live_ids))
    want, run = [], []

    def publish():
        for op, sid in run:
            if op == "delete":
                heapq.heappush(free, sid)
        run.clear()

    for op, p in traffic:
        if op not in ("ingest", "delete", "replace"):
            publish()
            continue
        if op == "ingest":
            if not free:
                free.extend(range(n_slots, 2 * n_slots))
                n_slots *= 2
            sid = heapq.heappop(free)
            want.append(sid)
        else:
            sid = p["ds_id"]
            want.append(None if op == "delete" else sid)
        run.append((op, sid))
    return want


def mixed_all_ops(q_sets, lo, hi, sigs, eps, point_ids, Query):
    """Four queries of each op of ``OPS``: RangeS, IA, GBO, ApproHaus,
    ExactHaus, RangeP and NNP (into ``point_ids``), overlap and
    coverage."""
    items = []
    for i, j in enumerate(point_ids):
        q = q_sets[i][:256]
        items += [Query(op="range_search", r_lo=lo[i], r_hi=hi[i]),
                  Query(op="topk_ia", r_lo=lo[i], r_hi=hi[i], k=K),
                  Query(op="topk_gbo", q_sig=sigs[i], k=K),
                  Query(op="topk_hausdorff_approx", q=q, k=K, eps=eps),
                  Query(op="topk_hausdorff", q=q, k=K),
                  Query(op="range_points", ds_id=j, r_lo=lo[i],
                        r_hi=hi[i]),
                  Query(op="nnp", ds_id=j + 1, q=q),
                  Query(op="topk_overlap", q=q, k=K),
                  Query(op="topk_coverage", q=q, k=K)]
    return items


def results_bitwise(got, want) -> bool:
    for a, b in zip(got, want):
        for f in ("vals", "ids", "mask"):
            x, y = getattr(a, f), getattr(b, f)
            if (x is None) != (y is None):
                return False
            if x is not None and (x.dtype != y.dtype or x.shape != y.shape
                                  or x.tobytes() != y.tobytes()):
                return False
    return len(got) == len(want)


def live_phase(datasets, repo, info, build_repo_s, items, ops,
               serve_search):
    """Phase 12: the live repository at T-Drive scale.  ``init_live`` of the
    same datasets (every row a batch-of-1 build), its slots against the
    batched build (information, no gate), then a served stream with a
    mutation every ``LIVE_EVERY``-th request; gates: every future resolves,
    each mutation returns the slot the free-list rule predicts, each served
    query is bitwise equal to a cold engine over the repository published
    at its stream position (the stream's peak memory therefore includes
    those retained snapshots), the payload bytes, the live repository
    bitwise equal to ``frozen_repository()``, and a mixed batch of every op
    bitwise equal to a cold engine over it."""
    from repro_torch.engine import LiveRepository, QueryEngine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live, init_s = sync_time(lambda: LiveRepository(
        datasets, leaf_capacity=16, theta=THETA, remove_outliers=True))
    geom = live.geometry
    check(live.n_slots == repo.n_slots and geom.point_capacity
          == repo.ds_index.points.shape[1], "live layout differs from the "
          "batched build's")
    differ, per_field = slots_differing(live.repo, repo)
    log("live init: " + json.dumps({
        "init_live_s": init_s, "build_repository_s": build_repo_s,
        "slots": live.n_slots, "point_capacity": geom.point_capacity,
        "r_prime": geom.r_prime, "space_lo": geom.space_lo,
        "space_hi": geom.space_hi, "resident_bytes": live.repo.nbytes(),
        "slots_differing_from_batched_build": differ,
        "slots_differing_by_field": per_field,
        "r_prime_equal_batched": geom.r_prime == float(
            info["outlier_threshold"]),
        "space_bounds_equal_batched": bool(
            torch.equal(live.repo.space_lo, repo.space_lo)
            and torch.equal(live.repo.space_hi, repo.space_hi))}))
    row_build_check(datasets[:ROW_CHECK], geom, live.device)

    traffic = serve_search.make_traffic(
        geom.space_lo, geom.space_hi, datasets, LIVE_REQUESTS, seed=0,
        mutate_every=LIVE_EVERY)
    n_mut = sum(op in serve_search.MUTATION_OPS for op, _ in traffic)
    want_out = predicted_slots(traffic, live.live_ids, live.n_slots)
    server = serve_search.SearchServer(live=live, max_batch=64)
    server.start()
    try:
        # warm-up: the stream's queries only, then the result cache and the
        # server's counters are dropped
        queries = [(op, p) for op, p in traffic
                   if op not in serve_search.MUTATION_OPS]
        for f in [server.submit(op, **p) for op, p in queries]:
            f.result(timeout=600)
        live.engine._result_cache.clear()
        server.stats = serve_search.ServerStats()
        # publishes are functional: keep the repository each publish
        # installs, keyed by the stream's mutations published so far, to
        # hold every served answer against the epoch of its position
        snaps = {0: live.repo}
        publish_group = live.publish_group

        def recording_publish(group):
            out = publish_group(group)
            snaps[max(snaps) + len(group.items)] = live.repo
            return out

        live.publish_group = recording_publish
        st0 = live.stats
        i0, mc0 = st0.epoch_invalidations, st0.mutations_coalesced
        p0, ov0 = len(st0.publish_seconds), st0.prepare_overlap_seconds
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        futures = [(server.submit_mutation(op, **p)
                    if op in serve_search.MUTATION_OPS
                    else server.submit(op, **p)) for op, p in traffic]
        got = [f.result(timeout=600) for f in futures]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
    finally:
        server.stop()
        vars(live).pop("publish_group", None)
    check(not server._thread.is_alive(), "the dispatcher thread outlived stop()")
    outs = [g for (op, _), g in zip(traffic, got)
            if op in serve_search.MUTATION_OPS]
    check(outs == want_out, f"mutation outcomes {outs}, the free-list rule "
          f"predicts {want_out}")
    n_payload = sum(op in ("ingest", "replace") for op, _ in traffic)
    check(live.bytes_uploaded == n_payload * geom.point_capacity * 9,
          f"bytes uploaded {live.bytes_uploaded}, not {n_payload} payloads "
          f"of {geom.point_capacity * 9}")
    for name in ("set_intersect", "bound_grid", "hausdorff_grid",
                 "bound_row_ub"):
        check(launches[name] > 0, f"the live stream launched no {name}")
    st = live.stats
    sv = server.stats
    summary = {
        "requests": LIVE_REQUESTS, "mutate_every": LIVE_EVERY,
        "mutations": n_mut, "seconds": dt, "qps": LIVE_REQUESTS / dt,
        "query_p50_ms": sv.p50_ms, "query_p99_ms": sv.p99_ms,
        "mutation_mean_ms": sv.mean_mutation_ms,
        "mutation_latencies_ms": [1e3 * x for x in sv.mutation_latencies],
        "publishes": len(st.publish_seconds) - p0,
        "publish_p50_ms": st.publish_percentile_ms(50, since=p0),
        "publish_p99_ms": st.publish_percentile_ms(99, since=p0),
        "publish_ms": [1e3 * x for x in st.publish_seconds[p0:]],
        "mutations_coalesced": st.mutations_coalesced - mc0,
        "epoch_invalidations": st.epoch_invalidations - i0,
        "prepare_overlap_host_s": st.prepare_overlap_seconds - ov0,
        "payload_bytes_per_mutation": geom.point_capacity * 9,
        "bytes_uploaded": live.bytes_uploaded, "epoch": live.epoch,
        "dispatch_groups": sv.batches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "epoch_snapshots_held": len(snaps),
        "launches": launches, "outcomes": outs}
    log("live stream: " + json.dumps(summary))

    # each served query against a cold engine over the repository of its
    # stream position: all mutations before it published, none after
    n_before, cold, t_sweep = 0, None, time.perf_counter()
    for i, ((op, p), res) in enumerate(zip(traffic, got)):
        if op in serve_search.MUTATION_OPS:
            n_before += 1
            continue
        check(n_before in snaps, f"served request {i}: no publish ended at "
              f"its stream position ({n_before} mutations before it; "
              f"publishes ended at {sorted(snaps)})")
        if cold is None or cold.repo is not snaps[n_before]:
            cold = QueryEngine(snaps[n_before], result_cache_size=0)
        check_served(i, op, p, res, cold, serve_search, what=f"a cold "
                     f"engine after the stream's first {n_before} mutations")
    n_query = len(traffic) - n_mut
    snaps.clear()
    cold = None
    log(f"gates: {n_query} served queries bitwise equal to a cold engine "
        f"over the repository published at their stream position "
        f"({time.perf_counter() - t_sweep:.3f} s; joinable: vals and ids)")

    frozen, frozen_s = sync_time(live.frozen_repository)
    check(repos_bitwise(live.repo, frozen), "the live repository differs "
          "from build_frozen of its slot contents")
    res_live, live_s = sync_time(lambda: live.search(items))
    cold = QueryEngine(frozen, result_cache_size=0)
    check(results_bitwise(res_live, cold.search(items)), "a mixed batch on "
          "the live engine differs from a cold engine over the frozen build")
    log(f"gates: {len(got)} futures resolved; {n_mut} mutations returned "
        f"the predicted slots; {live.bytes_uploaded} bytes uploaded; live "
        f"repository bitwise equal to build_frozen ({frozen_s:.3f} s); a "
        f"batch of {len(items)} (every op) bitwise equal to a cold engine "
        f"({live_s:.3f} s on the live engine)")
    return {"summary": dict(summary, init_live_s=init_s), "live": live,
            "traffic": traffic, "got": got, "outcomes": outs,
            "items": items, "results": res_live}


def row_build_check(datasets, geom, dev):
    """The row stages through their CUDA graphs (``build_row``, what
    ``init_live``, ``build_frozen`` and every ingest run) against the same
    stages run eagerly, row by row in turns at the main path's row shape:
    bitwise equal, and the time per row of each."""
    from repro_torch.core import repo_mutate as rm

    lo, hi = geom.space_bounds(dev)

    def eager(ds):
        pts, val = rm._host_pad(np.asarray(ds, np.float32), geom)
        tree = rm._tree_stage(geom.bottom_depth, pts.to(dev), val.to(dev))
        if geom.r_prime is not None:
            tree = rm._outlier_stage(geom.r_prime, *tree)
        return tree, rm._signature_stage(geom.theta, tree.points,
                                         tree.valid, lo, hi)

    graph_s = eager_s = 0.0
    for i, ds in enumerate(datasets):
        got, t_g = sync_time(lambda: rm.build_row(ds, geom, device=dev))
        want, t_e = sync_time(lambda: eager(ds))
        graph_s += t_g
        eager_s += t_e
        check(repos_bitwise(got, want), f"row {i}: the graphed row build "
              f"differs from the eager stages")
    n = len(datasets)
    log("row build: " + json.dumps({
        "rows": n, "point_capacity": geom.point_capacity,
        "graph_ms_per_row": 1e3 * graph_s / n,
        "eager_ms_per_row": 1e3 * eager_s / n, "bitwise": True}))


def growth_phase(datasets, items, ops):
    """Phase 13: tier growth on the card: 12 datasets in a 16-slot tier,
    ingests past it; the slot count doubles, the layout epoch reads 1, and
    the repository and a mixed batch are bitwise equal to the cold build."""
    from repro_torch.engine import LiveRepository, QueryEngine

    live = LiveRepository(datasets[:12], leaf_capacity=16, theta=THETA,
                          remove_outliers=True)
    check(live.n_slots == 16, f"{live.n_slots} slots for 12 datasets")
    ids = [live.ingest(d) for d in datasets[12:18]]
    live.delete(3)
    live.replace(ids[-1], datasets[18])
    check(ids == list(range(12, 18)), f"ingest ids {ids}")
    check(live.n_slots == 32 and live.engine.dispatch.repo_epoch == 1,
          f"after growth: {live.n_slots} slots, layout epoch "
          f"{live.engine.dispatch.repo_epoch}")
    frozen = live.frozen_repository()
    check(repos_bitwise(live.repo, frozen), "grown repository differs from "
          "build_frozen")
    small = [q for q in items if q.ds_id is None or q.ds_id in live.live_ids]
    check(len(small) == len(items), "the batch names a slot that is not live")
    ops.reset_launches()
    got = live.search(small)
    check(results_bitwise(got, QueryEngine(frozen, result_cache_size=0)
                          .search(small)),
          "after growth, a mixed batch differs from a cold engine")
    log(f"tier growth: 12 -> 18 datasets, 16 -> {live.n_slots} slots, "
        f"layout epoch {live.engine.dispatch.repo_epoch}, data epoch "
        f"{live.epoch}; repository and a batch of {len(small)} bitwise "
        f"equal to the cold build; launches {json.dumps(dict(ops.LAUNCHES))}")

# ---------------------------------------------------------------------------
# phase 14: multi-device dispatch, every shard on the one card
# ---------------------------------------------------------------------------

#: shards of the sharded phases' even and uneven (slot-padded) meshes, and
#: the (replica, data) grid of the replicated phase
SHARDS = 4
SHARDS_UNEVEN = 3
GRID = (2, 2)


def kernel_targets():
    """The kernel wrappers a sharded path may launch, for keep_operands."""
    from repro_torch.kernels import (bound_matrix, hausdorff, nn_distance,
                                     ops, set_intersect)
    return [(ops, "directed_hausdorff_lanes"), (bound_matrix, "bound_grid"),
            (bound_matrix, "bound_row_ub"),
            (set_intersect, "intersect_counts"),
            (hausdorff, "min_sq_dists_pairs"),
            (nn_distance, "nn_distance_batched")]


#: launch counter of each kept wrapper
KEPT_KERNEL = {"directed_hausdorff_lanes": "hausdorff_grid",
               "bound_grid": "bound_grid", "bound_row_ub": "bound_row_ub",
               "intersect_counts": "set_intersect",
               "min_sq_dists_pairs": "min_sq_dists",
               "nn_distance_batched": "nn_distance"}


def check_kept(label, calls):
    """Every kept launch of a sharded path, launched again on its operands
    and held bitwise against its plain version.  A lanes launch is
    compared on the queries with a live lane (a query's lanes are
    independent of the others', and the rest must come back BIG), so the
    plain version does the live work only.  Returns the checked count per
    kernel."""
    from repro_torch.kernels import (bound_matrix, hausdorff, nn_distance,
                                     ops, ref, set_intersect)
    checked = {}
    for name, kept in calls.items():
        for i, a in enumerate(kept):
            if name == "directed_hausdorff_lanes":
                q_c, n_q, pts, pv, extent, ids, live = a
                got = hausdorff.hausdorff_lanes(*a)
                act = live.any(dim=-1)
                want = ops.directed_hausdorff_lanes_plain(
                    q_c[act], n_q[act], pts, pv, extent, ids[act], live[act])
                ok = (bits_equal(got[act], want)
                      and bool((got[~act] == ref.BIG).all()))
            elif name == "bound_grid":
                args, kw = a
                ok = bits_equal(
                    torch.stack(bound_matrix.bound_grid(*args, **kw)),
                    torch.stack(ref.frontier_bound_levels(*args,
                                                          kw["levels"])))
            elif name == "bound_row_ub":
                ok = bits_equal(bound_matrix.bound_row_ub(*a),
                                ref.bound_row_ub(*a))
            elif name == "intersect_counts":
                ok = torch.equal(set_intersect.intersect_counts(*a),
                                 ref.set_intersect_count(*a))
            elif name == "min_sq_dists_pairs":
                ok = bits_equal(hausdorff.min_sq_dists_pairs(*a),
                                ref.min_sq_dists_pairs(*a))
            else:
                gd, gi = nn_distance.nn_distance_batched(*a)
                wd, wi = ref.nn_distance_batched(*a)
                ok = bits_equal(gd, wd) and torch.equal(gi, wi)
            check(ok, f"{label}: kept {KEPT_KERNEL[name]} launch {i} of "
                  f"{len(kept)} differs from its plain version")
            checked[KEPT_KERNEL[name]] = checked.get(KEPT_KERNEL[name], 0) + 1
    torch.cuda.synchronize()
    return checked


def mesh_path(label, engine, items, want, reps, ops, local):
    """One path through a mesh engine: a warm-up pass that keeps every
    kernel launch's operands, a pass with the launch counters set to 0
    just before it and read just after, more timed passes and one under
    the profiler; its results bitwise equal to the local phase's
    (``want``: vals, ids, masks), every kept launch bitwise equal to its
    plain version.  ``local`` holds the local phase's latency, busy ms and
    peak memory, printed beside.  Returns (results, summary, kept)."""
    with keep_operands(kernel_targets()) as calls:
        res, warm_s = sync_time(lambda: engine.search(items))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res, first_s = sync_time(lambda: engine.search(items))
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    times = [first_s]
    for _ in range(reps - 1):
        again, t = sync_time(lambda: engine.search(items))
        times.append(t)
        check(results_bitwise(again, res), f"{label}: repeat pass differs")
    check(results_bitwise(res, want), f"{label}: results differ from the "
          f"local engine's (vals, ids, masks)")
    for name, kept in calls.items():
        check(len(kept) == launches[KEPT_KERNEL[name]],
              f"{label}: the warm-up kept {len(kept)} "
              f"{KEPT_KERNEL[name]} launches, the counted pass made "
              f"{launches[KEPT_KERNEL[name]]}")
    summary = {"items": len(items), "warmup_s": warm_s,
               "batch_latency_s": float(np.mean(times)),
               "batch_latency_all_s": times,
               "local_batch_latency_s": local["latency_s"],
               "max_memory_allocated": peak,
               "local_max_memory_allocated": local["peak"],
               "launches_per_search": launches}
    per_name, busy_ms, wall_ms = device_profile(lambda: engine.search(items))
    if per_name:
        summary.update({"device_busy_ms": busy_ms,
                        "local_device_busy_ms": local["busy_ms"],
                        "device_idle_share": 1.0 - busy_ms / wall_ms})
    else:
        summary["device_profile"] = "not measured (no device work seen)"
    summary["kept_launches_checked"] = check_kept(label, calls)
    log(f"{label}: " + json.dumps(summary))
    return res, summary, calls


def lanes_per_search(calls):
    """The kept ``hausdorff_grid`` launches of one sharded search replayed
    under CUDA events, beside the least time of their live, valid work
    (each shard's valid counts from its own corpus)."""
    from repro_torch.kernels import hausdorff
    nvalid = {}
    bound = 0.0
    for a in calls:
        key = a[3].data_ptr()
        if key not in nvalid:
            nvalid[key] = a[3].sum(dim=-1, dtype=torch.int64)
        bound += least_ms(*lanes_work(a, nvalid[key]))[0]
    ms = event_ms(lambda: [hausdorff.hausdorff_lanes(*a) for a in calls], 3,
                  1)
    return {"ms_per_search": ms, "bound_ms_per_search": bound,
            "launches": len(calls),
            "live_lanes": sum(int(a[6].sum()) for a in calls)}


def shard_bytes(engine, repo):
    """Each shard's resident bytes beside total / N (the slot slices) plus
    the upper tree and space bounds every shard holds whole."""
    from repro_torch.engine.sharded import repo_device_bytes
    shards = (engine.dispatch.shards if hasattr(engine.dispatch, "shards")
              else engine.dispatch.groups[0].shards)
    n = len(shards)
    replicated = nbytes(*repo.repo, repo.space_lo, repo.space_hi)
    per = repo_device_bytes(shards)
    pad = shards[0].n_slots * n - repo.n_slots
    slot_bytes = repo.nbytes() - replicated
    return {"per_shard_bytes": per, "total_bytes": repo.nbytes(),
            "slot_bytes_over_n": slot_bytes / n,
            "replicated_bytes": replicated, "padded_slots": pad}


def ring_phase(q_np, d_np, ops, distributed, mesh):
    """The ring ops on one dataset pair, both point sets split over the
    mesh's shards: ``ring_hausdorff`` bitwise equal to
    ``ops.directed_hausdorff_pairs`` and ``ring_nn_distance`` to
    ``ops.nn_distance_batched`` (distances and ids), every hop's launch
    kept and held against its plain version."""
    n = len(mesh.flat)
    dev = mesh.lead

    def padded(x):
        m = -x.shape[0] % n
        pts = torch.as_tensor(np.concatenate([x, np.zeros((m, 2),
                                                          np.float32)]))
        val = torch.arange(pts.shape[0]) < x.shape[0]
        return pts.to(dev), val.to(dev)

    q, qv = padded(q_np)
    d, dv = padded(d_np)
    want_h = ops.directed_hausdorff_pairs(q, d[None], qv, dv[None])[0]
    want_d, want_i = ops.nn_distance_batched(q[None], d[None], qv[None],
                                             dv[None])
    parts = [distributed.shard(x, mesh.flat) for x in (q, qv, d, dv)]
    ops.reset_launches()
    with keep_operands(kernel_targets()) as calls:
        h = distributed.ring_hausdorff(*parts)
        nn = distributed.ring_nn_distance(*parts)
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    got_d = torch.cat([x for x, _ in nn])
    got_i = torch.cat([i for _, i in nn])
    check(bits_equal(h, want_h), "ring_hausdorff differs from "
          "ops.directed_hausdorff_pairs")
    check(bits_equal(got_d, want_d[0]) and torch.equal(got_i, want_i[0]),
          "ring_nn_distance differs from ops.nn_distance_batched")
    check(launches.get("min_sq_dists") == n * n
          and launches.get("nn_distance") == n * n,
          f"ring ops: launches {launches}, not {n * n} hops each")
    checked = check_kept("ring ops", calls)
    log("ring ops: " + json.dumps({
        "shards": n, "nq": q.shape[0], "nd": d.shape[0],
        "hausdorff": float(h), "launches": launches,
        "kept_launches_checked": checked}))


def multi_device_phase(repo, datasets, q_sets, queries, local, reps, ops,
                       serve_search):
    """Phase 14: the sharded and replicated engines over the same
    repository, every shard on the one card (so no multi-card speed is
    measured here).  ExactHaus on a 4-shard and a 3-shard (slot-padded)
    mesh, the mixed and join batches on the 4-shard mesh, the ExactHaus
    and mixed batches and a batch of 1 on a (2, 2) replica grid, a served
    burst over the 4-shard engine and the ring ops: each bitwise equal to
    the local phases' results, each kept kernel launch to its plain
    version.  ``local`` holds, per local phase ("exact", "mixed",
    "joins"), its items, results, latency, busy ms and peak memory."""
    from repro_torch.core import distributed
    from repro_torch.engine import (ReplicatedQueryEngine,
                                    ShardedQueryEngine, data_mesh,
                                    replica_mesh)

    card = repo.device
    t0 = time.perf_counter()
    out = {}
    for n in (SHARDS, SHARDS_UNEVEN):
        mesh = data_mesh(devices=[card] * n)
        log(f"mesh ({n} shards): devices {[str(x) for x in mesh.flat]}")
        engine = ShardedQueryEngine(repo, mesh=mesh, result_cache_size=0)
        log(f"sharded engine ({n} shards): " + json.dumps(
            shard_bytes(engine, repo)))
        label = f"sharded ExactHaus ({n} shards)"
        res, summary, calls = mesh_path(label, engine, queries,
                                        local["exact"]["results"], reps,
                                        ops, local["exact"])
        for r, w in zip(res, local["exact"]["results"]):
            check(r.stats.exact_evaluations
                  <= r.stats.candidates_after_bounds
                  and r.stats[:2] == w.stats[:2],
                  f"{label}: stats {r.stats} against local {w.stats}")
        launches = summary["launches_per_search"]
        check(launches["bound_grid"] == n and launches["hausdorff_grid"] > 0,
              f"{label}: launches {launches}")
        lanes = lanes_per_search(calls["directed_hausdorff_lanes"])
        log(f"{label} hausdorff_grid per search: " + json.dumps(lanes))
        out[f"exact_{n}"] = dict(summary, hausdorff_grid=lanes)
        del calls
        if n != SHARDS:
            del engine
            continue
        for key, what in (("mixed", "mixed batch"), ("joins", "join batch")):
            items, want = local[key]["items"], local[key]["results"]
            _, summary, calls = mesh_path(f"sharded {what} ({n} shards)",
                                          engine, items, want, reps, ops,
                                          local[key])
            out[f"{key}_{n}"] = summary
            del calls
        serving_phase(engine, repo, datasets, ops, serve_search,
                      label=f"sharded serving ({n} shards)")
        del engine

    R, D = GRID
    mesh = replica_mesh(R, D, [card] * (R * D))
    log(f"replica grid {GRID}: devices {[str(x) for x in mesh.flat]}")
    engine = ReplicatedQueryEngine(repo, mesh=mesh, result_cache_size=0)
    alone = {"latency_s": None, "peak": None, "busy_ms": None}
    for key, items, want in (
            ("exact", queries, local["exact"]["results"]),
            ("mixed", local["mixed"]["items"], local["mixed"]["results"]),
            ("one", queries[:1], local["exact"]["results"][:1])):
        # a batch of 1 on R = 2 groups: the second runs a copy of row 0
        _, summary, calls = mesh_path(f"replicated {key} {GRID}", engine,
                                      items, want, reps, ops,
                                      local.get(key, alone))
        out[f"replicated_{key}"] = summary
        del calls
    check(engine.stats.replica_subgroups >= engine.stats.plan_groups,
          "replica accounting")
    del engine
    ring_phase(q_sets[0], datasets[0], ops, distributed,
               data_mesh(devices=[card] * SHARDS))
    log(f"multi-device phase: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: the live repository on a mesh, every shard on the one card
# ---------------------------------------------------------------------------


def storage(shard):
    """The storage of a shard's slot tensors."""
    return [x.data_ptr() for x in (*shard.ds_index, shard.ds_sigs,
                                   shard.ds_valid)]


def kept_batch(label, live, items, want, ops):
    """A batch of every op on a live mesh: a pass keeping every kernel
    launch's operands (results bitwise equal to ``want``: vals, ids,
    masks), then a pass with the launch counters set to 0 just before it
    and read just after, and every kept launch held bitwise against its
    plain version.  Returns (launches, kept launches checked)."""
    live.engine._result_cache.clear()
    with keep_operands(kernel_targets()) as calls:
        res = live.search(items)
    check(results_bitwise(res, want), f"{label}: a batch of every op "
          f"differs (vals, ids, masks)")
    live.engine._result_cache.clear()
    ops.reset_launches()
    again = live.search(items)
    launches = dict(ops.LAUNCHES)
    check(results_bitwise(again, want), f"{label}: repeat batch differs")
    for name, kept in calls.items():
        check(len(kept) == launches[KEPT_KERNEL[name]],
              f"{label}: the kept pass made {len(kept)} "
              f"{KEPT_KERNEL[name]} launches, the counted one "
              f"{launches[KEPT_KERNEL[name]]}")
    for name in ("set_intersect", "bound_grid", "hausdorff_grid",
                 "bound_row_ub"):
        check(launches[name] > 0, f"{label}: the batch launched no {name}")
    return launches, check_kept(label, calls)


def live_mesh_stream(ref, datasets, ops, serve_search, card_line):
    """Phase 15, full width: ``LiveRepository`` over the same 10,357
    trajectories on a 4-shard mesh of the card, phase 12's stream served
    through it (the same traffic seed, a mutation every 16th request);
    gates: every future resolves, every mutation returns phase 12's slot,
    every response equals phase 12's at the same stream position
    (ExactHaus and joinable by vals and ids: their counters depend on the
    split), the payload bytes equal phase 12's, each shard is bitwise
    phase 12's final live repository split 4 ways, and a batch of every op
    is bitwise phase 12's (every kept launch against its plain version).
    ``ref`` is phase 12's state."""
    from repro_torch.engine import LiveRepository, data_mesh
    from repro_torch.engine.sharded import shard_repository

    card = ref["live"].device
    mesh = data_mesh(devices=[card] * SHARDS)
    log(f"live mesh ({SHARDS} shards): devices "
        f"{[str(x) for x in mesh.flat]}")
    live, init_s = sync_time(lambda: LiveRepository(
        datasets, leaf_capacity=16, theta=THETA, remove_outliers=True,
        mesh=mesh))
    traffic = serve_search.make_traffic(
        live.geometry.space_lo, live.geometry.space_hi, datasets,
        LIVE_REQUESTS, seed=0, mutate_every=LIVE_EVERY)
    check([op for op, _ in traffic] == [op for op, _ in ref["traffic"]],
          "the live mesh's stream differs from phase 12's")
    server = serve_search.SearchServer(live=live, max_batch=64)
    server.start()
    try:
        queries = [(op, p) for op, p in traffic
                   if op not in serve_search.MUTATION_OPS]
        for f in [server.submit(op, **p) for op, p in queries]:
            f.result(timeout=600)
        live.engine._result_cache.clear()
        server.stats = serve_search.ServerStats()
        st0 = live.stats
        p0 = len(st0.publish_seconds)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        futures = [(server.submit_mutation(op, **p)
                    if op in serve_search.MUTATION_OPS
                    else server.submit(op, **p)) for op, p in traffic]
        got = [f.result(timeout=600) for f in futures]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
    finally:
        server.stop()
    check(not server._thread.is_alive(), "the dispatcher thread outlived stop()")
    for name in ("set_intersect", "bound_grid", "hausdorff_grid",
                 "bound_row_ub"):
        check(launches[name] > 0, f"the live mesh stream launched no {name}")
    outs = [g for (op, _), g in zip(traffic, got)
            if op in serve_search.MUTATION_OPS]
    check(outs == ref["outcomes"], f"live mesh mutation outcomes {outs}, "
          f"phase 12's {ref['outcomes']}")
    check(live.bytes_uploaded == ref["live"].bytes_uploaded,
          f"live mesh uploaded {live.bytes_uploaded} bytes, phase 12 "
          f"{ref['live'].bytes_uploaded}")
    for i, ((op, _), res, want) in enumerate(zip(traffic, got, ref["got"])):
        if op in ("topk_hausdorff", "topk_overlap", "topk_coverage"):
            res, want = res[:2], want[:2]
        check(same_response(res, want), f"live mesh request {i} ({op}) "
              f"differs from phase 12's")

    st, sv, r12 = live.stats, server.stats, ref["summary"]
    summary = {
        "card": card_line, "shards": SHARDS, "requests": LIVE_REQUESTS,
        "mutate_every": LIVE_EVERY, "init_live_s": init_s,
        "local_init_live_s": r12["init_live_s"], "seconds": dt,
        "qps": LIVE_REQUESTS / dt, "local_qps": r12["qps"],
        "query_p50_ms": sv.p50_ms, "query_p99_ms": sv.p99_ms,
        "local_query_p50_ms": r12["query_p50_ms"],
        "local_query_p99_ms": r12["query_p99_ms"],
        "publishes": len(st.publish_seconds) - p0,
        "publish_p50_ms": st.publish_percentile_ms(50, since=p0),
        "publish_p99_ms": st.publish_percentile_ms(99, since=p0),
        "local_publish_p50_ms": r12["publish_p50_ms"],
        "local_publish_p99_ms": r12["publish_p99_ms"],
        "mutation_mean_ms": sv.mean_mutation_ms,
        "bytes_uploaded": live.bytes_uploaded,
        "per_shard_bytes": [sh.nbytes() for sh in live.shards],
        "local_resident_bytes": ref["live"].engine.repo.nbytes(),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches, "outcomes": outs}
    log(f"live mesh stream ({SHARDS} shards): " + json.dumps(summary))

    want, _ = shard_repository(ref["live"].engine.repo, mesh)
    check(len(want) == len(live.shards) and all(
        repos_bitwise(a, b) for a, b in zip(live.shards, want)),
        "a live mesh shard differs from phase 12's live repository split "
        f"{SHARDS} ways")
    del want
    _, checked = kept_batch(f"live mesh batch ({SHARDS} shards)", live,
                            ref["items"], ref["results"], ops)
    log(f"gates: {len(got)} futures resolved; mutation outcomes and "
        f"{live.bytes_uploaded} payload bytes as phase 12's; every response "
        f"equal to phase 12's (ExactHaus and joinable: vals and ids); every "
        f"shard bitwise phase 12's live repository split {SHARDS} ways; a "
        f"batch of {len(ref['items'])} (every op) bitwise phase 12's, kept "
        f"launches checked {json.dumps(checked)}")
    return launches


def live_growth_mesh(label, mesh, datasets, items, ops):
    """Phase 15, small scale: phase 13's tier-growth set on a mesh (12
    datasets in a 16-slot tier, six ingests past it, a delete and a
    replace); gates: 32 slots at layout epoch 1, the grown tier
    shard-aligned, every shard of every replica group bitwise
    ``shard_repository(build_frozen(...))``, the final replace gave new
    slot tensors to its owner shard alone, and a batch of every op bitwise
    equal to a cold engine on the same mesh (every kept launch against its
    plain version).  Returns the batch's launches."""
    from repro_torch.core.distributed import DATA_AXIS, Mesh
    from repro_torch.engine import LiveRepository, QueryEngine
    from repro_torch.engine.sharded import shard_repository

    live = LiveRepository(datasets[:12], leaf_capacity=16, theta=THETA,
                          remove_outliers=True, mesh=mesh)
    ids = [live.ingest(d) for d in datasets[12:18]]
    live.delete(3)
    check(ids == list(range(12, 18)), f"{label}: ingest ids {ids}")
    disp = live.engine.dispatch
    check(live.n_slots == 32 and disp.repo_epoch == 1,
          f"{label}: after growth, {live.n_slots} slots, layout epoch "
          f"{disp.repo_epoch}")
    layout = disp.layouts[0]
    n = len(layout.shards)
    before = [storage(sh) for sh in live.shards]
    live.replace(ids[-1], datasets[18])
    owner = ids[-1] // layout.shard_slots
    for i, (sh, old) in enumerate(zip(live.shards, before)):
        same = storage(sh) == old
        check(same == (i % n != owner), f"{label}: the replace of slot "
              f"{ids[-1]} (owner shard {owner}) "
              f"{'kept' if same else 'replaced'} shard {i % n}'s slot "
              f"tensors")
    frozen = live.frozen_repository()
    rows = ([Mesh(r, (DATA_AXIS,)) for r in mesh.devices]
            if len(mesh.axis_names) == 2 else [mesh])
    for L, row in zip(disp.layouts, rows):
        want, n_phys = shard_repository(frozen, row)
        check(L.n_slots_sharded == n_phys == -(-32 // n) * n
              and all(repos_bitwise(a, b) for a, b in zip(L.shards, want)),
              f"{label}: a shard differs from build_frozen split over its "
              f"group")
    small = [q for q in items if q.ds_id is None or q.ds_id in live.live_ids]
    check(len(small) == len(items), "the batch names a slot that is not live")
    want = QueryEngine(frozen, result_cache_size=0, mesh=mesh).search(small)
    launches, checked = kept_batch(label, live, small, want, ops)
    log(f"{label}: 12 -> 18 datasets, 16 -> {live.n_slots} slots "
        f"({layout.shard_slots} a shard), "
        f"layout epoch {disp.repo_epoch}, {live.bytes_uploaded} bytes "
        f"uploaded; every shard bitwise build_frozen split over its group; "
        f"the replace wrote shard {owner} alone; a batch of {len(small)} "
        f"bitwise a cold engine on the mesh; launches {json.dumps(launches)}"
        f"; kept launches checked {json.dumps(checked)}")
    return launches


def live_mesh_phase(ref, datasets, growth_items, ops, serve_search,
                    card_line):
    """Phase 15: the live repository on a mesh of the one card, at full
    width on 4 shards (``live_mesh_stream``) and at small scale on a
    3-shard (slot-padded) mesh and a (2, 2) replica grid
    (``live_growth_mesh``).  Returns the launches per path."""
    from repro_torch.engine import data_mesh, replica_mesh

    t0 = time.perf_counter()
    card = ref["live"].device
    out = {f"live_mesh_{SHARDS}": live_mesh_stream(ref, datasets, ops,
                                                   serve_search, card_line)}
    ref.clear()
    R, D = GRID
    for key, mesh in (
            (f"live_growth_{SHARDS_UNEVEN}",
             data_mesh(devices=[card] * SHARDS_UNEVEN)),
            (f"live_growth_{R}x{D}", replica_mesh(R, D, [card] * (R * D)))):
        out[key] = live_growth_mesh(key.replace("_", " "), mesh, datasets,
                                    growth_items, ops)
    log(f"live mesh phase: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if len(sys.argv) > 1:
        print("chip_smoke: takes no arguments", file=sys.stderr)
        return 2
    k, reps = 10, 3
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from repro_torch.core import search
    from repro_torch.core.build import build_repository
    from repro_torch.data import synthetic
    from repro_torch.engine import Query, QueryEngine
    from repro_torch.kernels import _build, bound_matrix, hausdorff, ops, ref

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    log(f"device: {kind} (torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    check(smi, "nvidia-smi gave no name and power limit")
    log(smi[0])

    # ---- 1. kernel build ----------------------------------------------
    build_s = _build.build_all()
    log(f"kernel build: {build_s:.2f} s ({len(_build.SOURCES)} sources, "
        f"{_build.build_dir()})")

    # ---- 2. repository build at full width -----------------------------
    t0 = time.perf_counter()
    datasets = synthetic.trajectory_repository(
        N_DATASETS, seed=1, n_points=(100, 2800))
    gen_s = time.perf_counter() - t0
    n_points = sum(d.shape[0] for d in datasets)
    (repo, info), build_repo_s = sync_time(lambda: build_repository(
        datasets, leaf_capacity=16, theta=5, remove_outliers=True,
        device=dev))
    log(f"repository: {N_DATASETS} datasets, {n_points} points "
        f"(generated in {gen_s:.2f} s), built on the card in "
        f"{build_repo_s:.3f} s; slots {info['n_slots']}, padded points "
        f"{repo.ds_index.points.shape[1]}, depth {info['bottom_depth']}, "
        f"resident {repo.nbytes() / 1e9:.3f} GB, outlier r' "
        f"{float(info['outlier_threshold']):.6g}")
    check(int(repo.ds_valid.sum()) == N_DATASETS, "ds_valid count")

    engine = QueryEngine(repo, result_cache_size=0)
    q_sets = synthetic.trajectory_repository(N_QUERIES, seed=7,
                                             n_points=(100, 2800))
    queries = [Query(op="topk_hausdorff", q=q, k=k, refine_levels=3,
                     chunk=32) for q in q_sets]

    # ---- 3. kernels vs plain versions, at the main path's shapes -------
    q_batch = engine.build_queries(q_sets)
    rows = []
    max_level = min(q_batch.depth, repo.ds_index.depth, 3)
    n_nodes = (1 << (max_level + 1)) - 1
    levels = tuple(((1 << l) - 1, (1 << (l + 1)) - 1)
                   for l in range(max_level + 1))
    bg_in = (q_batch.centers[:, :n_nodes].contiguous(),
             q_batch.radii[:, :n_nodes].contiguous(),
             (q_batch.counts[:, :n_nodes] > 0).contiguous(),
             repo.ds_index.centers[:, :n_nodes].contiguous(),
             repo.ds_index.radii[:, :n_nodes].contiguous(),
             (repo.ds_index.counts[:, :n_nodes] > 0).contiguous())
    got = bound_matrix.bound_grid(*bg_in, levels=levels)
    want = ref.frontier_bound_levels(*bg_in, levels)
    torch.cuda.synchronize()
    B, S, W = bg_in[0].shape[0], bg_in[3].shape[0], bg_in[0].shape[2]
    row = kernel_row(
        "bound_grid", "src/repro_torch/csrc/bound_grid.cu",
        "src/repro/kernels/bound_matrix.py:84",
        {"B": B, "S": S, "N": n_nodes, "W": W, "L": len(levels)},
        torch.stack(got), torch.stack(want),
        kernel_times(lambda: bound_matrix.bound_grid(*bg_in, levels=levels),
                     20),
        event_ms(lambda: ref.frontier_bound_levels(*bg_in, levels), 3, 1),
        nbytes(*bg_in, *got), bound_grid_ops(bg_in, levels))
    rows.append(row)
    log_row(row)

    # a real phase-2 chunk: the first 32 ascending-LB candidates per query,
    # every lane live, on the path's compacted query rows and the resident
    # corpus
    LB, tau, cand, _, _ = search._hausdorff_bound_phases(repo, q_batch, k, 3)
    order = torch.sort(torch.where(cand, LB, ref.BIG), dim=-1,
                       stable=True).indices
    ids = order[:, :32].contiguous()
    pts, pv = repo.ds_index.points, repo.ds_index.valid
    q_c, n_q = search.phase2_query_rows(q_batch)
    extent = hausdorff.valid_extent(pv)
    live = torch.ones(ids.shape, dtype=torch.bool, device=dev)
    lanes_in = (q_c, n_q, pts, pv, extent, ids, live)
    got = hausdorff.hausdorff_lanes(*lanes_in)
    ds, dsv = pts[ids], pv[ids]
    qp, qv = q_batch.points, q_batch.valid
    want = ops.directed_hausdorff_grid_plain(qp, ds, qv, dsv)
    torch.cuda.synchronize()
    nvalid = pv.sum(dim=-1, dtype=torch.int64)
    row = kernel_row(
        "hausdorff_grid", "src/repro_torch/csrc/hausdorff_grid.cu",
        "src/repro/kernels/hausdorff.py:96",
        {"B": ids.shape[0], "C": ids.shape[1], "nq": qp.shape[1],
         "nqp": q_c.shape[1], "nd": pts.shape[1], "W": pts.shape[2]},
        got, want,
        kernel_times(lambda: hausdorff.hausdorff_lanes(*lanes_in), 10),
        event_ms(lambda: ops.directed_hausdorff_grid_plain(qp, ds, qv, dsv),
                 2, 1),
        *lanes_work(lanes_in, nvalid))
    rows.append(row)
    log_row(row)

    # the oracle's first chunk: query 0 against its first 32 ascending-LB
    # candidates, gathered from the corpus as topk_hausdorff_host does
    ids0 = ids[0][cand[0, ids[0]]]
    q0, qv0, ds0, dsv0 = qp[0], qv[0], pts[ids0], pv[ids0]
    msd_in = (q0, ds0, qv0, dsv0)
    got = hausdorff.min_sq_dists_pairs(*msd_in)
    want = ref.min_sq_dists_pairs(*msd_in)
    torch.cuda.synchronize()
    row = kernel_row(
        "min_sq_dists", "src/repro_torch/csrc/min_sq_dists.cu",
        "src/repro/kernels/hausdorff.py:34",
        {"P": ds0.shape[0], "nq": q0.shape[0], "nd": ds0.shape[1],
         "W": q0.shape[1]}, got, want,
        kernel_times(lambda: hausdorff.min_sq_dists_pairs(*msd_in), 20),
        event_ms(lambda: ref.min_sq_dists_pairs(*msd_in), 3, 1),
        *pairs_work(msd_in, [got], roots=False))
    # one pair of the chunk, as the single-pair op launches it
    one = (q0, ds0[:1], qv0, dsv0[:1])
    row["p1_ms"] = graph_ms(lambda: hausdorff.min_sq_dists_pairs(*one), 50)
    row["p1_bound_ms"] = least_ms(*pairs_work(one, [got[:1]], roots=False))[0]
    rows.append(row)
    log_row(row)
    for r in rows:
        check(r["bitwise"], f"{r['name']}: kernel differs from its plain "
              f"version (max abs diff {r['max_abs_diff']})")
    del got, want, ds, dsv, LB, cand, order, lanes_in, msd_in, one

    # ---- 4. the main path: QueryEngine.search ---------------------------
    # warm-up; it keeps the operands of every hausdorff_grid launch
    with keep_operands([(ops, "directed_hausdorff_lanes")]) as lane_calls:
        res, warm_s = sync_time(lambda: engine.search(queries))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res, first_s = sync_time(lambda: engine.search(queries))
    launches = dict(ops.LAUNCHES)
    times = [first_s]
    for _ in range(reps - 1):
        res2, s = sync_time(lambda: engine.search(queries))
        times.append(s)
        for a, b in zip(res, res2):
            check(np.array_equal(a.vals.view(np.uint32), b.vals.view(np.uint32))
                  and np.array_equal(a.ids, b.ids), "repeat pass differs")
    lat = float(np.mean(times))
    evals = [r.stats.exact_evaluations for r in res]
    cands = [r.stats.candidates_after_bounds for r in res]
    pruned = [r.stats.pruned_fraction for r in res]
    peak = torch.cuda.max_memory_allocated()
    main = {
        "datasets": N_DATASETS, "points": n_points,
        "slots": info["n_slots"], "queries": N_QUERIES, "k": k,
        "build_s": build_repo_s, "warmup_s": warm_s,
        "batch_latency_s": lat, "batch_latency_all_s": times,
        "qps": N_QUERIES / lat,
        "mean_exact_evaluations": float(np.mean(evals)),
        "mean_candidates_after_bounds": float(np.mean(cands)),
        "mean_pruned_fraction": float(np.mean(pruned)),
        "resident_repo_bytes": repo.nbytes(),
        "max_memory_allocated": peak,
        "launches_per_search": launches,
    }
    log("main path: " + json.dumps(main))
    for r in res:
        check(r.vals.shape == (k,) and r.ids.shape == (k,), "result shape")
        check(np.isfinite(r.vals).all() and (r.vals < ref.BIG / 2).all(),
              "non-finite result")
        check(((r.ids >= 0) & (r.ids < N_DATASETS)).all(), "id range")
        check((np.diff(r.vals) >= 0).all(), "vals not ascending")
    for name in ("bound_grid", "hausdorff_grid"):
        check(launches[name] > 0, f"{name} was not launched by search()")

    # one more pass, under the profiler: where the device time goes
    per_name, busy_ms, wall_ms = device_profile(lambda: engine.search(queries))
    local = {"exact": {"results": res, "latency_s": lat,
                       "peak": main["max_memory_allocated"],
                       "busy_ms": busy_ms if per_name else None}}
    if not per_name:
        log("device profile: not measured (the profiler saw no device work)")
    else:
        by_kernel = {n: device_ms(per_name, n)
                     for n in ("bound_grid", "hausdorff_grid")}
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
        log("device profile: " + json.dumps({
            "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_ms": by_kernel,
            "hausdorff_grid_share_of_busy":
                by_kernel["hausdorff_grid"] / busy_ms,
            "hausdorff_grid_share_of_latency":
                by_kernel["hausdorff_grid"] / (lat * 1e3),
            "top_device_ms": top}))

    # every hausdorff_grid launch of the warm-up search, replayed
    calls = lane_calls["directed_hausdorff_lanes"]
    check(len(calls) == launches["hausdorff_grid"],
          f"the warm-up search made {len(calls)} hausdorff_grid launches, "
          f"the counted one {launches['hausdorff_grid']}")
    hg = next(r for r in rows if r["name"] == "hausdorff_grid")
    hg.update(replay_lanes(calls, nvalid, hausdorff, ops))
    log("hausdorff_grid per search: " + json.dumps(
        {key: hg[key] for key in ("ms_per_search", "plain_ms_per_search",
                                  "bound_ms_per_search", "launches_replayed",
                                  "live_lanes_per_search",
                                  "lanes_per_search")}))
    del calls, lane_calls

    # ---- 5. the oracle on the card, and a brute-force check -------------
    ops.reset_launches()
    n_check = min(4, N_QUERIES)
    chunks = 0
    oracle_s = 0.0
    for i in range(n_check):
        row_i = type(q_batch)(*[x[i] for x in q_batch])
        (vh, ih, sh), secs = sync_time(lambda: search.topk_hausdorff_host(
            repo, row_i, k, refine_levels=3, chunk=32))
        oracle_s += secs
        # chunks are full but for the last one a query evaluates
        chunks += -(-sh.exact_evaluations // 32)
        vh, ih = vh.cpu().numpy(), ih.cpu().numpy()
        check(np.array_equal(vh.view(np.uint32), res[i].vals.view(np.uint32)),
              f"query {i}: engine vals differ from topk_hausdorff_host")
        check(np.array_equal(ih, res[i].ids),
              f"query {i}: engine ids differ from topk_hausdorff_host")
        check(sh.exact_evaluations == res[i].stats.exact_evaluations,
              f"query {i}: exact_evaluations differ")
    oracle_launches = ops.LAUNCHES["min_sq_dists"]
    check(oracle_launches == chunks, f"the oracle launched min_sq_dists "
          f"{oracle_launches} times for {chunks} evaluated chunks")
    check(ops.LAUNCHES["hausdorff_grid"] == 0,
          "the oracle launched phase 2's hausdorff_grid")
    launches["min_sq_dists"] = oracle_launches
    log(f"oracle: {n_check} queries bitwise equal to the engine "
        f"(vals, ids, exact_evaluations) in {oracle_s:.3f} s; min_sq_dists "
        f"launches {oracle_launches}, one per evaluated chunk")

    small = synthetic.trajectory_repository(64, seed=3, n_points=(20, 300))
    srepo, _ = build_repository(small, leaf_capacity=16, theta=5,
                                remove_outliers=False, device=dev)
    sq = synthetic.trajectory_repository(4, seed=11, n_points=(20, 300))
    sres = QueryEngine(srepo, result_cache_size=0).search(
        [Query(op="topk_hausdorff", q=q, k=5) for q in sq])
    for q, r in zip(sq, sres):
        bv, bi = brute_topk(small, q, 5)
        check(np.array_equal(bv.view(np.uint32), r.vals.view(np.uint32))
              and np.array_equal(bi, r.ids),
              "small repository: engine differs from the numpy brute force")
    log("small repository: 4 queries equal to the numpy brute force")

    # ---- 6. the dataset -> point path -----------------------------------
    from repro_torch.core import point_search, zorder
    from repro_torch.engine import Pipeline
    from repro_torch.kernels import nn_distance, set_intersect

    q_sigs = zorder.signature(q_batch.points, q_batch.valid, repo.space_lo,
                              repo.space_hi, THETA)
    eps, ld = choose_eps(repo, search)
    lq = [search.approx_level(type(q_batch)(*[x[i] for x in q_batch]), eps)
          for i in range(N_QUERIES)]
    log(f"ApproHaus eps {eps!r}: dataset stopping level {ld}, query levels "
        f"{sorted(set(lq))} (counts {np.bincount(lq).tolist()})")
    items, res2, summary, launches2, lo, hi, calls = dataset_point_path(
        repo, engine, q_sets, q_batch,
        q_sigs.cpu().numpy().astype(np.uint32), eps, reps, Query, Pipeline,
        ops, [(set_intersect, "intersect_counts"),
              (bound_matrix, "bound_row_ub")])
    log("dataset/point path: " + json.dumps(summary))
    # one more pass, under the profiler: where the device time goes
    per_name, busy_ms, wall_ms = device_profile(lambda: engine.search(items))
    local["mixed"] = {"items": items, "results": res2,
                      "latency_s": summary["batch_latency_s"],
                      "peak": summary["max_memory_allocated"],
                      "busy_ms": busy_ms if per_name else None}
    if not per_name:
        log("dataset/point device profile: not measured (the profiler saw "
            "no device work)")
    else:
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
        log("dataset/point device profile: " + json.dumps({
            "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_ms": {n: device_ms(per_name, n)
                          for n in _build.KERNELS},
            "top_device_ms": [(e[:100], t) for e, t in top]}))
    for r in res2:
        for f in ("vals", "mask"):
            x = getattr(r, f)
            if x is not None and x.dtype.kind == "f":
                check(np.isfinite(x).all(), f"{r.op}: non-finite {f}")
        if r.ids is not None and r.op != "pipeline":
            check(r.ids.shape == (K,) and (r.ids >= 0).all()
                  and (r.ids < N_DATASETS).all(), f"{r.op}: ids")
    # one GBO group and one NNP group: one launch each, and the pruned NNP
    # takes its row bounds from the fused launch, never the matrices
    for name, n in (("set_intersect", 1), ("bound_row_ub", 1),
                    ("bound_matrices", 0)):
        check(launches2[name] == n, f"search() launched {name} "
              f"{launches2[name]} times, not {n}")

    # ---- 7. the dataset / point kernels vs plain versions ---------------
    rows += new_kernel_rows(repo, q_batch, res2, calls, ref,
                            (set_intersect, nn_distance, bound_matrix))
    del calls

    # ---- 8. the gates -----------------------------------------------------
    for name in ("set_intersect", "bound_row_ub", "bound_matrices"):
        launches[name] = launches2[name]
    launches["nn_distance"] = dataset_point_gates(
        repo, res2, lo, hi, q_batch, eps, search, point_search, ops)

    # ---- 9. the join batch: joinable ops and dataset -> dataset pipelines
    from repro_torch.core import join_search
    from repro_torch.launch import serve_search

    j_items = join_items(q_sets, q_sigs.cpu().numpy().astype(np.uint32), lo,
                         hi, Query, Pipeline)
    res_j, j_summary, j_launches, j_calls = join_path(
        engine, j_items, reps, ops, set_intersect)
    n_planes = join_search.num_planes(max(
        q.built_capacity(engine.leaf_capacity) for q in j_items
        if isinstance(q, Query)))
    B = engine.bucket_for(N_QUERIES)
    kinds = [join_call_kind(a, repo, B, n_planes) for a in j_calls]
    j_summary["set_intersect_launches_by_kind"] = {
        kd: kinds.count(kd) for kd in sorted(set(kinds))}
    log("join path: " + json.dumps(j_summary))
    local["joins"] = {"items": j_items, "results": res_j,
                      "latency_s": j_summary["batch_latency_median_s"],
                      "peak": j_summary["max_memory_allocated"],
                      "busy_ms": j_summary.get("device_busy_ms")}
    check(j_launches["set_intersect"] > 0,
          "the join batch launched no set_intersect")
    join_gates(repo, res_j, q_sets, lo, hi, res, res2, join_search)

    # ---- 10. set_intersect at the join shapes, on the path's operands --
    j_rows = join_kernel_rows(j_calls, repo, B, n_planes, set_intersect, ref)
    del j_calls

    # ---- 11. serving: SearchServer over the same engine ----------------
    serving_phase(engine, repo, datasets, ops, serve_search)

    # ---- 12. the live repository at T-Drive scale ----------------------
    sig_np = q_sigs.cpu().numpy().astype(np.uint32)
    del engine
    # point queries into ids the stream never deletes
    live_ref = live_phase(datasets, repo, info, build_repo_s, mixed_all_ops(
        q_sets, lo, hi, sig_np, eps, (6000, 6002, 6004, 6006), Query),
        ops, serve_search)

    # ---- 13. tier growth on the card ------------------------------------
    growth_items = mixed_all_ops(q_sets, lo, hi, sig_np, eps, (4, 6, 8, 10),
                                 Query)
    growth_phase(datasets, growth_items, ops)

    # ---- 14. multi-device dispatch, every shard on the one card --------
    mesh_out = multi_device_phase(repo, datasets, q_sets, queries, local,
                                  reps, ops, serve_search)
    mesh_out = {path: s["launches_per_search"] for path, s in
                mesh_out.items()}

    # ---- 15. the live repository on a mesh of the card ------------------
    mesh_out.update(live_mesh_phase(live_ref, datasets, growth_items, ops,
                                    serve_search, smi[0]))

    for r in rows:
        r["launches"] = launches[r["name"]]
        r["sharded_launches"] = {path: counts[r["name"]]
                                 for path, counts in mesh_out.items()}
    rows += j_rows
    log(f"smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

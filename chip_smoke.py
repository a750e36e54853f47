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
     is kept and held bitwise against its plain version;
 16. the pairwise and discovery paths on the phase-2 repository:
     ``hausdorff_pair_exact`` of each of phase 4's 32 queries against its
     ExactHaus winner and on phase 14's ring pair (one ``bound_matrices``
     launch a call; h bitwise phase 4's value and
     ``ops.directed_hausdorff_pairs``, except where the glb term sets it
     from above, counted and held to 4 ulp), ``hausdorff_pair_approx``
     within 2 eps_eff of it, ``frontier_bounds`` at levels 0..3 for 4
     queries against every slot (one ``bound_matrices`` launch a call,
     bitwise the ``bound_grid`` level), ``gbo_frontier_stats`` for the 32
     query signatures (one ``set_intersect`` launch a call; its counts
     bitwise phase 8's numpy counts, the kth value topk_gbo's, every
     upper-tree leaf holding one of the top k surviving), ``topk_emd``
     for 4 repository datasets, full and prefiltered (histograms bitwise
     a numpy bincount, each query first, values within 1e-4 of the port's
     CPU run on the same histograms, FP32 products at "highest"; the gap
     to a float64 numpy Sinkhorn and the latency printed), and ``curate``
     on 64 trajectories, its selection equal to the port's CPU run.
     Every ``bound_matrices`` launch is kept and held bitwise against its
     plain version;
 17. routing and autotune, then the trajectory LM, after phases 1-16
     have counted their launches at the default launch shapes:
     ``QueryEngine.tune()`` on a fresh engine over the phase-2 repository
     (each candidate's time, the shape installed per op and bucket, the
     gate's rejections, which must be none, the epoch and the chunk);
     every launch shape of ``bound_grid``, ``hausdorff_grid`` and
     ``min_sq_dists`` bitwise against the plain version on phase 3's
     operands, with its CUDA-graph time; the 32-query ExactHaus batch
     under the tuned table and chunk bitwise phase 4's vals and ids, its
     launches and latency beside phase 4's, and the share of its synced
     wall clock that ``EngineStats.op_seconds`` booked; then
     ``spadas_trajlm`` at its full config (12 x 768, ~116 M parameters,
     weights from a seeded generator) serving 8 prompts of 64 tokens
     (the repository's first trajectories tokenized at theta 6) and
     generating 32 tokens with the bf16 cache and with the int8 cache:
     prefill ms, decode ms a token, tokens per second, peak memory, and
     one decode step under torch.profiler (device busy ms, device
     operations, idle share of the step); gates: decode after an n-token
     prefill against the forward logits at n (``LM_DECODE_BOUNDS``), which
     must also fail on two planted faults (the cache zeroed, the step
     taken at n - 1), the card's prefill logits against the port's CPU
     run of the same weights and prompts (``LM_CPU_ATOL``), and the greedy
     tokens counted against that run;
 18. the LM's other kinds, each serving 8 requests of 64 inputs (256 for
     the SSM configs: one chunk) and generating 32 with the bf16 cache
     and, where the config has attention, the int8 cache: grok-1 at one
     layer (MoE), mamba2_780m at 12 of its 48 layers (Mamba-2),
     llama-3.2-vision at one repeat of its pattern with a 1,024-token
     image context and its cross-attention gates at 0.5
     (cross-attention), musicgen_medium at 12 of its 48 layers
     (embedding inputs), all at full width with weights drawn on
     the card, and jamba at its reduced config (the hybrid); per config
     prefill ms, decode ms a token, tokens per second, peak memory, the
     weight-init seconds and one profiled decode step; gates: decode
     after an n-input prefill against forward at n (MoE without drops),
     which must fail on the two planted faults (the caches zeroed, or
     the SSM state alone; the step taken at n - 1 against the caches of
     the first n - 1 inputs); then the reduced config of each of the six
     new families on the card against the port's CPU run of the same
     weights: every block on the card's hidden state (and the MoE on the
     card's MoE input), prefill and decode logits end to end (MoE
     routing made continuous), greedy tokens counted.  The phase books
     no launch of the six kernels;
 19. training: the full ``spadas_trajlm`` (12 x 768, 116,460,288
     parameters, float32 states) trained by
     ``repro_torch.launch.train.run`` at its defaults (batch 8 x seq 256,
     lr 3e-4 after 20 warm-up steps), its data curated on the card as the
     trainer does, for 60 steps with an async checkpoint every 10: step ms
     (median, spread), tokens per second, peak memory, the model-FLOP
     share of a step against the bf16 peak, one step under
     torch.profiler (device operations, busy ms, idle share); gates: the
     trainer's curation launches ``bound_grid`` and ``hausdorff_grid``
     (booked as ``train_launches``), while the train steps launch no
     kernel (the run resumed for 10 steps launches what the 60-step run
     did, and every other step launches nothing), the losses finite and
     the mean of the last 10 below the first 10's, one step of the same
     weights on a 2 x 256 batch against the port's CPU run
     (``TRAIN_CPU_BOUNDS``), the run resumed from the step-30 checkpoint
     (by the trainer's ``--resume`` and by a restore into a fresh model
     and optimizer) equal to the uninterrupted run's next 10 losses within
     ``RESUME_RTOL``, a gate that must fail on two planted faults (the
     restored moments zeroed; the pipeline cursor dropped); int8 states
     over the first 10 steps (their bytes a parameter, the losses within
     ``INT8_LOSS_ATOL`` of the float32 run's); mamba2_780m whole at full
     width with int8 states, 3 steps on one batch, the second loss below
     the first;
 20. training on a mesh: ``launch.train.run([... "--mesh", "test"],
     devices=["cuda:0"] * 8)``, the test mesh (data 4 x model 2) of
     ZeRO-3 storage, each data group's pass computed over its two model
     coordinates (attention heads, the SwiGLU d_ff, the vocabulary of the
     tied embedding, head and CE split), its eight coordinates on the
     card, phase 19's arguments for 10 steps with a checkpoint at step
     10: step ms (median), peak memory, each coordinate's resident bytes,
     one step under torch.profiler; then 3 steps on (1, 4) over
     ``["cuda:0"] * 4`` (``--mesh 1x4``: one group over four model
     coordinates), each loss within ``MESH_LOSS_ATOL`` of phase 19's
     first 3; gates: the curation launches
     ``bound_grid`` and ``hausdorff_grid`` (booked as
     ``mesh_train_launches``) and the steps launch none, each loss within
     ``MESH_LOSS_ATOL`` of phase 19's (its own first 10 steps are the
     reference: the same seed, curation and pipeline), the parameters at
     step 10 against phase 19's step-10 checkpoint (at most
     ``MESH_OVER_SHARE`` of the elements past 0.1 lr), each coordinate's
     bytes equal to the specs' prediction, and the mesh checkpoint
     restored onto one device, equal to the mesh state leaf for leaf, its
     step 11 within ``MESH_LOSS_ATOL`` of phase 19's.
 21. the dry run (``launch.specs`` + ``launch.dryrun``) of the cells the
     card ran above, on meta tensors: phase 19's one-device train step,
     phase 20's (4, 2) step over ``["cuda:0"] * 8`` and phase 17's decode
     step; gates: the records' resident bytes equal the card's (phase
     20's 174,892,032 a coordinate), phase 19's FLOPs equal the smoke's
     ``model_flops``, the (4, 2) lead's FLOPs an eighth of them (a group's
     quarter of the batch, every piece halved over the model axis), each
     predicted peak against one step's on the card
     (``DRYRUN_TEMP_RTOL``; on (4, 2) the lead's plus one gradient set),
     no kernel launched, the phase
     within
     ``DRYRUN_BUDGET_S``; the roofline's bound (H100 terms) printed
     beside the step ms the card measured.

The second-to-last line is the kernel table as JSON (each row's
``launches`` from the local path, ``sharded_launches`` per phase-14 path
(per search) and per phase-15 path: ``live_mesh_4`` over the stream,
``live_growth_3`` and ``live_growth_2x2`` per batch, ``pair_launches``
per phase-16 path; ``bound_matrices`` and ``set_intersect`` add
``at_path_shapes``, their times at phase 16's shapes; the three swept
kernels add ``variants``, each launch shape's time at phase 3's shapes,
and ``tuned``, the shape phase 17 installed; every local row adds
``train_launches``, its launches in phase 19's training run, and
``mesh_train_launches``, in phase 20's), the last line
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
# the trajectory LM's serving run: prompts, their tokens, the tokens
# generated, the Morton grid they are tokenized on, and the bound of the
# card's prefill logits against the CPU run of the same weights (bf16
# products whose float32 sums run in another order on the card: a bf16 ulp
# here and there, carried through 12 layers, on logits of |x| < ~3)
LM_BATCH = 8
LM_PROMPT = 64
LM_GEN = 32
LM_THETA = 6
LM_CPU_ATOL = 0.1
# the bounds of decode after prefill against forward, per cache: the
# reference's (tests/test_models_smoke.py::test_prefill_decode_consistency,
# test_int8_kv_cache_decode_matches_fp)
LM_DECODE_BOUNDS = {"bf16": (0.15, 0.05), "int8": (0.2, 0.1)}


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
    name, device busy ms, the host wall ms of the profiled run, and the
    number of device operations (kernels and copies) it ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = sync_time(run)
    per_name, n_ops = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name] = (per_name.get(e.name, 0.0)
                                + e.time_range.elapsed_us() / 1e3)
            n_ops += 1
    return per_name, sum(per_name.values()), wall * 1e3, n_ops


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
    nn_distance launches of the NNP oracle check, the numpy GBO counts
    (queries x datasets) and the numpy cell occupancy of the datasets and
    of the queries (bool, (datasets, cells) and (queries, cells))."""
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
    return nn_launches, counts, (occ_d > 0, occ_q > 0)


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
    per_name, busy_ms, wall_ms, _ = device_profile(lambda: engine.search(items))
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
               "bound_matrices": "bound_matrices",
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
            elif name == "bound_matrices":
                args, kw = a
                got = bound_matrix.bound_matrices(*args, **kw)
                want = ref.bound_matrix(*args)
                ok = bits_equal(got[1], want[1]) and (
                    got[0] is None or bits_equal(got[0], want[0]))
            elif name == "intersect_counts":
                ok = torch.equal(set_intersect.intersect_counts(*a),
                                 ref.set_intersect_count(*a))
            elif name == "min_sq_dists_pairs":
                # (q, ds, q_valid, ds_valid, launch shape)
                ok = bits_equal(hausdorff.min_sq_dists_pairs(*a),
                                ref.min_sq_dists_pairs(*a[:4]))
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
    per_name, busy_ms, wall_ms, _ = device_profile(lambda: engine.search(items))
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


# ---------------------------------------------------------------------------
# phase 16: pairwise Hausdorff, frontier bounds, GBO traversal stats,
# top-k EMD and data discovery
# ---------------------------------------------------------------------------

#: the EMD queries (repository slots), the histogram resolution and k
EMD_QUERIES = (0, 1, 2, 3)
EMD_THETA = 4
#: the curated lake: this many trajectories, k and theta
CURATE_N = 64
CURATE_K = 12
CURATE_THETA = 5


#: the kernels each phase-16 path must launch
PATH_KERNELS = {"pair_exact": ("bound_matrices",),
                "frontier_bounds": ("bound_matrices",),
                "gbo_frontier_stats": ("set_intersect",),
                "curate": ("bound_grid", "hausdorff_grid")}


def row_of(tree, i):
    return type(tree)(*[x[i] for x in tree])


def ulps_above(a: float, b: float) -> int:
    """How many float32 steps a lies above b (a >= b >= 0)."""
    return int(np.float32(a).view(np.int32)) - int(np.float32(b).view(
        np.int32))


def at_shape(name, inputs, shapes, launch, plain, n_ops, reps,
             n_in_bytes=None):
    """A kernel's numbers at one path's operands: ``launch`` and ``plain``
    (the wrapper and its plain version) each return a tensor or a tuple
    of them; the kernel must be bitwise the plain version.  The bound
    counts the inputs' bytes, or ``n_in_bytes`` where the function needs
    fewer than the launch is given."""
    def flat(x):
        return x if isinstance(x, torch.Tensor) else torch.stack(x)

    got, want = flat(launch(*inputs)), flat(plain(*inputs))
    torch.cuda.synchronize()
    if n_in_bytes is None:
        n_in_bytes = nbytes(*inputs)
    entry = kernel_row(name, "", "", shapes, got, want,
                       kernel_times(lambda: launch(*inputs), reps),
                       event_ms(lambda: plain(*inputs), 3, 1),
                       n_in_bytes + nbytes(got), n_ops)
    check(entry["bitwise"], f"{name} at {shapes}: kernel differs from its "
          f"plain version")
    return {key: entry[key] for key in (
        "shapes", "bitwise", "max_abs_err", "ms", "eager_ms", "plain_ms",
        "bound_ms", "bound_by", "bound_pipe")}


def bound_matrices_at(args, reps, bound_matrix, ref, *, one_query=False):
    """``bound_matrices`` at one path's frontiers (oq, rq, od, rd): per
    node pair 3W - 1 FP32 operations for cd^2, then sub, max, add, add,
    and two roots; rd * rd once per corpus node.  With ``one_query`` every
    pair holds a copy of one query frontier (``frontier_bounds``): the
    bound reads it once, and ``query_copy_ms`` times making the copies."""
    oq, rq, od, _ = args
    P, nq, W = oq.shape
    nd = od.shape[1]
    n_in = None
    if one_query:
        check(torch.equal(oq, oq[:1].expand_as(oq))
              and torch.equal(rq, rq[:1].expand_as(rq)),
              "frontier_bounds: the pairs' query frontiers differ")
        n_in = nbytes(oq[0], rq[0], *args[2:])
    entry = at_shape("bound_matrices", args,
                     {"P": P, "nq": nq, "nd": nd, "W": W},
                     bound_matrix.bound_matrices, ref.bound_matrix,
                     {"fp32": P * nq * nd * (3 * W + 3) + P * nd,
                      "mufu": 2 * P * nq * nd}, reps, n_in)
    if one_query:
        q, r = oq[:1], rq[:1]
        entry["query_copy_ms"] = graph_ms(
            lambda: (q.expand(P, -1, -1).contiguous(),
                     r.expand(P, -1).contiguous()), reps)
    return entry


def pair_exact_part(repo, q_batch, res, q_sets, datasets, ops, search,
                    build_query_index, bound_matrix):
    """hausdorff_pair_exact for each query against its ExactHaus winner,
    and on the ring pair: one bound_matrices launch a call; h bitwise the
    engine's value and ``ops.directed_hausdorff_pairs``, except where the
    glb term sets it (counted, within 4 ulp above).  Returns (summary,
    launches, the ring pair's kept operands, the pairs and their h)."""
    dev = q_batch.points.device
    pairs = [(row_of(q_batch, b), row_of(repo.ds_index, int(r.ids[0])),
              r.vals[0]) for b, r in enumerate(res)]
    q_ring, _ = build_query_index(q_sets[0], leaf_capacity=16, theta=THETA,
                                  device=dev)
    d_ring, _ = build_query_index(datasets[0], leaf_capacity=16,
                                  theta=THETA, device=dev)
    pairs.append((q_ring, d_ring, None))
    ops.reset_launches()
    hs, fracs, secs = [], [], []
    with keep_operands([(bound_matrix, "bound_matrices")]) as calls:
        for i, (q, d, _) in enumerate(pairs):
            n0 = ops.LAUNCHES["bound_matrices"]
            (h, pruned), t = sync_time(
                lambda: search.hausdorff_pair_exact(q, d))
            check(ops.LAUNCHES["bound_matrices"] == n0 + 1,
                  f"hausdorff_pair_exact {i}: "
                  f"{ops.LAUNCHES['bound_matrices'] - n0} bound_matrices "
                  f"launches, not 1")
            hs.append(float(h))
            fracs.append(float(pruned))
            secs.append(t)
    launches = dict(ops.LAUNCHES)
    # the gates, after the path's launches are read
    glb_set = []
    for i, ((q, d, engine_h), h) in enumerate(zip(pairs, hs)):
        exact = float(ops.directed_hausdorff_pairs(
            q.points, d.points[None], q.valid, d.valid[None])[0])
        if engine_h is not None:
            check(np.float32(exact) == engine_h,
                  f"pair {i}: directed_hausdorff_pairs {exact!r} is not "
                  f"phase 4's ExactHaus value {engine_h!r}")
        if h != exact:
            up = ulps_above(h, exact)
            check(0 < up <= 4, f"hausdorff_pair_exact {i}: {h!r} is {up} "
                  f"ulp from the exact {exact!r}")
            glb_set.append((i, up))
    args, _ = calls["bound_matrices"][-1]
    checked = check_kept("hausdorff_pair_exact", calls)
    summary = {
        "pairs": len(pairs), "ring_pair_points": [len(q_sets[0]),
                                                  len(datasets[0])],
        "ring_pair_h": hs[-1], "glb_set_pairs": glb_set,
        "pruned_fraction_mean": float(np.mean(fracs)),
        "pruned_fraction_min": min(fracs), "pruned_fraction_max": max(fracs),
        "ring_pair_pruned_fraction": fracs[-1],
        "call_ms_median": float(np.median(secs)) * 1e3,
        "kept_launches_checked": checked,
        "bound_matrices_launches": launches["bound_matrices"]}
    return summary, launches, args, pairs, hs


def pair_approx_part(pairs, hs, eps, search):
    """|hausdorff_pair_approx - hausdorff_pair_exact| <= 2 eps_eff, eps_eff
    as ``topk_hausdorff_approx`` derives it for the pair's two trees."""
    worst = 0.0
    for i, ((q, d, _), h) in enumerate(zip(pairs, hs)):
        a = float(search.hausdorff_pair_approx(q, d, eps))
        radius = []
        for t in (q, d):
            _, r, c = search._level_arrays(t, search.approx_level(t, eps))
            radius.append(float(torch.amax(torch.where(c > 0, r, 0.0))))
        eps_eff = max(eps, *radius)
        worst = max(worst, abs(a - h) / (2 * eps_eff))
        check(abs(a - h) <= 2 * eps_eff + 1e-4,
              f"hausdorff_pair_approx {i}: |{a} - {h}| > 2 eps_eff {eps_eff}")
    return {"pairs": len(pairs), "eps": eps,
            "worst_err_over_2eps_eff": worst}


def frontier_part(repo, q_batch, ops, search, bound_matrix):
    """frontier_bounds at levels 0..3 for 4 queries against every slot:
    one bound_matrices launch a call, bitwise level l of the fused
    bound_grid pass, every kept launch bitwise its plain version.  Returns
    (summary, launches, the kept operands at level 3)."""
    n_q = 4
    batch = type(q_batch)(*[x[:n_q] for x in q_batch])
    LBs, UBs = search._frontier_bound_all_levels(batch, repo.ds_index, 3)
    ops.reset_launches()
    secs = []
    with keep_operands([(bound_matrix, "bound_matrices")]) as calls:
        for b in range(n_q):
            q = row_of(q_batch, b)
            for level in range(4):
                n0 = ops.LAUNCHES["bound_matrices"]
                (LB, UB), t = sync_time(lambda: search.frontier_bounds(
                    q, repo.ds_index, level, level))
                secs.append(t)
                check(ops.LAUNCHES["bound_matrices"] == n0 + 1,
                      f"frontier_bounds: {ops.LAUNCHES['bound_matrices'] - n0}"
                      f" bound_matrices launches, not 1")
                check(bits_equal(LB, LBs[level, b])
                      and bits_equal(UB, UBs[level, b]),
                      f"frontier_bounds query {b} level {level}: not "
                      f"bitwise the bound_grid level")
    launches = dict(ops.LAUNCHES)
    args, _ = calls["bound_matrices"][-1]
    checked = check_kept("frontier_bounds", calls)
    return ({"queries": n_q, "levels": [0, 1, 2, 3], "slots": repo.n_slots,
             "call_ms_median": float(np.median(secs)) * 1e3,
             "kept_launches_checked": checked,
             "bound_matrices_launches": launches["bound_matrices"]},
            launches, args)


def np_gbo_walk(order, valid, depth, occ_d, occ_q, counts, k):
    """The pruned GBO walk of the upper tree in numpy, from the datasets'
    cell occupancy (phase 8's, built from the points): a node's bound is
    the number of the query's cells that any dataset beneath it occupies.
    ``order`` maps tree slots to dataset slots, ``valid`` is in dataset
    order.  Returns, per query, (nodes visited, {surviving leaf: its
    datasets})."""
    n = occ_d.shape[0]
    live = valid[order] & (order < n)
    occ = np.zeros((order.shape[0], occ_d.shape[1]), bool)
    occ[live] = occ_d[order[live]]
    bounds, sizes = [], []
    for level in range(depth + 1):
        nseg = 1 << level
        bounds.append(occ.reshape(nseg, -1, occ.shape[1]).any(axis=1))
        sizes.append(live.reshape(nseg, -1).sum(axis=1))
    sizes = np.concatenate(sizes)
    bounds = (np.concatenate(bounds).astype(np.float32)
              @ occ_q.T.astype(np.float32)).astype(np.int64)  # exact
    first_leaf = (1 << depth) - 1
    out = []
    for b in range(occ_q.shape[0]):
        kth = np.sort(counts[b])[-k]
        visited, leaves, stack = 0, {}, [0]
        while stack:
            node = stack.pop()
            visited += 1
            if sizes[node] == 0 or bounds[node, b] < kth:
                continue
            if node >= first_leaf:
                leaves[node - first_leaf] = int(sizes[node])
                continue
            stack += [2 * node + 1, 2 * node + 2]
        out.append((visited, leaves))
    return out


def gbo_part(repo, q_sigs, gbo_counts, gbo_occ, r_gbo, ops, search,
             set_intersect, ref):
    """gbo_frontier_stats for every query signature: one set_intersect
    launch a call, its counts (the kept launch run again) bitwise its plain
    version and phase 8's numpy counts, the kth value topk_gbo's; its
    nodes visited and surviving leaves those of a numpy walk of the same
    tree from phase 8's cell occupancy, every leaf that holds one of the
    top k among that walk's survivors, and the survivors holding at least
    k datasets.  Returns (summary, launches, the kept operands)."""
    up = repo.repo
    order = up.order.cpu().numpy()
    slot_of = np.argsort(order)                 # dataset slot -> tree slot
    f_up = order.shape[0] >> up.depth
    walks = np_gbo_walk(order, repo.ds_valid.cpu().numpy(), up.depth,
                        *gbo_occ, gbo_counts, K)
    ops.reset_launches()
    stats, secs = [], []
    with keep_operands([(set_intersect, "intersect_counts")]) as calls:
        for b in range(len(r_gbo)):
            n0 = ops.LAUNCHES["set_intersect"]
            st, t = sync_time(
                lambda: search.gbo_frontier_stats(repo, q_sigs[b], K))
            check(ops.LAUNCHES["set_intersect"] == n0 + 1,
                  f"gbo_frontier_stats {b}: "
                  f"{ops.LAUNCHES['set_intersect'] - n0} set_intersect "
                  f"launches, not 1")
            stats.append(st)
            secs.append(t)
    launches = dict(ops.LAUNCHES)
    held = []
    for b, (r, st, (sa, sb), (visited, leaves)) in enumerate(zip(
            r_gbo, stats, calls["intersect_counts"], walks)):
        exact = set_intersect.intersect_counts(sa, sb)[0]
        check(torch.equal(exact, ref.set_intersect_count(sa, sb)[0]),
              f"gbo_frontier_stats {b}: kept launch differs from its plain "
              f"version")
        exact = exact[:N_DATASETS].cpu().numpy()
        check(np.array_equal(exact, gbo_counts[b]),
              f"gbo_frontier_stats {b}: counts differ from phase 8's numpy "
              f"counts")
        check(np.sort(exact)[-K] == r.vals[K - 1],
              f"gbo_frontier_stats {b}: kth {np.sort(exact)[-K]} is not "
              f"topk_gbo's {r.vals[K - 1]}")
        check((st.nodes_evaluated, st.candidates_after_bounds)
              == (visited, len(leaves)),
              f"gbo_frontier_stats {b}: {st.nodes_evaluated} nodes visited "
              f"and {st.candidates_after_bounds} surviving leaves; the "
              f"numpy walk {visited} and {len(leaves)}")
        top = set((slot_of[r.ids] // f_up).tolist())
        check(top <= set(leaves),
              f"gbo_frontier_stats {b}: leaves {sorted(top - set(leaves))} "
              f"hold top-{K} datasets but were pruned")
        held.append(sum(leaves.values()))
        check(held[-1] >= K, f"gbo_frontier_stats {b}: the surviving leaves "
              f"hold {held[-1]} datasets, fewer than k = {K}")
    survivors = [st.candidates_after_bounds for st in stats]
    return ({"queries": len(r_gbo), "k": K, "tree_nodes": up.counts.shape[0],
             "leaf_datasets": f_up,
             "survivors_mean": float(np.mean(survivors)),
             "survivors_min": min(survivors),
             "datasets_in_survivors_min": min(held),
             "nodes_visited_mean": float(np.mean(
                 [st.nodes_evaluated for st in stats])),
             "equal_to_numpy_walk": len(walks),
             "call_ms_median": float(np.median(secs)) * 1e3,
             "set_intersect_launches": launches["set_intersect"]},
            launches, calls["intersect_counts"][0])


def np_sinkhorn(a, b, cost, reg, iters):
    """float64 numpy Sinkhorn, the JAX package's iteration."""
    a = a / max(a.sum(), 1e-9)
    b = b / max(b.sum(), 1e-9)
    K_ = np.exp(-cost / reg)
    v = np.ones_like(b)
    for _ in range(iters):
        u = a / np.maximum(K_ @ v, 1e-9)
        v = b / np.maximum(K_.T @ u, 1e-9)
    return float(np.sum(u[:, None] * K_ * v[None, :] * cost))


def emd_part(repo, ops):
    """topk_emd for 4 repository datasets as queries, full and
    prefiltered: histograms bitwise a numpy bincount; values finite and
    >= 0 and within 1e-4 of the port's CPU run on the same histograms, ids
    equal where neighbouring values differ by more; each query first in
    the full form, and in the prefiltered form wherever the overlap
    prefilter keeps it (it orders by ``hists @ q_hist``, which a dataset
    more concentrated on the query's cells can exceed: such queries are
    counted); the prefiltered values within 1e-4 of the best k of one
    Sinkhorn batch over every slot, restricted to the filter's
    candidates; the largest gap to a float64 numpy Sinkhorn, and each
    form's latency."""
    from repro_torch.core import emd

    check(torch.get_float32_matmul_precision() == "highest",
          f"float32 matmul precision is "
          f"{torch.get_float32_matmul_precision()!r}, not 'highest'")
    n = N_DATASETS
    lo, hi = repo.space_lo, repo.space_hi
    idx = repo.ds_index
    n_cells = 1 << (2 * EMD_THETA)
    hists = emd.cell_histogram(idx.points, idx.valid, lo, hi, EMD_THETA)
    pts, val = idx.points[:n].cpu().numpy(), idx.valid[:n].cpu().numpy()
    cells = np_cells(pts, lo.cpu().numpy(), hi.cpu().numpy(), EMD_THETA)
    rows = np.broadcast_to(np.arange(n)[:, None], val.shape)
    counts = np.bincount((rows * n_cells + cells)[val],
                         minlength=n * n_cells).reshape(n, n_cells)
    want = (counts.astype(np.float32)
            / np.maximum(counts.sum(axis=1, keepdims=True), 1).astype(
                np.float32))
    check(np.array_equal(hists[:n].cpu().numpy().view(np.uint32),
                         want.view(np.uint32)),
          "topk_emd: histograms differ from the numpy bincount")
    del pts, val, cells, rows, counts, want
    cost = emd.cost_matrix(lo, hi, EMD_THETA)
    reg = emd.REG_CELLS / (1 << EMD_THETA)
    cpu = [x.cpu() for x in (hists, repo.ds_valid, cost)]
    prefilter = max(16, 2 * K)
    ops.reset_launches()
    out = {"queries": list(EMD_QUERIES), "k": K, "theta": EMD_THETA,
           "prefilter": prefilter, "slots": repo.n_slots}
    for form, pf in (("full", 0), ("prefiltered", prefilter)):
        lat, gaps, worst_np, dropped = [], 0.0, 0.0, []
        for i in EMD_QUERIES:
            run = lambda: emd.topk_emd(repo, idx.points[i],   # noqa: E731
                                       idx.valid[i], K, theta=EMD_THETA,
                                       prefilter=pf)
            run()
            (v, ids), secs = sync_time(run)
            lat.append(secs * 1e3)
            v, ids = v.cpu().numpy(), ids.cpu().numpy()
            wv, wi = emd.topk_emd_hists(cpu[0][i], *cpu, K, theta=EMD_THETA,
                                        prefilter=pf)
            wv, wi = wv.numpy(), wi.numpy()
            check(np.isfinite(v).all() and (v >= 0).all(),
                  f"topk_emd {form} {i}: values {v}")
            check(np.allclose(v, wv, rtol=1e-4, atol=0),
                  f"topk_emd {form} {i}: {v} not within 1e-4 of the CPU's "
                  f"{wv}")
            sep = np.abs(np.diff(wv)) > 1e-4 * np.abs(wv[1:])
            sure = np.r_[True, sep] & np.r_[sep, True]
            check(np.array_equal(ids[sure], wi[sure]),
                  f"topk_emd {form} {i}: ids {ids} differ from the CPU's "
                  f"{wi} where the values are apart")
            if pf:
                scores = torch.where(repo.ds_valid, hists @ hists[i], -1.0)
                cand = torch.sort(scores, descending=True,
                                  stable=True).indices[:pf]
                kept = bool((cand == i).any())
                if not kept:
                    dropped.append(i)
                every = emd.sinkhorn_emd(hists[i], hists, cost, reg=reg)
                in_cand = torch.zeros_like(repo.ds_valid).index_fill_(
                    0, cand, True)
                sub = torch.where(repo.ds_valid & in_cand, every,
                                  float("inf"))
                sub = torch.sort(sub, stable=True).values[:K].cpu().numpy()
                check(np.allclose(v, sub, rtol=1e-4, atol=0),
                      f"topk_emd {form} {i}: {v} not within 1e-4 of the "
                      f"full batch's best among the candidates {sub}")
            else:
                kept = True
            check(ids[0] == i or not kept,
                  f"topk_emd {form} {i}: ranks {ids[0]} first")
            gaps = max(gaps, float(np.max(np.abs(v - wv) / np.abs(wv))))
            a = hists[i].double().cpu().numpy()
            c64 = cost.double().cpu().numpy()
            for val_, j in zip(v, ids):
                ref64 = np_sinkhorn(a, hists[j].double().cpu().numpy(), c64,
                                    reg, emd.SINKHORN_ITERS)
                worst_np = max(worst_np, abs(float(val_) - ref64) / ref64)
        out[form] = {"latency_ms": lat,
                     "latency_ms_median": float(np.median(lat)),
                     "max_rel_gap_to_cpu": gaps,
                     "max_rel_gap_to_float64_numpy": worst_np}
        if pf:
            out[form]["queries_dropped_by_prefilter"] = dropped
    out["launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
    return out


def curate_part(datasets, dev, ops):
    """curate on 64 trajectories, dataset 0 the exemplar, on the card:
    the selection equal to the port's CPU curate on the same lake."""
    from repro_torch.data import discovery

    lake = datasets[:CURATE_N]
    ops.reset_launches()
    (kept, _, info), secs = sync_time(lambda: discovery.curate(
        lake, lake[0], k=CURATE_K, theta=CURATE_THETA, device=dev))
    launches = dict(ops.LAUNCHES)
    want, _, winfo = discovery.curate(lake, lake[0], k=CURATE_K,
                                      theta=CURATE_THETA, device="cpu")
    check(kept == want and info["search_stats"] == winfo["search_stats"],
          f"curate on the card selected {kept}, on the CPU {want}")
    check(kept[0] == 0, f"curate: the exemplar is not first in {kept}")
    return {"datasets": CURATE_N, "k": CURATE_K, "theta": CURATE_THETA,
            "selected": kept, "deduped_away": info["deduped_away"],
            "card_s": secs,
            "launches": {k: v for k, v in launches.items() if v}}, launches


def pair_ops_phase(repo, q_batch, res, q_sigs, gbo_counts, gbo_occ, r_gbo,
                   eps, q_sets, datasets, rows):
    """Phase 16.  Adds the new paths' launches to each kernel row
    (``pair_launches``) and the path shapes of ``bound_matrices`` and
    ``set_intersect`` to theirs (``at_path_shapes``)."""
    from repro_torch.core import search
    from repro_torch.core.build import build_query_index
    from repro_torch.kernels import bound_matrix, ops, ref, set_intersect

    t0 = time.perf_counter()
    paths = {}
    exact, paths["pair_exact"], pe_args, pairs, hs = pair_exact_part(
        repo, q_batch, res, q_sets, datasets, ops, search, build_query_index,
        bound_matrix)
    log("pair exact: " + json.dumps(exact))
    log("pair approx: " + json.dumps(pair_approx_part(pairs, hs, eps,
                                                      search)))
    fb, paths["frontier_bounds"], fb_args = frontier_part(
        repo, q_batch, ops, search, bound_matrix)
    log("frontier bounds: " + json.dumps(fb))
    gbo, paths["gbo_frontier_stats"], (sa, sb) = gbo_part(
        repo, q_sigs, gbo_counts, gbo_occ, r_gbo, ops, search, set_intersect,
        ref)
    log("gbo frontier stats: " + json.dumps(gbo))
    out = emd_part(repo, ops)
    paths["topk_emd"] = dict(ops.LAUNCHES)
    log("topk emd: " + json.dumps(out))
    cur, paths["curate"] = curate_part(datasets, q_batch.points.device, ops)
    log("curate: " + json.dumps(cur))

    for path, counts in paths.items():
        for name in PATH_KERNELS.get(path, ()):
            check(counts[name] > 0, f"{path} launched no {name}")
    by_name = {r["name"]: r for r in rows}
    by_name["bound_matrices"]["at_path_shapes"] = {
        "pair_exact": bound_matrices_at(pe_args, 50, bound_matrix, ref),
        "frontier_bounds": bound_matrices_at(fb_args, 20, bound_matrix,
                                             ref, one_query=True)}
    # the binary tensor cores' rate is unpublished: bytes bound it
    by_name["set_intersect"]["at_path_shapes"] = {
        "gbo_frontier_stats": at_shape(
            "set_intersect", (sa, sb),
            {"na": sa.shape[0], "nb": sb.shape[0], "W": sa.shape[1]},
            set_intersect.intersect_counts, ref.set_intersect_count, {},
            50)}
    for r in rows:
        r["pair_launches"] = {path: counts[r["name"]]
                              for path, counts in paths.items()}
        for key, e in r.get("at_path_shapes", {}).items():
            log(f"kernel {r['name']} at {key} {e['shapes']}: "
                f"ms={e['ms']:.5f} eager_ms={e['eager_ms']:.4f} "
                f"plain_ms={e['plain_ms']:.4f} bound_ms={e['bound_ms']:.6f} "
                f"({e['bound_pipe']})" + (
                    f" query_copy_ms={e['query_copy_ms']:.5f}"
                    if "query_copy_ms" in e else ""))
    log(f"pair ops phase: {time.perf_counter() - t0:.1f} s")


def swept_inputs(repo, q_batch, k, search, hausdorff, ref):
    """The operands of the three swept kernels at the main path's shapes:
    ``bound_grid`` on phases 0/1's trees (levels 0..3), ``hausdorff_grid``
    on the first phase-2 chunk (the first 32 ascending-LB candidates of
    each query, every lane live, on the compacted query rows and the
    resident corpus; ``grid_in`` is the plain grid's form of it), and
    ``min_sq_dists`` on the oracle's first chunk (query 0 against its
    first 32 candidates) and on one pair of it."""
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
    LB, _, cand, _, _ = search._hausdorff_bound_phases(repo, q_batch, k, 3)
    order = torch.sort(torch.where(cand, LB, ref.BIG), dim=-1,
                       stable=True).indices
    ids = order[:, :32].contiguous()
    pts, pv = repo.ds_index.points, repo.ds_index.valid
    q_c, n_q = search.phase2_query_rows(q_batch)
    live = torch.ones(ids.shape, dtype=torch.bool, device=pts.device)
    qp, qv = q_batch.points, q_batch.valid
    ids0 = ids[0][cand[0, ids[0]]]
    ds0, dsv0 = pts[ids0], pv[ids0]
    return {
        "bg_in": bg_in, "levels": levels,
        "lanes_in": (q_c, n_q, pts, pv, hausdorff.valid_extent(pv), ids,
                     live),
        "grid_in": (qp, pts[ids], qv, pv[ids]),
        "nvalid": pv.sum(dim=-1, dtype=torch.int64),
        "msd_in": (qp[0], ds0, qv[0], dsv0),
        "one": (qp[0], ds0[:1], qv[0], dsv0[:1]),
    }


def variant_rows(rows, sw, autotune, hausdorff, bound_matrix, ops, ref):
    """Every launch shape of the three swept kernels on phase 3's operands
    (the main path's shapes): each bitwise against the plain version, its
    CUDA-graph time beside the row's bound.  Adds ``variants`` and
    ``tuned`` (the shape the tuner installed for that op and shape) to the
    kernel rows."""
    bg_in, levels = sw["bg_in"], sw["levels"]
    lanes_in, grid_in, msd_in = sw["lanes_in"], sw["grid_in"], sw["msd_in"]
    plain = {
        "bound_grid": torch.stack(ref.frontier_bound_levels(*bg_in, levels)),
        "hausdorff_grid": ops.directed_hausdorff_grid_plain(*grid_in),
        "min_sq_dists": ref.min_sq_dists_pairs(*msd_in),
    }
    launch = {
        "bound_grid": lambda cfg: torch.stack(bound_matrix.bound_grid(
            *bg_in, levels=levels, config=cfg)),
        "hausdorff_grid": lambda cfg: hausdorff.hausdorff_lanes(
            *lanes_in, config=cfg),
        "min_sq_dists": lambda cfg: hausdorff.min_sq_dists_pairs(
            *msd_in, config=cfg),
    }
    # the shapes the kernels were keyed on at these operands
    keys = {"bound_grid": (bg_in[0].shape[0], bg_in[3].shape[0]),
            "hausdorff_grid": (lanes_in[2].shape[1],) * 2,
            "min_sq_dists": (msd_in[0].shape[0], msd_in[1].shape[1])}
    dev = bg_in[0].device
    out = {}
    for name in ("bound_grid", "hausdorff_grid", "min_sq_dists"):
        row = next(r for r in rows if r["name"] == name)
        variants = []
        for i, cfg in enumerate(autotune.VARIANTS[name]):
            got = launch[name](cfg)
            torch.cuda.synchronize()
            check(bits_equal(got, plain[name]), f"{name}: variant {i} "
                  f"{cfg.fields()} differs from its plain version")
            ms = graph_ms(lambda cfg=cfg: launch[name](cfg), 10)
            variants.append({"variant": i, **cfg.fields(), "ms": ms,
                             "bitwise": True,
                             "share_of_bound": row["bound_ms"] / ms})
        tuned = autotune.lookup(name, keys[name], dev)
        row["variants"] = variants
        row["tuned"] = {"variant": autotune.variant(name, tuned),
                        **tuned.fields()}
        out[name] = {"tuned": row["tuned"], "variants": variants}
    log("launch-shape variants at the path's shapes: " + json.dumps(out))
    return out


def tune_phase(repo, q_sets, res, lat, rows, k, reps):
    """Phase 17a: ``QueryEngine.tune()`` on the T-Drive engine, every
    variant of the swept kernels gated at the path's shapes, and the
    32-query ExactHaus batch under the tuned table and chunk held bitwise
    to phase 4's."""
    from repro_torch.core import search
    from repro_torch.engine import Query, QueryEngine
    from repro_torch.kernels import autotune, bound_matrix, hausdorff, ops, ref

    engine = QueryEngine(repo, result_cache_size=0)
    e0 = autotune.epoch()
    report, tune_s = sync_time(engine.tune)
    summary = {"tune_s": tune_s, "epoch_before": e0,
               "epoch": autotune.epoch(), "chunk": report["chunk"],
               "device": report["device"]}
    for name in ("min_sq_dists", "hausdorff_grid"):
        summary[name] = report[name]
    summary["bound_grid"] = report["bound_grid"]
    log("tune: " + json.dumps(summary))
    for row in [report["min_sq_dists"], report["hausdorff_grid"],
                *report["bound_grid"].values()]:
        check(not row["plain_only"] and not row["cached"],
              f"tune: {row['key']} was not swept on the card")
        check(row["candidates_rejected_bitwise"] == 0,
              f"tune: {row['key']}: a launch shape differs bitwise from the "
              f"default at the probe")
        check(len(row["timings_s"]) == len(row["candidates"]) == 4,
              f"tune: {row['key']}: not every variant was timed")
    check(engine.default_chunk in report["chunk"]["candidates"],
          "tune: the chunk is not a candidate")

    q_batch = engine.build_queries(q_sets)
    sw = swept_inputs(repo, q_batch, k, search, hausdorff, ref)
    variants = variant_rows(rows, sw, autotune, hausdorff, bound_matrix, ops,
                            ref)
    del sw

    # the main path under the tuned table and chunk
    queries = [Query(op="topk_hausdorff", q=q, k=k, refine_levels=3)
               for q in q_sets]
    engine.search(queries)                                 # warm-up
    ops.reset_launches()
    before = engine.stats.op_seconds.get("topk_hausdorff", 0.0)
    res_t, first_s = sync_time(lambda: engine.search(queries))
    booked = engine.stats.op_seconds["topk_hausdorff"] - before
    launches = dict(ops.LAUNCHES)
    times = [first_s]
    for _ in range(reps - 1):
        times.append(sync_time(lambda: engine.search(queries))[1])
    for i, (a, b) in enumerate(zip(res_t, res)):
        check(np.array_equal(a.vals.view(np.uint32), b.vals.view(np.uint32))
              and np.array_equal(a.ids, b.ids),
              f"tuned ExactHaus: query {i} differs from phase 4's")
    check(launches["hausdorff_grid"] > 0 and launches["bound_grid"] == 1,
          "tuned ExactHaus: the path kernels were not launched")
    tuned = {"chunk": engine.default_chunk,
             "batch_latency_s": float(np.mean(times)),
             "batch_latency_all_s": times,
             "phase4_batch_latency_s": lat,
             "launches_per_search": {n: launches[n] for n in
                                     ("bound_grid", "hausdorff_grid")},
             # the planner's window around the group against the synced
             # wall clock of the same call: near 1 when the window holds
             # the device work (the group reads its counters inside it)
             "op_seconds_share_of_synced_wall": booked / first_s,
             "bitwise_phase4": True}
    log("tuned ExactHaus: " + json.dumps(tuned))
    return {"tune": summary, "variants": variants, "exact": tuned}


def has_ssm(cfg):
    return any(k.startswith("mamba") for k in cfg.block_pattern)


def decode_controls(model, gate_in, n, kv, want, atol, rtol, ctx=None):
    """The two planted faults the decode-vs-forward gate must catch: the
    caches zeroed (the SSM state alone where the config has no
    attention), and the step taken at n - 1 against the caches of the
    first n - 1 inputs (attention: the prefill's caches with slot n - 1
    overwritten; SSM states built by decoding the n - 1 inputs one by one,
    since a prefill needs whole chunks).  Returns each fault's largest
    error against the forward logits at n."""
    cfg = model.cfg
    out = {}
    for fault in ("zeroed_cache", "cache_len_minus_1"):
        _, caches, _ = model.prefill(gate_in[:, :n], n + 2, kv, ctx=ctx)
        at = n
        if fault == "zeroed_cache":
            for c in caches:
                for key, val in c.items():
                    if cfg.has_attention or key == "ssm":
                        val.zero_()
        else:
            at = n - 1
            if has_ssm(cfg):
                caches = model.init_cache(gate_in.shape[0], n + 2, kv)
                for i in range(n - 1):
                    model.decode_step(gate_in[:, i:i + 1], caches, i,
                                      ctx=ctx)
        lg, _ = model.decode_step(gate_in[:, n:n + 1], caches, at, ctx=ctx)
        err = max_abs(lg[:, 0], want)
        check(not torch.allclose(lg[:, 0], want, atol=atol, rtol=rtol),
              f"{cfg.name} {kv}: the decode gate passes a planted fault "
              f"({fault}, max abs {err}; atol {atol}, rtol {rtol})")
        out[fault] = err
    return out


def decode_profile(model, prompts, kv, step_in, decode_ms, ctx=None):
    """One decode step and its argmax, as ``serve.generate`` takes it,
    under torch.profiler after a prefill and one warm step: device busy
    ms, device operations, and the idle share of the unprofiled step time
    ``decode_ms``."""
    n = prompts.shape[1]
    _, caches, _ = model.prefill(prompts, n + 2, kv, ctx=ctx)
    model.decode_step(step_in, caches, n, ctx=ctx)

    def step():
        out, _ = model.decode_step(step_in, caches, n + 1, ctx=ctx)
        return torch.argmax(out[:, -1], dim=-1)

    per_name, busy_ms, wall_ms, n_ops = device_profile(step)
    top = sorted(per_name.items(), key=lambda kv_: -kv_[1])[:5]
    return {"device_busy_ms": busy_ms, "device_ops": n_ops,
            "profiled_wall_ms": wall_ms, "step_ms": decode_ms,
            "idle_share_of_step": 1.0 - busy_ms / decode_ms,
            "top_ops_ms": {k[:80]: v for k, v in top}}


def lm_phase(repo, datasets, card_line):
    """Phase 17b: the trajectory LM ``spadas_trajlm`` at its full config
    (12 x 768, 12 heads, d_ff 3072, vocab 4160, ~116 M parameters), weights
    from a seeded generator, serving 8 prompts of 64 tokens (the smoke's
    trajectories tokenized at theta 6) and generating 32 tokens with the
    bf16 cache and with the int8 cache.  Gates: decode after an n-token
    prefill against the forward logits at position n (the reference's
    bounds), the card's prefill logits against the port's CPU run of the
    same weights and prompts, and the greedy tokens counted against it."""
    from repro_torch import configs
    from repro_torch.data.tokens import tokenize_trajectory
    from repro_torch.launch import serve
    from repro_torch.models.model import LanguageModel

    cfg = configs.get("spadas_trajlm")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab_size)
          == (12, 768, 12, 3072, 4160), "spadas_trajlm: not the full config")
    lo, hi = repo.space_lo, repo.space_hi
    docs = []
    for t in datasets:
        d = tokenize_trajectory(t, lo, hi, LM_THETA)
        if len(d) >= LM_PROMPT:
            docs.append(d[:LM_PROMPT])
        if len(docs) == LM_BATCH:
            break
    prompts = np.stack(docs).astype(np.int64)
    check(prompts.shape == (LM_BATCH, LM_PROMPT)
          and prompts.max() < cfg.vocab_size, "LM prompts")
    dev = repo.space_lo.device
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model, init_s = sync_time(lambda: LanguageModel(cfg, device=dev, seed=0))
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_count(), "LM parameter count")
    cpu_model = LanguageModel(cfg, device="cpu", seed=0)
    tp = torch.as_tensor(prompts, device=dev)
    out = {"config": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "params": n_params,
           "prompts": list(prompts.shape), "gen": LM_GEN,
           "init_s": init_s, "card": card_line}
    for kv, (atol, rtol) in LM_DECODE_BOUNDS.items():
        serve.generate(model, prompts[:, :8], 2, kv)            # warm-up
        pre = [sync_time(lambda: model.prefill(tp, LM_PROMPT + LM_GEN,
                                               kv))[1]
               for _ in range(3)]
        gens = [sync_time(lambda: serve.generate(model, prompts, LM_GEN,
                                                 kv)) for _ in range(3)]
        gen = gens[0][0]
        total_s = float(np.mean([s for _, s in gens]))
        prefill_ms = float(np.mean(pre)) * 1e3
        decode_ms = (total_s * 1e3 - prefill_ms) / (LM_GEN - 1)
        for g, _ in gens[1:]:
            check(torch.equal(g.tokens, gen.tokens), f"LM {kv}: repeated "
                  f"generation differs")
        # decode after an n-token prefill == forward at position n
        full, _ = model(tp)
        _, caches, n = model.prefill(tp[:, :-1], LM_PROMPT + 4, kv)
        lg, _ = model.decode_step(tp[:, -1:], caches, n)
        cons = max_abs(lg[:, 0], full[:, -1])
        check(torch.allclose(lg[:, 0], full[:, -1], atol=atol, rtol=rtol),
              f"LM {kv}: decode after prefill differs from forward by "
              f"{cons} (atol {atol}, rtol {rtol})")
        controls = decode_controls(model, tp, LM_PROMPT - 1, kv,
                                   full[:, -1], atol, rtol)
        step = decode_profile(model, tp, kv, tp[:, -1:], decode_ms)
        # the port's CPU run of the same weights and prompts
        cpu_gen, cpu_s = sync_time(lambda: serve.generate(
            cpu_model, prompts, LM_GEN, kv))
        pre_err = max_abs(gen.logits[0].cpu(), cpu_gen.logits[0])
        check(pre_err <= LM_CPU_ATOL, f"LM {kv}: the card's prefill logits "
              f"differ from the CPU run's by {pre_err} (atol {LM_CPU_ATOL})")
        same = (gen.tokens.cpu() == cpu_gen.tokens).numpy()
        lead = [int(np.argmin(np.append(r, False))) for r in same]
        out[kv] = {
            "prefill_ms": prefill_ms, "prefill_all_s": pre,
            "decode_ms_per_token": decode_ms,
            "decode_tokens_per_s": LM_BATCH / decode_ms * 1e3,
            "tokens_per_s": LM_BATCH * LM_GEN / total_s,
            "generate_all_s": [s for _, s in gens],
            "prefill_decode_max_abs": cons,
            "decode_gate_controls": controls,
            "decode_step_profile": step,
            "prefill_logits_vs_cpu_max_abs": pre_err,
            "logit_scale": float(gen.logits[0].abs().max()),
            "greedy_tokens_equal_cpu": int(same.sum()),
            "greedy_tokens": int(same.size),
            "sequences_equal_cpu": int(same.all(axis=1).sum()),
            "leading_tokens_equal_cpu": lead,
            "cpu_generate_s": cpu_s}
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["lm_peak_above_resident_bytes"] = out["peak_memory_bytes"] - base
    log("lm serve: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 18: the LM's MoE, Mamba-2, hybrid, cross-attention and
# embedding-input kinds
# ---------------------------------------------------------------------------

#: (arch, the cut of its full config (None: the reduced config), prompt
#: tokens): grok-1 at one of its 64 layers (the MoE path), mamba2 at 12
#: of its 48 layers (the SSM path), llama-3.2-vision at one repeat of its
#: 5-layer pattern with its 1,024-token image context (cross-attention),
#: musicgen at 12 of its 48 layers (embedding inputs), each at full
#: width (mamba2 and musicgen, host-bound decode loops, are cut in depth
#: to keep the smoke in its time); jamba, the composition of the
#: MoE and SSM paths, at its reduced config (at full width one repeat of
#: its pattern, 63.6 GB of float32 weights, leaves too little room beside
#: the resident repository).  SSM prompts are one 256-token chunk.
KIND_RUNS = (("grok_1_314b", {"n_layers": 1}, 64),
             ("mamba2_780m", {"n_layers": 12}, 256),
             ("llama3_2_vision_11b", {"n_layers": 5}, 64),
             ("musicgen_medium", {"n_layers": 12}, 64),
             ("jamba_v0_1_52b", None, 256))
#: the six families held against the port's CPU run at their reduced
#: configs
KIND_CPU_ARCHS = ("grok_1_314b", "arctic_480b", "mamba2_780m",
                  "jamba_v0_1_52b", "llama3_2_vision_11b", "musicgen_medium")
#: the cross-attention gate set in every vision model here: it is zero at
#: init, where tanh(0) = 0 would hide the whole cross path from the logits
KIND_XGATE = 0.5
#: card against CPU: each block fed the card's hidden state (and at the
#: MoE the card's MoE input, since top-k routing switches experts on a
#: near tie when its input moves by one bf16 ulp) within 0.03 plus two
#: bf16 ulps of the element (a block sums up to four rounded bf16 terms),
#: and logits end to end within LM_CPU_ATOL (the MoE configs on a copy with
#: every expert chosen and no drop, whose routing is continuous)
KIND_BLOCK_ATOL = 0.03
KIND_BLOCK_RTOL = 2.0 ** -6
#: decode-vs-forward bounds tighter than the reference's (never looser):
#: musicgen's standard normal input embeddings (the JAX driver's stub for
#: EnCodec frames) dominate its residual stream, so a step taken one
#: position early moves its logits by 0.163 / 0.170 (bf16 / int8), under
#: the reference's int8 bound, while decode agrees with forward to 0.041
#: / 0.054 (H100 80GB HBM3, 700 W)
KIND_DECODE_BOUNDS = {"musicgen_medium": {"bf16": (0.1, 0.0),
                                          "int8": (0.1, 0.0)}}


@contextmanager
def config_as(model, **kw):
    """``model`` run under a copy of its config with ``kw`` replaced (the
    weights do not depend on these fields)."""
    import dataclasses

    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, **kw)
    try:
        yield model
    finally:
        model.cfg = cfg


def dropless(cfg):
    """Config fields that keep every token at every expert it is routed
    to: capacity C = S."""
    return ({"capacity_factor": cfg.n_experts / cfg.top_k_experts}
            if cfg.n_experts else {})


def smooth(cfg):
    """Config fields that make routing continuous: every expert chosen,
    C = S."""
    return ({"top_k_experts": cfg.n_experts, "capacity_factor": 1.0}
            if cfg.n_experts else {})


def set_xgate(model, value):
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "xgate"):
                m.xgate.fill_(value)


def kind_serve(arch, cut, prompt_len, dev, card_line):
    """One config of phase 18 served on the card: 8 requests of
    ``prompt_len`` inputs, 32 generated, with the bf16 cache and, where
    the config has attention, the int8 cache; timings, the decode gate
    (dropless for MoE) and its planted faults, one profiled decode step,
    peak memory and the weight-init seconds."""
    import gc

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models.model import LanguageModel

    if cut is None:
        cfg = configs.get_reduced(arch)
    else:
        import dataclasses
        cfg = dataclasses.replace(configs.get(arch), **cut)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model, init_s = sync_time(lambda: LanguageModel(
        cfg, device=dev, seed=0, init_on_device=cut is not None))
    set_xgate(model, KIND_XGATE)
    n_params = sum(p.numel() for p in model.parameters())
    B, P, G = LM_BATCH, prompt_len, LM_GEN
    prompts, ctx, step_embeds = serve.request_inputs(cfg, B, P, G, seed=1)
    # the gate's inputs: n = P, then forward over n + 1 (attention) or
    # 2n (an SSM prefill needs whole chunks)
    m = 2 * P if has_ssm(cfg) else P + 1
    gate_in, _, _ = serve.request_inputs(cfg, B, m, 2, seed=2)
    to = (lambda a: torch.as_tensor(a, device=dev))
    tp, tg = to(prompts), to(gate_in)
    tctx = None if ctx is None else to(ctx)
    step_in = (tp[:, -1:] if cfg.embed_input else to(step_embeds[:, :1]))
    out = {"config": cfg.name, "cut": cut if cut is not None else "reduced",
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": n_params, "prompts": [B, P], "gen": G,
           "context": None if ctx is None else list(ctx.shape),
           "xgate": KIND_XGATE if ctx is not None else None,
           "init_s": init_s, "init_on_device": cut is not None,
           "card": card_line}
    kvs = ("bf16", "int8") if cfg.has_attention else ("bf16",)
    for kv in kvs:
        def gen_run(g=G):
            return serve.generate(model, prompts, g, kv, ctx=ctx,
                                  step_embeds=step_embeds)
        gen_run(2)                                               # warm-up
        pre = [sync_time(lambda: model.prefill(tp, P + G, kv,
                                               ctx=tctx))[1]
               for _ in range(2)]
        gens = [sync_time(gen_run) for _ in range(2)]
        gen = gens[0][0]
        check(torch.equal(gens[1][0].tokens, gen.tokens),
              f"{cfg.name} {kv}: repeated generation differs")
        check(bool(torch.isfinite(gen.logits).all()),
              f"{cfg.name} {kv}: non-finite logits")
        total_s = float(np.mean([s for _, s in gens]))
        prefill_ms = float(np.mean(pre)) * 1e3
        decode_ms = (total_s * 1e3 - prefill_ms) / (G - 1)
        atol, rtol = KIND_DECODE_BOUNDS.get(arch, LM_DECODE_BOUNDS)[kv]
        with config_as(model, **dropless(cfg)):
            full, aux = model(tg, tctx)
            want = full[:, P]
            _, caches, n = model.prefill(tg[:, :P], P + 2, kv, ctx=tctx)
            lg, _ = model.decode_step(tg[:, P:P + 1], caches, n, ctx=tctx)
            cons = max_abs(lg[:, 0], want)
            check(torch.allclose(lg[:, 0], want, atol=atol, rtol=rtol),
                  f"{cfg.name} {kv}: decode after prefill differs from "
                  f"forward by {cons} (atol {atol}, rtol {rtol})")
            controls = decode_controls(model, tg, P, kv, want, atol, rtol,
                                       ctx=tctx)
        step = decode_profile(model, tp, kv, step_in, decode_ms, ctx=tctx)
        out[kv] = {
            "prefill_ms": prefill_ms, "prefill_all_s": pre,
            "decode_ms_per_token": decode_ms,
            "decode_tokens_per_s": B / decode_ms * 1e3,
            "tokens_per_s": B * G / total_s,
            "generate_all_s": [s for _, s in gens],
            "prefill_decode_max_abs": cons,
            "decode_gate_bounds": [atol, rtol],
            "forward_aux": float(aux),
            "decode_gate_controls": controls,
            "decode_step_profile": step,
            "logit_scale": float(gen.logits[0].abs().max())}
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["peak_above_resident_bytes"] = out["peak_memory_bytes"] - base
    del model, full, caches, gen, gens
    gc.collect()
    torch.cuda.empty_cache()
    log("lm kind serve: " + json.dumps(out))
    return out


def blockwise_vs_cpu(card, cpu, inp, ctx):
    """The card model's forward, block by block against the CPU model's:
    each CPU block is fed the card's hidden state and, at the MoE, the
    card's MoE input (``repro_torch.models.moe.moe`` is swapped while the
    CPU block runs).  Returns the largest block and logit differences and
    the aux losses' largest relative difference."""
    from repro_torch.models import moe as moe_lib

    cfg = card.cfg
    x = card._embed_in(inp)
    S = x.shape[1]
    pc, ph = card._positions(0, S), cpu._positions(0, S)
    cc = card._ctx(ctx)
    ch = None if cc is None else cc.cpu()
    orig = moe_lib.moe
    block_err, aux_rel = 0.0, 0.0
    for rep_c, rep_h in zip(card.blocks, cpu.blocks):
        for bc, bh in zip(rep_c, rep_h):
            seen = []

            def spy(p, h, c):
                seen.append(h)
                return orig(p, h, c)

            def fed(p, h, c):
                return orig(p, seen[0].cpu(), c)

            try:
                moe_lib.moe = spy
                y, a, _ = bc.run(x, cfg, ctx=cc, positions=pc)
                moe_lib.moe = fed
                yh, ah, _ = bh.run(x.cpu(), cfg, ctx=ch, positions=ph)
            finally:
                moe_lib.moe = orig
            y_cpu = y.cpu().float()
            check(torch.allclose(y_cpu, yh.float(), atol=KIND_BLOCK_ATOL,
                                 rtol=KIND_BLOCK_RTOL),
                  f"{cfg.name}: the card's {bc.kind} block differs from the "
                  f"CPU's by {max_abs(y_cpu, yh)}")
            block_err = max(block_err, max_abs(y_cpu, yh))
            if float(ah):
                aux_rel = max(aux_rel, abs(float(a) / float(ah) - 1))
            x = y
    lg_err = max_abs(card._logits(x).cpu(), cpu._logits(x.cpu()))
    check(lg_err <= LM_CPU_ATOL, f"{cfg.name}: the card's logits differ from "
          f"the CPU's by {lg_err} on the same hidden state")
    check(aux_rel <= 1e-5, f"{cfg.name}: aux loss differs by {aux_rel}")
    return block_err, lg_err, aux_rel


def kinds_vs_cpu(dev):
    """The card against the port's CPU run of the same weights, on the
    reduced config of each new family: the forward block by block at the
    configured routing, then prefill and three decode steps end to end
    with both caches (MoE configs on their ``smooth`` copy), and the
    greedy tokens of 8 generated, counted."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models.model import LanguageModel

    rows = {}
    for arch in KIND_CPU_ARCHS:
        cfg = configs.get_reduced(arch)
        card = LanguageModel(cfg, device=dev, seed=5)
        cpu = LanguageModel(cfg, device="cpu", seed=5)
        set_xgate(card, KIND_XGATE)
        set_xgate(cpu, KIND_XGATE)
        n = cfg.ssm_chunk if has_ssm(cfg) else 32
        inp, ctx, step_embeds = serve.request_inputs(cfg, 2, 2 * n, 8,
                                                     seed=3)
        tin = torch.as_tensor(inp)
        tctx = None if ctx is None else torch.as_tensor(ctx)
        block_err, lg_err, aux_rel = blockwise_vs_cpu(
            card, cpu, tin.to(dev), None if tctx is None else tctx.to(dev))
        row = {"block_max_abs": block_err, "logits_same_state_max_abs":
               lg_err, "aux_max_rel": aux_rel}
        kvs = ("bf16", "int8") if cfg.has_attention else ("bf16",)
        with config_as(card, **smooth(cfg)), config_as(cpu, **smooth(cfg)):
            for kv in kvs:
                outs = []
                for model in (card, cpu):
                    d = model.device
                    c = None if tctx is None else tctx.to(d)
                    lg, caches, _ = model.prefill(tin[:, :n].to(d), n + 4,
                                                  kv, ctx=c)
                    steps = [lg]
                    for i in range(3):
                        lg, caches = model.decode_step(
                            tin[:, n + i:n + i + 1].to(d), caches, n + i,
                            ctx=c)
                        steps.append(lg)
                    outs.append(torch.cat(steps, dim=1))
                errs = max_abs(outs[0].cpu(), outs[1])
                check(errs <= LM_CPU_ATOL, f"{cfg.name} {kv}: the card's "
                      f"prefill and decode logits differ from the CPU's by "
                      f"{errs} (atol {LM_CPU_ATOL})")
                g_card = serve.generate(card, inp[:, :n], 8, kv, ctx=ctx,
                                        step_embeds=step_embeds)
                g_cpu = serve.generate(cpu, inp[:, :n], 8, kv, ctx=ctx,
                                       step_embeds=step_embeds)
                same = (g_card.tokens.cpu() == g_cpu.tokens).numpy()
                row[kv] = {"prefill_decode_max_abs": errs,
                           "greedy_tokens_equal_cpu": int(same.sum()),
                           "greedy_tokens": int(same.size)}
        rows[cfg.name] = row
        del card, cpu
    log("lm kinds vs cpu: " + json.dumps(rows))
    return rows


def kinds_phase(dev, card_line):
    """Phase 18: the five serving runs, then the reduced configs against
    the CPU.  The LM path runs no kernel of ``repro_torch.kernels``: the
    phase must book no launch."""
    from repro_torch.kernels import ops

    ops.reset_launches()
    for arch, cut, prompt_len in KIND_RUNS:
        kind_serve(arch, cut, prompt_len, dev, card_line)
    kinds_vs_cpu(dev)
    check(not any(ops.LAUNCHES.values()), f"the LM path launched a search "
          f"kernel: {dict(ops.LAUNCHES)}")


# ---------------------------------------------------------------------------
# phase 19: training: the LM trained on data curated on the card
# ---------------------------------------------------------------------------

#: the trainer's defaults (``launch/train.py``) at the full spadas_trajlm:
#: batch 8 x seq 256, a lake of 256 trajectories (``examples/train_lm.py``)
#: curated to k = 64; 60 steps with an async checkpoint every 10
TRAIN_ARGS = ["--arch", "spadas_trajlm", "--batch", "8", "--seq", "256",
              "--lake-size", "256", "--log-every", "20"]
TRAIN_STEPS = 60
TRAIN_CKPT_AT = 30
TRAIN_RESUMED = 10
#: the run's checkpoints are every 10 steps: phase 20 holds the mesh run's
#: state at step 10 against the step-10 checkpoint
TRAIN_CKPT_EVERY = 10
#: steps left out of the step-time statistics (first launches, cuBLAS
#: heuristics, the allocator's first growth)
TRAIN_WARM = 5
#: the published dense bf16 peak of one H100 SXM (989 TFLOP/s at 700 W)
PEAK_BF16 = 989e12
#: one step of the same weights on the card and on the CPU, 2 x 256
#: tokens, lr 1e-3 after one warm-up step, float32 states: both round bf16
#: products of float32 sums taken in another order (the CPU tests' bounds
#: for the port against the JAX package, tests/torch_train_parity.py):
#: loss within 2e-3, grad norm within 2 %, every parameter within 2 lr
#: (Adam moves each by about lr; a gradient near zero may flip its sign)
#: and at most 1.5 % of them past 0.1 lr, the first moments within 5 % of
#: their norm
TRAIN_CPU_BATCH = 2
TRAIN_CPU_LR = 1e-3
TRAIN_CPU_BOUNDS = {"loss_atol": 2e-3, "grad_norm_rtol": 0.02,
                    "param_lr": 2.0 * (1 + 1e-3), "over_share": 0.015,
                    "m_rel": 0.05}
#: the resumed run's losses against the uninterrupted run's (the JAX
#: package's crash-resume bound; bitwise is not asked: the gathers'
#: backward accumulates with atomics on the card)
RESUME_RTOL = 1e-5
#: int8 states against float32 over the first 10 steps of the same
#: batches and weights: each loss within 0.05 (the warm-up keeps the
#: updates small; 0.0179 seen at step 9, H100 80GB HBM3, 700 W; 0.0013 on
#: the reduced config on the CPU)
INT8_STEPS = 10
INT8_LOSS_ATOL = 0.05
#: mamba2_780m whole, int8 states, lr 1e-3 after one warm-up step, 3 steps
#: on one batch of 2 x 256 (one SSD chunk), its config's remat on: the
#: reference's check (tests/test_models_smoke.py::test_train_step)
MAMBA_BATCH = (2, 256)


def model_flops(cfg, model, B, S):
    """The step's model FLOPs, op by op as the port computes them: 6 per
    token and matrix weight (forward and backward of the products; the
    tied table once, as the head: the embedding is a gather) and the
    attention's two S x S products per layer (forward 2, backward 4 of
    2 B S^2 d each; the port computes the whole masked square).  The norm
    scales (vectors) are elementwise: no product."""
    n_mat = sum(p.numel() for p in model.parameters() if p.ndim >= 2)
    return 6 * n_mat * B * S + 12 * cfg.n_layers * B * S * S * cfg.d_model


def state_bytes(opt):
    """Bytes of the optimizer's moments."""
    from repro_torch.train.optimizer import QTensor

    return sum(x.size_bytes() if isinstance(x, QTensor)
               else x.numel() * x.element_size()
               for tree in (opt.m, opt.v) for x in tree.values())


def step_gaps(card_state, cpu_state, lr):
    """Card against CPU after one step: the largest parameter gap in
    units of lr, the share of elements past 0.1 lr, and the first
    moments' relative gap (norm over the whole tree)."""
    worst, over, n, num, den = 0.0, 0, 0, 0.0, 0.0
    cpu_p = dict(cpu_state.params.named_parameters())
    for name, p in card_state.params.named_parameters():
        gap = (p.detach().cpu().double() - cpu_p[name].detach().double()
               ).abs() / lr
        worst = max(worst, float(gap.max()))
        over += int((gap > 0.1).sum())
        n += gap.numel()
        a, b = card_state.opt.m[name].cpu().double(), \
            cpu_state.opt.m[name].double()
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
    return worst, over / n, (num / den) ** 0.5


def train_vs_cpu(cfg, batch, dev):
    """One step of the same weights (seed 1, drawn on the CPU and copied
    to the card) on the card and on the CPU, on the first rows of a
    pipeline batch."""
    import copy

    from repro_torch.models.model import LanguageModel
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    b = {k: v[:TRAIN_CPU_BATCH] for k, v in batch.items()}
    opt = opt_lib.OptConfig(lr=TRAIN_CPU_LR, warmup_steps=1)
    cpu_model = LanguageModel(cfg, device="cpu", seed=1)
    models = {"card": copy.deepcopy(cpu_model).to(dev), "cpu": cpu_model}
    out, states = {}, []
    for where, model in models.items():
        st = ts.train_state_for(model, opt)
        (st, m), secs = sync_time(lambda: ts.make_train_step(cfg, opt)(st, b))
        states.append(st)
        out[where] = {"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]), "step_s": secs}
    worst, over, m_rel = step_gaps(*states, TRAIN_CPU_LR)
    bd = TRAIN_CPU_BOUNDS
    loss_gap = abs(out["card"]["loss"] - out["cpu"]["loss"])
    gn_rel = abs(out["card"]["grad_norm"] / out["cpu"]["grad_norm"] - 1)
    out.update({"tokens": [TRAIN_CPU_BATCH, b["tokens"].shape[1]],
                "loss_gap": loss_gap, "grad_norm_rel": gn_rel,
                "param_gap_lr": worst, "share_past_0.1_lr": over,
                "m_rel": m_rel, "bounds": bd})
    check(loss_gap <= bd["loss_atol"] and gn_rel <= bd["grad_norm_rtol"]
          and worst <= bd["param_lr"] and over <= bd["over_share"]
          and m_rel <= bd["m_rel"],
          f"train step on the card differs from the CPU's: {out}")
    return out


def resume_losses(ckpt_dir, step, cfg, opt, docs, fresh, fault=None):
    """Restore ``step`` into ``fresh`` (a model and optimizer of other
    weights; the restore overwrites it) and take ``TRAIN_RESUMED`` steps
    from the restored pipeline cursor; ``fault`` plants a fault the gate
    must catch: "moments" zeroes the restored moments, "cursor" restarts
    the pipeline at the beginning."""
    from repro_torch.checkpoint import ckpt as ckpt_lib
    from repro_torch.data import tokens as tok
    from repro_torch.train import train_step as ts

    state, extra = ckpt_lib.restore(ckpt_dir, fresh, step=step)
    check(int(state.step) == step and extra["step"] == step,
          f"restored step {int(state.step)}, not {step}")
    if fault == "moments":
        for tree in (state.opt.m, state.opt.v):
            for x in tree.values():
                x.zero_()
    cursor = (None if fault == "cursor" else
              tok.PipelineState.from_dict(extra["pipeline"]))
    pipe = tok.TokenPipeline(docs, 256, 8, seed=0, state=cursor)
    step_fn = ts.make_train_step(cfg, opt)
    losses = []
    for _ in range(TRAIN_RESUMED):
        state, m = step_fn(state, pipe.next_batch())
        losses.append(float(m["loss"]))
    return losses


def resume_gate(got, want):
    return bool(np.allclose(got, want, rtol=RESUME_RTOL, atol=0))


def mamba_train(dev, card_line):
    """mamba2_780m whole at full width (weights drawn on the card), int8
    states: 3 steps on one batch, the second's loss below the first's."""
    import gc

    from repro_torch import configs
    from repro_torch.models.model import LanguageModel
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    cfg = configs.get("mamba2_780m")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = LanguageModel(cfg, device=dev, seed=0, init_on_device=True)
    opt = opt_lib.OptConfig(lr=1e-3, warmup_steps=1, state_dtype="int8")
    state = ts.train_state_for(model, opt)
    B, S = MAMBA_BATCH
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
             for k in ("tokens", "labels")}
    step_fn = ts.make_train_step(cfg, opt)
    losses, secs = [], []
    for _ in range(3):
        (state, m), s = sync_time(lambda: step_fn(state, batch))
        losses.append(float(m["loss"]))
        secs.append(s)
    check(all(np.isfinite(losses)), f"mamba2_780m: losses {losses}")
    check(losses[1] < losses[0], f"mamba2_780m: the second step's loss "
          f"{losses[1]} is not below the first's {losses[0]}")
    n_params = sum(p.numel() for p in model.parameters())
    out = {"config": cfg.name, "params": n_params, "layers": cfg.n_layers,
           "remat": cfg.remat, "batch": [B, S], "state_dtype": "int8",
           "losses": losses, "step_s": secs,
           "state_bytes_per_param": state_bytes(state.opt) / n_params,
           "peak_above_resident_bytes":
               torch.cuda.max_memory_allocated() - base,
           "card": card_line}
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_phase(dev, rows, card_line):
    """Phase 19.  The full spadas_trajlm trained by
    ``launch.train.run`` (curation on the card, 60 steps, an async
    checkpoint every 10), its curation's kernel launches booked as
    ``train_launches``, one step profiled, the card against the CPU, the
    resume gate with its planted faults, int8 states, and mamba2_780m's
    full-width steps.  The train steps launch none of the six kernels: the
    resumed run (10 steps) launches what the 60-step run did, and every
    step taken outside ``launch.train`` launches nothing."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.data import tokens as tok
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models.model import LanguageModel
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get("spadas_trajlm"), remat=False)
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size) == (12, 768, 4160),
          "spadas_trajlm: not the full config")
    opt = opt_lib.OptConfig(lr=3e-4, warmup_steps=20)   # the trainer's
    B, S = 8, 256
    tmp = Path(tempfile.mkdtemp(prefix="smoke_train_"))
    try:
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        run, run_s = sync_time(lambda: train.run(
            TRAIN_ARGS + ["--steps", str(TRAIN_STEPS), "--ckpt-every",
                          str(TRAIN_CKPT_EVERY), "--ckpt-dir",
                          str(tmp / "a")]))
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - base
        for name in ("bound_grid", "hausdorff_grid"):
            check(launches[name] > 0, f"the trainer's curation launched no "
                  f"{name}")
        losses = run.losses
        check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
              f"training losses {losses}")
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        check(last < first, f"the loss did not fall: mean of the first 10 "
              f"{first}, of the last 10 {last}")
        model = run.state.params
        n_params = sum(p.numel() for p in model.parameters())
        check(n_params == cfg.param_count() == 116_460_288,
              f"parameters {n_params}")
        steady = np.asarray(run.step_s[TRAIN_WARM:])
        step_ms = float(np.median(steady)) * 1e3
        flops = model_flops(cfg, model, B, S)
        resident = (sum(p.numel() * p.element_size()
                        for p in model.parameters())
                    + state_bytes(run.state.opt))
        ops.reset_launches()
        step_fn = ts.make_train_step(cfg, opt)
        batch = run.pipeline.next_batch()
        state = run.state
        state, _ = step_fn(state, batch)                 # warm, unprofiled

        def one_step():
            nonlocal state
            state, m = step_fn(state, batch)
            return m["loss"]

        per_name, busy_ms, wall_ms, n_ops = device_profile(one_step)
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
        out = {
            "config": cfg.name, "params": n_params, "batch": [B, S],
            "steps": TRAIN_STEPS, "lr": opt.lr, "warmup": opt.warmup_steps,
            "run_s": run_s, "setup_s": run_s - float(sum(run.step_s)),
            "loss_first": losses[0], "loss_last": losses[-1],
            "loss_mean_first10": first, "loss_mean_last10": last,
            "step_ms_median": step_ms,
            "step_ms_p10_p90": [float(np.percentile(steady, q)) * 1e3
                                for q in (10, 90)],
            "step_ms_min_max": [float(steady.min()) * 1e3,
                                float(steady.max()) * 1e3],
            "first_steps_ms": [s * 1e3 for s in run.step_s[:TRAIN_WARM]],
            "tokens_per_s": B * S / step_ms * 1e3,
            "model_flops_per_step": flops,
            "bound_ms_bf16": flops / PEAK_BF16 * 1e3,
            "model_flop_share": flops / (step_ms * 1e-3) / PEAK_BF16,
            "peak_above_resident_bytes": peak,
            "state_bytes_per_param": state_bytes(state.opt) / n_params,
            "step_profile": {"device_ops": n_ops, "device_busy_ms": busy_ms,
                             "profiled_wall_ms": wall_ms,
                             "idle_share_of_step": 1.0 - busy_ms / step_ms,
                             "top_ops_ms": {k[:80]: v for k, v in top}},
            "launches": {k: v for k, v in launches.items() if v},
            "card": card_line}
        log("train run: " + json.dumps(out))
        docs = run.pipeline.docs
        ref = {"losses": losses[:MESH_STEPS + 1], "docs": docs,
               "params": ckpt_params(tmp / "a" / cfg.name
                                     / f"step_{MESH_STEPS:08d}"),
               "step_ms": step_ms, "flops": flops,
               "resident_bytes": resident}
        del run, state, model
        for r in rows:
            r["train_launches"] = launches[r["name"]]

        # card against the CPU, one step of the same weights
        log("train card vs cpu: " + json.dumps(train_vs_cpu(cfg, batch,
                                                            dev)))
        step_launches = dict(ops.LAUNCHES)

        # resume: launch.train from the step-30 checkpoint (its curation
        # launches what the 60-step run's did), then the gate's own loop
        # with and without a planted fault
        name = cfg.name
        shutil.copytree(tmp / "a" / name / f"step_{TRAIN_CKPT_AT:08d}",
                        tmp / "b" / name / f"step_{TRAIN_CKPT_AT:08d}")
        want = losses[TRAIN_CKPT_AT:TRAIN_CKPT_AT + TRAIN_RESUMED]
        ops.reset_launches()
        resumed, resume_s = sync_time(lambda: train.main(
            TRAIN_ARGS + ["--steps", str(TRAIN_CKPT_AT + TRAIN_RESUMED),
                          "--ckpt-every", str(TRAIN_STEPS), "--resume",
                          "--ckpt-dir", str(tmp / "b")]))
        check(dict(ops.LAUNCHES) == launches, f"the resumed run (10 steps) "
              f"launched {dict(ops.LAUNCHES)}, the 60-step run {launches}: "
              f"the train steps must launch no kernel")
        ops.reset_launches()
        fresh = ts.train_state_for(LanguageModel(
            cfg, device=dev, seed=7, init_on_device=True), opt)
        gate = {"launch_train": resumed}
        for fault in (None, "moments", "cursor"):
            gate[fault or "restored"] = resume_losses(
                tmp / "a" / name, TRAIN_CKPT_AT, cfg, opt, docs, fresh,
                fault)
        del fresh
        rel = {k: float(np.max(np.abs(np.asarray(v) / np.asarray(want)
                                      - 1))) for k, v in gate.items()}
        check(resume_gate(resumed, want) and
              resume_gate(gate["restored"], want),
              f"resumed losses differ from the uninterrupted run's: {rel}")
        for fault in ("moments", "cursor"):
            check(not resume_gate(gate[fault], want), f"the resume gate "
                  f"passes a planted fault ({fault}): {rel}")
        log("train resume: " + json.dumps({
            "from_step": TRAIN_CKPT_AT, "steps": TRAIN_RESUMED,
            "uninterrupted": want, "max_rel_gap": rel,
            "rtol": RESUME_RTOL, "launch_train_resume_s": resume_s,
            **gate}))

        # int8 states on the same weights and batches as the run's first
        # ten steps
        opt8 = dataclasses.replace(opt, state_dtype="int8")
        st8 = ts.init_train_state(cfg, opt8, device=dev, seed=0)
        pipe = tok.TokenPipeline(docs, S, B, seed=0)
        step8 = ts.make_train_step(cfg, opt8)
        l8 = []
        for _ in range(INT8_STEPS):
            st8, m = step8(st8, pipe.next_batch())
            l8.append(float(m["loss"]))
        gap8 = float(np.max(np.abs(np.asarray(l8)
                                   - np.asarray(losses[:INT8_STEPS]))))
        b8 = state_bytes(st8.opt)
        check(gap8 <= INT8_LOSS_ATOL, f"int8 states: losses {l8} against "
              f"float32 {losses[:INT8_STEPS]}")
        log("train int8: " + json.dumps({
            "steps": INT8_STEPS, "losses": l8,
            "fp32_losses": losses[:INT8_STEPS], "max_loss_gap": gap8,
            "atol": INT8_LOSS_ATOL, "state_bytes": b8,
            "state_bytes_per_param": b8 / n_params,
            "fp32_state_bytes_per_param": 8.0}))
        del st8
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    log("train mamba2: " + json.dumps(mamba_train(dev, card_line)))
    for counts in (step_launches, dict(ops.LAUNCHES)):
        check(not any(counts.values()), f"the train steps launched a "
              f"search kernel: {counts}")
    log(f"phase 19: {time.perf_counter() - t0:.1f} s")
    return ref


def ckpt_params(step_dir: Path) -> dict:
    """The ``.params/...`` leaves of a committed checkpoint, as numpy."""
    manifest = json.loads((step_dir / "manifest.json").read_text())
    out = {}
    for key, info in manifest["leaves"].items():
        if key.startswith(".params/"):
            with np.load(step_dir / f"shard_{info['shard']}.npz") as f:
                out[key] = f[key.replace("/", "__")]
    return out


# ---------------------------------------------------------------------------
# phase 20: training on the test mesh, its eight coordinates on the card
# ---------------------------------------------------------------------------

#: the trainer's ``--mesh test`` (data 4 x model 2) over eight entries of
#: the card, phase 19's arguments (the same seed, curation and pipeline),
#: 10 steps; the reference is phase 19's own first 10 steps
MESH_STEPS = 10
MESH_DEVICES = ["cuda:0"] * 8
#: the second mesh of phase 20: one data group over four model
#: coordinates (12 heads, d_ff 3072 and 4160 tokens split in four),
#: 3 steps against phase 19's first 3
MESH_1X4_STEPS = 3
MESH_1X4_DEVICES = ["cuda:0"] * 4
#: each step's loss against phase 19's: the mesh step sums 4 groups'
#: gradients of 2 rows where one device takes one backward over 8, and
#: sums each group's partial products over the model axis after rounding
#: them to bf16, so only the order of sums and the bf16 products'
#: blocking differ (predicted gap <= 5e-4; the port's CPU tests hold a
#: mesh step to the JAX mesh step at 2e-3, the bound kept here)
MESH_LOSS_ATOL = 2e-3
#: the parameters at step 10 against phase 19's step-10 checkpoint, in
#: units of the run's lr (3e-4): at most 1 % of the elements past 0.1 lr
#: (phase 19's card-against-CPU bound is 1.5 % after one step)
MESH_OVER_SHARE = 0.01


def mesh_bytes_predicted(params) -> list:
    """Each coordinate's bytes from the specs alone: every parameter's
    block (its numel over the product of the mesh axes its spec names)
    for the params and the two float32 moments."""
    mesh = params.mesh
    per = 0
    for name, x in params.tensors.items():
        spec = params.shardings[name].spec
        split = 1
        for entry in spec:
            for axis in ((entry,) if isinstance(entry, str)
                         else (entry or ())):
                split *= mesh.shape[axis]
        per += x.shards[0].element_size() * 3 * (
            int(np.prod(x.shape)) // split)
    return [per] * len(mesh.flat)


def mesh_train_phase(dev, rows, ref, card_line):
    """Phase 20.  ``launch.train.run(..., "--mesh", "test")`` over eight
    entries of the card: the full spadas_trajlm, phase 19's arguments, 10
    steps, a checkpoint at step 10 (gathered leaves, the JAX layout); its
    curation's launches booked as ``mesh_train_launches``.  Gates: each
    loss against phase 19's, the state at step 10 against phase 19's
    step-10 checkpoint, each coordinate's resident bytes against the
    specs, and the mesh checkpoint restored onto one device, equal to the
    mesh state leaf for leaf, stepping on to phase 19's loss at step 11;
    the steps launch no search kernel."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import ckpt as ckpt_lib
    from repro_torch.data import tokens as tok
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import convert
    from repro_torch.models.model import LanguageModel
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="smoke_mesh_train_"))
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        run, run_s = sync_time(lambda: train.run(
            TRAIN_ARGS + ["--mesh", "test", "--steps", str(MESH_STEPS),
                          "--ckpt-every", str(MESH_STEPS), "--ckpt-dir",
                          str(tmp)], devices=MESH_DEVICES))
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - base
        for name in ("bound_grid", "hausdorff_grid"):
            check(launches[name] > 0, f"the mesh trainer's curation "
                  f"launched no {name}")
        for r in rows:
            r["mesh_train_launches"] = launches[r["name"]]
        state = run.state
        params = state.params
        mesh = params.mesh
        check(mesh.shape == {"data": 4, "model": 2}
              and mesh.flat == [torch.device(d) for d in MESH_DEVICES],
              f"the mesh is {mesh.shape} over {mesh.flat}")
        cfg = params.cfg

        # each step's loss against phase 19's first 10
        losses = run.losses
        gaps = np.abs(np.asarray(losses) - np.asarray(ref["losses"][:10]))
        check(len(losses) == MESH_STEPS and gaps.max() <= MESH_LOSS_ATOL,
              f"mesh losses {losses} against one device "
              f"{ref['losses'][:10]}")

        # the state at step 10 against phase 19's step-10 checkpoint
        leaves = convert.state_leaves(state)
        worst, over, n = 0.0, 0, 0
        for key, want in ref["params"].items():
            gap = np.abs(leaves[key].cpu().double().numpy()
                         - want.astype(np.float64)) / 3e-4
            worst = max(worst, float(gap.max()))
            over += int((gap > 0.1).sum())
            n += gap.size
        check(over / n <= MESH_OVER_SHARE, f"the mesh state at step 10: "
              f"{over / n:.4%} of the elements past 0.1 lr")

        # resident bytes of each coordinate against the specs
        got = ts.state_device_bytes(state)
        want_b = mesh_bytes_predicted(params)
        check(got == want_b, f"per-device bytes {got}, the specs say "
              f"{want_b}")

        # the mesh checkpoint (step 10) restored onto one device, stepping
        # on: its loss at step 11 against phase 19's
        ops.reset_launches()
        opt = opt_lib.OptConfig(lr=3e-4, warmup_steps=20)   # the trainer's
        fresh = ts.train_state_for(LanguageModel(
            cfg, device=dev, seed=7, init_on_device=True), opt)
        restored, extra = ckpt_lib.restore(tmp / cfg.name, fresh)
        check(int(restored.step) == MESH_STEPS, "restored step")
        back = convert.state_leaves(restored)
        check(all(torch.equal(back[k].cpu(), leaves[k].cpu())
                  for k in leaves if not hasattr(leaves[k], "codes")),
              "the one-device restore differs from the mesh state")
        pipe = tok.TokenPipeline(ref["docs"], 256, 8, seed=0,
                                 state=tok.PipelineState.from_dict(
                                     extra["pipeline"]))
        restored, m = ts.make_train_step(cfg, opt)(restored,
                                                   pipe.next_batch())
        loss11 = float(m["loss"])
        check(abs(loss11 - ref["losses"][MESH_STEPS]) <= MESH_LOSS_ATOL,
              f"step 11 on one device from the mesh checkpoint: {loss11}, "
              f"phase 19: {ref['losses'][MESH_STEPS]}")
        del restored, fresh, back

        # one more mesh step under the profiler
        step_fn = ts.make_train_step(cfg, opt,
                                     param_shardings=params.shardings)
        batch = run.pipeline.next_batch()

        def one_step():
            nonlocal state
            state, met = step_fn(state, batch)
            return met["loss"]

        per_name, busy_ms, wall_ms, n_ops = device_profile(one_step)
        check(not any(ops.LAUNCHES.values()), f"the train steps launched a "
              f"search kernel: {dict(ops.LAUNCHES)}")
        check(ts.computes_on_model_axis(cfg, mesh), "the (4, 2) step does "
              "not compute on the model axis")
        steady = np.asarray(run.step_s[TRAIN_WARM:])
        step_ms = float(np.median(steady)) * 1e3
        step_s_all = list(run.step_s)
        del state, run

        # (1, 4): one data group over four model coordinates
        torch.cuda.synchronize()
        base4 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run4, run4_s = sync_time(lambda: train.run(
            TRAIN_ARGS + ["--mesh", "1x4", "--steps", str(MESH_1X4_STEPS),
                          "--ckpt-every", "1000", "--ckpt-dir",
                          str(tmp / "1x4")], devices=MESH_1X4_DEVICES))
        peak4 = torch.cuda.max_memory_allocated() - base4
        check(run4.state.params.mesh.shape == {"data": 1, "model": 4},
              f"the (1, 4) mesh is {run4.state.params.mesh.shape}")
        gaps4 = np.abs(np.asarray(run4.losses)
                       - np.asarray(ref["losses"][:MESH_1X4_STEPS]))
        check(len(run4.losses) == MESH_1X4_STEPS
              and gaps4.max() <= MESH_LOSS_ATOL,
              f"(1, 4) losses {run4.losses} against one device "
              f"{ref['losses'][:MESH_1X4_STEPS]}")
        mesh_1x4 = {
            "mesh": run4.state.params.mesh.shape,
            "devices": MESH_1X4_DEVICES, "steps": MESH_1X4_STEPS,
            "run_s": run4_s, "losses": run4.losses,
            "loss_gaps": gaps4.tolist(), "max_loss_gap": float(gaps4.max()),
            "step_ms": [t * 1e3 for t in run4.step_s],
            "device_bytes": ts.state_device_bytes(run4.state),
            "peak_above_resident_bytes": peak4}
        del run4
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
        log("mesh train: " + json.dumps({
            "config": cfg.name, "mesh": mesh.shape, "devices": MESH_DEVICES,
            "batch": [8, 256], "steps": MESH_STEPS, "run_s": run_s,
            "setup_s": run_s - float(sum(step_s_all)),
            "losses": losses, "one_device_losses": ref["losses"][:10],
            "loss_gaps": gaps.tolist(), "max_loss_gap": float(gaps.max()),
            "loss_atol": MESH_LOSS_ATOL,
            "step10_param_gap_lr": worst,
            "step10_share_past_0.1_lr": over / n,
            "over_share_bound": MESH_OVER_SHARE,
            "step_ms_median": step_ms,
            "step_ms_min_max": [float(steady.min()) * 1e3,
                                float(steady.max()) * 1e3],
            "first_steps_ms": [t * 1e3 for t in step_s_all[:TRAIN_WARM]],
            "tokens_per_s": 8 * 256 / step_ms * 1e3,
            "device_bytes": got, "device_bytes_predicted": want_b,
            "whole_state_bytes": sum(
                3 * 4 * int(np.prod(x.shape))
                for x in params.tensors.values()),
            "peak_above_resident_bytes": peak,
            "restored_step11_loss": loss11,
            "one_device_step11_loss": ref["losses"][MESH_STEPS],
            "step_profile": {"device_ops": n_ops, "device_busy_ms": busy_ms,
                             "profiled_wall_ms": wall_ms,
                             "idle_share_of_step": 1.0 - busy_ms / wall_ms,
                             "top_ops_ms": {k[:80]: v for k, v in top}},
            "launches": {k: v for k, v in launches.items() if v},
            "mesh_1x4": mesh_1x4, "card": card_line}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 20: {time.perf_counter() - t0:.1f} s")
    return {"device_bytes": got, "step_ms": step_ms}

# ---------------------------------------------------------------------------
# phase 21: the dry run and the roofline against what the card ran
# ---------------------------------------------------------------------------

#: the dry run's predicted peak against the card's peak allocated bytes
#: over one step above what was allocated before it, within 10 % (1 MiB
#: below 10 MiB), the card adding its allocator's rounding and its
#: kernels' scratch.  A one-device cell predicts its record's temp_bytes;
#: the (4, 2) mesh over one card the lead coordinate's temp_bytes plus
#: one whole gradient set: on one card the later groups' passes run
#: beside the running gradient sum, and at 2 rows a group's activations
#: are small beside the gradient tail at the lead, which sets the peak
DRYRUN_TEMP_RTOL = 0.10
DRYRUN_TEMP_ATOL = 1 << 20
DRYRUN_BUDGET_S = 20.0


def step_peak(fn):
    """(fn's result, the card's peak allocated bytes during it above what
    was allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def plan_state_bytes(plan) -> list:
    """Each coordinate's bytes of a train plan's params and moments."""
    from repro_torch.launch.specs import block_bytes

    n = len(plan.mesh.flat)
    per = [0] * n
    for name, t in plan.abstract_args.items():
        if name.startswith(("params/", "opt.")):
            per = [u + v for u, v in zip(
                per, block_bytes(t, plan.in_shardings[name], n))]
    return per


def temp_check(name, rec, measured, extra=0):
    """The predicted peak (the record's temp_bytes plus ``extra``) against
    the card's measured peak."""
    want = rec["memory"]["temp_bytes"] + extra
    check(abs(measured - want) <= max(DRYRUN_TEMP_RTOL * want,
                                      DRYRUN_TEMP_ATOL),
          f"dry run {name}: predicted peak {want} B, the card's {measured} B")
    return {"predicted_temp_bytes": rec["memory"]["temp_bytes"],
            "predicted_peak_bytes": want, "measured_peak_bytes": measured,
            "ratio": measured / want}


def dryrun_phase(dev, train_ref, mesh_ref, lm_ref, card_line):
    """Phase 21.  The dry run (``launch.specs`` + ``launch.dryrun``) of
    the cells the card ran in this call, on meta tensors: phase 19's
    one-device train step (full spadas_trajlm, 8 x 256, remat off, float32
    states), phase 20's (4, 2) mesh step over ``["cuda:0"] * 8`` and phase
    17's decode step (8 prompts, bf16 cache of 96 positions).  Gates: the
    records' resident bytes equal what the card holds (phase 19's state,
    phase 20's 174,892,032 a coordinate, the decode's params and caches);
    the phase-19 FLOPs equal the smoke's op-by-op count; each predicted
    peak against one step's on the card (``temp_check``); no kernel
    launched; the phase within ``DRYRUN_BUDGET_S``.  Prints the roofline
    of each record (H100 terms) beside the step ms the card measured."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, roofline, specs
    from repro_torch.launch import sharding as sh
    from repro_torch.models.model import LanguageModel
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    t0 = time.perf_counter()
    ops.reset_launches()
    cfg = dataclasses.replace(configs.get("spadas_trajlm"), remat=False)
    opt = opt_lib.OptConfig(lr=3e-4, warmup_steps=20)     # the trainer's
    B, S = 8, 256

    def meta_record(label, cell, devices):
        shape = (4, 2) if len(devices) == 8 else (1, 1)
        mesh = dist.grid_mesh(shape, ("data", "model"), devices, label)
        plan = specs.make_plan(cfg, label, mesh, shapes={label: cell})
        return plan, dryrun.record(plan, cfg, cfg.name, label, label,
                                   *cell[1:])

    def roof(rec, measured_ms):
        a = roofline.analyze(rec)
        bound_ms = max(a["compute_s"], a["memory_s"],
                       a["collective_s"]) * 1e3
        return {"compute_ms": a["compute_s"] * 1e3,
                "memory_ms": a["memory_s"] * 1e3,
                "collective_ms": a["collective_s"] * 1e3,
                "bound_ms": bound_ms, "bottleneck": a["bottleneck"],
                "measured_ms": measured_ms,
                "bound_share_of_measured": bound_ms / measured_ms,
                "roofline_fraction": a["roofline_fraction"]}

    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             dtype=torch.int32, device=dev)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    out = {"card": card_line}

    # phase 19's cell, one device
    plan, rec = meta_record("train_1x1", ("train", B, S), [dev])
    check(rec["flops_per_device"] == train_ref["flops"], f"dry-run FLOPs "
          f"{rec['flops_per_device']}, phase 19's count {train_ref['flops']}")
    model = LanguageModel(cfg, device=dev, seed=0, init_on_device=True)
    state = ts.train_state_for(model, opt)
    held = (sum(p.numel() * p.element_size() for p in model.parameters())
            + state_bytes(state.opt))
    parts = rec["memory"]["argument_parts"]
    check(parts["params"] + parts["opt"] == held == train_ref[
        "resident_bytes"], f"dry-run state bytes {parts}, the card's {held}, "
        f"phase 19's {train_ref['resident_bytes']}")
    step = ts.make_train_step(cfg, opt)
    state, _ = step(state, batch)                           # warm
    (state, _), peak = step_peak(lambda: step(state, batch))
    out["train_1x1"] = {
        "flops_per_device": rec["flops_per_device"],
        "flop_counts": rec["flop_counts"],
        "phase19_model_flops": train_ref["flops"],
        "argument_bytes": rec["memory"]["argument_bytes"],
        "state_bytes": held, "bytes_per_device": rec["bytes_per_device"],
        "trace_s": rec["trace_s"],
        "temp": temp_check("train_1x1", rec, peak),
        "roofline": roof(rec, train_ref["step_ms"])}
    del state, model, step

    # phase 20's cell: (4, 2) over eight entries of the card
    plan, rec = meta_record("train_4x2", ("train", B, S), MESH_DEVICES)
    per = plan_state_bytes(plan)
    check(per == mesh_ref["device_bytes"] == [174_892_032] * 8,
          f"dry-run bytes a coordinate {per}, phase 20's "
          f"{mesh_ref['device_bytes']}")
    groups, m_axis = rec["compute"]["groups"], rec["compute"]["model_axis"]
    check(rec["flops_per_device"] * groups * m_axis == train_ref["flops"]
          and rec["flops_total"] == train_ref["flops"],
          f"dry-run (4, 2) FLOPs: the lead's {rec['flops_per_device']}, "
          f"the cell's {rec['flops_total']}; phase 19's count "
          f"{train_ref['flops']} over {groups} groups x {m_axis} model "
          f"coordinates")
    model = LanguageModel(cfg, device=dev, seed=0, init_on_device=True)
    grad_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    mesh = plan.mesh
    p_shard = sh.param_shardings(dict(model.named_parameters()), mesh)
    state = ts.shard_state(ts.train_state_for(model, opt), p_shard)
    check(ts.state_device_bytes(state) == per, "placed bytes")
    step = ts.make_train_step(cfg, opt, param_shardings=p_shard)
    state, _ = step(state, batch)                           # warm
    (state, _), peak = step_peak(lambda: step(state, batch))
    out["train_4x2"] = {
        "flops_per_device": rec["flops_per_device"],
        "flops_total": rec["flops_total"], "compute": rec["compute"],
        "state_bytes_per_coordinate": per,
        "argument_bytes": rec["memory"]["argument_bytes"],
        "work_bytes": rec["memory"]["work_bytes"],
        "collectives_moved_bytes_per_coordinate":
            rec["collective_moved_bytes_per_coordinate"],
        "trace_s": rec["trace_s"],
        "temp": temp_check("train_4x2", rec, peak, extra=grad_bytes),
        "roofline": roof(rec, mesh_ref["step_ms"])}
    del state, model, step

    # phase 17's decode step: 8 prompts, a bf16 cache of 96 positions
    T = LM_PROMPT + LM_GEN
    plan, rec = meta_record("decode_1x1", ("decode", LM_BATCH, T), [dev])
    model = LanguageModel(configs.get("spadas_trajlm"), device=dev, seed=0,
                          init_on_device=True)
    caches = model.init_cache(LM_BATCH, T, "bf16")
    held = (sum(p.numel() * p.element_size() for p in model.parameters())
            + sum(v.numel() * v.element_size() for c in caches
                  for v in c.values()))
    parts = rec["memory"]["argument_parts"]
    check(parts["params"] + parts["caches"] == held, f"dry-run decode "
          f"bytes {parts}, the card's {held}")
    tok = tokens[:LM_BATCH, :1]
    model.decode_step(tok, caches, T - 1)                   # warm
    _, peak = step_peak(lambda: model.decode_step(tok, caches, T - 1))
    out["decode_1x1"] = {
        "flops_per_device": rec["flops_per_device"],
        "argument_bytes": rec["memory"]["argument_bytes"],
        "params_and_caches_bytes": held, "trace_s": rec["trace_s"],
        "temp": temp_check("decode_1x1", rec, peak),
        "roofline": roof(rec, lm_ref["bf16"]["decode_ms_per_token"])}
    del model, caches

    check(not any(ops.LAUNCHES.values()), f"the dry-run phase launched a "
          f"search kernel: {dict(ops.LAUNCHES)}")
    phase_s = time.perf_counter() - t0
    out["phase_s"] = phase_s
    log("dryrun: " + json.dumps(out))
    check(phase_s <= DRYRUN_BUDGET_S, f"phase 21 took {phase_s:.1f} s")
    log(f"phase 21: {phase_s:.1f} s")


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
    sw = swept_inputs(repo, q_batch, k, search, hausdorff, ref)
    bg_in, levels = sw["bg_in"], sw["levels"]
    got = bound_matrix.bound_grid(*bg_in, levels=levels)
    want = ref.frontier_bound_levels(*bg_in, levels)
    torch.cuda.synchronize()
    B, S, W = bg_in[0].shape[0], bg_in[3].shape[0], bg_in[0].shape[2]
    row = kernel_row(
        "bound_grid", "src/repro_torch/csrc/bound_grid.cu",
        "src/repro/kernels/bound_matrix.py:84",
        {"B": B, "S": S, "N": bg_in[0].shape[1], "W": W, "L": len(levels)},
        torch.stack(got), torch.stack(want),
        kernel_times(lambda: bound_matrix.bound_grid(*bg_in, levels=levels),
                     20),
        event_ms(lambda: ref.frontier_bound_levels(*bg_in, levels), 3, 1),
        nbytes(*bg_in, *got), bound_grid_ops(bg_in, levels))
    rows.append(row)
    log_row(row)

    # a real phase-2 chunk, every lane live, on the path's compacted query
    # rows and the resident corpus
    lanes_in, grid_in = sw["lanes_in"], sw["grid_in"]
    got = hausdorff.hausdorff_lanes(*lanes_in)
    want = ops.directed_hausdorff_grid_plain(*grid_in)
    torch.cuda.synchronize()
    nvalid = sw["nvalid"]
    q_c, ids, pts = lanes_in[0], lanes_in[5], lanes_in[2]
    row = kernel_row(
        "hausdorff_grid", "src/repro_torch/csrc/hausdorff_grid.cu",
        "src/repro/kernels/hausdorff.py:96",
        {"B": ids.shape[0], "C": ids.shape[1], "nq": grid_in[0].shape[1],
         "nqp": q_c.shape[1], "nd": pts.shape[1], "W": pts.shape[2]},
        got, want,
        kernel_times(lambda: hausdorff.hausdorff_lanes(*lanes_in), 10),
        event_ms(lambda: ops.directed_hausdorff_grid_plain(*grid_in), 2, 1),
        *lanes_work(lanes_in, nvalid))
    rows.append(row)
    log_row(row)

    # the oracle's first chunk: query 0 against its first 32 ascending-LB
    # candidates, gathered from the corpus as topk_hausdorff_host does
    msd_in, one = sw["msd_in"], sw["one"]
    got = hausdorff.min_sq_dists_pairs(*msd_in)
    want = ref.min_sq_dists_pairs(*msd_in)
    torch.cuda.synchronize()
    q0, ds0 = msd_in[0], msd_in[1]
    row = kernel_row(
        "min_sq_dists", "src/repro_torch/csrc/min_sq_dists.cu",
        "src/repro/kernels/hausdorff.py:34",
        {"P": ds0.shape[0], "nq": q0.shape[0], "nd": ds0.shape[1],
         "W": q0.shape[1]}, got, want,
        kernel_times(lambda: hausdorff.min_sq_dists_pairs(*msd_in), 20),
        event_ms(lambda: ref.min_sq_dists_pairs(*msd_in), 3, 1),
        *pairs_work(msd_in, [got], roots=False))
    # one pair of the chunk, as the single-pair op launches it
    row["p1_ms"] = graph_ms(lambda: hausdorff.min_sq_dists_pairs(*one), 50)
    row["p1_bound_ms"] = least_ms(*pairs_work(one, [got[:1]], roots=False))[0]
    rows.append(row)
    log_row(row)
    for r in rows:
        check(r["bitwise"], f"{r['name']}: kernel differs from its plain "
              f"version (max abs diff {r['max_abs_diff']})")
    del got, want, sw, lanes_in, grid_in, msd_in, one, q_c, ids, ds0

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
    per_name, busy_ms, wall_ms, _ = device_profile(lambda: engine.search(queries))
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
    per_name, busy_ms, wall_ms, _ = device_profile(lambda: engine.search(items))
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
    launches["nn_distance"], gbo_counts, gbo_occ = dataset_point_gates(
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

    # ---- 16. pairwise Hausdorff, frontier bounds, GBO stats, EMD, curate
    pair_ops_phase(repo, q_batch, res, q_sigs, gbo_counts, gbo_occ,
                   res2[2 * N_QUERIES:3 * N_QUERIES], eps, q_sets, datasets,
                   rows)

    # ---- 17. routing and autotune, then the trajectory LM --------------
    t17 = time.perf_counter()
    tune_phase(repo, q_sets, res, lat, rows, k, reps)
    lm_ref = lm_phase(repo, datasets, smi[0])
    log(f"phase 17: {time.perf_counter() - t17:.1f} s")

    # ---- 18. the LM's MoE, Mamba-2, hybrid, cross and embedding kinds ---
    t18 = time.perf_counter()
    kinds_phase(dev, smi[0])
    log(f"phase 18: {time.perf_counter() - t18:.1f} s")

    # ---- 19. training: the LM trained on data curated on the card -------
    train_ref = train_phase(dev, rows, smi[0])

    # ---- 20. training on the test mesh, eight coordinates on the card ---
    mesh_ref = mesh_train_phase(dev, rows, train_ref, smi[0])

    # ---- 21. the dry run and the roofline against the card --------------
    dryrun_phase(dev, train_ref, mesh_ref, lm_ref, smi[0])
    del train_ref
    rows += j_rows
    log(f"smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port's ExactHaus path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

It takes no options: the sizes are fixed at T-Drive's scale, so every
kernel line it prints is at the main path's shapes.

Phases, each of which must pass (any failure raises and exits non-zero):

  1. the card's name and power limit, and the build of the CUDA kernels
     from ``src/repro_torch/csrc`` (one nvcc per source, in parallel);
  2. the repository build on the card: 10,357 random-walk trajectories of
     100-2,800 points (~15 M points, T-Drive's scale), outlier removal on;
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes, bitwise, with CUDA-event times;
  4. the main path: ``QueryEngine.search`` on 32 held-out trajectories,
     ``Query(op="topk_hausdorff", k=10)``, one warm-up pass then timed
     passes, with the launch counters of both path kernels read around one
     pass, then one more pass under ``torch.profiler`` for the device time
     of each kernel and the device's idle share;
  5. the ExactHaus oracle ``topk_hausdorff_host`` (the third kernel) on 4 of
     those queries, bitwise against the engine, and a small repository
     checked against a numpy brute force.

The second-to-last line is the kernel table as JSON, the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's ``src/`` beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# the main path: T-Drive's 10,357 taxis, a burst of 32 held-out queries
N_DATASETS = 10357
N_QUERIES = 32


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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.contiguous(), b.contiguous()
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def kernel_row(name, source, replaces, shapes, got, want, ms, plain_ms,
               n_bytes, n_ops):
    bound_bytes = n_bytes / PEAK_BYTES * 1e3
    bound_ops = n_ops / PEAK_FP32 * 1e3
    err = max_abs(got, want)
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "shapes": shapes,
        "launches": None,                  # filled from the main path's run
        "bitwise": bits_equal(got, want),
        # one number under both names: ``max_abs_err`` is the kernel-line
        # format's key, ``max_abs_diff`` the name PERF.md and the docs use
        "max_abs_err": err, "max_abs_diff": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": None,
        "bytes": n_bytes, "fp32_ops": n_ops,
    }


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


def main() -> int:
    if len(sys.argv) > 1:
        print("chip_smoke: takes no arguments", file=sys.stderr)
        return 2
    k, reps = 10, 3

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
    log(f"kernel build: {build_s:.2f} s ({len(_build.KERNELS)} sources, "
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
    pairs = sum((b - a) ** 2 for a, b in levels)
    row = kernel_row(
        "bound_grid", "src/repro_torch/csrc/bound_grid.cu",
        "src/repro/kernels/bound_matrix.py:84",
        {"B": B, "S": S, "N": n_nodes, "W": W, "L": len(levels)},
        torch.stack(got), torch.stack(want),
        event_ms(lambda: bound_matrix.bound_grid(*bg_in, levels=levels), 20),
        event_ms(lambda: ref.frontier_bound_levels(*bg_in, levels), 3, 1),
        nbytes(*bg_in, *got),
        # the least the function needs.  Per node pair: 3W-1 for cd^2,
        # sqrt, sub (cd - rd), add (cd^2 + rd^2), sqrt, 2 row mins.  Per
        # (b, s, query node): the "+ rq" and "max(., 0)", which commute with
        # the row min (rounding is monotonic), and 2 level maxes.  Per
        # (s, corpus node): rd*rd, shared by every query.
        B * S * (pairs * (3 * W + 5) + 4 * sum(b - a for a, b in levels))
        + S * n_nodes)
    rows.append(row)
    log(f"kernel bound_grid: bitwise={row['bitwise']} "
        f"max_abs_diff={row['max_abs_diff']} ms={row['ms']:.4f} "
        f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f}")

    # a real phase-2 chunk: the first 32 ascending-LB candidates per query
    LB, tau, cand, _, _ = search._hausdorff_bound_phases(repo, q_batch, k, 3)
    order = torch.sort(torch.where(cand, LB, ref.BIG), dim=-1,
                       stable=True).indices
    ids = order[:, :32]
    ds, dsv = repo.ds_index.points[ids], repo.ds_index.valid[ids]
    qp, qv = q_batch.points, q_batch.valid
    got = hausdorff.hausdorff_grid(qp, ds, qv, dsv)
    want = ops.directed_hausdorff_grid_plain(qp, ds, qv, dsv)
    torch.cuda.synchronize()
    Bq, C, nd, W = ds.shape
    nq = qp.shape[1]
    valid_pairs = int((qv.sum(1).double()[:, None]
                       * dsv.sum(2).double()).sum())
    row = kernel_row(
        "hausdorff_grid", "src/repro_torch/csrc/hausdorff_grid.cu",
        "src/repro/kernels/hausdorff.py:96",
        {"B": Bq, "C": C, "nq": nq, "nd": nd, "W": W}, got, want,
        event_ms(lambda: hausdorff.hausdorff_grid(qp, ds, qv, dsv), 10),
        event_ms(lambda: ops.directed_hausdorff_grid_plain(qp, ds, qv, dsv),
                 2, 1),
        nbytes(qp, qv, ds, dsv, got),
        # valid (row, point) pairs x (W sub, W mul, W-1 add, 1 min), plus
        # min, sqrt, max per valid (query row, candidate)
        valid_pairs * (3 * W) + C * int(qv.sum()) * 3)
    rows.append(row)
    log(f"kernel hausdorff_grid: bitwise={row['bitwise']} "
        f"max_abs_diff={row['max_abs_diff']} ms={row['ms']:.4f} "
        f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f}")

    # one (Q, D) pair at (4096, 4096): query 0 against its first candidate
    q0, d0, dv0 = qp[0], ds[0, 0], dsv[0, 0]
    got = hausdorff.min_sq_dists(q0, d0, dv0)
    want = ref.min_sq_dists(q0, d0, dv0)
    torch.cuda.synchronize()
    row = kernel_row(
        "min_sq_dists", "src/repro_torch/csrc/min_sq_dists.cu",
        "src/repro/kernels/hausdorff.py:34",
        {"nq": q0.shape[0], "nd": d0.shape[0], "W": q0.shape[1]}, got, want,
        event_ms(lambda: hausdorff.min_sq_dists(q0, d0, dv0), 50),
        event_ms(lambda: ref.min_sq_dists(q0, d0, dv0), 10),
        nbytes(q0, d0, dv0, got),
        q0.shape[0] * int(dv0.sum()) * (3 * q0.shape[1]))
    rows.append(row)
    log(f"kernel min_sq_dists: bitwise={row['bitwise']} "
        f"max_abs_diff={row['max_abs_diff']} ms={row['ms']:.4f} "
        f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f}")
    for r in rows:
        check(r["bitwise"], f"{r['name']}: kernel differs from its plain "
              f"version (max abs diff {r['max_abs_diff']})")
    del got, want, ds, dsv, LB, cand, order

    # ---- 4. the main path: QueryEngine.search ---------------------------
    res, warm_s = sync_time(lambda: engine.search(queries))   # warm-up
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
    if not per_name:
        log("device profile: not measured (the profiler saw no device work)")
    else:
        by_kernel = {n: sum(t for e, t in per_name.items()
                            if f"{n}_kernel" in e)
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

    # ---- 5. the oracle on the card, and a brute-force check -------------
    ops.reset_launches()
    n_check = min(4, N_QUERIES)
    for i in range(n_check):
        row_i = type(q_batch)(*[x[i] for x in q_batch])
        vh, ih, sh = search.topk_hausdorff_host(repo, row_i, k,
                                                refine_levels=3, chunk=32)
        vh, ih = vh.cpu().numpy(), ih.cpu().numpy()
        check(np.array_equal(vh.view(np.uint32), res[i].vals.view(np.uint32)),
              f"query {i}: engine vals differ from topk_hausdorff_host")
        check(np.array_equal(ih, res[i].ids),
              f"query {i}: engine ids differ from topk_hausdorff_host")
        check(sh.exact_evaluations == res[i].stats.exact_evaluations,
              f"query {i}: exact_evaluations differ")
    oracle_launches = ops.LAUNCHES["min_sq_dists"]
    check(oracle_launches > 0, "min_sq_dists was not launched by the oracle")
    launches["min_sq_dists"] = oracle_launches
    log(f"oracle: {n_check} queries bitwise equal to the engine "
        f"(vals, ids, exact_evaluations); min_sq_dists launches "
        f"{oracle_launches}")

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

    for r in rows:
        r["launches"] = launches[r["name"]]
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Multi-pod dry run: every (architecture x input shape) cell of the JAX
grid built on ``meta`` tensors through the port's own model, train step
and placement rules, with a record per cell of what each mesh coordinate
holds, computes, reads and writes, and moves.

Counterpart of ``repro.launch.dryrun``.  The JAX module lowers and
compiles each cell and reads XLA's memory and cost analyses and the
compiled HLO; here the plan (``launch/specs.py``) is run once on meta
tensors, which have shapes and no values, under two dispatch modes:
``torch.utils.flop_counter.FlopCounterMode`` and :class:`Tracer`, which
books each dispatched op's bytes and the storages it makes.  The record
keeps the JAX field names and meanings:

  * ``memory.argument_bytes``: the resident bytes of the step's inputs on
    the coordinate that holds the most (its blocks of the params, the
    moments, the error feedback, the batch and the caches, from
    ``shard_slices``; the 0-d ``count`` / ``step`` on the lead), with
    every coordinate's in ``argument_bytes_per_coordinate`` and the
    lead's parts in ``argument_parts``;
  * ``memory.temp_bytes``: the peak of the live bytes of the storages the
    busiest coordinate's work makes (outputs included while they live);
    ``output_bytes``: the bytes of what it returns, ``alias_bytes`` those
    of them written into an input's storage (in place), from the same
    pass; ``generated_code_bytes`` 0: eager PyTorch compiles no program
    per cell (the CUDA kernels of the search paths are not on these
    steps); ``work_bytes``: the params the lead keeps to compute on
    (the mesh step's work model: the whole params, or where the model
    axis computes, its model blocks), 0 on one device;
  * ``flops_per_device``: ``FlopCounterMode`` over the busiest
    coordinate's work (the products: matmul, bmm, convolution), as the
    port's code places it (``compute`` names the placement; where the
    model axis computes, the lead's part, the other coordinates' results
    arriving as stand-ins); ``flops_total``: the cell's, the busiest
    coordinate's times the computing ones (the data groups' passes are
    equal, and so are a group's model coordinates' where the vocabulary
    divides the axis: an undivided head is coordinate 0's alone);
  * ``bytes_per_device``: the sum over the busiest coordinate's
    dispatched ops of their input and output tensor bytes, views
    excluded: an eager op's HBM traffic;
  * ``collectives``: the busiest coordinate's bytes moved between
    coordinates, under the JAX op names, with ``bytes`` (the result),
    ``moved_bytes`` (what arrives there) and ``count``; booked by mesh
    coordinate, not by ``torch.device``, so that a meta mesh, ``["cuda:0"]
    * 8`` and eight cards count the same;
  * ``trace_s`` in place of ``lower_s`` and ``compile_s``.

Not ported: ``parse_collectives`` reads XLA's HLO text, which has no
torch counterpart (ROADMAP 14j); ``probe_cell`` corrects XLA's cost
analysis, which counts a ``scan`` body once, and eager counting
dispatches every repeat; the module's ``XLA_FLAGS`` line (512 forced host
devices) has no counterpart: a mesh here is a list of devices,
``["meta"] * 512`` for ``--mesh multi``.

Usage:
  python -m repro_torch.launch.dryrun --arch yi_9b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class Tracer(TorchDispatchMode):
    """Books the ops dispatched under it: ``op_bytes``, each non-view
    op's input and output tensor bytes; ``live`` / ``peak``, the bytes of
    the storages its ops made (a storage is booked when an op first
    returns it and released when it dies); ``ops``, the ops run."""

    def __init__(self):
        super().__init__()
        self.op_bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.made = set()      # keys of the live storages booked here

    def _release(self, key: int, nbytes: int) -> None:
        self.made.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        out = func(*args, **kwargs)
        self.ops += 1
        if func.is_view:
            return out
        outs = _tensors(out)
        self.op_bytes += sum(t.numel() * t.element_size()
                             for t in ins + outs)
        had = {_storage_key(t) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in had or key in self.made:
                continue
            self.made.add(key)
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._release, key, st.nbytes())
        return out


def book(moves: list, n: int) -> list:
    """Per coordinate (``mesh.flat`` order), the collectives of ``moves``
    ((coordinate, op, bytes, moved bytes) bookings): op -> bytes, moved
    bytes, count."""
    out = [{op: {"bytes": 0, "moved_bytes": 0.0, "count": 0}
            for op in COLLECTIVE_OPS} for _ in range(n)]
    for c, op, nbytes, moved in moves:
        out[c][op]["bytes"] += nbytes
        out[c][op]["moved_bytes"] += float(moved)
        out[c][op]["count"] += 1
    return out


def argument_bytes(plan) -> tuple:
    """(each coordinate's resident input bytes, the lead's by part:
    params, opt, err, batch, caches, scalars)."""
    from repro_torch.launch.specs import block_bytes

    n = len(plan.mesh.flat)
    per = [0] * n
    parts: dict = {}
    for name, t in plan.abstract_args.items():
        b = block_bytes(t, plan.in_shardings[name], n)
        per = [u + v for u, v in zip(per, b)]
        part = name.split("/")[0].split(".")[0] if "/" in name else "scalars"
        parts[part] = parts.get(part, 0) + b[0]
    return per, parts


def trace_plan(plan) -> dict:
    """Run ``plan.step_fn`` once under the FLOP counter and the tracer;
    the numbers of the busiest coordinate."""
    t0 = time.perf_counter()
    tracer = Tracer()
    with FlopCounterMode(display=False) as fc, tracer:
        out = plan.step_fn()
    trace_s = time.perf_counter() - t0
    outs = _tensors(out)
    seen, out_b, alias_b = set(), 0, 0
    for t in outs:
        key = _storage_key(t)
        if key in seen:
            continue
        seen.add(key)
        nb = t.untyped_storage().nbytes()
        out_b += nb
        if key not in tracer.made:
            alias_b += nb
    return {"flops": float(fc.get_total_flops()),
            "flop_counts": {str(k): int(v) for k, v in
                            fc.get_flop_counts().get("Global", {}).items()},
            "op_bytes": float(tracer.op_bytes), "ops": tracer.ops,
            "temp_bytes": tracer.peak, "output_bytes": out_b,
            "alias_bytes": alias_b, "trace_s": trace_s}


def record(plan, cfg, arch: str, shape_name: str, mesh_kind: str, B: int,
           S: int, tag: str = "") -> dict:
    """The dry-run record of one planned cell (global batch ``B``, seq
    ``S``)."""
    n = len(plan.mesh.flat)
    per, parts = argument_bytes(plan)
    tr = trace_plan(plan)
    colls = book(plan.moves, n)
    moved = [sum(v["moved_bytes"] for v in c.values()) for c in colls]
    lead = colls[0]
    computing = (plan.compute.get("groups", 1)
                 * plan.compute.get("model_axis", 1))
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "tag": tag, "status": "ok",
        "cell_kind": plan.kind, "batch": B, "seq": S,
        "n_devices": n,
        "model_params": int(cfg.param_count()),
        "model_params_active": int(cfg.active_param_count()),
        "flops_per_device": tr["flops"],
        "flops_total": tr["flops"] * computing,
        "flop_counts": tr["flop_counts"],
        "bytes_per_device": tr["op_bytes"],
        "ops_traced": tr["ops"],
        "compute": plan.compute,
        "memory": {
            "argument_bytes": max(per),
            "output_bytes": tr["output_bytes"],
            "temp_bytes": tr["temp_bytes"],
            "alias_bytes": tr["alias_bytes"],
            "generated_code_bytes": 0,
            "work_bytes": plan.work_bytes,
            "argument_parts": parts,
            "argument_bytes_per_coordinate": per,
        },
        "collectives": lead,
        "collective_bytes_total": sum(v["bytes"] for v in lead.values()),
        "collective_moved_bytes_total": moved[0],
        "collective_moved_bytes_per_coordinate": moved,
        "trace_s": round(tr["trace_s"], 3),
    }


def test_shapes(shapes: dict) -> dict:
    """A copy of ``shapes`` shrunk for the CPU (``--test``): batch
    max(8, B // 32), seq at most 512."""
    return {k: (kind, max(8, B // 32), min(S, 512))
            for k, (kind, B, S) in shapes.items()}


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path,
             *, test: bool = False, plan_kw: dict | None = None,
             tag: str = "") -> dict:
    """Plan and trace one cell on the ``single`` or ``multi`` mesh
    (``make_test_mesh`` with ``test``, else ``make_production_mesh``) over
    ``["meta"] * n``, and write its record."""
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import specs

    cfg = configs.get_reduced(arch) if test else configs.get(arch)
    shapes = test_shapes(specs.SHAPES) if test else dict(specs.SHAPES)
    _, B, S = shapes[shape_name]
    if not specs.runnable(cfg, shape_name):
        rec = {
            "arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "status": "skipped", "reason": specs.SKIP_REASON,
        }
        _dump(out_dir, arch, shape_name, mesh_kind, rec, tag)
        return rec
    make = mesh_lib.make_test_mesh if test else mesh_lib.make_production_mesh
    multi = mesh_kind == "multi"
    shape = (mesh_lib.TEST_SHAPES if test
             else mesh_lib.PRODUCTION_SHAPES)[multi]
    n = 1
    for e in shape:
        n *= e
    mesh = make(multi_pod=multi, devices=["meta"] * n)
    plan_kw = dict(plan_kw or {})
    overrides = plan_kw.pop("cfg_overrides", None)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    plan = specs.make_plan(cfg, shape_name, mesh, shapes=shapes, **plan_kw)
    rec = record(plan, cfg, arch, shape_name, mesh_kind, B, S, tag)
    print({k: rec[k] for k in ("flops_per_device", "bytes_per_device")},
          {k: rec["memory"][k] for k in ("argument_bytes", "temp_bytes")},
          flush=True)
    _dump(out_dir, arch, shape_name, mesh_kind, rec, tag)
    return rec


def _dump(out_dir: Path, arch, shape, mesh_kind, rec, tag=""):
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = out_dir / f"{arch}__{shape}__{mesh_kind}{suffix}.json"
    path.write_text(json.dumps(rec, indent=2))
    print(f"[dryrun] wrote {path}", flush=True)


def parse_opts(opt: str) -> dict:
    """``--opt``'s comma list as ``make_plan`` keywords (and
    ``cfg_overrides``)."""
    plan_kw: dict = {}
    rules_override: dict = {}
    for item in [s for s in opt.split(",") if s]:
        if item == "constrain_grads":
            raise SystemExit(
                "--opt constrain_grads has no port yet: it pins the "
                "gradients to the params' shardings (the gradients' "
                "reduce-scatter), and the port's mesh step sums whole "
                "gradients at the lead (ROADMAP 14k (b))")
        if item == "compress":
            plan_kw["compress"] = True
        elif item.startswith("microbatch="):
            plan_kw["microbatch"] = int(item.split("=")[1])
        elif item.startswith("kvseq="):
            v = item.split("=")[1]
            rules_override["kvseq"] = None if v == "none" else v
        elif item.startswith("expert="):
            v = item.split("=")[1]
            rules_override["expert"] = None if v == "none" else v
        elif item == "kvint8":
            plan_kw["cfg_overrides"] = {"kv_cache_dtype": "int8"}
        else:
            raise SystemExit(f"unknown --opt item {item}")
    if rules_override:
        plan_kw["rules_override"] = rules_override
    return plan_kw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--test", action="store_true",
                    help="reduced configs + 8-device mesh (CI)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="",
                    help="variant tag appended to output filenames")
    ap.add_argument("--opt", default="",
                    help="comma list of plan opts: compress,"
                         "microbatch=N,kvseq=none,expert=model,kvint8 "
                         "(constrain_grads exits: ROADMAP 14k (b))")
    args = ap.parse_args(argv)
    plan_kw = parse_opts(args.opt)

    from repro_torch.launch import specs
    out_dir = Path(args.out)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = list(specs.all_cells(include_skips=True))
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        raise SystemExit("dryrun: give --arch and --shape, or --all")

    failures = []
    for arch, shape in cells:
        for mk in meshes:
            suffix = f"__{args.tag}" if args.tag else ""
            f = out_dir / f"{arch}__{shape}__{mk}{suffix}.json"
            if args.skip_existing and f.exists():
                st = json.loads(f.read_text()).get("status")
                if st in ("ok", "skipped"):
                    print(f"[dryrun] skip existing {f}", flush=True)
                    continue
            print(f"=== {arch} / {shape} / {mk} ===", flush=True)
            try:
                rec = run_cell(arch, shape, mk, out_dir, test=args.test,
                               plan_kw=dict(plan_kw), tag=args.tag)
                print(f"[dryrun] {rec['status']}", flush=True)
            except Exception as e:   # a cell's failure is recorded, not fatal
                traceback.print_exc()
                failures.append((arch, shape, mk, repr(e)))
                _dump(out_dir, arch, shape, mk,
                      {"arch": arch, "shape": shape, "mesh": mk,
                       "status": "error", "error": repr(e)}, args.tag)
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:", flush=True)
        for f in failures:
            print("   ", f, flush=True)
        sys.exit(1)
    print("[dryrun] all cells ok", flush=True)


if __name__ == "__main__":
    main()

"""End-to-end trainer: the LM trained on data curated by Spadas.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch spadas_trajlm \\
        --steps 200 --batch 8 --seq 256          # on the card

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --steps 4 --mesh test        # (4, 2) over 8 x the CPU

Counterpart of ``repro.launch.train``, with its flags and its wiring:
Spadas data curation (``data.discovery.curate`` on the device, so
ExactHaus runs its kernels there) -> token pipeline -> train step ->
watchdog -> async checkpointing.  ``--device`` names the device (the card
by default; without one it raises).

``--mesh test|single|multi`` trains on the JAX package's grids
(``launch.mesh``: (4, 2), (16, 16), (2, 16, 16)), ``--mesh DxM`` on a
(data, model) grid of any extents, with the state placed
by its rules (``launch.sharding.param_shardings``) and the mesh step of
``train.train_step``.  The mesh is the visible cards, or ``devices``
where a caller of :func:`run` lists them (``["cuda:0"] * 8`` holds the
test mesh on one card); with ``--device cpu`` it is that many entries of
the CPU.  Too few devices raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import re
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch import configs
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.data import synthetic, tokens as tok_lib
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as sh
from repro_torch.models import sharding_rules
from repro_torch.runtime.straggler import (StepWatchdog, StragglerEvent,
                                           WatchdogConfig)
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts


class TrainRun(NamedTuple):
    """What :func:`run` returns: the loss of each step it took, each
    step's seconds (host clock around the step and a device sync, as the
    watchdog takes them), the final state, and the pipeline (its cursor
    after the last batch)."""
    losses: list
    step_s: list
    state: ts.TrainState
    pipeline: tok_lib.TokenPipeline


def build_pipeline(cfg, args, device):
    """spadas_trajlm: curate ``--lake-size`` random-walk trajectories on
    ``device`` against the first as exemplar, and tokenize the selection;
    another config: a synthetic corpus of token ids."""
    if args.arch == "spadas_trajlm":
        from repro_torch.data import discovery
        # grid resolution must match the vocab: 4^theta cells + specials
        theta = int(math.log(cfg.vocab_size - tok_lib.SPECIALS, 4))
        lake = synthetic.trajectory_repository(args.lake_size, seed=0)
        selected, repo, info = discovery.curate(
            lake, lake[0], k=min(64, args.lake_size), theta=theta,
            device=device)
        print(f"[train] Spadas curated {len(selected)} shards "
              f"(deduped {info['deduped_away']})")
        return discovery.pipeline_from_selection(
            lake, selected, repo, theta=theta, seq_len=args.seq,
            batch=args.batch)
    docs = tok_lib.synthetic_corpus(2048, cfg.vocab_size, seed=0)
    return tok_lib.TokenPipeline(docs, args.seq, args.batch, seed=0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="spadas_trajlm")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test reduced config")
    ap.add_argument("--mesh", default="none", type=_mesh_kind,
                    help="none, test, single, multi, or DxM: a (data, "
                         "model) grid of D x M devices")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lake-size", type=int, default=128)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _mesh_kind(kind: str) -> str:
    if kind in ("none", "test", "single", "multi") or re.fullmatch(
            r"[1-9][0-9]*x[1-9][0-9]*", kind):
        return kind
    raise argparse.ArgumentTypeError(f"--mesh {kind!r}: none, test, single, "
                                     f"multi or DxM")


def make_mesh(kind: str, device=None, devices=None):
    """The ``--mesh`` grid (None for ``none``): over ``devices`` where
    given, else over as many entries of ``device`` as it needs when that
    is the CPU, else over the visible cards."""
    if kind == "none":
        return None
    multi = kind == "multi"
    grid = (tuple(int(v) for v in kind.split("x"))
            if kind not in ("test", "single", "multi") else None)
    if devices is None and device is not None \
            and torch.device(device).type == "cpu":
        shapes = (mesh_lib.TEST_SHAPES if kind == "test"
                  else mesh_lib.PRODUCTION_SHAPES)
        devices = [device] * math.prod(grid or shapes[multi])
    if grid is not None:
        return mesh_lib.make_grid_mesh(*grid, devices=devices)
    if kind == "test":
        return mesh_lib.make_test_mesh(devices=devices)
    return mesh_lib.make_production_mesh(multi_pod=multi, devices=devices)


def run(argv=None, devices=None) -> TrainRun:
    """Train as the flags say.  ``devices`` lists the devices a
    ``--mesh`` is laid over (without it: see :func:`make_mesh`)."""
    args = parse_args(argv)
    mesh = make_mesh(args.mesh, args.device, devices)
    dev = mesh.lead if mesh is not None else resolve_device(args.device)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get(args.arch))
    if not cfg.embed_input or cfg.vision_tokens:
        raise ValueError(f"--arch {args.arch}: the pipeline yields token "
                         f"ids only, and this config takes embeddings or "
                         f"an image context")
    cfg = dataclasses.replace(cfg, remat=False) if args.seq <= 512 else cfg
    opt_cfg = opt_lib.OptConfig(lr=args.lr, warmup_steps=20)

    pipe = build_pipeline(cfg, args, dev)
    state = ts.init_train_state(cfg, opt_cfg, device=dev, seed=0,
                                compress=args.compress_grads)
    p_shard = None
    if mesh is not None:
        sharding_rules.set_mesh(mesh)
        p_shard = sh.param_shardings(
            dict(state.params.named_parameters()), mesh)
        state = ts.shard_state(state, p_shard)
    step_fn = ts.make_train_step(cfg, opt_cfg, compress=args.compress_grads,
                                 param_shardings=p_shard)

    start = 0
    ckpt_dir = Path(args.ckpt_dir) / cfg.name
    if args.resume and ckpt_lib.latest_step(ckpt_dir) is not None:
        state, extra = ckpt_lib.restore(ckpt_dir, state)
        pipe.state = tok_lib.PipelineState.from_dict(extra["pipeline"])
        start = int(extra["step"])
        print(f"[train] resumed from step {start}")

    saver = ckpt_lib.AsyncSaver()
    watchdog = StepWatchdog(WatchdogConfig())
    losses, step_s = [], []
    for step in range(start, args.steps):
        batch = pipe.next_batch()
        watchdog.start()
        try:
            state, metrics = step_fn(state, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_s.append(watchdog.stop())
        except StragglerEvent as e:
            step_s.append(e.step_time)
            print(f"[train] straggler detected: {e}; checkpoint + "
                  "remesh would trigger here")
        losses.append(float(metrics["loss"]))
        if (step + 1) % args.log_every == 0:
            print(f"[train] step {step+1} loss={losses[-1]:.4f} "
                  f"ce={float(metrics['ce']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f}", flush=True)
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            saver.save(ckpt_dir, step + 1, state,
                       extra={"step": step + 1,
                              "pipeline": pipe.state.as_dict()})
    saver.wait()
    if losses:
        print(f"[train] done. first loss {losses[0]:.4f} -> last "
              f"{losses[-1]:.4f}")
    return TrainRun(losses, step_s, state, pipe)


def main(argv=None):
    """Train as the flags say; returns the losses of the steps taken."""
    return run(argv).losses


if __name__ == "__main__":
    main()

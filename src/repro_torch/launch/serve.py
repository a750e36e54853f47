"""Batched LM serving: prefill, then greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch spadas_trajlm --requests 8 --prompt-len 64 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --full   # the card

Counterpart of ``repro.launch.serve`` on the port's dense LM
(:class:`~repro_torch.models.model.LanguageModel`).  The config is the
reduced one unless ``--full`` is given; weights come from a seeded
generator and the prompts are random tokens from numpy.  Without
``--device`` it runs on the card (and raises where there is none).
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models.model import LanguageModel


class Generation(NamedTuple):
    """What :func:`generate` returns: the greedy tokens (B, gen) int64 and
    the logits each was taken from (gen, B, V) float32, both on the
    model's device; step 0 is the prefill's last position."""
    tokens: torch.Tensor
    logits: torch.Tensor


@torch.no_grad()
def generate(model: LanguageModel, prompts, gen: int,
             kv_cache_dtype: str | None = None) -> Generation:
    """Prefill ``prompts`` (B, P) token ids, then decode ``gen`` tokens
    greedily (``argmax``, first index on ties, as ``jnp.argmax``): the
    first from the prefill's logits, each next one from a decode step
    against the cache, bf16 or int8 (``kv_cache_dtype``, default the
    model config's)."""
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                              device=model.device)
    B, P = prompts.shape
    logits, caches, cur = model.prefill(prompts, P + gen, kv_cache_dtype)
    steps = [logits[:, -1, :]]
    toks = [torch.argmax(steps[-1], dim=-1)]
    for i in range(gen - 1):
        logits, caches = model.decode_step(toks[-1][:, None], caches,
                                           cur + i)
        steps.append(logits[:, -1, :])
        toks.append(torch.argmax(steps[-1], dim=-1))
    return Generation(torch.stack(toks, dim=1), torch.stack(steps))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="spadas_trajlm")
    ap.add_argument("--full", action="store_true",
                    help="the full config (default: the reduced one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the "
                         "CPU)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--kv-cache", choices=("bf16", "int8"), default=None,
                    help="KV cache dtype (default: the config's)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch) if args.full else configs.get_reduced(
        args.arch)
    model = LanguageModel(cfg, device=dev, seed=args.seed)
    B, P, G = args.requests, args.prompt_len, args.gen
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (B, P))

    generate(model, prompts[:, :8], 2, args.kv_cache)        # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    model.prefill(torch.as_tensor(prompts, device=dev), P + G, args.kv_cache)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = generate(model, prompts, G, args.kv_cache)
    _sync(dev)
    t_all = time.perf_counter() - t0
    t_decode = max(t_all - t_prefill, 0.0)
    seqs = out.tokens.cpu().numpy()
    print(f"[serve] {cfg.name} on {dev}: {B} requests  prefill({P} tok) "
          f"{t_prefill * 1e3:.1f} ms   decode {G - 1} steps "
          f"{t_decode * 1e3:.1f} ms ({t_decode / max(G - 1, 1) * 1e3:.2f} "
          f"ms/tok incl. dispatch)")
    print(f"[serve] sample generation (req 0): {seqs[0][:16].tolist()}")
    return seqs


if __name__ == "__main__":
    main()

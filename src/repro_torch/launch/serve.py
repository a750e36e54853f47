"""Batched LM serving: prefill, then greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch spadas_trajlm --requests 8 --prompt-len 64 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --full   # the card

Counterpart of ``repro.launch.serve`` on the port's LM
(:class:`~repro_torch.models.model.LanguageModel`), for every ``--arch``
of ``repro_torch.configs.ARCH_IDS``.  The config is the reduced one unless
``--full`` is given; weights come from a seeded generator.  The inputs are
drawn from a numpy generator seeded with ``--seed``: token prompts, or,
for a config with ``embed_input=False``, prompt embeddings and one
embedding per decode step (the JAX driver draws these at random too), and
for a cross-attention config the image context.  An SSM config needs a
prompt length that is a multiple of its ``ssm_chunk`` (32 reduced, 256
full).  Without ``--device`` it runs on the card (and raises where there
is none).
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


def _on(model, x, dtype=None):
    return None if x is None else torch.as_tensor(
        np.asarray(x) if not isinstance(x, torch.Tensor) else x,
        dtype=dtype, device=model.device)


@torch.no_grad()
def generate(model: LanguageModel, prompts, gen: int,
             kv_cache_dtype: str | None = None, *, ctx=None,
             step_embeds=None) -> Generation:
    """Prefill ``prompts``, then decode ``gen`` tokens greedily
    (``argmax``, first index on ties, as ``jnp.argmax``): the first from
    the prefill's logits, each next one from a decode step against the
    cache, bf16 or int8 (``kv_cache_dtype``, default the model config's).

    ``prompts`` are token ids (B, P), or embeddings (B, P, d) where the
    config has ``embed_input=False``; such a model is fed
    ``step_embeds[:, i]`` at decode step i (``step_embeds`` (B, gen - 1,
    d)) instead of its last token.  A cross-attention config takes its
    context ``ctx`` (B, T, d) at every step."""
    embeds = not model.cfg.embed_input
    prompts = _on(model, prompts, torch.float32 if embeds else torch.int64)
    if embeds:
        if step_embeds is None or step_embeds.shape[1] < gen - 1:
            raise ValueError(f"{model.cfg.name} takes embeddings: pass "
                             f"step_embeds (B, {gen - 1}, d)")
        step_embeds = _on(model, step_embeds, torch.float32)
    ctx = _on(model, ctx)
    B, P = prompts.shape[:2]
    logits, caches, cur = model.prefill(prompts, P + gen, kv_cache_dtype,
                                        ctx=ctx)
    steps = [logits[:, -1, :]]
    toks = [torch.argmax(steps[-1], dim=-1)]
    for i in range(gen - 1):
        step_in = step_embeds[:, i:i + 1] if embeds else toks[-1][:, None]
        logits, caches = model.decode_step(step_in, caches, cur + i, ctx=ctx)
        steps.append(logits[:, -1, :])
        toks.append(torch.argmax(steps[-1], dim=-1))
    return Generation(torch.stack(toks, dim=1), torch.stack(steps))


def request_inputs(cfg, batch: int, prompt_len: int, gen: int, seed: int):
    """The inputs of ``batch`` requests, drawn from a numpy generator
    seeded with ``seed``: (prompts, ctx, step_embeds), the last two None
    where the config takes none.  Prompts are token ids, or standard
    normal float32 embeddings for ``embed_input=False``; the image context
    (``vision_tokens`` of them) is standard normal too."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    if cfg.embed_input:
        prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
        step_embeds = None
    else:
        prompts = rng.standard_normal((batch, prompt_len, d), np.float32)
        step_embeds = rng.standard_normal((batch, gen - 1, d), np.float32)
    ctx = (rng.standard_normal((batch, cfg.vision_tokens, d), np.float32)
           if cfg.vision_tokens else None)
    return prompts, ctx, step_embeds


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="spadas_trajlm",
                    choices=configs.ARCH_IDS)
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
    prompts, ctx, step_embeds = request_inputs(cfg, B, P, G, args.seed)

    def run(gen):
        return generate(model, prompts, gen, args.kv_cache, ctx=ctx,
                        step_embeds=step_embeds)

    run(2)                                                  # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    model.prefill(_on(model, prompts), P + G, args.kv_cache,
                  ctx=_on(model, ctx))
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = run(G)
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

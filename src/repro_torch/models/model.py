"""The decoder LM of the dense families, as an ``nn.Module``.

Counterpart of ``repro.models.model`` for ``block_pattern=(ATTN,)``: the
trajectory LM ``spadas_trajlm`` and the dense configs (``llama3_8b``,
``yi_9b``, ...).  The JAX code scans one stacked block over the repeats;
here the repeats are a ``ModuleList`` with the same parameters, and the
caches keep the JAX layout: one dict per pattern position whose tensors are
stacked ``(n_repeats, ...)``.  ``remat`` and ``scan_layers`` are training
and dry-run knobs: accepted and ignored.

Three entry points, as in the JAX package:

  forward      — teacher-forced logits
  prefill      — last-token logits + populated caches
  decode_step  — one token against live caches

The caches are written in place (the JAX code returns updated copies):
``prefill`` and ``decode_step`` return the caches they were given, filled.

Block kinds that are not ported raise ``NotImplementedError`` naming their
ROADMAP item: MoE (14a), Mamba-2 and the hybrids (14b), cross-attention and
embedding inputs (14c).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import (ATTN, ATTN_MOE, ATTN_MOE_DENSE, CROSS,
                                       MAMBA, MAMBA_MOE, ModelConfig)

#: block kinds the port does not serve yet, and their ROADMAP items
UNPORTED = {
    ATTN_MOE: "14a (MoE, models/moe.py)",
    ATTN_MOE_DENSE: "14a (MoE, models/moe.py)",
    MAMBA: "14b (Mamba-2 and the hybrids, models/ssm.py)",
    MAMBA_MOE: "14b (Mamba-2 and the hybrids, models/ssm.py)",
    CROSS: "14c (cross-attention and embedding inputs)",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config the port cannot serve."""
    for kind in cfg.block_pattern:
        if kind in UNPORTED:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported "
                f"(ROADMAP item {UNPORTED[kind]})")
        if kind != ATTN:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")
    if not cfg.embed_input:
        raise NotImplementedError(
            f"{cfg.name}: embedding inputs (embed_input=False) are not "
            f"ported (ROADMAP item {UNPORTED[CROSS]})")


def _dense(gen, shape, scale: float | None = None) -> nn.Parameter:
    """The JAX package's ``dense_init``: normal * (scale or 1/sqrt(fan_in)),
    drawn on the CPU from ``gen`` so that every device gets one set of
    weights."""
    s = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return nn.Parameter(torch.randn(shape, generator=gen) * s)


class RMSNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, gen):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        self.wq = _dense(gen, (d, cfg.n_heads * hd))
        self.wk = _dense(gen, (d, cfg.n_kv_heads * hd))
        self.wv = _dense(gen, (d, cfg.n_kv_heads * hd))
        self.wo = _dense(gen, (cfg.n_heads * hd, d), scale=1.0 / math.sqrt(
            cfg.n_heads * hd * cfg.n_layers))


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, gen):
        super().__init__()
        d, dff = cfg.d_model, cfg.d_ff
        self.wg = _dense(gen, (d, dff))
        self.wu = _dense(gen, (d, dff))
        self.wd = _dense(gen, (dff, d),
                         scale=1.0 / math.sqrt(dff * cfg.n_layers))


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, gen):
        super().__init__()
        self.table = _dense(gen, (vocab, d), scale=0.02)


class Block(nn.Module):
    """One ATTN block: pre-norm self-attention, then a pre-norm SwiGLU."""

    def __init__(self, cfg: ModelConfig, gen):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model)
        self.attn = Attention(cfg, gen)
        if cfg.d_ff > 0:
            self.mlp = MLP(cfg, gen)
            self.ln2 = RMSNorm(cfg.d_model)

    def run(self, x, cfg, *, positions, cache=None, cache_len=None):
        """Returns (x, new (k, v) or the decode cache tuple)."""
        h = L.rmsnorm(self.ln1, x, cfg.norm_eps)
        out, new_kv = L.self_attention_block(
            self.attn, h, cfg, positions=positions, kv_cache=cache,
            cache_len=cache_len)
        x = x + out
        if cfg.d_ff > 0:
            x = x + L.mlp(self.mlp, L.rmsnorm(self.ln2, x, cfg.norm_eps))
        return x, new_kv


class LanguageModel(nn.Module):
    """The dense decoder LM of ``cfg`` on ``device`` (the card unless the
    caller names another), its weights drawn from a ``torch.Generator``
    seeded with ``seed`` on the CPU in the JAX package's init scales and
    then moved, so every device gets the same weights.  Parameters are
    float32, as the JAX package's; activations are bf16."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, gen)
        self.head = (None if cfg.tie_embeddings
                     else Embedding(cfg.vocab_size, cfg.d_model, gen))
        self.final_norm = RMSNorm(cfg.d_model)
        self.blocks = nn.ModuleList(Block(cfg, gen)
                                    for _ in range(cfg.n_repeats))
        self.requires_grad_(False)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    # -- caches ---------------------------------------------------------

    def init_cache(self, batch: int, max_len: int,
                   kv_cache_dtype: str | None = None) -> tuple:
        """Preallocated decode caches in the JAX layout: per pattern
        position a dict of ``k``, ``v`` (n_repeats, batch, max_len, KH, hd),
        bf16, or int8 codes with bf16 ``k_scale`` / ``v_scale``
        (n_repeats, batch, max_len, KH).  ``kv_cache_dtype`` defaults to
        the config's."""
        cfg = self.cfg
        int8 = (kv_cache_dtype or cfg.kv_cache_dtype) == "int8"
        shape = (cfg.n_repeats, batch, max_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        kv_dt = torch.int8 if int8 else torch.bfloat16
        c = {"k": torch.zeros(shape, dtype=kv_dt, device=self.device),
             "v": torch.zeros(shape, dtype=kv_dt, device=self.device)}
        if int8:
            for key in ("k_scale", "v_scale"):
                c[key] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                     device=self.device)
        return (c,)

    # -- the stack --------------------------------------------------------

    def _embed_in(self, tokens: torch.Tensor) -> torch.Tensor:
        return L.embed(self.embed, tokens.to(self.device)).to(torch.bfloat16)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        head = self.head if self.head is not None else self.embed
        return L.unembed(head, x)

    def _positions(self, start: int, n: int) -> torch.Tensor:
        return (start + torch.arange(n, device=self.device))[None, :]

    # -- public entry points ------------------------------------------------

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits (B, S, V) float32 for tokens (B, S).  (The
        JAX forward also returns the MoE aux loss, 0 for the dense kinds.)"""
        x = self._embed_in(tokens)
        positions = self._positions(0, x.shape[1])
        for blk in self.blocks:
            x, _ = blk.run(x, self.cfg, positions=positions)
        return self._logits(x)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int,
                kv_cache_dtype: str | None = None):
        """Run the whole prompt tokens (B, S); returns (last-token logits
        (B, 1, V), caches of ``max_len`` positions holding the prompt's K/V,
        S).  An int8 cache is quantized before it is stored."""
        x = self._embed_in(tokens)
        B, S, _ = x.shape
        positions = self._positions(0, S)
        caches = self.init_cache(B, max_len, kv_cache_dtype)
        new_k, new_v = [], []
        for blk in self.blocks:
            x, (k, v) = blk.run(x, self.cfg, positions=positions)
            new_k.append(k)
            new_v.append(v)
        logits = self._logits(x[:, -1:, :])
        _merge_prefill_caches(caches, new_k, new_v)
        return logits, caches, S

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, caches: tuple,
                    cache_len: int):
        """One decode step: tokens (B, 1) at position ``cache_len`` against
        the caches (bf16 or int8, as they were made), which are updated in
        place.  Returns (logits (B, 1, V), caches)."""
        x = self._embed_in(tokens)
        positions = self._positions(int(cache_len), 1)
        c = caches[0]
        int8 = "k_scale" in c
        for r, blk in enumerate(self.blocks):
            kv = ((c["k"][r], c["v"][r], c["k_scale"][r], c["v_scale"][r])
                  if int8 else (c["k"][r], c["v"][r]))
            x, _ = blk.run(x, self.cfg, positions=positions, cache=kv,
                             cache_len=int(cache_len))
        return self._logits(x), caches


def _merge_prefill_caches(caches: tuple, new_k: list, new_v: list) -> None:
    """Place each repeat's prefill K/V (length S) at the head of the
    preallocated caches, in place: bf16 as it is, int8 quantized first."""
    c = caches[0]
    for r, (k, v) in enumerate(zip(new_k, new_v)):
        S = k.shape[1]
        if "k_scale" in c:
            (kc, ksc), (vc, vsc) = L.quantize_kv(k), L.quantize_kv(v)
            c["k"][r, :, :S] = kc
            c["v"][r, :, :S] = vc
            c["k_scale"][r, :, :S] = ksc
            c["v_scale"][r, :, :S] = vsc
        else:
            c["k"][r, :, :S] = k.to(c["k"].dtype)
            c["v"][r, :, :S] = v.to(c["v"].dtype)

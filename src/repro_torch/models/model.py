"""The unified decoder LM of every family, as an ``nn.Module``.

Counterpart of ``repro.models.model``: dense, MoE (``attn_moe``, Arctic's
``attn_moe_dense``), Mamba-2 (``mamba``, ``mamba_moe``), hybrid
(Jamba's pattern), cross-attention to an image context (``cross``) and
embedding inputs (``embed_input=False``).  The layer stack is
``n_repeats`` repeats of the config's ``block_pattern``.  The JAX code
stacks each pattern position's parameters over the repeats and scans;
here ``blocks[r][i]`` is repeat r's block at pattern position i, with the
same parameters, and the caches keep the JAX layout: one dict per pattern
position whose tensors are stacked ``(n_repeats, ...)``.

Serving models are frozen (``requires_grad`` off, as ``__init__`` leaves
them); the trainer (:mod:`repro_torch.train.train_step`) turns gradients
on and runs ``forward`` under autograd.  There ``remat`` is honoured as
the JAX package's ``jax.checkpoint(body, policy=nothing_saveable)`` over
one scan body: each repeat of the pattern runs under
``torch.utils.checkpoint`` and is recomputed in the backward pass.
``scan_layers`` is a dry-run knob, accepted and ignored: eager PyTorch has
no scan, so the repeats always run as a Python loop.

Three entry points, as in the JAX package:

  forward      — teacher-forced logits and the summed MoE aux loss
  prefill      — last-token logits + populated caches
  decode_step  — one token against live caches

Inputs are token ids (B, S), or embeddings (B, S, d) where the config has
``embed_input=False``; a ``cross`` config takes its context ``ctx``
(B, vision_tokens, d) at every entry point (decode recomputes the
context's K and V at every step, as the JAX code does).  The caches are
written in place (the JAX code returns updated copies): ``prefill`` and
``decode_step`` return the caches they were given, filled.
"""
from __future__ import annotations

import math
from contextlib import nullcontext

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import (ATTN, ATTN_MOE, ATTN_MOE_DENSE, CROSS,
                                       MAMBA, MAMBA_MOE, ModelConfig)

ATTN_KINDS = (ATTN, ATTN_MOE, ATTN_MOE_DENSE, CROSS)
#: the parameters the JAX package makes float32 whatever ``init_params``'
#: dtype: the MoE router, the SSM's per-head ``A_log``, ``D`` and
#: ``dt_bias``, and the cross-attention gate
FLOAT32_LEAVES = ("router", "A_log", "D", "dt_bias", "xgate")
SSM_KINDS = (MAMBA, MAMBA_MOE)
KINDS = ATTN_KINDS + SSM_KINDS


class RMSNorm(nn.Module):
    def __init__(self, d: int, dev):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=dev))


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, gen):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        self.wq = L.dense_init(gen, (d, cfg.n_heads * hd))
        self.wk = L.dense_init(gen, (d, cfg.n_kv_heads * hd))
        self.wv = L.dense_init(gen, (d, cfg.n_kv_heads * hd))
        self.wo = L.dense_init(gen, (cfg.n_heads * hd, d), scale=1.0 / (
            math.sqrt(cfg.n_heads * hd * cfg.n_layers)))


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, gen):
        super().__init__()
        d, dff = cfg.d_model, cfg.d_ff
        self.wg = L.dense_init(gen, (d, dff))
        self.wu = L.dense_init(gen, (d, dff))
        self.wd = L.dense_init(gen, (dff, d),
                               scale=1.0 / math.sqrt(dff * cfg.n_layers))


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, gen):
        super().__init__()
        self.table = L.dense_init(gen, (vocab, d), scale=0.02)


class Block(nn.Module):
    """One pattern position's block of kind ``kind``, with the JAX
    package's parameters (``_init_block``, drawn in its order): ``ln1``;
    ``attn`` for the attention kinds; ``xattn``, ``lnx`` and the
    zero-initialised ``xgate`` for ``cross``; ``mamba`` for the SSM kinds;
    where d_ff > 0, ``mlp`` (dense kinds and ``attn_moe_dense``), ``moe``
    (MoE kinds) and ``ln2``."""

    def __init__(self, kind: str, cfg: ModelConfig, gen):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")
        dev = gen.device
        self.kind = kind
        self.ln1 = RMSNorm(cfg.d_model, dev)
        if kind in ATTN_KINDS:
            self.attn = Attention(cfg, gen)
        if kind == CROSS:
            self.xattn = Attention(cfg, gen)
            self.lnx = RMSNorm(cfg.d_model, dev)
            self.xgate = nn.Parameter(torch.zeros(1, device=dev))
        if kind in SSM_KINDS:
            self.mamba = ssm_lib.Mamba(cfg, gen)
        if cfg.d_ff > 0:
            if kind in (ATTN, MAMBA, CROSS, ATTN_MOE_DENSE):
                self.mlp = MLP(cfg, gen)
            if kind in (ATTN_MOE, MAMBA_MOE, ATTN_MOE_DENSE):
                self.moe = moe_lib.MoE(cfg, gen)
            self.ln2 = RMSNorm(cfg.d_model, dev)

    def run(self, x, cfg, *, ctx, positions, cache=None, r=0,
            cache_len=None):
        """``_apply_block``.  Train / prefill (``cache`` None): returns
        (x, aux, this block's new cache entries: the attention's (k, v),
        the SSM's (ssm, conv)).  Decode: ``cache`` is the pattern
        position's cache dict, repeat ``r`` of which is read and written
        in place."""
        kind = self.kind
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new = {}
        if kind in ATTN_KINDS:
            h = L.rmsnorm(self.ln1, x, cfg.norm_eps)
            kv = None
            if cache is not None:
                kv = tuple(cache[key][r] for key in
                           ("k", "v", "k_scale", "v_scale") if key in cache)
            out, new_kv = L.self_attention_block(
                self.attn, h, cfg, positions=positions, kv_cache=kv,
                cache_len=cache_len)
            x = x + out
            if cache is None:
                new["k"], new["v"] = new_kv
        if kind == CROSS:
            hx = L.rmsnorm(self.lnx, x, cfg.norm_eps)
            xo = L.cross_attention_block(self.xattn, hx, ctx, cfg)
            x = x + torch.tanh(self.xgate).to(x.dtype) * xo
        if kind in SSM_KINDS:
            h = L.rmsnorm(self.ln1, x, cfg.norm_eps)
            st = ((cache["ssm"][r], cache["conv"][r]) if cache is not None
                  else (None, None))
            out, (new_ssm, new_conv) = ssm_lib.mamba_block(
                self.mamba, h, cfg, state=st[0], conv_state=st[1])
            x = x + out
            if cache is None:
                new["ssm"], new["conv"] = new_ssm, new_conv
            else:
                cache["ssm"][r] = new_ssm
                cache["conv"][r] = new_conv
        if cfg.d_ff > 0:
            h2 = L.rmsnorm(self.ln2, x, cfg.norm_eps)
            if kind in (ATTN, MAMBA, CROSS):
                x = x + L.mlp(self.mlp, h2)
            elif kind in (ATTN_MOE, MAMBA_MOE):
                y, aux = moe_lib.moe(self.moe, h2, cfg)
                x = x + y
            else:                                     # ATTN_MOE_DENSE
                y_moe, aux = moe_lib.moe(self.moe, h2, cfg)
                x = x + L.mlp(self.mlp, h2) + y_moe
        return x, aux, new

    def run_tp(self, xs: list, cfg, *, positions, peers: list,
               ax: L.ModelAxis) -> list:
        """An ``attn`` block in training over the model axis: ``peers[m]``
        is this block in coordinate m's work model and ``xs[m]`` that
        coordinate's copy of the residual stream.  Each coordinate takes
        the norms and the residual adds on its copy; attention and the MLP
        run as the tensor-parallel pieces of
        :mod:`repro_torch.models.layers`."""
        if self.kind != ATTN:
            raise NotImplementedError(
                f"{cfg.name}: a {self.kind!r} block does not compute on the "
                f"model axis (ROADMAP item 14k)")
        eps = cfg.norm_eps
        hs = [L.rmsnorm(b.ln1, x, eps) for b, x in zip(peers, xs)]
        ys = L.self_attention_tp([b.attn for b in peers], hs, cfg,
                                 positions, ax)
        xs = [x + y for x, y in zip(xs, ys)]
        if cfg.d_ff > 0:
            hs = [L.rmsnorm(b.ln2, x, eps) for b, x in zip(peers, xs)]
            ys = L.mlp_tp([b.mlp for b in peers], hs, cfg.d_ff, ax)
            xs = [x + y for x, y in zip(xs, ys)]
        return xs


class LanguageModel(nn.Module):
    """The decoder LM of ``cfg`` on ``device`` (the card unless the caller
    names another).  Its weights are drawn in the JAX package's init
    scales from a ``torch.Generator`` seeded with ``seed``: on the CPU and
    then moved (the default, so every device gets the same weights), or,
    with ``init_on_device=True``, by a generator on ``device`` itself
    (other weights for the same seed; a full-width MoE's billions of
    normals take seconds there and a minute on the host).  Parameters are
    float32, as the JAX package's, or ``param_dtype`` (bf16 masters for
    the largest configs, as ``init_params(dtype=...)``: each weight drawn
    in float32 and cast, ``FLOAT32_LEAVES`` kept float32); activations
    are bf16.  On the ``meta`` device the parameters are shapes without
    values (placement plans and dry runs at full width)."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0,
                 init_on_device: bool = False,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator(device=dev if init_on_device else "cpu")
        gen.manual_seed(seed)
        with torch.device("meta") if dev.type == "meta" else nullcontext():
            self.embed = (Embedding(cfg.vocab_size, cfg.d_model, gen)
                          if cfg.embed_input else None)
            self.head = (None if cfg.tie_embeddings
                         else Embedding(cfg.vocab_size, cfg.d_model, gen))
            self.final_norm = RMSNorm(cfg.d_model, gen.device)
            self.blocks = nn.ModuleList(
                nn.ModuleList(Block(kind, cfg, gen)
                              for kind in cfg.block_pattern)
                for _ in range(cfg.n_repeats))
        if param_dtype != torch.float32:
            for name, p in self.named_parameters():
                if name.rsplit(".", 1)[-1] not in FLOAT32_LEAVES:
                    p.data = p.data.to(param_dtype)
        self.requires_grad_(False)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    # -- caches ---------------------------------------------------------

    def init_cache(self, batch: int, max_len: int,
                   kv_cache_dtype: str | None = None) -> tuple:
        """Preallocated decode caches in the JAX layout, one dict per
        pattern position, stacked over the repeats: attention positions
        hold ``k``, ``v`` (n_repeats, batch, max_len, KH, hd), bf16, or
        int8 codes with bf16 ``k_scale`` / ``v_scale`` (n_repeats, batch,
        max_len, KH); SSM positions hold ``ssm`` (n_repeats, batch, H, P,
        N) float32 and ``conv`` (n_repeats, batch, W-1, d_inner + 2N)
        bf16.  ``kv_cache_dtype`` defaults to the config's."""
        cfg, dev = self.cfg, self.device
        int8 = (kv_cache_dtype or cfg.kv_cache_dtype) == "int8"
        R = cfg.n_repeats
        caches = []
        for kind in cfg.block_pattern:
            c = {}
            if kind in ATTN_KINDS:
                shape = (R, batch, max_len, cfg.n_kv_heads,
                         cfg.resolved_head_dim)
                kv_dt = torch.int8 if int8 else torch.bfloat16
                c["k"] = torch.zeros(shape, dtype=kv_dt, device=dev)
                c["v"] = torch.zeros(shape, dtype=kv_dt, device=dev)
                if int8:
                    for key in ("k_scale", "v_scale"):
                        c[key] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                             device=dev)
            if kind in SSM_KINDS:
                c["ssm"] = torch.zeros(
                    (R, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                     cfg.ssm_state), dtype=torch.float32, device=dev)
                c["conv"] = torch.zeros(
                    (R, batch, cfg.conv_width - 1,
                     cfg.d_inner + 2 * cfg.ssm_state), dtype=torch.bfloat16,
                    device=dev)
            caches.append(c)
        return tuple(caches)

    # -- the stack --------------------------------------------------------

    def _embed_in(self, inputs: torch.Tensor, tp=None):
        """Token ids (B, S) through the table, or embeddings (B, S, d)
        where the config has ``embed_input=False``; bf16 either way.  With
        ``tp``, one copy per model coordinate, the table split over the
        vocabulary (``layers.embed_tp``)."""
        if tp is not None:
            xs = (L.embed_tp([m.embed for m in tp.models], inputs,
                             self.cfg.vocab_size, tp) if self.cfg.embed_input
                  else [inputs.to(d) for d in tp.devices])
            return [x.to(torch.bfloat16) for x in xs]
        inputs = inputs.to(self.device)
        if self.cfg.embed_input:
            inputs = L.embed(self.embed, inputs)
        return inputs.to(torch.bfloat16)

    def _ctx(self, ctx):
        if CROSS not in self.cfg.block_pattern:
            return None
        if ctx is None:
            raise ValueError(f"{self.cfg.name}: a cross-attention config "
                             f"needs its context ctx")
        return ctx.to(self.device, torch.bfloat16)

    def _repeat(self, rep, x, aux, ctx, positions):
        """One repeat of the pattern in training (no caches): the JAX
        scan body, aux carried through it."""
        for blk in rep:
            x, a, _ = blk.run(x, self.cfg, ctx=ctx, positions=positions)
            aux = aux + a
        return x, aux

    def _stack(self, x, *, ctx, positions, caches=None, cache_len=None):
        """Every block in order (repeat by repeat, the pattern's positions
        within each).  Returns (x, summed aux, per (repeat, position) the
        blocks' new cache entries)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new = []
        for r, rep in enumerate(self.blocks):
            for i, blk in enumerate(rep):
                x, a, nc = blk.run(
                    x, self.cfg, ctx=ctx, positions=positions,
                    cache=None if caches is None else caches[i], r=r,
                    cache_len=cache_len)
                aux = aux + a
                new.append((r, i, nc))
        return x, aux, new

    def _repeat_tp(self, r, xs, positions, tp):
        """Repeat ``r`` of the pattern over the model axis ``tp``, ``xs``
        the coordinates' copies of the residual stream."""
        for i, blk in enumerate(self.blocks[r]):
            xs = blk.run_tp(xs, self.cfg, positions=positions, ax=tp,
                            peers=[m.blocks[r][i] for m in tp.models])
        return xs

    def _logits(self, x, tp=None):
        key = "head" if self.head is not None else "embed"
        eps = self.cfg.norm_eps
        if tp is None:
            return L.unembed(getattr(self, key),
                             L.rmsnorm(self.final_norm, x, eps))
        hs = [L.rmsnorm(m.final_norm, xm, eps) for m, xm in zip(tp.models, x)]
        return L.unembed_tp([getattr(m, key) for m in tp.models], hs,
                            self.cfg.vocab_size, tp)

    def _positions(self, start: int, n: int) -> torch.Tensor:
        return (start + torch.arange(n, device=self.device))[None, :]

    # -- public entry points ------------------------------------------------

    def forward(self, inputs: torch.Tensor, ctx: torch.Tensor | None = None,
                tp: L.ModelAxis | None = None):
        """Teacher-forced logits (B, S, V) float32 for token ids (B, S) or
        embeddings (B, S, d), and the MoE aux loss summed over the blocks
        (float32 scalar; 0 without MoE), as the JAX ``forward``.  Records
        the autograd graph where the parameters require gradients (the
        trainer's); with ``cfg.remat`` each repeat is then recomputed in
        the backward pass instead of keeping its activations.

        ``tp`` (this model its ``models[0]``) computes the pass over the
        model axis, for a config whose blocks are all ``attn``: each model
        coordinate its copy of the replicated activations, the embedding,
        attention, the MLP and the head as the tensor-parallel pieces of
        :mod:`repro_torch.models.layers`; the logits are
        :class:`~repro_torch.models.layers.VocabBlocks` where the axis
        splits the vocabulary, else coordinate 0's."""
        x = self._embed_in(inputs, tp)
        ctx = self._ctx(ctx)
        positions = self._positions(0, inputs.shape[1])
        remat = (self.cfg.remat and torch.is_grad_enabled()
                 and self.final_norm.scale.requires_grad)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for r, rep in enumerate(self.blocks):
            if tp is not None:
                x = (checkpoint(self._repeat_tp, r, x, positions, tp,
                                use_reentrant=False) if remat
                     else self._repeat_tp(r, x, positions, tp))
            elif remat:
                x, aux = checkpoint(self._repeat, rep, x, aux, ctx,
                                    positions, use_reentrant=False)
            else:
                x, aux = self._repeat(rep, x, aux, ctx, positions)
        return self._logits(x, tp), aux

    @torch.no_grad()
    def prefill(self, inputs: torch.Tensor, max_len: int,
                kv_cache_dtype: str | None = None,
                ctx: torch.Tensor | None = None):
        """Run the whole prompt (token ids (B, S) or embeddings
        (B, S, d)); returns (last-token logits (B, 1, V), caches of
        ``max_len`` positions holding the prompt's K/V and the SSM and
        conv states after it, S).  An int8 cache is quantized before it is
        stored.  An SSM config needs S a multiple of ``ssm_chunk``."""
        x = self._embed_in(inputs)
        B, S, _ = x.shape
        caches = self.init_cache(B, max_len, kv_cache_dtype)
        x, _, new = self._stack(x, ctx=self._ctx(ctx),
                                positions=self._positions(0, S))
        logits = self._logits(x[:, -1:, :])
        _merge_prefill_caches(caches, new)
        return logits, caches, S

    @torch.no_grad()
    def decode_step(self, inputs: torch.Tensor, caches: tuple,
                    cache_len: int, ctx: torch.Tensor | None = None):
        """One decode step: token ids (B, 1), or embeddings (B, 1, d), at
        position ``cache_len`` against the caches (bf16 or int8, as they
        were made), which are updated in place.  Returns (logits
        (B, 1, V), caches)."""
        x = self._embed_in(inputs)
        cache_len = int(cache_len)
        x, _, _ = self._stack(x, ctx=self._ctx(ctx),
                              positions=self._positions(cache_len, 1),
                              caches=caches, cache_len=cache_len)
        return self._logits(x), caches


def _merge_prefill_caches(caches: tuple, new: list) -> None:
    """Place each block's prefill K/V (length S) at the head of the
    preallocated caches, bf16 as it is or quantized to int8 first, and
    keep its SSM and conv states; in place."""
    for r, i, nc in new:
        c = caches[i]
        if "k" in nc:
            S = nc["k"].shape[1]
            if "k_scale" in c:
                for key in ("k", "v"):
                    codes, scale = L.quantize_kv(nc[key])
                    c[key][r, :, :S] = codes
                    c[f"{key}_scale"][r, :, :S] = scale
            else:
                for key in ("k", "v"):
                    c[key][r, :, :S] = nc[key].to(c[key].dtype)
        if "ssm" in nc:
            c["ssm"][r] = nc["ssm"]
            c["conv"][r] = nc["conv"].to(c["conv"].dtype)

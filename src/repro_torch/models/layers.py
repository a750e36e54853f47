"""Neural substrate layers: RMSNorm, RoPE, memory-efficient GQA attention
(self and cross), SwiGLU MLP, embeddings.

Counterpart of ``repro.models.layers``, in plain PyTorch and in the same
arithmetic.  Parameters are float32 and cast to the activations' dtype
(bf16) at use; the projections are bf16 products.  Where the JAX code asks
for float32 accumulation of bf16 operands (``preferred_element_type``: the
attention scores, p @ V and the logits), the operands are cast to float32
first: a product of two bf16 values is exact in float32, so only the order
of the sums differs.  Softmax statistics are float32.  Attention is
KV-chunked with an online softmax, ``NEG_INF`` masks and
``acc / max(l, 1e-30)``, the flash-attention schedule of the JAX code; no
fused-attention library is called, so the card runs the arithmetic the CPU
tests check.  The ``shard(...)`` annotations of the JAX code are dropped:
on one device they do nothing, and the mesh train step splits its batch
by the spec they give (``models.sharding_rules.spec_for``).

A layer function takes its parameters as an object with the JAX names as
attributes (the modules of :mod:`repro_torch.models.model`).
"""
from __future__ import annotations

import math

import torch
from torch import nn

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init helper
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape,
               scale: float | None = None) -> nn.Parameter:
    """The JAX package's ``dense_init``: a float32 normal draw times
    ``scale`` (default 1/sqrt(fan_in), fan_in = shape[0]), drawn from
    ``gen`` on the generator's own device; inside ``torch.device("meta")``
    a meta tensor (a shape, no values)."""
    s = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    meta = torch.get_default_device().type == "meta"
    w = torch.randn(shape, generator=gen,
                    device="meta" if meta else gen.device)
    return nn.Parameter(w.mul_(s))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Float32 inside, cast back to x's dtype; ``p.scale`` (d,)."""
    return rms_scale(x, p.scale, eps)


def rms_scale(x: torch.Tensor, scale: torch.Tensor,
              eps: float) -> torch.Tensor:
    """RMSNorm of x by the bare ``scale`` tensor (the Mamba-2 block keeps
    its norm's scale as a plain parameter, ``norm_scale``)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x (..., S, H, D), positions (..., S) -> same shape; the half-split
    form (first half against second half), not interleaved."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device)
        * (math.log(theta) / half))
    ang = positions[..., None].float() * freqs           # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.split(x.float(), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# memory-efficient attention (online softmax over KV chunks)
# ---------------------------------------------------------------------------


def _attn_q_block(q5, k, v, q_pos, kv_len, *, causal: bool, kv_chunk: int):
    """One block of queries q5 (B, Bq, KH, G, Dh) at absolute positions
    q_pos (Bq,) against k, v (B, T, KH, Dh), T a multiple of kv_chunk;
    ``kv_len`` (an int or None) masks the keys at and past it.
    Returns (B, Bq, KH * G, Dh) float32."""
    B, Bq, KH, G, Dh = q5.shape
    T = k.shape[1]
    dev = q5.device
    scale = 1.0 / math.sqrt(Dh)
    qf = q5.float()
    m = torch.full((B, KH, G, Bq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KH, G, Bq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KH, G, Bq, Dh), dtype=torch.float32, device=dev)
    for start in range(0, T, kv_chunk):
        kc = k[:, start:start + kv_chunk]
        vc = v[:, start:start + kv_chunk]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc.float()) * scale
        kv_pos = start + torch.arange(kv_chunk, device=dev)
        mask = torch.ones((Bq, kv_chunk), dtype=torch.bool, device=dev)
        if causal:
            mask &= kv_pos[None, :] <= q_pos[:, None]
        if kv_len is not None:
            mask &= (kv_pos < kv_len)[None, :]
        s = torch.where(mask[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vc.dtype).float(),
                          vc.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    # (B, KH, G, Bq, Dh) -> (B, Bq, KH * G, Dh)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Bq, KH * G, Dh)


def attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
              kv_len: int | None = None, q_chunk: int = 1024,
              kv_chunk: int = 1024) -> torch.Tensor:
    """GQA attention, O(q_chunk * kv_chunk) score memory: q (B, S, H, Dh),
    k, v (B, T, KH, Dh) -> (B, S, H, Dh) float32.

    ``q_offset`` is the absolute position of q[0] (decode: the live cache
    length); ``kv_len`` masks a preallocated cache to its live prefix.
    Both sequence axes are padded to chunk multiples; padded keys are
    masked through ``kv_len``."""
    B, S, H, Dh = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, T)
    kv_pad = (-T) % kv_chunk
    if kv_pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, kv_pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, kv_pad))
    if kv_len is None and (kv_pad or not causal):
        kv_len = T
    q_pad = (-S) % q_chunk
    if q_pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, q_pad))
    Sp = S + q_pad
    q5 = q.reshape(B, Sp, KH, G, Dh)
    blocks = []
    for q0 in range(0, Sp, q_chunk):
        pos = q_offset + q0 + torch.arange(q_chunk, device=q.device)
        blocks.append(_attn_q_block(q5[:, q0:q0 + q_chunk], k, v, pos,
                                    kv_len, causal=causal,
                                    kv_chunk=kv_chunk))
    out = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)
    return out[:, :S]


# ---------------------------------------------------------------------------
# int8 KV cache quantization (per-token, per-head absmax scales)
# ---------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor):
    """x (B, S, KH, Dh) -> (codes int8, scales bf16 (B, S, KH)).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 codes and bf16 scales -> bf16, the product taken in bf16."""
    return codes.to(torch.bfloat16) * scale.to(torch.bfloat16)[..., None]


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------


def qkv_proj(p, x: torch.Tensor, cfg, positions: torch.Tensor | None):
    """x (B, S, d) -> q (B, S, H, hd), k, v (B, S, KH, hd) in x's dtype,
    with RoPE at ``positions``."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    cd = x.dtype
    q = (x @ p.wq.to(cd)).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p.wk.to(cd)).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p.wv.to(cd)).reshape(B, S, cfg.n_kv_heads, hd)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def self_attention_block(p, x, cfg, *, positions, kv_cache=None,
                         cache_len: int | None = None):
    """Self attention.  Train / prefill (``kv_cache`` None): the full
    sequence, returning the new (k, v) for the cache.  Decode: S == 1
    against a preallocated (B, T, KH, Dh) cache, bf16 (ck, cv) or int8
    (ck, cv, k_scale, v_scale); the new token is written into the cache in
    place at ``cache_len`` (the JAX code returns updated copies), and the
    cache tuple is returned.  Decode runs unchunked (kv_chunk = T)."""
    q, k, v = qkv_proj(p, x, cfg, positions)
    if kv_cache is None:
        out = attention(q, k, v, causal=True, q_chunk=cfg.attn_q_chunk,
                        kv_chunk=cfg.attn_kv_chunk)
        new_kv = (k, v)
    else:
        S = q.shape[1]
        at = slice(cache_len, cache_len + S)
        if len(kv_cache) == 4:
            # int8 cache: write the quantized token, dequantize at the read
            ck, cv, ks_c, vs_c = kv_cache
            k_codes, k_scale = quantize_kv(k)
            v_codes, v_scale = quantize_kv(v)
            ck[:, at] = k_codes
            cv[:, at] = v_codes
            ks_c[:, at] = k_scale
            vs_c[:, at] = v_scale
            kd, vd = dequantize_kv(ck, ks_c), dequantize_kv(cv, vs_c)
        else:
            ck, cv = kv_cache
            ck[:, at] = k.to(ck.dtype)
            cv[:, at] = v.to(cv.dtype)
            kd, vd = ck, cv
        out = attention(q, kd, vd, causal=False, q_offset=cache_len,
                        kv_len=cache_len + 1, q_chunk=1,
                        kv_chunk=kd.shape[1])
        new_kv = kv_cache
    B, S, H, Dh = out.shape
    y = out.reshape(B, S, H * Dh).to(x.dtype) @ p.wo.to(x.dtype)
    return y, new_kv


def cross_attention_block(p, x: torch.Tensor, ctx: torch.Tensor,
                          cfg) -> torch.Tensor:
    """Non-causal GQA of x (B, S, d) over a precomputed context ctx
    (B, T, d) (the vision stub's image embeddings), without RoPE and
    without a cache: K and V are projected from the context at every call,
    as the JAX decode step does."""
    B, S, _ = x.shape
    T = ctx.shape[1]
    hd = cfg.resolved_head_dim
    cd = x.dtype
    q = (x @ p.wq.to(cd)).reshape(B, S, cfg.n_heads, hd)
    k = (ctx @ p.wk.to(cd)).reshape(B, T, cfg.n_kv_heads, hd)
    v = (ctx @ p.wv.to(cd)).reshape(B, T, cfg.n_kv_heads, hd)
    out = attention(q, k, v, causal=False, q_chunk=cfg.attn_q_chunk,
                    kv_chunk=cfg.attn_kv_chunk)
    return out.reshape(B, S, -1).to(cd) @ p.wo.to(cd)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU in x's dtype, ``silu`` taken in float32."""
    cd = x.dtype
    g = x @ p.wg.to(cd)
    u = x @ p.wu.to(cd)
    h = torch.nn.functional.silu(g.float()).to(cd) * u
    return h @ p.wd.to(cd)


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p.table[tokens]


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) against the table cast to x's dtype -> float32 logits
    (B, S, V), accumulated in float32."""
    table = p.table.to(x.dtype)
    return torch.einsum("bsd,vd->bsv", x.float(), table.float())

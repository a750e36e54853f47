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
tests check.  The ``shard(...)`` annotations of the JAX code are not
calls here: on one device they do nothing; the mesh train step splits its
batch by the spec they give (``models.sharding_rules.spec_for``), and the
tensor-parallel pieces at the end of this module compute the placement
they give on the ``model`` axis.

A layer function takes its parameters as an object with the JAX names as
attributes (the modules of :mod:`repro_torch.models.model`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

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


# ---------------------------------------------------------------------------
# tensor-parallel pieces: one data group's pass split over the model axis
# ---------------------------------------------------------------------------
#
# The JAX layers' ``shard`` annotations place the column projections
# (wq, wk, wv, wg, wu), q's heads, the SwiGLU hidden and the vocabulary
# on ``tp`` = ``model``, and the row projections (wo, wd) with their
# outputs summed over it.  Every other activation is replicated: each
# model coordinate holds its own copy of the residual stream, the norms'
# outputs and every piece the axis does not divide, and computes them
# itself, as GSPMD places them.  So a piece takes one input per
# coordinate and returns one output per coordinate (``ModelAxis``
# order).  A row projection's partial products are all-reduced: each
# coordinate sums them in float32, in coordinate order, and casts the
# sum to the activations' dtype; column blocks that a replicated tensor
# needs whole (k and v: the rule ``kv: None``) are all-gathered.  One
# autograd graph spans the coordinates and the loss is read at
# coordinate 0.  The backward of an all-reduce then sums the
# coordinates' gradients, that of an all-gather sums each block's, and
# each coordinate's copy of a replicated weight receives the part of its
# gradient that flows through that coordinate: the copies' sum is the
# weight's gradient, each path counted once.


class ModelAxis:
    """The model coordinates of one data group: ``models[m]`` is
    coordinate m's work model (its blocks of the split weights, the
    replicated ones whole), on its device.  The collectives take one
    tensor per coordinate and return one per coordinate; coordinates on
    one device share one result."""

    def __init__(self, models: list):
        self.models = list(models)
        self.devices = [m.device for m in self.models]

    @property
    def size(self) -> int:
        """The extent of the axis (the blocks a split weight has)."""
        return len(self.models)

    def _on_each(self, fn) -> list:
        done = {}
        for d in self.devices:
            if d not in done:
                done[d] = fn(d)
        return [done[d] for d in self.devices]

    def all_reduce(self, ys: list, dtype) -> list:
        """The sum of ``ys`` at every coordinate: float32, in coordinate
        order, cast to ``dtype``."""
        def total(d):
            acc = ys[0].to(d).float()
            for y in ys[1:]:
                acc = acc + y.to(d).float()
            return acc.to(dtype)
        return self._on_each(total)

    def all_gather(self, ys: list, dim: int = -1) -> list:
        """The blocks ``ys`` joined along ``dim`` at every coordinate."""
        return self._on_each(
            lambda d: torch.cat([y.to(d) for y in ys], dim=dim))

    def all_max(self, ys: list) -> list:
        """The elementwise max of ``ys`` at every coordinate."""
        return self._on_each(
            lambda d: torch.stack([y.to(d) for y in ys]).amax(0))


def _split(w: torch.Tensor, dim: int, whole: int) -> bool:
    return w.shape[dim] != whole


def _kv_heads(a: int, b: int, group: int):
    """The kv heads q heads [a, b) read under GQA (head h reads h //
    group): a slice with a uniform group where the block covers whole
    groups or lies in one, else one index per q head."""
    idx = [h // group for h in range(a, b)]
    k0, n = idx[0], idx[-1] - idx[0] + 1
    g = (b - a) // n
    if g * n == b - a and idx == [k0 + j // g for j in range(b - a)]:
        return slice(k0, k0 + n)
    return idx


def self_attention_tp(ps: list, xs: list, cfg, positions: torch.Tensor,
                      ax: ModelAxis) -> list:
    """Training self attention over the model axis: ``ps[m]`` holds
    coordinate m's column blocks of wq, wk, wv and row block of wo,
    ``xs[m]`` its copy of the input.  k and v are whole at every
    coordinate (the rule ``kv: None``: their column blocks all-gathered)
    and take RoPE there.  q is split over heads where the axis divides
    them (``("batch", "seq", "tp", None)``): each coordinate takes RoPE
    on its block and attends with the K/V heads its heads read.  Where
    the heads do not divide, q's blocks are all-gathered too and each
    coordinate computes the whole attention, taking its block of the
    output for wo's rows.  wo's partial products are all-reduced."""
    B, S, _ = xs[0].shape
    hd, H, KH = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    cd, M, theta = xs[0].dtype, ax.size, cfg.rope_theta
    pos = [positions.to(x.device) for x in xs]
    opts = dict(causal=True, q_chunk=cfg.attn_q_chunk,
                kv_chunk=cfg.attn_kv_chunk)

    def whole(name, heads):
        """Each coordinate's (B, S, heads, hd) projection, whole."""
        ys = [x @ getattr(p, name).to(cd) for x, p in zip(xs, ps)]
        if _split(getattr(ps[0], name), 1, heads * hd):
            ys = ax.all_gather(ys)
        return [y.reshape(B, S, heads, hd) for y in ys]

    by_heads = _split(ps[0].wq, 1, H * hd) and H % M == 0
    # qkv_proj's order, so that x's gradient sums its three parts in the
    # same order (bitwise where nothing splits)
    q = None if by_heads else whole("wq", H)
    k, v = whole("wk", KH), whole("wv", KH)
    if q is not None:
        q = [rope(t, pm, theta) for t, pm in zip(q, pos)]
    k = [rope(t, pm, theta) for t, pm in zip(k, pos)]
    if by_heads:                                  # q over heads
        hb = H // M
        ys = []
        for m, (x, p, km, vm, pm) in enumerate(zip(xs, ps, k, v, pos)):
            sel = _kv_heads(m * hb, (m + 1) * hb, H // KH)
            qm = rope((x @ p.wq.to(cd)).reshape(B, S, hb, hd), pm, theta)
            out = attention(qm, km[:, :, sel], vm[:, :, sel], **opts)
            ys.append(out.reshape(B, S, hb * hd).to(cd) @ p.wo.to(cd))
        return ax.all_reduce(ys, cd)
    outs = [attention(*qkv, **opts).reshape(B, S, H * hd).to(cd)
            for qkv in zip(q, k, v)]
    if not _split(ps[0].wo, 0, H * hd):
        return [o @ p.wo.to(cd) for o, p in zip(outs, ps)]
    w = H * hd // M
    return ax.all_reduce([o[..., m * w:(m + 1) * w] @ p.wo.to(cd)
                          for m, (o, p) in enumerate(zip(outs, ps))], cd)


def mlp_tp(ps: list, xs: list, d_ff: int, ax: ModelAxis) -> list:
    """SwiGLU over the model axis: each coordinate's column blocks of wg
    and wu, ``silu(g) * u`` on its block of ``d_ff`` and its row block of
    wd give a partial product; the partials are all-reduced.  Where the
    axis does not divide ``d_ff``, each coordinate's whole MLP."""
    ys = [mlp(p, x) for p, x in zip(ps, xs)]
    if not _split(ps[0].wg, 1, d_ff):
        return ys
    return ax.all_reduce(ys, xs[0].dtype)


def embed_tp(ps: list, tokens: torch.Tensor, vocab: int, ax: ModelAxis
             ) -> list:
    """The lookup of a table split over the vocabulary: each coordinate
    looks up the tokens its block holds, zeros elsewhere, and the rows
    are all-reduced, bitwise the whole-table lookup (each token's row
    plus zeros) at every coordinate."""
    toks = [tokens.to(d) for d in ax.devices]
    if not _split(ps[0].table, 0, vocab):
        return [embed(p, t) for p, t in zip(ps, toks)]
    vb = ps[0].table.shape[0]
    rows = []
    for m, (p, tok) in enumerate(zip(ps, toks)):
        own = (tok >= m * vb) & (tok < (m + 1) * vb)
        r = p.table[(tok - m * vb).clamp(0, vb - 1)]
        rows.append(torch.where(own[..., None], r, r.new_zeros(())))
    return ax.all_reduce(rows, rows[0].dtype)


class VocabBlocks(NamedTuple):
    """Logits split over the vocabulary: ``parts[m]`` (B, S, V / M)
    float32 on coordinate m, its columns from m * V / M."""
    parts: list
    ax: ModelAxis


def unembed_tp(ps: list, xs: list, vocab: int, ax: ModelAxis):
    """The head over the model axis (logits ``("batch", "seq", "tp")``):
    each coordinate's logits against its vocabulary block, as
    :class:`VocabBlocks`.  Where the axis does not divide the vocabulary,
    the whole logits of coordinate 0, which reads the loss."""
    if not _split(ps[0].table, 0, vocab):
        return unembed(ps[0], xs[0])
    return VocabBlocks([unembed(p, x) for p, x in zip(ps, xs)], ax)


def vocab_parallel_logp(logits: VocabBlocks,
                        labels: torch.Tensor) -> torch.Tensor:
    """The float32 log-softmax at ``labels`` (B, S) from the vocabulary
    blocks, without gathering them: the max over the blocks (detached),
    the sum of exponentials over the blocks and the label's logit from
    the block that owns it (a label outside every block, -1, takes 0),
    each all-reduced.  At coordinate 0."""
    ax, parts = logits.ax, logits.parts
    vb = parts[0].shape[-1]
    tops = ax.all_max([p.detach().amax(-1) for p in parts])
    sums, takes = [], []
    for m, (p, top) in enumerate(zip(parts, tops)):
        lab = labels.to(p.device)
        sums.append(torch.exp(p - top[..., None]).sum(-1))
        own = (lab >= m * vb) & (lab < (m + 1) * vb)
        t = torch.gather(p, -1, (lab - m * vb).clamp(0, vb - 1)[..., None])
        takes.append(torch.where(own, t[..., 0], t.new_zeros(())))
    total = ax.all_reduce(sums, torch.float32)[0]
    take = ax.all_reduce(takes, torch.float32)[0]
    return take - (tops[0] + torch.log(total))

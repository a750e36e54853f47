"""Shared set-up of the LM parity tests: one reduced config in both
packages with the same weights (``params_from_jax``), inputs made with
numpy, the JAX entry points jitted once per config, and the block-by-block
comparison the MoE configs need.

Why block by block.  Top-k routing and capacity selection are
discontinuous: a token whose 2nd and 3rd expert probabilities lie within
~1e-4, or whose gate sits at an expert's capacity cut, switches experts
when its input moves by one bf16 ulp, and the two packages' attention
sums do differ by such ulps (float32 sums in another order).  Through a
whole stack such a switch changes a token's output by O(1) (0.06-0.43 on
the reduced grok, arctic and jamba at three seeds, with 2nd-3rd gaps of
5.5e-5 at the switching token).  Within one block the attention's ulps
reach the router as well.  So at their configured top-k and capacity,
the MoE configs are held to the JAX package one block at a time: both
packages' block gets the port's hidden state, the JAX block's ``moe``
gets the port's MoE input (it is swapped in while the JAX block is
traced; the JAX package is not edited), and outputs, aux losses and
caches must agree.  End to end they are compared on a
copy whose routing is continuous (``smooth``: every expert chosen,
``top_k_experts = n_experts``, and capacity 1.0, so C = S and no token is
dropped); that copy runs the same gather, gated products and
scatter-add.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import model as M
from repro.models import moe as JMOE
from repro_torch import configs
from repro_torch.models import layers as L
from repro_torch.models import moe as TMOE
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import LanguageModel

#: the six configs whose kinds this slice ports
NEW_ARCHS = ("grok_1_314b", "arctic_480b", "mamba2_780m", "jamba_v0_1_52b",
             "llama3_2_vision_11b", "musicgen_medium")
MOE_ARCHS = ("grok_1_314b", "arctic_480b", "jamba_v0_1_52b")
#: batch; forward length (two SSM chunks of the reduced configs); prompt
#: length (one chunk)
B, S, PROMPT = 2, 64, 32
#: the cross-attention gate set in the compared weights: it is zero at
#: init, where tanh(0) = 0 hides the whole cross path from the logits
XGATE = 0.5
#: the dense tests' bounds (``tests/test_torch_models.py``): logits, and
#: K/V caches carried through a stack
LOGIT_ATOL = 0.03
CACHE_ATOL = 0.1


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The reduced models' tensors are tiny, so PyTorch's intra-op threads
    buy nothing here, and beside the other test workers of a parallel run
    they contend for the cores (a 31-step decode loop took 69 s so, under
    a second alone).  A module binds this fixture to run on one thread; the
    count is restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_pair(arch, kv="bf16", smooth=False):
    """(JAX config, port config) of the reduced ``arch`` with 16-wide
    attention chunks (several q and kv blocks) and the KV cache ``kv``;
    ``smooth``: routing made continuous (see the module docstring)."""
    kw = dict(attn_q_chunk=16, attn_kv_chunk=16, kv_cache_dtype=kv)
    cfg = configs.get_reduced(arch)
    if smooth and cfg.n_experts:
        kw.update(top_k_experts=cfg.n_experts, capacity_factor=1.0)
    return (dataclasses.replace(jconfigs.get_reduced(arch), **kw),
            dataclasses.replace(cfg, **kw))


@functools.lru_cache(maxsize=None)
def _init(jcfg):
    return jax.jit(lambda k: M.init_params(k, jcfg))


def load(arch, seed=3, smooth=False):
    """(JAX params, the port's model with the same weights); a cross
    config's gates are set to ``XGATE`` in both."""
    jcfg, cfg = cfg_pair(arch, smooth=smooth)
    params = _init(jcfg)(jax.random.PRNGKey(seed))
    params["blocks"] = tuple(
        dict(p, xgate=jnp.full_like(p["xgate"], XGATE)) if "xgate" in p
        else p for p in params["blocks"])
    model = LanguageModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          cfg))
    return params, model


def make_inputs(cfg, n, seed=11):
    """(inputs (B, n) token ids or (B, n, d) float32 embeddings, context
    (B, vision_tokens, d) float32 or None), from numpy."""
    rng = np.random.default_rng(seed)
    if cfg.embed_input:
        inp = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    else:
        inp = rng.standard_normal((B, n, cfg.d_model), np.float32)
    ctx = (rng.standard_normal((B, cfg.vision_tokens, cfg.d_model),
                               np.float32) if cfg.vision_tokens else None)
    return inp, ctx


def jbatch(cfg, inp, ctx=None):
    b = {"tokens" if cfg.embed_input else "embeds": jnp.asarray(inp)}
    if ctx is not None:
        b["image_embeds"] = jnp.asarray(ctx)
    return b


def t(x):
    """numpy inputs as the port takes them."""
    x = torch.from_numpy(np.asarray(x))
    return x.long() if x.dtype == torch.int32 else x


def jctx(ctx):
    """The context as the JAX decode step takes it (its forward and
    prefill cast it to bf16 themselves)."""
    return None if ctx is None else jnp.asarray(ctx).astype(jnp.bfloat16)


@functools.lru_cache(maxsize=None)
def jax_forward(jcfg):
    return jax.jit(lambda p, b: M.forward(p, jcfg, b))


@functools.lru_cache(maxsize=None)
def jax_prefill(jcfg, max_len):
    return jax.jit(lambda p, b: M.prefill(p, jcfg, b, max_len=max_len))


@functools.lru_cache(maxsize=None)
def jax_decode(jcfg):
    return jax.jit(lambda p, x, c, n, ctx: M.decode_step(p, jcfg, x, c, n,
                                                         ctx=ctx))


def f32(x):
    """A tensor of either package as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def dequant(c, key):
    """A cache's K or V (either package's) as float32 numpy, dequantized
    where it is int8."""
    x = c[key]
    if f"{key}_scale" in c:
        x = (L.dequantize_kv if isinstance(x, torch.Tensor)
             else JL.dequantize_kv)(x, c[f"{key}_scale"])
    return f32(x)


# ---------------------------------------------------------------------------
# block by block
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_block(kind, jcfg, mode):
    """The JAX ``_apply_block`` of one kind, jitted; given ``h2``, its
    ``moe`` runs on h2 in place of the block's own MoE input."""
    def run(p, x, ctx, pos, cache, n, h2):
        orig = JMOE.moe
        if h2 is not None:
            JMOE.moe = lambda pp, _x, c: orig(pp, h2, c)
        try:
            return M._apply_block(kind, p, x, jcfg, ctx=ctx, positions=pos,
                                  cache=cache, cache_len=n, mode=mode)
        finally:
            JMOE.moe = orig
    return jax.jit(run)


@contextlib.contextmanager
def _port_moe_inputs():
    """Record the inputs of the port's ``moe`` calls."""
    seen, orig = [], TMOE.moe

    def spy(p, x, cfg):
        seen.append(x)
        return orig(p, x, cfg)

    TMOE.moe = spy
    try:
        yield seen
    finally:
        TMOE.moe = orig


def _to_jax(x: torch.Tensor):
    """A copy (``jnp.asarray`` of a numpy view may share the port's
    buffer, which decode writes in place)."""
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(x.numpy().copy())


def chained(model, params, jcfg, x, ctx, mode, *, caches=None,
            cache_len=None):
    """Run the port's blocks in order from its hidden state x (bf16), and
    at each block the JAX package's block on the same hidden state (in
    decode, the same cache; with MoE, the same MoE input).  Returns (the
    port's final hidden state, records): per block (kind, port output, JAX
    output, port aux, JAX aux, port new cache, JAX new cache); decode
    caches are the block's repeat slice after the step (the port's
    written in place)."""
    cfg = model.cfg
    n = x.shape[1]
    start = 0 if cache_len is None else cache_len
    pos = model._positions(start, n)
    jpos = jnp.arange(start, start + n)[None]
    tctx = None if ctx is None else t(ctx).bfloat16()
    records = []
    for r, rep in enumerate(model.blocks):
        for i, blk in enumerate(rep):
            jp = jax.tree.map(lambda a: a[r], params["blocks"][i])
            jc = None
            if caches is not None:
                jc = {k: _to_jax(v[r]) for k, v in caches[i].items()}
            jx = _to_jax(x)
            with _port_moe_inputs() as seen:
                y, a, new = blk.run(
                    x, cfg, ctx=tctx, positions=pos,
                    cache=None if caches is None else caches[i], r=r,
                    cache_len=cache_len)
            jy, ja, jn = _jax_block(blk.kind, jcfg, mode)(
                jp, jx, jctx(ctx), jpos, jc,
                None if cache_len is None else jnp.int32(cache_len),
                _to_jax(seen[0]) if seen else None)
            if caches is not None:
                new = {k: v[r] for k, v in caches[i].items()}
            records.append((blk.kind, y, jy, a, ja, new, jn))
            x = y
    return x, records

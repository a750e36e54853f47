"""The port's MoE (``repro_torch.models.moe``) against ``repro.models.moe``
on the CPU, and the MoE configs (``grok_1_314b``, ``arctic_480b``,
``jamba_v0_1_52b``, reduced) against ``repro.models.model`` block by block
at their configured top-2 routing and capacity factor 1.25 (why block by
block: ``tests/torch_lm_parity.py``).

Tolerances, and why:

* ``moe`` on the same bf16 input: the routing is float32 and picks the
  same experts and tokens; the expert products are bf16 products with
  float32 sums whose order differs now and then (XLA's dot against
  PyTorch's batched matmul), so an output may differ by one bf16 ulp:
  y is held to ``2**-7`` times its largest magnitude (an ulp of it; 0 to
  0.0078 seen over 15 draws, most of them bitwise).  The aux loss is a
  float32 mean of another order: ``rtol=1e-6`` (2.4e-7 seen).
* Blocks fed the same hidden state: a block's output is a sum of up to
  four bf16 terms (the residual, attention or SSM, the dense MLP, the
  MoE), each rounded, so outputs are held to ``BLOCK_ATOL + BLOCK_RTOL *
  |y|`` (0.03, the ``LOGIT_ATOL`` of the dense tests, plus two bf16 ulps
  of the element; 0.03125 seen at |y| = 2.4 in an ``attn_moe_dense``
  block) and K/V to ``BLOCK_ATOL``; ``ssm`` states (float32 sums) within
  ``rtol=1e-5, atol=1e-4`` (2.1e-5 seen at |s| <= 20), ``conv`` states
  (the input projection's bf16 outputs) within ``BLOCK_ATOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parity as P
from repro import configs as jconfigs
from repro.models import model as M
from repro.models import moe as JM
from repro_torch import configs
from repro_torch.models import moe

BLOCK_ATOL = 0.03
BLOCK_RTOL = 2.0 ** -6
AUX_RTOL = 1e-6

one_torch_thread = P.one_torch_thread


def _moe_params(jcfg, seed):
    p = JM.moe_init(jax.random.PRNGKey(seed), jcfg)

    class W:
        pass

    w = W()
    for k in ("router", "wg", "wu", "wd"):
        setattr(w, k, torch.from_numpy(np.array(p[k])))
    return p, w


def _both(arch, **kw):
    return (dataclasses.replace(jconfigs.get_reduced(arch), **kw),
            dataclasses.replace(configs.get_reduced(arch), **kw))


def _close_bf16(got, want):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("arch,b,s,cf", [
    ("grok_1_314b", 2, 64, None),     # C = 40 of 64: overflow, drops
    ("arctic_480b", 2, 64, None),     # 8 experts, C = 20
    ("grok_1_314b", 8, 1, None),      # a decode step: C = 1, no drop
    ("arctic_480b", 3, 17, 4.0),      # dropless: C = S
    ("jamba_v0_1_52b", 2, 32, None)])
def test_moe_matches_jax(arch, b, s, cf):
    kw = {} if cf is None else {"capacity_factor": cf}
    jcfg, cfg = _both(arch, **kw)
    p, w = _moe_params(jcfg, 0)
    x = np.random.default_rng(b * s).standard_normal(
        (b, s, cfg.d_model), np.float32)
    jy, jaux = JM.moe(p, jnp.asarray(x).astype(jnp.bfloat16), jcfg)
    y, aux = moe.moe(w, torch.from_numpy(x).bfloat16(), cfg)
    assert y.dtype == torch.bfloat16 and y.shape == (b, s, cfg.d_model)
    assert aux.dtype == torch.float32 and aux.shape == ()
    _close_bf16(y, jy)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)
    if cf is None and s > 1:
        assert moe.capacity(cfg, s) < s


def test_capacity_overflow_and_tied_gates():
    """Eight identical tokens, and a router whose first three columns are
    equal: every token's top-2 is a tie of three experts, which both
    packages break toward experts 0 and 1; both experts then get 8 tokens
    with equal gates (0.5) for C = 4 slots, which go to tokens 0-3.  So
    tokens 4-7 are dropped (y exactly 0) and 0-3 get the same output; the
    port equals the JAX package bitwise."""
    jcfg, cfg = _both("grok_1_314b", capacity_factor=1.0)
    S = 8
    assert moe.capacity(cfg, S) == 4
    p, w = _moe_params(jcfg, 1)
    col = np.asarray(p["router"][:, :1])
    router = np.concatenate([col, col, col, -col], axis=1)
    p = dict(p, router=jnp.asarray(router))
    w.router = torch.from_numpy(router)
    x = np.broadcast_to(np.random.default_rng(2).standard_normal(
        (1, 1, cfg.d_model), np.float32), (2, S, cfg.d_model)).copy()
    tx = torch.from_numpy(x).bfloat16()
    y, aux = moe.moe(w, tx, cfg)
    jy, jaux = JM.moe(p, jnp.asarray(x).astype(jnp.bfloat16), jcfg)
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(jy.astype(jnp.float32)))
    assert float(aux) == pytest.approx(float(jaux), rel=AUX_RTOL)
    assert torch.all(y[:, 4:] == 0)
    assert torch.all(y[:, :4] == y[:, :1]) and torch.any(y[:, 0] != 0)
    # the ties themselves, on the port's selections
    probs = torch.softmax(tx.float() @ w.router, dim=-1)
    assert probs[0, 0, 0] == probs[0, 0, 1] == probs[0, 0, 2]
    _, top_i = moe.top_k(probs, 2)
    assert top_i[..., 0].eq(0).all() and top_i[..., 1].eq(1).all()
    gates = torch.zeros_like(probs).scatter_(-1, top_i, 0.5)
    gv, gi = moe.top_k(gates.transpose(1, 2), 4)
    assert gi[:, :2].eq(torch.arange(4)).all() and (gv[:, :2] == 0.5).all()
    # expert 2 has no token: its slots take tokens 0-3 at gate 0, not live
    assert gi[:, 2].eq(torch.arange(4)).all() and (gv[:, 2] == 0).all()


def test_top_k_breaks_ties_toward_the_lower_index():
    x = torch.tensor([[0.5, 0.25, 0.5, 0.25, 0.5, 0.0]])
    v, i = moe.top_k(x, 4)
    assert i.tolist() == [[0, 2, 4, 1]] and v.tolist() == [[0.5] * 3 + [0.25]]
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert np.asarray(ji).tolist() == i.tolist()


def test_combine_is_order_free():
    """The scatter-add back to the tokens: with at most two nonzero terms
    a token (the top-2 picks; the other slots of a token are exact zeros),
    ``index_add_`` in bf16 equals the float32 sum rounded once, in any
    order of the slots."""
    rng = np.random.default_rng(5)
    b, E, C, S, d = 2, 4, 6, 8, 16
    gi = torch.from_numpy(np.stack([np.stack(
        [rng.permutation(S)[:C] for _ in range(E)]) for _ in range(b)]))
    ye = torch.from_numpy(rng.standard_normal((b, E, C, d),
                                              np.float32)).bfloat16()
    # keep two nonzero terms a token: zero every later slot of a token
    seen = np.zeros((b, S), int)
    for bi in range(b):
        for e in range(E):
            for c in range(C):
                tok = int(gi[bi, e, c])
                seen[bi, tok] += 1
                if seen[bi, tok] > 2:
                    ye[bi, e, c] = 0
    y = moe.combine(ye, gi, S)
    want = torch.zeros((b, S, d))
    for bi in range(b):
        for e in range(E):
            for c in range(C):
                want[bi, gi[bi, e, c]] += ye[bi, e, c].float()
    assert torch.equal(y, want.bfloat16())
    rev = moe.combine(ye.flip(1).flip(2), gi.flip(1).flip(2), S)
    assert torch.equal(y, rev)


# ---------------------------------------------------------------------------
# the MoE configs, block by block at their configured routing
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=P.MOE_ARCHS)
def moe_lm(request):
    arch = request.param
    params, model = P.load(arch)
    jcfg, _ = P.cfg_pair(arch)
    inp, _ = P.make_inputs(model.cfg, P.S)
    return arch, params, model, jcfg, inp


def _check_block(kind, y, jy, a, ja):
    np.testing.assert_allclose(P.f32(y), P.f32(jy), atol=BLOCK_ATOL,
                               rtol=BLOCK_RTOL, err_msg=kind)
    np.testing.assert_allclose(float(a), float(ja), rtol=AUX_RTOL,
                               atol=1e-7)


def _check_states(kind, new, jn):
    if "ssm" in jn:
        np.testing.assert_allclose(P.f32(new["ssm"]), P.f32(jn["ssm"]),
                                   rtol=1e-5, atol=1e-4, err_msg=kind)
        np.testing.assert_allclose(P.f32(new["conv"]), P.f32(jn["conv"]),
                                   atol=BLOCK_ATOL, rtol=0, err_msg=kind)


def test_moe_config_forward_block_by_block(moe_lm):
    """Forward at the configured routing (tokens dropped at capacity):
    every block's output and aux loss on the port's hidden state, then the
    logits of the last one; the port's ``forward`` gives the chained run's
    logits bitwise and the blocks' aux losses summed in order."""
    arch, params, model, jcfg, inp = moe_lm
    x0 = model._embed_in(P.t(inp))
    x, rec = P.chained(model, params, jcfg, x0, None, "train")
    for kind, y, jy, a, ja, _, _ in rec:
        _check_block(kind, y, jy, a, ja)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    logits = model._logits(x)
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(M._logits(params, jcfg, jx)),
                               atol=P.LOGIT_ATOL, rtol=0)
    got, aux = model(P.t(inp))
    assert torch.equal(got, logits)
    want_aux = torch.zeros(())
    for r in rec:
        want_aux = want_aux + r[3]
    assert float(aux) == float(want_aux) > 0
    np.testing.assert_allclose(float(aux), sum(float(r[4]) for r in rec),
                               rtol=AUX_RTOL)


def test_moe_config_prefill_block_by_block(moe_lm):
    """Prefill: each block's K/V and SSM / conv states on the port's
    hidden state against the JAX block's (bf16 cache), and the port's
    ``prefill`` stores the chained run's entries."""
    arch, params, model, jcfg, inp = moe_lm
    x0 = model._embed_in(P.t(inp[:, :P.PROMPT]))
    x, rec = P.chained(model, params, jcfg, x0, None, "prefill")
    for kind, y, jy, a, ja, new, jn in rec:
        _check_block(kind, y, jy, a, ja)
        for key in ("k", "v"):
            if key in jn:
                np.testing.assert_allclose(P.f32(new[key].bfloat16()),
                                           P.f32(jn[key]), atol=BLOCK_ATOL,
                                           rtol=0)
        _check_states(kind, new, jn)
    lg, caches, n = model.prefill(P.t(inp[:, :P.PROMPT]), P.S, "bf16")
    assert n == P.PROMPT and torch.equal(lg, model._logits(x[:, -1:]))
    R = model.cfg.n_repeats
    for j, (_, _, _, _, _, new, _) in enumerate(rec):
        r, i = divmod(j, len(model.cfg.block_pattern))
        assert r < R
        for key, val in new.items():
            stored = caches[i][key][r]
            if key in ("k", "v"):
                stored = stored[:, :P.PROMPT]
            assert torch.equal(stored, val.to(stored.dtype)), key


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_moe_config_decode_block_by_block(moe_lm, kv):
    """Three decode steps after the port's prefill: each block's output
    and updated caches (K/V with the new token, the SSM and conv states)
    against the JAX block's on the same hidden state and caches; the
    port's ``decode_step`` gives the chained step's logits bitwise."""
    arch, params, model, _, inp = moe_lm
    jcfg, _ = P.cfg_pair(arch, kv)
    _, caches, n = model.prefill(P.t(inp[:, :P.PROMPT]), P.S, kv)
    for step in range(3):
        at = n + step
        tok = P.t(inp[:, at:at + 1])
        twin = tuple({k: v.clone() for k, v in c.items()} for c in caches)
        x, rec = P.chained(model, params, jcfg, model._embed_in(tok), None,
                           "decode", caches=caches, cache_len=at)
        for kind, y, jy, a, ja, new, jn in rec:
            _check_block(kind, y, jy, a, ja)
            for key in ("k", "v"):
                if key in jn:
                    np.testing.assert_allclose(
                        P.dequant(new, key), P.dequant(jn, key),
                        atol=BLOCK_ATOL, rtol=0)
            _check_states(kind, new, jn)
        lg, twin = model.decode_step(tok, twin, at)
        assert torch.equal(lg, model._logits(x))
        for c, w in zip(caches, twin):
            for key in c:
                assert torch.equal(c[key], w[key]), key

"""The port's Mamba-2 block (``repro_torch.models.ssm``) against
``repro.models.ssm`` on the CPU, on the same numpy inputs and the same
weights (``mamba_init`` of the reduced ``jamba_v0_1_52b``: d_model 128,
16 heads of 16, state 16, chunk 32).

Tolerances, and why:

* ``_causal_conv``: the port mirrors the JAX code's unrolled bf16 sum
  (W products added in order, then the bias, ``silu`` in float32), and is
  held to it bitwise; streaming the sequence token by token gives the
  full run's bits, and the last W-1 inputs as its state.
* ``ssd_chunked`` in float32: the same contractions summed in another
  order, ``rtol=atol=1e-5`` against the JAX function (9.5e-6 seen at
  |y| <= 50, 2.9e-6 on the states); against the O(L) recurrence, the
  JAX test's own ``atol=rtol=1e-3`` (``tests/test_models_smoke.py``).
* ``mamba_block``: bf16 projections whose float32 sums run in another
  order give an output bf16 ulp now and then: outputs within 0.03 (the
  dense tests' ``LOGIT_ATOL``; 0.0039 seen), states within
  ``rtol=1e-5, atol=1e-4`` (4.5e-6 seen), conv states exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parity as P
from repro.models import ssm as JS
from repro_torch.models import ssm

ATOL = 0.03

one_torch_thread = P.one_torch_thread


@pytest.fixture(scope="module")
def mamba():
    jcfg, cfg = P.cfg_pair("jamba_v0_1_52b")
    p = JS.mamba_init(jax.random.PRNGKey(0), jcfg)

    class W:
        pass

    w = W()
    for k, v in p.items():
        setattr(w, k, torch.from_numpy(np.array(v)))
    return jcfg, cfg, p, w


def _bf16(x):
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _eq(got, want):
    np.testing.assert_array_equal(P.f32(got), P.f32(want))


def test_causal_conv_matches_jax_and_streams():
    rng = np.random.default_rng(0)
    Bn, L, C, W = 2, 12, 40, 4
    jx, tx = _bf16(rng.standard_normal((Bn, L, C), np.float32))
    jw, tw = _bf16(rng.standard_normal((W, C), np.float32) * 0.5)
    jb, tb = _bf16(rng.standard_normal((C,), np.float32) * 0.1)
    y, st = ssm._causal_conv(tx, tw, tb)
    jy, jst = JS._causal_conv(jx, jw, jb)
    _eq(y, jy)
    _eq(st, jst)
    assert st.shape == (Bn, W - 1, C) and torch.equal(st, tx[:, -(W - 1):])
    # the first 5 inputs at once, then the rest one at a time
    y0, s = ssm._causal_conv(tx[:, :5], tw, tb)
    ys = [y0]
    for i in range(5, L):
        yi, s = ssm._causal_conv(tx[:, i:i + 1], tw, tb, s)
        ys.append(yi)
    assert torch.equal(torch.cat(ys, dim=1), y) and torch.equal(s, st)
    # a streaming step in the JAX package, from the same state
    jy1, jst1 = JS._causal_conv(jx[:, 5:6], jw, jb,
                                jnp.asarray(P.f32(tx[:, 2:5])).astype(
                                    jnp.bfloat16))
    y1, st1 = ssm._causal_conv(tx[:, 5:6], tw, tb, tx[:, 2:5])
    _eq(y1, jy1)
    _eq(st1, jst1)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_jax_and_sequential(with_state):
    """As ``tests/test_models_smoke.py::test_ssd_chunked_equals_sequential``
    (numpy inputs of its shapes), against the JAX ``ssd_chunked`` too, with
    and without an initial state."""
    rng = np.random.default_rng(1)
    Bn, L, H, Pd, N = 2, 64, 4, 16, 8
    x = rng.standard_normal((Bn, L, H, Pd), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bn, L, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((H,))).astype(np.float32)
    Bm = rng.standard_normal((Bn, L, N), np.float32)
    Cm = rng.standard_normal((Bn, L, N), np.float32)
    s0 = (rng.standard_normal((Bn, H, Pd, N), np.float32) if with_state
          else None)
    targs = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    ts0 = None if s0 is None else torch.from_numpy(s0)
    y, s = ssm.ssd_chunked(*targs, chunk=16, init_state=ts0)
    jy, js = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=16,
                            init_state=None if s0 is None else
                            jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    y2, s2 = ssm.ssd_sequential(*targs, init_state=ts0)
    np.testing.assert_allclose(y.numpy(), y2.numpy(), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(s.numpy(), s2.numpy(), atol=1e-3, rtol=1e-3)
    jy2, _ = JS.ssd_sequential(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                               init_state=None if s0 is None else
                               jnp.asarray(s0))
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), rtol=1e-5,
                               atol=1e-5)


def test_ssd_chunked_needs_whole_chunks():
    z = torch.zeros
    with pytest.raises(ValueError, match="not a multiple of the chunk 16"):
        ssm.ssd_chunked(z(1, 24, 2, 4), z(1, 24, 2), z(2), z(1, 24, 3),
                        z(1, 24, 3), chunk=16)


def test_mamba_block_prefill_and_decode_match_jax(mamba):
    """Prefill by chunked SSD (one chunk of 32), then three recurrent
    decode steps from its states, in both packages; and decode after a
    prefill of 32 against the recurrence run over all 35 tokens
    (``sequential``, whose length needs no whole chunks)."""
    jcfg, cfg, p, w = mamba
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 35, cfg.d_model), np.float32)
    jx, tx = _bf16(x)
    y, (s, c) = ssm.mamba_block(w, tx[:, :32], cfg)
    jy, (js, jc) = JS.mamba_block(p, jx[:, :32], jcfg)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert s.shape == (2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    assert c.shape == (2, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state)
    np.testing.assert_allclose(P.f32(y), P.f32(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-4)
    _eq(c, jc)
    steps = []
    for i in range(32, 35):
        y1, (s, c) = ssm.mamba_block(w, tx[:, i:i + 1], cfg, state=s,
                                     conv_state=c)
        jy1, (js, jc) = JS.mamba_block(p, jx[:, i:i + 1], jcfg, state=js,
                                       conv_state=jc)
        np.testing.assert_allclose(P.f32(y1), P.f32(jy1), atol=ATOL, rtol=0)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-4)
        _eq(c, jc)
        steps.append(y1)
    full, (sf, _) = ssm.mamba_block(w, tx, cfg, sequential=True)
    np.testing.assert_allclose(P.f32(torch.cat(steps, 1)),
                               P.f32(full[:, 32:]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(s.numpy(), sf.numpy(), rtol=1e-4, atol=1e-4)

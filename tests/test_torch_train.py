"""The port's training side (``repro_torch.train``) against ``repro.train``
on the CPU, on the same numpy inputs.

* The quantizers (``optimizer._quantize`` / ``_dequantize``,
  ``compression.quantize_int8`` / ``dequantize_int8``) are bitwise the
  JAX ones, run eagerly (no jit, so XLA contracts no FMA).
* ``apply_updates`` on the same params, grads and states, float32 and
  int8, three steps: the global norm's sums of squares run in another
  order in the two libraries (an ulp apart), and so do the clip and all
  after it; parameters, moments and scales are held within 8 float32 ulps
  of each leaf's largest magnitude (twice the most seen, 4), and the
  int8 codes equal but where the quantized value lies within 1e-4 of a
  rounding boundary, there by one code (counted: at most 1e-3 of them;
  none seen).
* One train step of the reduced dense, Mamba-2 and embedding-input
  configs from the JAX state carried across, and one with int8 states and
  gradient compression, against the jitted JAX step, at the bounds of
  ``torch_train_parity`` (the MoE, hybrid and cross configs:
  ``test_torch_train_kinds.py``).
* ``microbatch=2`` against the full batch at the JAX package's own bounds
  (``tests/test_train_and_checkpoint.py``), and ``remat`` on against off,
  bitwise on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_parity as TP
from repro.models import model as M
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro_torch.models import convert
from repro_torch.models.model import LanguageModel
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from torch_lm_parity import one_torch_thread  # noqa: F401

ULPS = 8


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


SHAPES = [(5,), (300,), (64, 256), (3, 40, 70), (2, 1, 513)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("block", [64, 256])
def test_quantize_is_bitwise_jax(shape, block):
    rng = np.random.default_rng(len(shape) * block)
    x = (rng.standard_normal(shape) * rng.uniform(1e-4, 10.0)).astype(
        np.float32)
    x.reshape(-1)[:3] = 0.0
    jq = jopt._quantize(jnp.asarray(x), block)
    tq = topt._quantize(torch.from_numpy(x), block)
    assert tq.shape == jq.shape == shape
    np.testing.assert_array_equal(_np(tq.codes), np.asarray(jq.codes))
    np.testing.assert_array_equal(_np(tq.scales).view(np.uint32),
                                  np.asarray(jq.scales).view(np.uint32))
    np.testing.assert_array_equal(
        _np(topt._dequantize(tq)).view(np.uint32),
        np.asarray(jopt._dequantize(jq)).view(np.uint32))
    assert tq.size_bytes() == jq.size_bytes()
    zero = topt._quantize(torch.zeros(shape), block)
    assert not zero.codes.any() and torch.all(zero.scales == 1e-12)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quantize_int8_is_bitwise_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    jc, js = jcomp.quantize_int8(jnp.asarray(x))
    tc, tsc = tcomp.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(tsc).view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    np.testing.assert_array_equal(
        _np(tcomp.dequantize_int8(tc, tsc, shape)).view(np.uint32),
        np.asarray(jcomp.dequantize_int8(jc, js, shape)).view(np.uint32))


def test_compress_with_feedback_is_bitwise_jax():
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((700,)).astype(np.float32),
         "b": rng.standard_normal((9, 31)).astype(np.float32)}
    je = {k: jnp.zeros(v.shape) for k, v in g.items()}
    te = tcomp.init_error({k: torch.from_numpy(v) for k, v in g.items()})
    for _ in range(3):
        jg, je = jcomp.compress_with_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, je)
        tg, te = tcomp.compress_with_feedback(
            {k: torch.from_numpy(v) for k, v in g.items()}, te)
        for k in g:
            np.testing.assert_array_equal(_np(tg[k]).view(np.uint32),
                                          np.asarray(jg[k]).view(np.uint32))
            np.testing.assert_array_equal(_np(te[k]).view(np.uint32),
                                          np.asarray(je[k]).view(np.uint32))


def _ulp_close(got, want, what):
    """Within ``ULPS`` float32 ulps of the leaf's largest magnitude."""
    want = np.asarray(want, np.float32)
    tol = ULPS * np.spacing(np.abs(want).max())
    gap = np.abs(np.asarray(got, np.float32) - want)
    assert np.all(gap <= tol), (what, float(gap.max()), float(tol))


def _jax_pre_quant(prev, g, gn, cfg, second):
    """The float32 moment the JAX step quantized (its own arithmetic,
    eager), from its previous int8 moment, the grads and their norm."""
    clip = jnp.minimum(1.0, cfg.grad_clip / jnp.maximum(gn, 1e-9))
    g = jnp.asarray(g) * clip
    if second:
        return cfg.b2 * jopt._dequantize(prev) + (1 - cfg.b2) * g * g
    return cfg.b1 * jopt._dequantize(prev) + (1 - cfg.b1) * g


def _codes_agree(tq, jq, pre, block):
    """int8 codes equal but where the quantized value lies within 1e-4 of
    a rounding boundary, and there by one code.  Returns how many
    differ."""
    diff = tq.codes.numpy() != np.asarray(jq.codes)
    if not diff.any():
        return 0
    x = np.asarray(pre)
    x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, (-x.shape[-1]) % block)])
    v = x.reshape(diff.shape) / np.asarray(jq.scales)[..., None]
    near = np.abs(np.abs(v - np.floor(v)) - 0.5) < 1e-4
    gap = np.abs(tq.codes.numpy().astype(int) - np.asarray(jq.codes))
    assert np.all(near[diff]) and np.all(gap <= 1)
    return int(diff.sum())


@pytest.mark.parametrize("state_dtype", ["fp32", "int8"])
def test_apply_updates_matches_jax(state_dtype):
    """Three steps of ``apply_updates`` on the same params, grads and
    states: a vector (no decay, float32 state), matrices, a rank-3 leaf
    and padded last axes; a large gradient at the second step, so that
    the clip acts.  The global norm's sums run in another order (an ulp or
    two), so the clip and all after it may differ by ulps."""
    rng = np.random.default_rng(7)
    shapes = {"b": (300,), "e": (10, 65), "k": (3, 40, 70),
              "w": (64, 300)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    kw = dict(lr=1e-2, warmup_steps=2, state_dtype=state_dtype, q_block=64)
    jo, to = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, tst = jopt.init_state(jp, jo), topt.init_state(tp, to)
    differing = 0
    for step in range(3):
        grads = {k: (rng.standard_normal(s) * (5.0 if step == 1 else 0.3))
                 .astype(np.float32) for k, s in shapes.items()}
        prev = js
        jp, js, jgn = jopt.apply_updates(
            jp, {k: jnp.asarray(v) for k, v in grads.items()}, js, jo)
        tp, tst, tgn = topt.apply_updates(
            tp, {k: torch.from_numpy(v) for k, v in grads.items()}, tst,
            to)
        _ulp_close(tgn.numpy(), jgn, "grad norm")
        assert int(tst.count) == int(js.count) == step + 1
        for k in shapes:
            _ulp_close(tp[k].numpy(), jp[k], f"param {k}")
            if not isinstance(tst.m[k], topt.QTensor):
                assert not isinstance(js.m[k], jopt.QTensor)
                _ulp_close(tst.m[k].numpy(), js.m[k], f"m {k}")
                _ulp_close(tst.v[k].numpy(), js.v[k], f"v {k}")
                continue
            assert isinstance(js.m[k], jopt.QTensor) and len(shapes[k]) >= 2
            for second, (jq, tq) in enumerate(((js.m[k], tst.m[k]),
                                               (js.v[k], tst.v[k]))):
                _ulp_close(tq.scales.numpy(), jq.scales, f"scales {k}")
                pre = _jax_pre_quant((prev.v if second else prev.m)[k],
                                     grads[k], jgn, jo, second)
                differing += _codes_agree(tq, jq, pre, 64)
    n_codes = sum(2 * int(np.prod(s)) for s in shapes.values())
    assert differing <= n_codes * 1e-3, differing


@pytest.mark.parametrize("arch", TP.DENSE_SSM_ARCHS)
def test_train_step_matches_jax(arch):
    """Dense (tied and untied head), Mamba-2 and embedding inputs; the
    MoE, hybrid and cross configs are in ``test_torch_train_kinds.py``."""
    TP.check_family_step(arch)


def test_train_step_int8_states_and_compression_match_jax():
    jm, tm, jl, tl, _ = TP.step_both(
        "spadas_trajlm", {"state_dtype": "int8", "q_block": 64},
        compress=True)
    TP.check_step(jm, tm, jl, tl)
    qkeys = [k for k, v in jl.items() if hasattr(v, "codes")]
    # a stacked norm scale is a matrix in the JAX tree: int8 there
    assert ".opt/.m/blocks/0/ln1/scale" in qkeys
    assert all(hasattr(tl[k], "codes") for k in qkeys)
    assert not hasattr(jl[".opt/.m/final_norm/scale"], "codes")
    errs = [k for k in jl if k.startswith(".err/")]
    assert errs and all(tl[k].shape == jl[k].shape for k in errs)


def test_jax_ranks_follow_the_stacked_tree():
    """Each port parameter's rank in the JAX tree (which decides weight
    decay and int8 states) is the rank of its JAX leaf."""
    for arch in TP.FAMILY_ARCHS:
        jcfg, cfg = TP.cfg_pair(arch)
        shapes = convert.tree_leaves(jax.eval_shape(
            lambda k: M.init_params(k, jcfg), jax.random.PRNGKey(0)))
        ranks = convert.jax_ranks(dict(LanguageModel(
            cfg, device="cpu").named_parameters()))
        assert {convert.jax_key(n)[0] for n in ranks} == set(shapes)
        for name, r in ranks.items():
            assert len(shapes[convert.jax_key(name)[0]].shape) == r, name


def test_microbatched_grads_match_full():
    """The JAX package's bounds: loss within 1e-4, the first parameter
    within 2e-3."""
    _, cfg = TP.cfg_pair("llama3_8b")
    to = TP.opt_pair()[1]
    b = TP.batch(cfg, 4, 32, ignore=False)
    out = []
    for mb in (0, 2):
        st = tts.init_train_state(cfg, to, device="cpu", seed=0)
        st, m = tts.make_train_step(cfg, to, microbatch=mb)(st, b)
        out.append((float(m["loss"]), next(st.params.parameters()).detach()))
    assert abs(out[0][0] - out[1][0]) < 1e-4
    np.testing.assert_allclose(out[0][1].numpy(), out[1][1].numpy(),
                               atol=2e-3)


@pytest.mark.parametrize("arch", ["llama3_8b", "mamba2_780m"])
def test_remat_is_bitwise_on_cpu(arch):
    """Each repeat recomputed in the backward pass (torch.utils.checkpoint)
    gives the same bits as keeping its activations: two steps."""
    _, cfg = TP.cfg_pair(arch)
    to = TP.opt_pair()[1]
    b = TP.batch(cfg, 2, 64)
    runs = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        st = tts.init_train_state(c, to, device="cpu", seed=1)
        step = tts.make_train_step(c, to)
        losses = []
        for _ in range(2):
            st, m = step(st, b)
            losses.append(m["loss"])
        runs.append((torch.stack(losses),
                     [p.detach().clone() for p in st.params.parameters()]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_serving_models_stay_frozen():
    """A serving model records no graph; the trainer's does."""
    _, cfg = TP.cfg_pair("spadas_trajlm")
    model = LanguageModel(cfg, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.long)
    logits, _ = model(toks)
    assert not logits.requires_grad
    st = tts.train_state_for(model, TP.opt_pair()[1])
    logits, _ = st.params(toks)
    assert logits.requires_grad


# ---------------------------------------------------------------------------
# each module's backward, in float32, against jax.grad
# ---------------------------------------------------------------------------


class _W:
    """A JAX parameter dict as the attributes a port layer reads."""

    def __init__(self, p):
        for k, v in p.items():
            setattr(self, k, torch.from_numpy(np.array(v)).requires_grad_())


def _module(kind):
    """(JAX params, port params, JAX fn(p, x, ctx), port fn(w, x, ctx))
    of one module of a reduced config."""
    from repro.models import layers as JL
    from repro.models import moe as JMOE
    from repro.models import ssm as JS
    from repro_torch.models import layers as L
    from repro_torch.models import moe as TMOE
    from repro_torch.models import ssm as TS

    key = jax.random.PRNGKey(2)
    if kind == "mamba":
        jcfg, cfg = TP.cfg_pair("jamba_v0_1_52b")
        return (JS.mamba_init(key, jcfg),
                lambda p, x, c: JS.mamba_block(p, x, jcfg)[0],
                lambda w, x, c: TS.mamba_block(w, x, cfg)[0])
    if kind == "moe":      # configured routing: top-2 of 4, capacity 1.25
        jcfg, cfg = TP.cfg_pair("grok_1_314b")

        def jm(p, x, c):
            y, aux = JMOE.moe(p, x, jcfg)
            return y + aux

        def tm(w, x, c):
            y, aux = TMOE.moe(w, x, cfg)
            return y + aux
        return JMOE.moe_init(key, jcfg), jm, tm
    jcfg, cfg = TP.cfg_pair("llama3_2_vision_11b")
    if kind == "mlp":
        return (JL.mlp_init(key, jcfg.d_model, jcfg.d_ff, jcfg.n_layers),
                lambda p, x, c: JL.mlp(p, x), lambda w, x, c: L.mlp(w, x))
    p = JL.attn_init(key, jcfg)
    if kind == "cross":
        return (p, lambda p, x, c: JL.cross_attention_block(p, x, c, jcfg),
                lambda w, x, c: L.cross_attention_block(w, x, c, cfg))
    pos = np.arange(64)[None]
    return (p, lambda p, x, c: JL.self_attention_block(
        p, x, jcfg, positions=jnp.asarray(pos))[0],
        lambda w, x, c: L.self_attention_block(
            w, x, cfg, positions=torch.from_numpy(pos))[0])


@pytest.mark.parametrize("kind", ["attn", "cross", "mlp", "moe", "mamba"])
def test_module_backward_matches_jax_grad(kind):
    """The gradient of <module(x), ct> with respect to every parameter and
    to x, on float32 activations (the modules then compute in float32
    throughout), against ``jax.grad`` of the JAX module: within 1e-4 of
    each gradient's norm (the sums run in another order; 9.4e-6 seen, on
    the SSD's A_log)."""
    p, jf, tf = _module(kind)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64, 128)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, 128)).astype(np.float32)
    ct = rng.standard_normal((2, 64, 128)).astype(np.float32)
    jg, jgx = jax.jit(jax.grad(
        lambda p, x: jnp.sum(jf(p, x, jnp.asarray(ctx)) * ct),
        argnums=(0, 1)))(p, jnp.asarray(x))
    w = _W(p)
    xt = torch.from_numpy(x).requires_grad_()
    (tf(w, xt, torch.from_numpy(ctx)) * torch.from_numpy(ct)).sum().backward()
    pairs = [(np.asarray(jgx), xt.grad)] + [
        (np.asarray(jg[k]), getattr(w, k).grad) for k in p]
    for want, got in pairs:
        assert got is not None and torch.isfinite(got).all()
        gap = np.linalg.norm(got.numpy() - want)
        assert gap <= 1e-4 * np.linalg.norm(want), gap

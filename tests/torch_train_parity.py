"""Shared set-up of the training parity tests: one reduced config's train
state in both packages with the same values (the JAX state carried into
the port by ``convert.train_state_from_jax``), batches made with numpy,
the comparison of two states leaf by leaf under the JAX checkpoint keys,
and one train step of a family held to the JAX step.

The step's bounds, and why.  Both packages round bf16 products of float32
sums taken in another order, so losses agree to 2e-3 (2.5x the largest
gap seen, 7.9e-4 on jamba), the grad norms to 2 % (jamba: 1.0 %), the aux
losses to 1e-5 relative.  Adam normalises each gradient element, so a
parameter moves by about ``lr`` whatever its gradient's size, and a
gradient near zero may take either sign in the two packages: every
parameter is held within 2 lr (plus 1e-3 of it) of the JAX one, and few
elements may differ by more than 0.1 lr: 1.5 % (0.59 % seen at most).
The first moments (0.1 g after one step) are held, over the whole tree,
to 5 % of their norm (1.9 % seen at most).  Jamba's hybrid stack of 8
bf16 layers carries the rounding differences further (XLA's own jitted
and eager jamba forwards differ by 0.056 on the reduced config), so
there the bounds are 6 % of elements past 0.1 lr (2.45 % seen) and 20 %
on the moments (8.2 % seen).  The backward of each module, in float32,
agrees with ``jax.grad`` to 1e-4 (``test_torch_train.py``), which is
where a wrong gradient would show.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.models import convert
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from torch_lm_parity import XGATE, cfg_pair

#: every family of the LM: dense (tied and untied head), MoE, Arctic's
#: dense + MoE, Mamba-2, the hybrid, cross-attention, embedding inputs
FAMILY_ARCHS = ("spadas_trajlm", "llama3_8b", "grok_1_314b", "arctic_480b",
                "mamba2_780m", "jamba_v0_1_52b", "llama3_2_vision_11b",
                "musicgen_medium")
DENSE_SSM_ARCHS = ("spadas_trajlm", "llama3_8b", "mamba2_780m",
                   "musicgen_medium")
KIND_ARCHS = ("grok_1_314b", "arctic_480b", "jamba_v0_1_52b",
              "llama3_2_vision_11b")
LR = 1e-3
LOSS_ATOL = 2e-3
GNORM_RTOL = 0.02
#: the step's parameter bound in units of lr, and the share of elements
#: allowed past 0.1 lr
PARAM_LR_BOUND = 2.0 * (1 + 1e-3)
#: (the share of elements past 0.1 lr, the moments' relative gap) allowed
STEP_BOUNDS = {"jamba_v0_1_52b": (0.06, 0.2)}
DEFAULT_STEP_BOUNDS = (0.015, 0.05)


def opt_pair(**kw):
    """(JAX, port) OptConfig alike; warm-up 1 so that step 1 runs at
    ``LR``."""
    kw = {"lr": LR, "warmup_steps": 1, **kw}
    return jopt.OptConfig(**kw), topt.OptConfig(**kw)


def states(arch, opt_kw=None, *, compress=False, seed=3):
    """(JAX config, port config, JAX opt config, port opt config, JAX
    TrainState, port TrainState with the same values on the CPU)."""
    jcfg, cfg = cfg_pair(arch, smooth=True)
    jo, to = opt_pair(**(opt_kw or {}))
    js = _jax_init(jcfg, jo, compress)(jax.random.PRNGKey(seed))
    blocks = tuple(dict(b, xgate=jnp.full_like(b["xgate"], XGATE))
                   if "xgate" in b else b for b in js.params["blocks"])
    js = js._replace(params=dict(js.params, blocks=blocks))
    like = tts.init_train_state(cfg, to, device="cpu", compress=compress)
    return jcfg, cfg, jo, to, js, convert.train_state_from_jax(
        jax.tree.map(np.asarray, js), like)


@functools.lru_cache(maxsize=None)
def _jax_init(jcfg, jo, compress):
    return jax.jit(lambda k: jts.init_train_state(k, jcfg, jo,
                                                  compress=compress))


def batch(cfg, B, S, seed=5, ignore=True):
    """A numpy batch in the JAX layout; with ``ignore``, a few labels of
    the first row are ignored (-1)."""
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if ignore:
        b["labels"][0, :5] = -1
    if cfg.embed_input:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    else:
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model), np.float32)
    if cfg.vision_tokens:
        b["image_embeds"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model), np.float32)
    return b


@functools.lru_cache(maxsize=None)
def jax_step(jcfg, jo, compress=False, microbatch=0):
    return jax.jit(jts.make_train_step(jcfg, jo, compress=compress,
                                       microbatch=microbatch))


def jax_leaves(js) -> dict:
    """A JAX TrainState's leaves (numpy) under the checkpoint keys."""
    return convert.tree_leaves(jax.tree.map(np.asarray, js))


def port_leaves(ts_) -> dict:
    """A port TrainState's leaves (numpy copies, or QTensors of them)
    under the same keys."""
    out = {}
    for k, v in convert.state_leaves(ts_).items():
        out[k] = (type(v)(v.codes.numpy().copy(), v.scales.numpy().copy(),
                          v.shape)
                  if hasattr(v, "codes") else v.detach().numpy().copy())
    return out


def param_update_gap(jl: dict, tl: dict, lr: float):
    """Parameters after one step, port against JAX, in units of ``lr``:
    (the largest gap, the share of elements whose gap exceeds 0.1 lr)."""
    worst, over, n = 0.0, 0, 0
    for k, a in jl.items():
        if not k.startswith(".params/"):
            continue
        gap = np.abs(np.asarray(a, np.float64) - tl[k]) / lr
        worst = max(worst, float(gap.max()))
        over += int((gap > 0.1).sum())
        n += gap.size
    return worst, over / n


def step_both(arch, opt_kw=None, compress=False, B=2, S=64):
    """One step of both packages from the same state on the same batch:
    (JAX metrics, port metrics, JAX leaves, port leaves, port state)."""
    jcfg, cfg, jo, to, js, st = states(arch, opt_kw, compress=compress)
    b = batch(cfg, B, S)
    js2, jm = jax_step(jcfg, jo, compress)(js, jax.tree.map(jnp.asarray, b))
    st2, tm = tts.make_train_step(cfg, to, compress=compress)(st, b)
    return jm, tm, jax_leaves(js2), port_leaves(st2), st2


def check_step(jm, tm, jl, tl, arch=None):
    over_share, m_rel = STEP_BOUNDS.get(arch, DEFAULT_STEP_BOUNDS)
    for k in ("loss", "ce"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_ATOL, k
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=GNORM_RTOL)
    worst, over = param_update_gap(jl, tl, LR)
    assert worst <= PARAM_LR_BOUND and over <= over_share, (worst, over)
    assert int(tl[".step"]) == int(jl[".step"]) == 1
    assert int(tl[".opt/.count"]) == int(jl[".opt/.count"]) == 1
    num = den = 0.0
    for k, a in jl.items():
        if k.startswith(".opt/.m/") and not hasattr(a, "codes"):
            a = np.asarray(a, np.float64)
            num += float(((tl[k] - a) ** 2).sum())
            den += float((a ** 2).sum())
    assert num <= (m_rel ** 2) * den, (num / den) ** 0.5


def check_family_step(arch):
    """One step of ``arch``'s reduced config, float32 states, within the
    bounds above; every parameter finite after it (the SSD's masked
    segment sums exponentiate -inf, and their backward must give no
    NaN)."""
    jm, tm, jl, tl, st = step_both(arch)
    check_step(jm, tm, jl, tl, arch)
    assert all(torch.isfinite(p).all() for p in st.params.parameters())

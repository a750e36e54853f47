"""``repro_torch.launch.serve.generate`` against a JAX loop of
``repro.models.model.prefill`` and ``decode_step`` on the same weights and
prompts, on the CPU.

The prompts are trajectories tokenized as the smoke tokenizes them
(``repro_torch.data.tokens.tokenize_trajectory``, at theta 5 for the
reduced ``spadas_trajlm``'s 4**5 + 64 vocabulary), cut to 24 tokens.  The
JAX loop is fed the port's greedy tokens, so both packages see the same
inputs at every step.  Logits agree within ``LOGIT_ATOL`` (0.03, the bound
of ``tests/test_torch_models.py``; 0.009 is the largest difference seen).
Each greedy token equals the JAX package's argmax wherever the JAX logits'
top-2 margin exceeds that tolerance; at a step with a closer margin (random
weights give flat logits: 12 and 10 of the 48 steps with the bf16 and int8
caches) the two may pick either candidate, so there the test compares the
logits, and it prints how many such steps it met.  On the test seed the
greedy tokens are equal at every step all the same, and equal to the JAX
package's own free-running greedy loop; the test holds that too.

The six new families' reduced configs (the MoE ones on their ``smooth``
copies, ``tests/torch_lm_parity.py``) run ``generate`` on requests drawn
by ``serve.request_inputs`` against the same JAX loop, logits compared;
the CLI serves every ``--arch``.
"""
import dataclasses
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parity as P
from repro import configs as jconfigs
from repro.models import model as M
from repro_torch import configs
from repro_torch.data import synthetic
from repro_torch.data.tokens import tokenize_trajectory
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import LanguageModel

LOGIT_ATOL = 0.03
PROMPT, GEN, B = 24, 12, 4

one_torch_thread = P.one_torch_thread


@pytest.fixture(scope="module")
def env():
    jcfg = jconfigs.get_reduced("spadas_trajlm")
    cfg = configs.get_reduced("spadas_trajlm")
    params = M.init_params(jax.random.PRNGKey(5), jcfg)
    model = LanguageModel(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          cfg))
    trajs = synthetic.trajectory_repository(16, seed=4, n_points=(200, 400))
    lo = np.min([t.min(0) for t in trajs], axis=0)
    hi = np.max([t.max(0) for t in trajs], axis=0)
    docs = [tokenize_trajectory(t, lo, hi, 5) for t in trajs]
    prompts = np.stack([d[:PROMPT] for d in docs if len(d) >= PROMPT][:B])
    assert prompts.shape == (B, PROMPT) and prompts.max() < cfg.vocab_size
    return jcfg, params, model, prompts


def _jax_steps(jcfg, params, prompts, feed):
    """JAX logits (GEN, B, V): the prefill's last position, then a decode
    step on each token of ``feed`` (B, GEN - 1)."""
    lg, caches, cur = M.prefill(params, jcfg, {"tokens": jnp.asarray(prompts)},
                                max_len=PROMPT + GEN)
    out = [np.asarray(lg[:, -1])]
    for i in range(GEN - 1):
        lg, caches = M.decode_step(params, jcfg,
                                   jnp.asarray(feed[:, i:i + 1], jnp.int32),
                                   caches, jnp.int32(cur + i))
        out.append(np.asarray(lg[:, -1]))
    return np.stack(out)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_generate_matches_jax_loop(env, kv):
    jcfg, params, model, prompts = env
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv)
    out = serve.generate(model, prompts, GEN, kv_cache_dtype=kv)
    toks, logits = out.tokens.numpy(), out.logits.numpy()
    assert toks.shape == (B, GEN) and logits.shape == (GEN, B, 1088)
    np.testing.assert_array_equal(toks, logits.argmax(-1).T)
    want = _jax_steps(jcfg, params, prompts, toks)
    np.testing.assert_allclose(logits, want, atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > LOGIT_ATOL
    np.testing.assert_array_equal(toks.T[clear], want.argmax(-1)[clear])
    differ = toks.T != want.argmax(-1)
    print(f"{kv}: {int((~clear).sum())} of {clear.size} steps have a top-2 "
          f"margin within {LOGIT_ATOL}, where the logits are compared and "
          f"not the tokens; the greedy tokens differ at {int(differ.sum())}; "
          f"max logit difference {np.abs(logits - want).max():.3g}")
    assert not differ.any(), "greedy tokens differ on the test seed"
    # so the tokens are the JAX package's own greedy loop's: that loop
    # feeds step i + 1 the argmax of step i, which is the token the JAX
    # loop above was fed there (``toks``), so it makes the same calls on
    # the same inputs and its tokens are ``want``'s argmaxes
    np.testing.assert_array_equal(toks, want.argmax(-1).T)


def test_serve_main_on_the_cpu(capsys):
    seqs = serve.main(["--device", "cpu", "--requests", "2",
                       "--prompt-len", "16", "--gen", "6"])
    assert seqs.shape == (2, 6)
    out = capsys.readouterr().out
    assert "[serve] spadas-trajlm on cpu: 2 requests" in out


def test_serve_points_example_on_the_cpu(capsys):
    """``examples/serve_points_torch.py``: the search server answers the
    mixed batch (equal to ``engine.search``) while the LM decodes."""
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "serve_points_torch.py"
    runpy.run_path(str(path))["main"](["--device", "cpu", "--gen", "4"])
    out = capsys.readouterr().out
    assert "[retrieval] served the same 17 specs" in out
    assert "[generation] spadas-trajlm: 8 prompts of 32" in out


@pytest.fixture(scope="module", params=P.NEW_ARCHS)
def kind_env(request):
    """A reduced config of each new family with the JAX package's weights
    (MoE configs on their ``smooth`` copies, tests/torch_lm_parity.py), and
    its requests drawn by ``serve.request_inputs``."""
    arch = request.param
    params, model = P.load(arch, smooth=True)
    inputs = serve.request_inputs(model.cfg, P.B, P.PROMPT, 6, seed=7)
    return arch, params, model, inputs


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_generate_every_kind_matches_jax_loop(kind_env, kv):
    """``generate`` with the context and, for embedding inputs, the
    per-step embeddings, against a JAX prefill/decode loop fed the port's
    greedy tokens (or the same step embeddings): each step's logits within
    the end-to-end bounds of ``tests/test_torch_models.py`` (0.03; 0.12
    on the 8-layer hybrid, whose jitted reference is noisier), and the
    tokens are the argmax of the logits."""
    arch, params, model, (prompts, ctx, step_embeds) = kind_env
    gen = 6
    jcfg, _ = P.cfg_pair(arch, kv, smooth=True)
    out = serve.generate(model, prompts, gen, kv, ctx=ctx,
                         step_embeds=step_embeds)
    toks, logits = out.tokens.numpy(), out.logits.numpy()
    V = model.cfg.vocab_size
    assert toks.shape == (P.B, gen) and logits.shape == (gen, P.B, V)
    np.testing.assert_array_equal(toks, logits.argmax(-1).T)
    lg, caches, cur = P.jax_prefill(jcfg, P.PROMPT + gen)(
        params, P.jbatch(model.cfg, prompts, ctx))
    want = [np.asarray(lg[:, -1])]
    step = P.jax_decode(jcfg)
    for i in range(gen - 1):
        x = (toks[:, i:i + 1].astype(np.int32) if model.cfg.embed_input
             else step_embeds[:, i:i + 1])
        lg, caches = step(params, jnp.asarray(x), caches,
                          jnp.int32(int(cur) + i), P.jctx(ctx))
        want.append(np.asarray(lg[:, -1]))
    atol = 0.12 if arch == "jamba_v0_1_52b" else LOGIT_ATOL
    np.testing.assert_allclose(logits, np.stack(want), atol=atol, rtol=0)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_serve_main_serves_every_arch(arch, capsys):
    """The CLI serves every config on the CPU, reduced (a prompt of one
    SSM chunk)."""
    seqs = serve.main(["--device", "cpu", "--arch", arch, "--requests", "2",
                       "--prompt-len", "32", "--gen", "3"])
    assert seqs.shape == (2, 3)
    name = configs.get_reduced(arch).name
    assert f"[serve] {name} on cpu: 2 requests" in capsys.readouterr().out


def test_generate_on_the_default_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "1", "--gen", "2"])

"""Tensor-parallel compute on the model axis (the pieces of
``repro_torch.models.layers``: ``self_attention_tp``, ``mlp_tp``,
``embed_tp``, ``unembed_tp`` and ``vocab_parallel_logp``;
``LanguageModel.forward(tp=...)``; the mesh train step of a config whose
blocks are all ``attn``) on the CPU, meshes of ``["cpu"] * N``.

* Each piece against its whole counterpart on one device, on (1, 2) and
  (1, 4), forward and gradient, the blocks being the ones the mesh step
  computes on (``MeshParams.coord_model``).  Attention and the MLP take
  bf16 activations and round each coordinate's partial product to bf16
  before the float32 sum over the axis, where the whole product rounds
  once; their outputs and gradients are held within ``TP_TOL`` (2 %) of
  the largest magnitude of the value compared, about five bf16 ulps
  (the largest gap seen is 0.98 %, x's gradient over 8 coordinates).
  The vocabulary-parallel logits and log-softmax are float32: within
  ``CE_TOL``; the gradients of x and of the table pass the head's bf16
  casts (``TP_TOL``).  The split embedding's lookup is bitwise the whole
  table's (each row plus zeros).
* One step of each of the six dense configs, reduced, on (1, 2) against
  the one-device step: ``loss`` and ``ce`` within ``STEP_RTOL``,
  ``grad_norm`` within ``NORM_RTOL`` (both relative).
* Each coordinate computes the replicated activations on its own copy,
  and the row projections' partials are all-reduced: every coordinate's
  output is bitwise coordinate 0's.
* Pieces the model axis does not divide are computed whole on every
  coordinate: on (1, 3) no piece of the reduced spadas_trajlm divides,
  and the step is bitwise the one-device step; on (1, 8) its 4 heads do
  not divide, so q's column blocks are all-gathered and each coordinate
  runs the whole attention.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_train_parity as TP
from repro_torch import configs
from repro_torch.core import distributed as dist
from repro_torch.launch import sharding as sh
from repro_torch.models import layers as L
from repro_torch.models.model import LanguageModel
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from torch_lm_parity import one_torch_thread  # noqa: F401

TP_TOL = 2e-2
CE_TOL = 2e-6
STEP_RTOL = 2e-4
NORM_RTOL = 1e-2
DENSE = ["spadas_trajlm", "llama3_8b", "yi_9b", "internlm2_20b",
         "deepseek_coder_33b", "musicgen_medium"]
OPT = {"lr": 1e-3, "warmup_steps": 5}


def _mesh(M, D=1):
    return dist.grid_mesh((D, M), ("data", "model"), ["cpu"] * (D * M),
                          "test")


def _models(arch, M, seed=0):
    """(the whole model, gradients on; each model coordinate's work model
    of a (1, M) mesh holding the same weights; their ModelAxis)."""
    cfg = configs.get_reduced(arch)
    whole = LanguageModel(cfg, device="cpu", seed=seed)
    whole.requires_grad_(True)
    shard = sh.param_shardings(dict(whole.named_parameters()), _mesh(M))
    mp = tts.MeshParams(LanguageModel(cfg, device="cpu", seed=seed), shard)
    coords = [mp.coord_model(i) for i in range(M)]
    return cfg, whole, coords, L.ModelAxis(coords)


def _close(got, want, tol, what):
    got, want = got.detach().float(), want.detach().float()
    gap = float((got - want).abs().max())
    scale = float(want.abs().max())
    assert gap <= tol * scale, f"{what}: gap {gap:.3g} of {scale:.3g}"


def _rand(shape, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal(shape), dtype=dtype)


def _check_blocks(whole_mod, coord_mods, names, dims, tol, what):
    """Each coordinate's gradient block of each weight against the slice
    of the whole weight's gradient it covers."""
    for name, dim in zip(names, dims):
        full = getattr(whole_mod, name).grad
        parts = [getattr(m, name).grad for m in coord_mods]
        if parts[0].shape == full.shape:            # not split: the lead's
            _close(parts[0], full, tol, f"{what}.{name}")
            continue
        _close(torch.cat(parts, dim=dim), full, tol, f"{what}.{name}")


def _same_everywhere(ys):
    """Every coordinate's output bitwise coordinate 0's."""
    for y in ys[1:]:
        assert torch.equal(y, ys[0])


class _Gathers(L.ModelAxis):
    """A model axis that books each all-gather as (blocks, bytes of
    one)."""

    def __init__(self, models):
        super().__init__(models)
        self.blocks = []

    def all_gather(self, ys, dim=-1):
        self.blocks.append((len(ys), ys[0].numel() * ys[0].element_size()))
        return super().all_gather(ys, dim)


@pytest.mark.parametrize("M", [2, 4])
def test_attention_pieces_match_whole(M):
    """GQA of the reduced llama3_8b (4 q heads, 2 kv heads): heads split
    over M, each coordinate reading the kv heads its q heads use."""
    cfg, whole, coords, ax = _models("llama3_8b", M)
    assert (cfg.n_heads, cfg.n_kv_heads) == (4, 2)
    pos = torch.arange(32)[None]
    x = _rand((2, 32, cfg.d_model), 0)
    w = _rand((2, 32, cfg.d_model), 1, torch.float32)
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    ya = L.self_attention_block(whole.blocks[0][0].attn, xa, cfg,
                                positions=pos)[0]
    yb = L.self_attention_tp([c.blocks[0][0].attn for c in coords],
                             [xb] * M, cfg, pos, ax)
    _same_everywhere(yb)
    _close(yb[0], ya, TP_TOL, "attention")
    (ya.float() * w).sum().backward()
    (yb[0].float() * w).sum().backward()
    _close(xb.grad, xa.grad, TP_TOL, "attention dx")
    _check_blocks(whole.blocks[0][0].attn, [c.blocks[0][0].attn
                                            for c in coords],
                  ("wq", "wk", "wv", "wo"), (1, 1, 1, 0), TP_TOL,
                  "attention")


@pytest.mark.parametrize("M", [2, 4])
def test_mlp_pieces_match_whole(M):
    cfg, whole, coords, ax = _models("llama3_8b", M)
    x = _rand((2, 32, cfg.d_model), 2)
    w = _rand((2, 32, cfg.d_model), 3, torch.float32)
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    ya = L.mlp(whole.blocks[1][0].mlp, xa)
    yb = L.mlp_tp([c.blocks[1][0].mlp for c in coords], [xb] * M, cfg.d_ff,
                  ax)
    _same_everywhere(yb)
    _close(yb[0], ya, TP_TOL, "mlp")
    (ya.float() * w).sum().backward()
    (yb[0].float() * w).sum().backward()
    _close(xb.grad, xa.grad, TP_TOL, "mlp dx")
    _check_blocks(whole.blocks[1][0].mlp, [c.blocks[1][0].mlp
                                           for c in coords],
                  ("wg", "wu", "wd"), (1, 1, 0), TP_TOL, "mlp")


@pytest.mark.parametrize("M", [2, 4])
def test_vocab_parallel_ce_matches_whole(M):
    """The head's logits split over the vocabulary and the log-softmax
    at the labels from the blocks (-1 labels included) against the whole
    logits' ``log_softmax``; the gradients of x and of the table."""
    cfg, whole, coords, ax = _models("llama3_8b", M)
    x = _rand((2, 32, cfg.d_model), 4)
    lab = torch.tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 32)))
    lab[0, :5] = -1
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    logits = L.unembed(whole.embed, xa)
    logp = torch.log_softmax(logits, -1)
    want = torch.gather(logp, -1, lab.clamp(0)[..., None])[..., 0]
    blocks = L.unembed_tp([c.embed for c in coords], [xb] * M,
                          cfg.vocab_size, ax)
    assert isinstance(blocks, L.VocabBlocks) and len(blocks.parts) == M
    _close(torch.cat(blocks.parts, -1), logits, CE_TOL, "logits")
    got = L.vocab_parallel_logp(blocks, lab)
    mask = (lab != -1).float()
    _close(got * mask, want * mask, CE_TOL, "log-softmax at the labels")
    (-(want * mask).sum()).backward()
    (-(got * mask).sum()).backward()
    _close(xb.grad, xa.grad, TP_TOL, "CE dx (bf16)")
    _check_blocks(whole.embed, [c.embed for c in coords], ("table",), (0,),
                  TP_TOL, "CE (bf16 table cast)")


@pytest.mark.parametrize("M", [2, 4])
def test_split_embedding_is_bitwise(M):
    cfg, whole, coords, ax = _models("llama3_8b", M)
    tok = torch.tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 32)))
    want = L.embed(whole.embed, tok)
    got = L.embed_tp([c.embed for c in coords], tok, cfg.vocab_size, ax)
    assert len(got) == M
    for g in got:
        assert g.dtype == want.dtype and torch.equal(g, want)


@pytest.mark.parametrize("arch", DENSE)
def test_tp_step_of_each_dense_config(arch):
    """One mesh step on (1, 2), computing on the model axis, against the
    one-device step from the same weights and batch."""
    cfg = configs.get_reduced(arch)
    oc = topt.OptConfig(**OPT)
    mesh = _mesh(2)
    assert tts.computes_on_model_axis(cfg, mesh)
    one = tts.init_train_state(cfg, oc, device="cpu")
    ms = tts.init_train_state(cfg, oc, device="cpu")
    shard = sh.param_shardings(dict(ms.params.named_parameters()), mesh)
    ms = tts.shard_state(ms, shard)
    b = TP.batch(cfg, 2, 32)
    one, m1 = tts.make_train_step(cfg, oc)(one, b)
    ms, m2 = tts.make_train_step(cfg, oc, param_shardings=shard)(ms, b)
    for k in ("loss", "ce"):
        assert abs(float(m2[k]) / float(m1[k]) - 1) <= STEP_RTOL, k
    assert abs(float(m2["grad_norm"]) / float(m1["grad_norm"]) - 1) \
        <= NORM_RTOL
    assert float(m2["aux"]) == 0.0


def test_undivided_pieces_are_computed_whole():
    """(1, 3): no dim of the reduced spadas_trajlm divides 3, so every
    piece is whole on every coordinate and the step is bitwise the
    one-device step.  (1, 8): d_ff, the vocabulary and the projections'
    columns divide, the 4 heads do not: q's blocks are all-gathered with
    k's and v's and each coordinate runs the attention whole, its output
    split by wo's rows."""
    cfg = configs.get_reduced("spadas_trajlm")
    oc = topt.OptConfig(**OPT)
    one = tts.init_train_state(cfg, oc, device="cpu")
    ms = tts.init_train_state(cfg, oc, device="cpu")
    shard = sh.param_shardings(dict(ms.params.named_parameters()), _mesh(3))
    assert all("model" not in s.spec for s in shard.values())
    ms = tts.shard_state(ms, shard)
    b = TP.batch(cfg, 2, 32)
    one, m1 = tts.make_train_step(cfg, oc)(one, b)
    ms, m2 = tts.make_train_step(cfg, oc, param_shardings=shard)(ms, b)
    assert all(float(m1[k]) == float(m2[k]) for k in m1)
    for k, v in TP.port_leaves(one).items():
        assert np.asarray(TP.port_leaves(ms)[k]).tobytes() == \
            np.asarray(v).tobytes(), k

    cfg8, whole, coords, _ = _models("spadas_trajlm", 8)
    assert cfg8.n_heads % 8 and coords[0].blocks[0][0].attn.wq.shape[1] == \
        cfg8.n_heads * cfg8.resolved_head_dim // 8
    ax = _Gathers(coords)
    tok = torch.tensor(b["tokens"], dtype=torch.long)
    with torch.no_grad():
        want = whole(tok)[0]
        got = coords[0](tok, tp=ax)[0]
    _close(torch.cat(got.parts, -1), want, TP_TOL, "logits on (1, 8)")
    # per layer: q's, k's and v's column blocks, 8 of 2 x 32 x 4 bf16
    q_cols = 2 * 32 * cfg8.n_heads * cfg8.resolved_head_dim // 8 * 2
    assert ax.blocks == [(8, q_cols)] * 3 * cfg8.n_layers


def test_tp_config_kinds():
    """Only configs whose blocks are all ``attn`` compute on the model
    axis; a model axis of 1 never does."""
    for arch in configs.ARCH_IDS:
        cfg = configs.get(arch)
        assert tts.computes_on_model_axis(cfg, _mesh(2)) == (arch in DENSE)
        assert not tts.computes_on_model_axis(cfg, _mesh(1, 2))
    assert not tts.computes_on_model_axis(
        dataclasses.replace(configs.get_reduced("llama3_8b"), n_layers=4,
                            block_pattern=("attn", "cross")), _mesh(2))

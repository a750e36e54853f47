"""The port's dry run (``repro_torch.launch.dryrun``) and roofline
(``repro_torch.launch.roofline``) against the JAX package's and against
closed forms.

* Argument bytes: five reduced cells at the ``--test`` shapes (yi_9b
  train_4k and decode_32k, mamba2_780m prefill_32k and long_500k,
  arctic_480b train_4k as it is and under ``{"expert": "model"}``) on a
  (4, 2) mesh: the port's per-device argument bytes equal the JAX
  ``memory_analysis().argument_size_in_bytes`` of the same cell, lowered
  in one ``conftest.run_py`` subprocess with 8 forced host devices on an
  Auto-axes mesh (the Explicit-axes ``make_test_mesh`` does not lower
  under jax 0.9.0).  One named leaf differs: JAX passes decode's
  ``cache_len`` as an int32 array (4 bytes, dropped by ``jit`` where a
  config has no attention to read it), the port as a Python int.
* FLOPs: ``flops_per_device`` equals an op-by-op closed form of the
  port's products (the block matrices, the head, the attention's whole
  masked square forward and backward) on reduced dense cells (train on
  (4, 2): one data group's rows over the model axis, every piece halved;
  prefill and decode on one device) and on the full spadas_trajlm train
  step at 8 x 256 with remat off.  Against the storage-only placement
  (the whole group's pass at its lead, the whole params in its work
  model), computing on the model axis cuts ``flops_per_device`` and
  ``work_bytes`` by the closed form of the split pieces, on (4, 2) and on
  (1, 8), where the 4 heads do not divide and the attention's square
  stays whole at the lead.
* Collectives on (4, 2) equal a closed form from the specs (each model
  coordinate's gather of its model blocks, group 0's gradient blocks
  joined and its replicated leaves' copies summed at the lead, the
  gradient sum at the lead and each coordinate's block of it) and of
  the pass over the model axis (the partial products and the CE's
  statistics all-reduced, k's and v's blocks all-gathered, each with its
  gradient's collective), and are 0 on a 1 x 1 mesh.
* ``roofline.analyze`` given the TPU v5e terms reproduces
  ``benchmarks/roofline.analyze`` on the same record.
* The CLI: ``python -m repro_torch.launch.dryrun --arch yi_9b --shape
  train_4k --mesh multi --test`` writes ``status: ok`` with FLOPs and
  collective bytes; ``roofline`` prints its table; a cell whose plan
  raises is written as ``status: error`` and the CLI exits 1.
"""
import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import run_py
from repro_torch import configs
from repro_torch.core import distributed as dist
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.launch import sharding as sh
from torch_lm_parity import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TEST_SHAPES = dryrun.test_shapes(specs.SHAPES)
CELLS = [("yi_9b", "train_4k", None), ("yi_9b", "decode_32k", None),
         ("mamba2_780m", "prefill_32k", None),
         ("mamba2_780m", "long_500k", None),
         ("arctic_480b", "train_4k", None),
         ("arctic_480b", "train_4k", {"expert": "model"})]
#: the JAX figures under jax 0.9.0 (argument bytes a device)
JAX_0_9_ARGS = {("yi_9b", "train_4k"): 879_112,
                ("yi_9b", "decode_32k"): 1_543_692,
                ("mamba2_780m", "prefill_32k"): 989_312,
                ("mamba2_780m", "long_500k"): 1_057_672,
                ("arctic_480b", "train_4k"): 2_356_744}

_JAX = """
import json
import jax
from jax.sharding import AxisType
from repro import configs
from repro.launch import specs

CELLS = %(cells)r
shapes = dict(specs.SHAPES)
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = []
for arch, shape, over in CELLS:
    kind, B, S = shapes[shape]
    specs.SHAPES = {**shapes, shape: (kind, max(8, B // 32), min(S, 512))}
    plan = specs.make_plan(configs.get_reduced(arch), shape, mesh,
                           rules_override=over)
    with mesh:
        c = jax.jit(plan.step_fn, in_shardings=plan.in_shardings,
                    donate_argnums=plan.donate_argnums
                    ).lower(*plan.abstract_args).compile()
    out.append(int(c.memory_analysis().argument_size_in_bytes))
print(json.dumps(out))
"""


def _mesh(shape=(4, 2), devices="meta"):
    names = ("data", "model")[:len(shape)]
    return dist.grid_mesh(shape, names, [devices] * math.prod(shape),
                          "test")


def _plan(arch, shape, mesh, over=None, **kw):
    return specs.make_plan(configs.get_reduced(arch), shape, mesh,
                           rules_override=over, shapes=TEST_SHAPES, **kw)


@pytest.fixture(scope="module")
def jax_args():
    return json.loads(run_py(_JAX % {"cells": CELLS}, devices=8).strip()
                      .splitlines()[-1])


def test_argument_bytes_equal_jax(jax_args):
    for (arch, shape, over), want in zip(CELLS, jax_args):
        per, _ = dryrun.argument_bytes(_plan(arch, shape, _mesh(), over))
        cfg = configs.get_reduced(arch)
        named = 4 if (shape.startswith(("decode", "long"))
                      and cfg.has_attention) else 0   # cache_len
        assert max(per) + named == want, (arch, shape, over, max(per), want)
        fig = JAX_0_9_ARGS.get((arch, shape))
        if fig is not None:
            assert max(per) + named == fig


# ---------------------------------------------------------------------------
# FLOPs against closed forms
# ---------------------------------------------------------------------------


def _padded(n, chunk):
    c = min(chunk, n)
    return -(-n // c) * c


def dense_flops(cfg, kind, B, S):
    """The products of a dense attention config's step as the port
    computes them: each block matrix and the head 2 FLOPs a token and
    weight forward (train: 6 with the backward's two products); the
    attention's q k^T and p v over the whole (padded) square, 2 B H Sq Skv
    hd each forward (train: 3x)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KH, L = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    mats = L * (2 * d * H * hd + 2 * d * KH * hd + 3 * d * cfg.d_ff)
    head = cfg.vocab_size * d
    if kind == "train":
        sq = _padded(S, cfg.attn_q_chunk)
        skv = _padded(S, cfg.attn_kv_chunk)
        return 6 * B * S * (mats + head) + 12 * L * B * H * hd * sq * skv
    if kind == "prefill":
        sq = _padded(S, cfg.attn_q_chunk)
        skv = _padded(S, cfg.attn_kv_chunk)
        return 2 * B * S * mats + 2 * B * head + 4 * L * B * H * hd * sq * skv
    return 2 * B * (mats + head) + 4 * L * B * H * hd * S


@pytest.fixture(scope="module")
def yi_train():
    """The reduced yi_9b train_4k record on (4, 2)."""
    _, B, S = TEST_SHAPES["train_4k"]
    return dryrun.record(_plan("yi_9b", "train_4k", _mesh()),
                         configs.get_reduced("yi_9b"), "yi_9b", "train_4k",
                         "single", B, S)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_flops_match_closed_form_reduced(shape, yi_train):
    cfg = configs.get_reduced("yi_9b")
    kind, B, S = TEST_SHAPES[shape]
    if kind == "train":                  # (4, 2): four groups of 2 rows
        rec = yi_train                   # over the model axis: halves
        assert rec["compute"]["groups"] == 4
        assert rec["compute"]["model_axis"] == 2
        assert rec["flops_per_device"] == dense_flops(cfg, kind, B // 4,
                                                      S) // 2
        assert rec["flops_total"] == dense_flops(cfg, kind, B, S)
    else:                                # one device
        rec = dryrun.record(_plan("yi_9b", shape, _mesh((1, 1))), cfg,
                            "yi_9b", shape, "single", B, S)
        assert rec["flops_per_device"] == dense_flops(cfg, kind, B, S)


def test_phase19_cell_flops():
    """The smoke's phase-19 cell: the full spadas_trajlm, one device,
    8 x 256, remat off, float32 states: 1.48881e12 FLOPs, of which the
    tied head's 6 T V d (a bmm) and the attention's 12 L B S^2 d."""
    cfg = dataclasses.replace(configs.get("spadas_trajlm"), remat=False)
    plan = specs.make_plan(cfg, "cell", _mesh((1, 1)),
                           shapes={"cell": ("train", 8, 256)})
    rec = dryrun.record(plan, cfg, "spadas_trajlm", "cell", "single", 8,
                        256)
    want = dense_flops(cfg, "train", 8, 256)
    assert rec["flops_per_device"] == want == 1_488_810_147_840
    T, d, V, L = 8 * 256, cfg.d_model, cfg.vocab_size, cfg.n_layers
    assert rec["flop_counts"]["aten.bmm"] == (6 * T * V * d
                                              + 12 * L * 8 * 256 ** 2 * d)
    n_norm = sum(p.numel() for n, p in specs.abstract_params(cfg)
                 .named_parameters() if p.ndim == 1)
    assert want == 6 * T * (cfg.param_count() - n_norm) + \
        12 * L * 8 * 256 ** 2 * d
    per, parts = dryrun.argument_bytes(plan)
    assert parts["params"] == 4 * cfg.param_count()
    assert parts["opt"] == 8 * cfg.param_count()


def _model_split(n: str, p, M: int) -> int:
    """Into how many blocks the model axis cuts a reduced dense leaf:
    the rules' ``model`` dim (columns of wq/wk/wv/wg/wu, rows of wo/wd,
    the tables' vocabulary), where it divides."""
    dim = {"wq": 1, "wk": 1, "wv": 1, "wg": 1, "wu": 1, "wo": 0, "wd": 0,
           "table": 0}.get(n.rsplit(".", 1)[-1])
    return M if dim is not None and p.shape[dim] % M == 0 else 1


@pytest.mark.parametrize("shape", [(4, 2), (1, 8)])
def test_tp_cuts_flops_and_work_bytes(shape, request):
    """The reduced yi_9b train cell computing on the model axis against
    the storage-only placement's closed forms: the lead's FLOPs are the
    group's with each split piece's products over M, the attention's
    square whole where the heads do not divide M; its work model holds
    each split leaf's model block (whole over the data axes)."""
    cfg = configs.get_reduced("yi_9b")
    D, M = shape
    if shape == (4, 2):                  # the module's record
        _, B, S = TEST_SHAPES["train_4k"]
        rec = request.getfixturevalue("yi_train")
    else:                                # the closed form holds at any S
        B, S = 8, 128
        plan = specs.make_plan(cfg, "cell", _mesh(shape),
                               shapes={"cell": ("train", B, S)})
        rec = dryrun.record(plan, cfg, "yi_9b", "cell", "single", B, S)
    rows = B // D
    hd, L, H = cfg.resolved_head_dim, cfg.n_layers, cfg.n_heads
    whole = dense_flops(cfg, "train", rows, S)          # storage-only
    sq = 12 * L * rows * H * hd * _padded(S, cfg.attn_q_chunk) * _padded(
        S, cfg.attn_kv_chunk)                           # the square
    split_sq = H % M == 0
    assert rec["flops_per_device"] == (
        (whole - sq) // M + (sq // M if split_sq else sq))
    assert rec["flops_total"] == rec["flops_per_device"] * D * M
    assert (rec["flops_total"] == whole * D) == split_sq
    params = dict(specs.abstract_params(cfg).named_parameters())
    full = sum(p.numel() * 4 for p in params.values())  # storage-only
    assert rec["memory"]["work_bytes"] == sum(
        p.numel() * 4 // _model_split(n, p, M) for n, p in params.items())
    assert rec["memory"]["work_bytes"] < full
    assert split_sq == (shape == (4, 2))
    assert all(_model_split(n, p, M) == M for n, p in params.items()
               if p.ndim == 2)              # every matrix splits


# ---------------------------------------------------------------------------
# collectives against a closed form
# ---------------------------------------------------------------------------


def test_collectives_closed_form(yi_train):
    """(4, 2): four data groups of 2 rows, each over its 2 model
    coordinates (0, 1), (2, 3), ...; bytes moved by coordinate."""
    arch, mesh, rec = "yi_9b", _mesh(), yi_train
    _, B, S = TEST_SHAPES["train_4k"]
    cfg = configs.get_reduced(arch)
    params = dict(specs.abstract_params(cfg).named_parameters())
    shard = sh.param_shardings(params, mesh)
    G, M = 4, 2
    want = [0.0] * 8
    ops = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    for n, p in params.items():
        W = p.numel() * p.element_size()
        split = math.prod(mesh.shape[a] for e in shard[n].spec
                          for a in dist.spec_axes(e))
        msplit = _model_split(n, p, M)
        for c in range(8):
            if W // msplit > W // split:          # its model block, ZeRO-3
                want[c] += W // msplit - W // split
            want[c] += (G - 1) * W if c == 0 else W // split   # grad sum
        if W // msplit > W // split:
            ops["all-gather"] += W // msplit
        if msplit > 1:                            # group 0's blocks joined
            want[0] += W - W // msplit
            ops["all-gather"] += W
        else:                                     # a replicated leaf's copies
            want[0] += (M - 1) * W
            ops["all-reduce"] += W
        ops["reduce-scatter"] += W
    # the pass over the model axis, the same at every coordinate: the
    # embedding's rows, each layer's attention and MLP partials and the
    # CE's max, sums and label logits all-reduced (each but the max with
    # its gradient's all-reduce), k's and v's column blocks all-gathered
    # (their gradients reduce-scattered); each coordinate receives the
    # other's part of each
    assert not cfg.remat
    rows, d, L = B // G, cfg.d_model, cfg.n_layers
    X = rows * S * d * 2                          # bf16 activations
    KV = rows * S * cfg.n_kv_heads * cfg.resolved_head_dim * 2 // M
    E, st = rows * S * d * 4, rows * S * 4
    reduced = 2 * E + L * 4 * X + 5 * st
    for c in range(8):
        want[c] += (M - 1) * (reduced + L * 4 * KV)
    ops["all-reduce"] += reduced
    ops["all-gather"] += L * 2 * M * KV
    ops["reduce-scatter"] += L * 2 * M * KV
    assert rec["collective_moved_bytes_per_coordinate"] == want
    assert rec["collective_moved_bytes_total"] == want[0]
    for op, b in ops.items():
        assert rec["collectives"][op]["bytes"] == b, op
    assert rec["collective_bytes_total"] == sum(ops.values()) > 0

    one = dryrun.record(_plan(arch, "train_4k", _mesh((1, 1))),
                        configs.get_reduced(arch), arch, "train_4k",
                        "single", B, S)
    assert one["collective_bytes_total"] == 0
    assert one["collective_moved_bytes_total"] == 0
    assert one["memory"]["work_bytes"] == 0


# ---------------------------------------------------------------------------
# roofline and the CLI
# ---------------------------------------------------------------------------


def _jax_roofline():
    spec = importlib.util.spec_from_file_location(
        "jax_roofline", REPO / "benchmarks" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_record_and_roofline(tmp_path):
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "yi_9b", "--shape", "train_4k", "--mesh", "multi", "--test",
         "--out", str(tmp_path)], capture_output=True, text=True,
        timeout=300, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads((tmp_path / "yi_9b__train_4k__multi.json").read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 8
    assert rec["flops_per_device"] > 0 and rec["collective_bytes_total"] > 0
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--dir",
         str(tmp_path), "--mesh", "multi", "--json-out",
         str(tmp_path / "roof.json")], capture_output=True, text=True,
        timeout=120, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert "H100" in r.stdout and "yi_9b" in r.stdout
    row = json.loads((tmp_path / "roof.json").read_text())[0]["roofline"]
    assert row == roofline.analyze(rec)

    # the port's analyze at the v5e terms is the JAX module's
    jr = _jax_roofline()
    got = roofline.analyze(rec, peak_flops=jr.PEAK_FLOPS, hbm_bw=jr.HBM_BW,
                           link_bw=jr.LINK_BW)
    want = jr.analyze(rec)
    assert want.pop("scan_corrected") is False
    assert got == want
    assert roofline.model_flops(rec) == jr.model_flops(rec)
    assert roofline.fmt_s(0.0123) == jr.fmt_s(0.0123)


def test_failed_cell_is_an_error(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(specs, "make_plan", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "yi_9b", "--shape", "decode_32k", "--test",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    rec = json.loads((tmp_path / "yi_9b__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "error" and "planted" in rec["error"]


def test_constrain_grads_exits_naming_the_reduce_scatter():
    """The JAX ``--opt constrain_grads`` has no port: the CLI exits and
    names the gradients' reduce-scatter, the part of ROADMAP 14k left."""
    with pytest.raises(SystemExit, match="reduce-scatter.*14k \\(b\\)"):
        dryrun.parse_opts("compress,constrain_grads")

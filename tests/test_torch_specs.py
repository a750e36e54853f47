"""The dry-run's cell definitions (``repro_torch.launch.specs``), the
caches' placement (``launch.sharding.cache_sharding``) and bf16 masters
(``init_train_state(param_dtype=...)``) against the JAX package's.

* ``SHAPES``, ``SKIP_REASON``, ``runnable``, ``all_cells`` and
  ``arch_rules`` equal the JAX module's for every arch and kind.
* ``cache_sharding`` equals the JAX function for every cache leaf of
  every config (bf16 and int8 KV caches), at the decode shapes and the
  ``--test`` shapes, on the test and production mesh shapes.  The JAX
  function reads only ``mesh.shape`` and ``mesh.axis_names``, so a small
  stand-in object serves as its mesh.
* bf16 masters: the state's leaf names, shapes and dtypes equal the JAX
  ``init_train_state(param_dtype=jnp.bfloat16)`` state of a reduced
  config with int8 moments; one step of both from the same values within
  the bounds of ``torch_train_parity``, a bf16 master's bound widened by
  one bf16 ulp: each package rounds its new value to bf16, so where the
  two updates take opposite signs (2 lr apart) the roundings add up to an
  ulp of the larger value.
* On ``["cpu"] * 8``, the plan's per-coordinate argument bytes equal
  ``train_step.state_device_bytes`` of a really placed state plus the
  batch block (and the 0-d count and step on the lead), with float32 and
  int8 moments and with error feedback; with int8 and compression the
  record is the one the same plan gives over ``["meta"] * 8`` (it books
  by mesh coordinate).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import model as jmodel
from repro.train import train_step as jts
from repro_torch import configs
from repro_torch.core import distributed as dist
from repro_torch.launch import dryrun, specs
from repro_torch.launch import sharding as sh
from repro_torch.models import convert
from repro_torch.models.model import FLOAT32_LEAVES, LanguageModel
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from torch_train_parity import (DEFAULT_STEP_BOUNDS, GNORM_RTOL, LOSS_ATOL,
                                LR, batch, cfg_pair, jax_step, opt_pair)
from torch_lm_parity import one_torch_thread  # noqa: F401

MESH_SHAPES = {"test": {"data": 4, "model": 2},
               "test_multi": {"pod": 2, "data": 2, "model": 2},
               "single": {"data": 16, "model": 16},
               "multi": {"pod": 2, "data": 16, "model": 16}}


def _spec(p) -> tuple:
    """A spec's entries with one-name tuples as the name (JAX keeps the
    tuple, the port's PartitionSpec the name)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in p)


def test_grid_equals_jax():
    assert specs.SHAPES == jspecs.SHAPES
    assert specs.SKIP_REASON == jspecs.SKIP_REASON
    assert list(specs.all_cells()) == list(jspecs.all_cells())
    assert (list(specs.all_cells(include_skips=True))
            == list(jspecs.all_cells(include_skips=True)))
    assert len(list(specs.all_cells())) == 32
    assert len(list(specs.all_cells(include_skips=True))) == 40
    for arch in configs.ARCH_IDS:
        cfg, jcfg = configs.get(arch), jconfigs.get(arch)
        for shape in specs.SHAPES:
            assert specs.runnable(cfg, shape) == jspecs.runnable(jcfg, shape)
        for kind in ("train", "prefill", "decode"):
            assert specs.arch_rules(cfg, kind) == jspecs.arch_rules(jcfg,
                                                                    kind)
        big = cfg.param_count() > 60e9
        assert specs._param_dtype(cfg) == (torch.bfloat16 if big
                                           else torch.float32)
        assert jspecs._param_dtype(jcfg) == (jnp.bfloat16 if big
                                             else jnp.float32)
        assert (specs._opt_cfg(cfg).state_dtype
                == jspecs._opt_cfg(jcfg).state_dtype)


def _cache_shapes(model, B, T, kv):
    return [tuple(v.shape) for c in model.init_cache(B, T, kv)
            for v in c.values()]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_sharding_equals_jax(arch):
    test_shapes = dryrun.test_shapes(specs.SHAPES)
    cases = 0
    for reduced in (False, True):
        cfg = configs.get_reduced(arch) if reduced else configs.get(arch)
        jcfg = (jconfigs.get_reduced(arch) if reduced
                else jconfigs.get(arch))
        model = LanguageModel(cfg, device="meta")
        for shape_name in ("decode_32k", "long_500k"):
            for shapes in (specs.SHAPES, test_shapes):
                _, B, T = shapes[shape_name]
                for kv in ("bf16", "int8"):
                    leaves = _cache_shapes(model, B, T, kv)
                    jc = dataclasses.replace(jcfg, kv_cache_dtype=kv)
                    want = [tuple(x.shape) for x in jax.tree.leaves(
                        jmodel.cache_specs(jc, B, T))]
                    assert sorted(leaves) == sorted(want)
                    for name, sizes in MESH_SHAPES.items():
                        mesh = dist.grid_mesh(
                            tuple(sizes.values()), tuple(sizes),
                            ["meta"] * int(np.prod(list(sizes.values()))),
                            "test")
                        jmesh = types.SimpleNamespace(
                            shape=dict(sizes), axis_names=tuple(sizes))
                        for shp in leaves:
                            for t in (False, True):
                                got = sh.cache_sharding(shp, mesh,
                                                        shard_time=t)
                                exp = jsh.cache_sharding(shp, jmesh,
                                                         shard_time=t)
                                assert _spec(got) == _spec(exp), (
                                    name, shp, t)
                                cases += 1
    assert cases > 0


# ---------------------------------------------------------------------------
# bf16 masters
# ---------------------------------------------------------------------------


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def test_bf16_masters_match_jax_state_and_step():
    jcfg, cfg = cfg_pair("spadas_trajlm", smooth=True)
    jo, to = opt_pair(state_dtype="int8", q_block=64)
    js = jax.jit(lambda k: jts.init_train_state(
        k, jcfg, jo, param_dtype=jnp.bfloat16))(jax.random.PRNGKey(3))
    like = tts.init_train_state(cfg, to, device="cpu",
                                param_dtype=torch.bfloat16)
    jl = convert.tree_leaves(js)
    tl = convert.state_leaves(like)
    assert set(jl) == set(tl)
    for k, a in jl.items():
        b = tl[k]
        if hasattr(a, "codes"):
            assert tuple(a.codes.shape) == tuple(b.codes.shape), k
            assert tuple(a.scales.shape) == tuple(b.scales.shape), k
            assert (_dtype_name(a.codes), _dtype_name(a.scales)) == (
                _dtype_name(b.codes), _dtype_name(b.scales)), k
        else:
            assert tuple(a.shape) == tuple(b.shape), k
            assert _dtype_name(a) == _dtype_name(b), k
    f32 = {n for n, p in like.params.named_parameters()
           if p.dtype == torch.float32}
    assert all(n.rsplit(".", 1)[-1] in FLOAT32_LEAVES for n in f32)

    st = convert.train_state_from_jax(jax.tree.map(_np, js), like)
    b = batch(cfg, 2, 64)
    js2, jm = jax_step(jcfg, jo)(js, jax.tree.map(jnp.asarray, b))
    st2, tm = tts.make_train_step(cfg, to)(st, b)
    for k in ("loss", "ce"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_ATOL, k
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=GNORM_RTOL)
    over_share, _ = DEFAULT_STEP_BOUNDS
    jl2 = convert.tree_leaves(jax.tree.map(_np, js2))
    worst, over, n = 0.0, 0, 0
    for name, p in st2.params.named_parameters():
        key = convert.jax_key(name)
        a = jl2[".params/" + key[0]]
        a = a[key[1]] if key[1] is not None else a
        got = p.detach().float().numpy().astype(np.float64)
        gap = np.abs(got - a.astype(np.float64))
        bound = 2 * LR * (1 + 1e-3)
        if p.dtype == torch.bfloat16:
            big = np.maximum(np.abs(a), np.abs(got)).astype(np.float32)
            bound = bound + np.spacing(big).astype(np.float64) * 2 ** 16
        worst = max(worst, float((gap / bound).max()))
        over += int((gap > 0.1 * LR).sum())
        n += gap.size
    assert worst <= 1.0 and over / n <= over_share, (worst,
                                                         over / n)
    assert all(torch.isfinite(p.float()).all()
               for p in st2.params.parameters())


# ---------------------------------------------------------------------------
# argument bytes against a placed state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("state_dtype,compress",
                         [("fp32", False), ("int8", True)])
def test_argument_bytes_equal_placed_state(monkeypatch, state_dtype,
                                           compress):
    """The meta plan's per-coordinate bytes on ``["cpu"] * 8`` against
    the resident bytes of a state placed there by the same rules."""
    monkeypatch.setattr(specs, "_opt_cfg", lambda cfg: topt.OptConfig(
        state_dtype=state_dtype))
    cfg = configs.get_reduced("yi_9b")
    shapes = dryrun.test_shapes(specs.SHAPES)
    mesh = dist.grid_mesh((4, 2), ("data", "model"), ["cpu"] * 8, "test")
    plan = specs.make_plan(cfg, "train_4k", mesh, compress=compress,
                           shapes=shapes)
    per, parts = dryrun.argument_bytes(plan)

    st = tts.init_train_state(cfg, topt.OptConfig(state_dtype=state_dtype),
                              device="cpu", compress=compress)
    p_shard = sh.param_shardings(dict(st.params.named_parameters()), mesh)
    placed = tts.shard_state(st, p_shard)
    resident = tts.state_device_bytes(placed)
    _, B, S = shapes["train_4k"]
    rows = B // 4
    batch_block = 2 * rows * S * 4                 # tokens, labels: int32
    want = [r + batch_block + (8 if i == 0 else 0)
            for i, r in enumerate(resident)]
    assert per == want
    assert parts["batch"] == batch_block and parts["scalars"] == 8
    assert parts.get("err", 0) > 0 if compress else "err" not in parts

    if not compress:
        return
    recs = []                   # every booking kind: int8 leaves, err
    for devs in (["cpu"] * 8, ["meta"] * 8):
        m = dist.grid_mesh((4, 2), ("data", "model"), devs, "test")
        r = dryrun.record(specs.make_plan(cfg, "train_4k", m,
                                          compress=compress, shapes=shapes),
                          cfg, "yi_9b", "train_4k", "single", B, S)
        r.pop("trace_s")
        recs.append(r)
    assert recs[0] == recs[1]
    assert recs[0]["memory"]["argument_bytes_per_coordinate"] == want


def test_plan_runs_the_mesh_steps_gradient_tail(monkeypatch):
    """The plan's lead step and the mesh step it stands for reach the
    same gradient tail (``train_step.finish_grads``) in the same order:
    with compression, the summed gradients are compressed and then their
    norm is taken, once each, in both."""
    cfg = configs.get_reduced("yi_9b")
    shapes = {"cell": ("train", 8, 32)}
    calls = {}
    comp, norm = tts._compressed, topt.global_norm

    def spy(key):
        monkeypatch.setattr(tts, "_compressed", lambda *a: (
            calls[key].append("compress"), comp(*a))[1])
        monkeypatch.setattr(topt, "global_norm", lambda *a: (
            calls[key].append("norm"), norm(*a))[1])
        calls[key] = []

    meta = dist.grid_mesh((4, 2), ("data", "model"), ["meta"] * 8, "test")
    plan = specs.make_plan(cfg, "cell", meta, compress=True, shapes=shapes)
    spy("plan")
    plan.step_fn()

    opt = specs._opt_cfg(cfg)
    mesh = dist.grid_mesh((4, 2), ("data", "model"), ["cpu"] * 8, "test")
    st = tts.init_train_state(cfg, opt, device="cpu", compress=True)
    p_shard = sh.param_shardings(dict(st.params.named_parameters()), mesh)
    st = tts.shard_state(st, p_shard)
    step = tts.make_train_step(cfg, opt, compress=True,
                               param_shardings=p_shard)
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 32)), dtype=torch.int32)
    spy("step")
    step(st, {"tokens": tok, "labels": tok.roll(-1, 1)})
    assert calls["plan"] == calls["step"] == ["compress", "norm"]

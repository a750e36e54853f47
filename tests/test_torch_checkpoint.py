"""The port's checkpoints (``repro_torch.checkpoint.ckpt``) and runtime
(``repro_torch.runtime``) on the CPU, against ``repro.checkpoint.ckpt`` and
``repro.runtime``.

* Round trip and crash-resume, as the JAX package's own test: the
  continuation's losses within ``rtol=1e-5`` of the uninterrupted run's
  (they are bitwise on the CPU).
* ``AsyncSaver`` takes a real snapshot: two steps taken at once after a
  save at step 3 leave step 3's values on disk (the port's tensors are
  updated in place).
* A checkpoint written by the JAX package restores into the port, and one
  written by the port restores into the JAX package, leaf for leaf
  bitwise, with float32 and with int8 moments and the compression error.
* An elastic restore onto another device list, ``plan_remesh`` equal to
  the JAX one over a grid of meshes and failures, and the watchdog driven
  by a patched ``time.perf_counter`` in both packages (no real sleeps).
"""
import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_parity as TP
from repro.checkpoint import ckpt as jckpt
from repro.runtime import elastic as jelastic
from repro.runtime import straggler as jstraggler
from repro_torch.checkpoint import ckpt
from repro_torch.core.distributed import Mesh
from repro_torch.data import tokens as tok
from repro_torch.models import convert
from repro_torch.runtime import elastic, straggler
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from torch_lm_parity import one_torch_thread  # noqa: F401

INT8 = {"state_dtype": "int8", "q_block": 64}


def _leaves_equal(got: dict, want: dict):
    """Two leaf dicts (numpy, or QTensors of numpy) bitwise equal."""
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        parts = (("codes", "scales") if hasattr(w, "codes") else (None,))
        for part in parts:
            a = np.asarray(g if part is None else getattr(g, part))
            b = np.asarray(w if part is None else getattr(w, part))
            assert a.shape == b.shape and a.dtype == b.dtype, k
            assert a.tobytes() == b.tobytes(), (k, part)


def _pipe(cfg, state=None):
    docs = tok.synthetic_corpus(32, cfg.vocab_size, seed=0)
    return tok.TokenPipeline(docs, 32, 2, seed=0, state=state)


def _port_run(opt_kw=None, compress=False, steps=2, seed=0):
    """A reduced spadas_trajlm state on the CPU after ``steps`` steps."""
    _, cfg = TP.cfg_pair("spadas_trajlm")
    to = TP.opt_pair(**(opt_kw or {}))[1]
    st = tts.init_train_state(cfg, to, device="cpu", seed=seed,
                              compress=compress)
    step = tts.make_train_step(cfg, to, compress=compress)
    pipe = _pipe(cfg)
    for _ in range(steps):
        st, _ = step(st, pipe.next_batch())
    return cfg, to, st, step, pipe


@pytest.mark.parametrize("opt_kw,compress", [(None, False), (INT8, True)],
                         ids=["fp32", "int8_compress"])
def test_roundtrip_and_crash_resume(tmp_path, opt_kw, compress):
    cfg, to, st, step, pipe = _port_run(opt_kw, compress, steps=3)
    ckpt.save(tmp_path, 3, st, extra={"step": 3,
                                      "pipeline": pipe.state.as_dict()})
    saved = TP.port_leaves(st)
    ref_losses = []
    for _ in range(2):
        st, m = step(st, pipe.next_batch())
        ref_losses.append(float(m["loss"]))

    # "crash": a fresh state of other weights, restored from disk
    fresh = tts.init_train_state(cfg, to, device="cpu", seed=42,
                                 compress=compress)
    restored, extra = ckpt.restore(tmp_path, fresh)
    assert extra["step"] == 3 and int(restored.step) == 3
    assert restored.params is fresh.params        # filled in place
    _leaves_equal(TP.port_leaves(restored), saved)
    pipe2 = _pipe(cfg, tok.PipelineState.from_dict(extra["pipeline"]))
    got = []
    for _ in range(2):
        restored, m = step(restored, pipe2.next_batch())
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, ref_losses, rtol=1e-5)


def test_async_snapshot_is_a_copy(tmp_path, monkeypatch):
    """Save at step 3 in the background, take two steps at once (they
    update the same tensors in place), then restore: step 3's values.  The
    background write is held until the two steps are done, so a snapshot
    that shared the tensors' memory would write step 5's."""
    cfg, to, st, step, pipe = _port_run(steps=3)
    want = TP.port_leaves(st)
    release, write = threading.Event(), ckpt._write

    def held_write(*args):
        assert release.wait(60)
        return write(*args)

    monkeypatch.setattr(ckpt, "_write", held_write)
    saver = ckpt.AsyncSaver()
    saver.save(tmp_path, 3, st, extra={"step": 3})
    for _ in range(2):
        st, _ = step(st, pipe.next_batch())
    release.set()
    saver.wait()
    assert int(st.step) == 5
    fresh = tts.init_train_state(cfg, to, device="cpu", seed=9)
    restored, _ = ckpt.restore(tmp_path, fresh)
    _leaves_equal(TP.port_leaves(restored), want)


def test_async_saver_and_latest_step(tmp_path):
    state = {"w": torch.arange(10.0), "q": {"b": torch.ones(3, 4)}}
    saver = ckpt.AsyncSaver()
    saver.save(tmp_path, 1, state, extra={"step": 1})
    saver.save(tmp_path, 2, state, extra={"step": 2})
    saver.wait()
    assert ckpt.latest_step(tmp_path) == 2
    # an interrupted save leaves no COMMITTED marker: never restored
    (tmp_path / "step_00000007").mkdir()
    (tmp_path / ".tmp_step_00000008").mkdir()
    assert ckpt.latest_step(tmp_path) == 2
    got, extra = ckpt.restore(tmp_path, {"w": torch.zeros(10),
                                         "q": {"b": torch.zeros(3, 4)}})
    assert extra == {"step": 2} and torch.equal(got["w"], state["w"])
    assert torch.equal(got["q"]["b"], state["q"]["b"])
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "none", state)


def test_restore_refuses_another_structure(tmp_path):
    cfg, to, st, _, _ = _port_run(steps=1)
    ckpt.save(tmp_path, 1, st)
    int8 = tts.init_train_state(cfg, topt.OptConfig(**{**vars(to), **INT8}),
                                device="cpu")
    with pytest.raises(KeyError):
        ckpt.restore(tmp_path, int8)
    _, wide = TP.cfg_pair("llama3_8b")
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, tts.init_train_state(wide, to, device="cpu"))
    deep = dataclasses.replace(cfg, n_layers=3)
    with pytest.raises(ValueError, match="repeats"):
        ckpt.restore(tmp_path, tts.init_train_state(deep, to, device="cpu"))


def _jax_run(opt_kw, compress):
    """A reduced spadas_trajlm JAX state after two steps, and its port
    counterpart's empty structure."""
    jcfg, cfg, jo, to, js, _ = TP.states("spadas_trajlm", opt_kw,
                                         compress=compress)
    step = TP.jax_step(jcfg, jo, compress)
    for seed in (1, 2):
        js, _ = step(js, jax.tree.map(jnp.asarray, TP.batch(cfg, 2, 32,
                                                            seed=seed)))
    like = tts.init_train_state(cfg, to, device="cpu", seed=7,
                                compress=compress)
    return js, like


@pytest.mark.parametrize("opt_kw,compress", [(None, False), (INT8, True)],
                         ids=["fp32", "int8_compress"])
def test_jax_checkpoint_restores_into_the_port(tmp_path, opt_kw, compress):
    js, like = _jax_run(opt_kw, compress)
    jckpt.save(tmp_path, 2, js, extra={"step": 2})
    restored, extra = ckpt.restore(tmp_path, like)
    assert extra == {"step": 2}
    _leaves_equal(TP.port_leaves(restored), TP.jax_leaves(js))
    # and the bridge without a file
    again = convert.train_state_from_jax(
        jax.tree.map(np.asarray, js),
        tts.init_train_state(like.params.cfg, _opt(opt_kw), device="cpu",
                             compress=compress))
    _leaves_equal(TP.port_leaves(again), TP.jax_leaves(js))


def _opt(opt_kw):
    return TP.opt_pair(**(opt_kw or {}))[1]


@pytest.mark.parametrize("opt_kw,compress", [(None, False), (INT8, True)],
                         ids=["fp32", "int8_compress"])
def test_port_checkpoint_restores_into_jax(tmp_path, opt_kw, compress):
    js, _ = _jax_run(opt_kw, compress)
    _, _, st, _, _ = _port_run(opt_kw, compress, steps=2, seed=5)
    ckpt.save(tmp_path, 2, st, extra={"step": 2, "pipeline": {"epoch": 0,
                                                              "cursor": 4}})
    manifest = json.loads((tmp_path / "step_00000002" / "manifest.json")
                          .read_text())
    assert ".params/blocks/0/attn/wk" in manifest["leaves"]
    assert manifest["leaves"][".params/blocks/0/attn/wk"]["shape"][0] == 2
    restored, extra = jckpt.restore(tmp_path, js)
    assert extra["pipeline"] == {"epoch": 0, "cursor": 4}
    _leaves_equal(TP.jax_leaves(restored), TP.port_leaves(st))


def test_elastic_restore_onto_another_device_list(tmp_path):
    """A state saved from one device restores onto the lead device of the
    mesh a remesh plan lays over the survivors; ``reshard_tree`` moves a
    state's every leaf."""
    cfg, to, st, step, pipe = _port_run(INT8, True, steps=2)
    ckpt.save(tmp_path, 2, st)
    plan = elastic.plan_remesh({"data": 4, "model": 2}, failed=3)
    assert plan.new_shape == {"data": 2, "model": 2}
    survivors = [torch.device("cpu")] * 5
    mesh = elastic.make_mesh_from_plan(plan, survivors)
    assert isinstance(mesh, Mesh) and mesh.shape == {"data": 2, "model": 2}
    fresh = tts.init_train_state(cfg, to,
                                 device="cpu", seed=3, compress=True)
    restored, _ = ckpt.restore(tmp_path, fresh, devices=mesh.flat)
    _leaves_equal(TP.port_leaves(restored), TP.port_leaves(st))
    moved = elastic.reshard_tree(restored, mesh.lead)
    assert isinstance(moved, tts.TrainState)
    assert all(t.device == mesh.lead for t in
               [moved.step, moved.opt.count, *moved.params.parameters(),
                *(q.codes for q in moved.opt.m.values()
                  if isinstance(q, topt.QTensor))])
    with pytest.raises(ValueError, match="devices"):
        elastic.make_mesh_from_plan(plan, survivors[:3])


MESHES = [{"data": 8}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}, {"pod": 4, "data": 3,
                                                "model": 2}]


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_plan_remesh_matches_jax(shape):
    total = int(np.prod(list(shape.values())))
    for failed in range(0, total, max(1, total // 37)):
        try:
            want = jelastic.plan_remesh(shape, failed)
        except RuntimeError:
            with pytest.raises(RuntimeError):
                elastic.plan_remesh(shape, failed)
            continue
        got = elastic.plan_remesh(shape, failed)
        assert (got.old_shape, got.new_shape, got.lost_devices,
                got.per_device_batch_factor, got.new_axis_sizes) == (
            want.old_shape, want.new_shape, want.lost_devices,
            want.per_device_batch_factor, want.new_axis_sizes)


class _Clock:
    """A stand-in for the ``time`` module: ``perf_counter`` reads a clock
    that the test advances."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


@pytest.mark.parametrize("cfg_kw", [
    {"warmup": 0, "tolerance": 2.0, "consecutive": 1, "min_deadline_s": 0.0},
    {"warmup": 2, "tolerance": 3.0, "consecutive": 2},
    {"window": 4, "warmup": 1, "tolerance": 1.5, "consecutive": 1}],
    ids=["trip_at_once", "two_in_a_row", "short_window"])
def test_watchdog_matches_jax_on_a_patched_clock(monkeypatch, cfg_kw):
    """Both watchdogs driven by one patched clock over the same step
    times (steady, one slow step, then two slow in a row): the same
    recorded times, deadlines and events."""
    clock = _Clock()
    monkeypatch.setattr(straggler, "time", clock)
    monkeypatch.setattr(jstraggler, "time", clock)
    ours = straggler.StepWatchdog(straggler.WatchdogConfig(**cfg_kw))
    theirs = jstraggler.StepWatchdog(jstraggler.WatchdogConfig(**cfg_kw))
    times = [0.002] * 6 + [0.05] + [0.002] * 3 + [0.05, 0.06] + [0.002] * 2
    events = []
    for dt in times:
        out = []
        for wd, exc in ((ours, straggler.StragglerEvent),
                        (theirs, jstraggler.StragglerEvent)):
            start = clock.now
            wd.start()
            clock.now = start + dt
            try:
                out.append(("ok", wd.stop()))
            except exc as e:
                out.append(("event", e.step, e.step_time, e.deadline))
            clock.now = start
        assert out[0] == out[1]
        assert ours.deadline() == theirs.deadline()
        events.append(out[0][0])
        clock.now += dt
    assert "event" in events

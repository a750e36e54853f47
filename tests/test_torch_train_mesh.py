"""The port's training on a mesh (``train_step.make_train_step(...,
param_shardings=...)``, ``shard_state``, checkpoints and remesh,
``launch/train.py --mesh``) on the CPU, meshes of ``["cpu"] * N``.

* Against the JAX mesh step: the reduced spadas_trajlm, lr 1e-3 after 5
  warm-up steps, on (4, 2), the JAX package on a mesh of Auto axes (the
  Explicit axes ``make_test_mesh`` gives fail under jax 0.9.0), both
  from the same JAX state (its checkpoint, restored onto the port's mesh)
  and fed the same 3 batches of 8 x 64: each step's loss within 2e-3 of
  JAX's (the bound of ``test_torch_train_launch.py``, 15x the 1.35e-4
  between JAX's own mesh and one-device steps; the port's gap is
  asserted below 5e-4 and reported).
* On a data = 1 mesh, (1, 2), the dense config computes on the model
  axis, whose sums are a new reduction order.  Each of 3 steps is also
  taken by the one-device step from the same state (the mesh state's,
  gathered): ``loss`` and ``ce`` within ``TP_RTOL`` of its, ``grad_norm``
  within ``TP_NORM_RTOL`` (relative); the params after it with at most
  ``OVER_SHARE`` of the elements past 0.1 lr from its (``chip_smoke.py``'s
  ``MESH_OVER_SHARE`` rule) with float32 states, ``INT8_OVER_SHARE``
  with int8 states (blocks of 256: a param block of 64 columns lies
  inside one moment block, so those leaves update in the moment's
  layout; blocks of 64: they line up), compression and microbatches,
  whose int8 quantizations turn a last-bit gradient difference into a
  different code (3.3 % of the elements seen); and the new moments and
  error feedback against its (``_state_close``).  With float32 states
  the two steps also run 3 steps each on their own: each step's metrics
  keep those bounds and the step-3 params ``OVER_SHARE``; the int8 runs
  jump at their third step (loss 7.0 -> 89 on one device), so there only
  the steps from the same state are held.  Two runs of that step on
  fresh meshes are bitwise equal, and each model coordinate's gradient
  block, and each replicated leaf's copies summed, equal the one-device
  gradient (its slice) within ``GRAD_TOL`` of the leaf's largest
  magnitude (2.3 % seen: bf16 activations).  An MoE config keeps the
  storage-only path: bitwise the one-device step on (1, 2), and raising
  where more than one data group computes.
* Resume, restore and remesh: a (4, 2) run saved at step 3 and resumed
  gives steps 4-6 bitwise; checkpoints cross between one device and a
  mesh; the async snapshot is a copy; ``plan_remesh`` ->
  ``make_mesh_from_plan`` -> ``reshard_tree`` gives a state that steps
  on (batch 8 does not split over 3 groups, so one group computes it,
  over the model axis: within ``TP_RTOL`` of the one-device step).
* The trainer: ``--mesh test --device cpu`` trains with checkpoints;
  ``--mesh single`` / ``multi`` take a step within 2e-3 of the
  one-device step; ``--mesh test`` with no device list and no card
  raises.

The JAX side runs in one ``conftest.run_py`` subprocess with 8 forced
host devices (~15 s).
"""
import json
import threading

import jax
import numpy as np
import pytest
import torch

import torch_train_parity as TP
from conftest import run_py
from repro_torch import configs
from repro_torch.checkpoint import ckpt
from repro_torch.core import distributed as dist
from repro_torch.data import tokens as tok
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as sh
from repro_torch.launch import train
from repro_torch.models import convert
from repro_torch.runtime import elastic
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from torch_lm_parity import one_torch_thread  # noqa: F401

LOSS_ATOL = 2e-3
TP_RTOL = 2e-4
TP_NORM_RTOL = 1e-2
OVER_SHARE = 0.01
INT8_OVER_SHARE = 0.05
GRAD_TOL = 5e-2
#: m and v (dequantized where int8) after a step from the same state: at
#: most STATE_SHARE of the elements more than STATE_TOL of their leaf's
#: largest magnitude apart (seen: none with float32 states, 1.4e-4 at
#: the int8 runs' third step, their largest gap 12 %)
STATE_TOL = 5e-2
STATE_SHARE = 1e-3
#: the error feedback (an int8 quantization residual) after a step from
#: the same state: its largest magnitude in each block of 256 (half the
#: block's quantization step) within ERR_TOL of the one-device step's,
#: for all but ERR_SHARE of the blocks (seen: every block within 4.1 %
#: at steps 1-2, 1.9-4.5 % of the blocks past 5 % at the third)
ERR_TOL = 5e-2
ERR_SHARE = 0.1
OPT = {"lr": 1e-3, "warmup_steps": 5}
SMALL = ["--device", "cpu", "--reduced", "--batch", "8", "--seq", "64",
         "--lake-size", "24", "--log-every", "1"]

_JAX = """
import json
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro import configs
from repro.checkpoint import ckpt as jckpt
from repro.data import tokens as tok_lib
from repro.launch import sharding as jsh
from repro.models import sharding_rules
from repro.train import optimizer as jopt, train_step as jts

out_dir = %(out)r
cfg = configs.get_reduced("spadas_trajlm")
oc = jopt.OptConfig(**%(opt)r)
state = jts.init_train_state(jax.random.PRNGKey(0), cfg, oc)
jckpt.save(out_dir + "/init", 0, state)
docs = tok_lib.synthetic_corpus(256, cfg.vocab_size, seed=0)
pipe = tok_lib.TokenPipeline(docs, 64, 8, seed=0)
batches = [pipe.next_batch() for _ in range(3)]
np.savez(out_dir + "/batches.npz", **{f"{k}{i}": v for i, b in
                                      enumerate(batches) for k, v in b.items()})
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
sharding_rules.set_mesh(mesh)
p_shard = jsh.param_shardings(jax.eval_shape(lambda: state.params), mesh)
state = state._replace(params=jax.tree.map(jax.device_put, state.params,
                                           p_shard))
step = jax.jit(jts.make_train_step(cfg, oc, param_shardings=p_shard))
losses = []
with mesh:
    for b in batches:
        state, m = step(state, jax.tree.map(jnp.asarray, b))
        losses.append(float(m["loss"]))
print(json.dumps({"losses": losses}))
"""


@pytest.fixture(scope="module")
def jax_mesh_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_mesh")
    res = json.loads(run_py(_JAX % {"out": str(out), "opt": OPT},
                            devices=8).strip().splitlines()[-1])
    npz = np.load(out / "batches.npz")
    batches = [{k: npz[f"{k}{i}"] for k in ("tokens", "labels")}
               for i in range(3)]
    return out / "init", batches, res["losses"]


def _cpu_mesh(shape, names=("data", "model")):
    return dist.grid_mesh(shape, names, ["cpu"] * int(np.prod(shape)),
                          "test")


def _state(cfg, oc, *, seed=0, compress=False):
    return tts.init_train_state(cfg, oc, device="cpu", seed=seed,
                                compress=compress)


def _on_mesh(st, mesh):
    p_shard = sh.param_shardings(dict(st.params.named_parameters()), mesh)
    return tts.shard_state(st, p_shard), p_shard


def _pipe(cfg, state=None):
    docs = tok.synthetic_corpus(64, cfg.vocab_size, seed=0)
    return tok.TokenPipeline(docs, 64, 8, seed=0, state=state)


def _leaves_equal(got: dict, want: dict):
    """Two leaf dicts (numpy, or QTensors of numpy) bitwise equal."""
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        parts = ("codes", "scales") if hasattr(w, "codes") else (None,)
        for part in parts:
            x = np.asarray(g if part is None else getattr(g, part))
            y = np.asarray(w if part is None else getattr(w, part))
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (k, part)


def test_mesh_step_tracks_the_jax_mesh_step(jax_mesh_run):
    init, batches, jax_losses = jax_mesh_run
    cfg = configs.get_reduced("spadas_trajlm")
    oc = topt.OptConfig(**OPT)
    mesh = _cpu_mesh((4, 2))
    like = _state(cfg, oc, seed=7)
    p_shard = sh.param_shardings(dict(like.params.named_parameters()), mesh)
    st, extra = ckpt.restore(init, like, shardings=p_shard)
    assert convert.on_mesh(st) and st.params.mesh == mesh
    step = tts.make_train_step(cfg, oc, param_shardings=p_shard)
    losses = []
    for b in batches:
        st, m = step(st, b)
        losses.append(float(m["loss"]))
    gap = np.abs(np.asarray(losses) - jax_losses)
    print(f"port (4, 2) mesh vs JAX (4, 2) mesh: losses {losses}, JAX "
          f"{jax_losses}, largest gap {gap.max():.3g}")
    np.testing.assert_allclose(losses, jax_losses, atol=LOSS_ATOL, rtol=0)
    assert gap.max() < 5e-4
    assert losses[-1] < losses[0] and int(st.step) == 3


def _params_close(got: dict, want: dict, lr: float, share=OVER_SHARE):
    """The params of two leaf dicts: at most ``share`` of the elements
    more than 0.1 lr apart."""
    over = n = 0
    for k, w in want.items():
        if k.startswith(".params/"):
            gap = np.abs(np.asarray(got[k], np.float64)
                         - np.asarray(w, np.float64)) / lr
            over += int((gap > 0.1).sum())
            n += gap.size
    assert n and over / n <= share, over / n


def _metrics_close(m1: dict, m2: dict):
    for k in ("loss", "ce"):
        assert abs(float(m2[k]) / float(m1[k]) - 1) <= TP_RTOL, k
    assert abs(float(m2["grad_norm"]) / float(m1["grad_norm"]) - 1) \
        <= TP_NORM_RTOL
    assert float(m1["aux"]) == float(m2["aux"]) == 0.0


def _dequantized(v) -> np.ndarray:
    if hasattr(v, "codes"):
        v = topt._dequantize(topt.QTensor(torch.as_tensor(v.codes),
                                          torch.as_tensor(v.scales),
                                          v.shape)).numpy()
    return np.asarray(v, np.float64)


def _block_max(a: np.ndarray) -> np.ndarray:
    flat = np.abs(a).reshape(-1)
    return np.pad(flat, (0, (-flat.size) % 256)).reshape(-1, 256).max(1)


def _state_close(got: dict, want: dict):
    """The new moments and error feedback of two leaf dicts from steps
    taken from the same state.  m and v: ``STATE_SHARE`` of the elements
    past ``STATE_TOL`` of the leaf's largest magnitude.  The error
    feedback is what the int8 quantization of each block of 256 lost, so
    a last-bit difference of the gradient moves its elements anywhere
    within half the block's quantization step; it is held by its largest
    magnitude in each block, which tracks that step: ``ERR_SHARE`` of the
    blocks past ``ERR_TOL`` (relative)."""
    over = {".m": [0, 0], ".v": [0, 0], ".err": [0, 0]}
    for k, w in want.items():
        if k.startswith((".opt/.m/", ".opt/.v/")):
            a, b = _dequantized(got[k]), _dequantized(w)
            gap = np.abs(a - b) > STATE_TOL * np.abs(b).max()
            c = over[k.split("/")[1]]
        elif k.startswith(".err/"):
            a, b = _block_max(_dequantized(got[k])), _block_max(
                _dequantized(w))
            gap = np.abs(a - b) > ERR_TOL * b
            c = over[".err"]
        else:
            continue
        c[0] += int(gap.sum())
        c[1] += gap.size
    assert over[".m"][1] and over[".v"][1]
    for kind, (n_over, n) in over.items():
        share = ERR_SHARE if kind == ".err" else STATE_SHARE
        assert not n or n_over / n <= share, (kind, n_over / n)


@pytest.mark.parametrize("opt_kw,compress,microbatch", [
    ({}, False, 0), ({"state_dtype": "int8"}, True, 0),
    ({"state_dtype": "int8", "q_block": 64}, True, 4)],
    ids=["fp32", "int8_256_compress", "int8_64_compress_microbatch"])
def test_data1_mesh_is_the_one_device_step(opt_kw, compress, microbatch):
    cfg = configs.get_reduced("spadas_trajlm")
    oc = topt.OptConfig(**OPT, **opt_kw)
    ms, p_shard = _on_mesh(_state(cfg, oc, compress=compress),
                           _cpu_mesh((1, 2)))
    alone = _state(cfg, oc, compress=compress)     # float32: its own run
    assert tts.computes_on_model_axis(cfg, ms.params.mesh)
    s1 = tts.make_train_step(cfg, oc, compress=compress,
                             microbatch=microbatch)
    s2 = tts.make_train_step(cfg, oc, compress=compress,
                             microbatch=microbatch, param_shardings=p_shard)
    pipe = _pipe(cfg)
    share = INT8_OVER_SHARE if opt_kw else OVER_SHARE
    for _ in range(3):
        b = pipe.next_batch()
        one, m1 = s1(tts.unshard_state(ms, "cpu"), b)
        ms, m2 = s2(ms, b)
        _metrics_close(m1, m2)
        if not opt_kw:
            alone, m0 = s1(alone, b)
            _metrics_close(m0, m2)
        got, want = TP.port_leaves(ms), TP.port_leaves(one)
        _params_close(got, want, OPT["lr"], share)
        _state_close(got, want)
    if not opt_kw:
        _params_close(TP.port_leaves(ms), TP.port_leaves(alone), OPT["lr"])


def test_tp_step_is_reproducible():
    """The step over the model axis on two fresh (1, 2) meshes of the
    CPU: losses and every leaf bitwise equal over 2 steps."""
    cfg = configs.get_reduced("llama3_8b")
    oc = topt.OptConfig(**OPT)
    runs = []
    for _ in range(2):
        ms, p_shard = _on_mesh(_state(cfg, oc), _cpu_mesh((1, 2)))
        step = tts.make_train_step(cfg, oc, param_shardings=p_shard)
        losses = []
        for i in range(2):
            ms, m = step(ms, TP.batch(cfg, 2, 32, seed=i))
            losses.append(float(m["loss"]))
        runs.append((losses, TP.port_leaves(ms)))
    assert runs[0][0] == runs[1][0]
    _leaves_equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("arch", ["llama3_8b", "musicgen_medium"])
def test_tp_gradient_blocks_are_slices_of_the_whole(arch):
    """One data group's pass over the model axis of a (1, 2) mesh
    (``group_pass`` with a ``ModelAxis``): each coordinate's gradient
    block of each split leaf against its slice of the one-device
    gradient, within ``GRAD_TOL`` of the leaf's largest magnitude; the
    leaves ``model_axis_grads`` assembles (blocks joined, a replicated
    leaf's copies summed) against the whole gradients, within the
    same."""
    from repro_torch.models import layers as L

    cfg = configs.get_reduced(arch)
    oc = topt.OptConfig(**OPT)
    one = _state(cfg, oc)
    ms, _ = _on_mesh(_state(cfg, oc), _cpu_mesh((1, 2)))
    b = TP.batch(cfg, 2, 32)
    loss, _ = tts.loss_fn(one.params, cfg, b)
    loss.backward()
    params = ms.params
    work = [params.coord_model(i) for i in (0, 1)]
    denoms = tts.ce_divisors(b["labels"], 2, "cpu")
    tts.group_pass(work[0], cfg, b, 0, 2, 2, denoms, tp=L.ModelAxis(work))
    coords = dist.mesh_coords(params.mesh)
    split = 0
    for n, p in one.params.named_parameters():
        x = params.tensors[n]
        tol = GRAD_TOL * float(p.grad.abs().max())
        if tuple(work[0].get_parameter(n).shape) == tuple(x.shape):
            continue                     # replicated: the copies' sum below
        split += 1
        for i, w in enumerate(work):
            g = w.get_parameter(n).grad
            idx = tts.model_block(x.shape, x.sharding, coords[i])
            assert float((g - p.grad[idx]).abs().max()) <= tol, n
    assert split >= 6 * cfg.n_layers
    whole = tts.model_axis_grads(work, params.tensors, coords, "cpu")
    for n, p in one.params.named_parameters():
        assert whole[n].shape == p.grad.shape
        assert float((whole[n] - p.grad).abs().max()) <= \
            GRAD_TOL * float(p.grad.abs().max()), n


def test_moe_mesh_step():
    """grok-1 reduced: on (1, 2) bitwise the one-device step; on (4, 2)
    the batch splits over 4 groups, and the step raises."""
    cfg = configs.get_reduced("grok_1_314b")
    oc = topt.OptConfig(**OPT)
    b = TP.batch(cfg, 4, 32)
    one = _state(cfg, oc)
    ms, p_shard = _on_mesh(_state(cfg, oc), _cpu_mesh((1, 2)))
    one, m1 = tts.make_train_step(cfg, oc)(one, b)
    ms, m2 = tts.make_train_step(cfg, oc, param_shardings=p_shard)(ms, b)
    assert float(m1["aux"]) > 0 and float(m1["loss"]) == float(m2["loss"])
    _leaves_equal(TP.port_leaves(ms), TP.port_leaves(one))
    wide, p_wide = _on_mesh(_state(cfg, oc), _cpu_mesh((4, 2)))
    with pytest.raises(NotImplementedError, match="14k"):
        tts.make_train_step(cfg, oc, param_shardings=p_wide)(wide, b)


def test_state_from_jax_lands_on_a_mesh():
    """``convert.train_state_from_jax`` onto a (4, 2) mesh state: every
    leaf, gathered, bitwise the JAX state's (int8 moments and the
    compression error too)."""
    for opt_kw, compress in ((None, False),
                             ({"state_dtype": "int8", "q_block": 64}, True)):
        jcfg, cfg, jo, to, js, _ = TP.states("spadas_trajlm", opt_kw,
                                             compress=compress)
        ms, _ = _on_mesh(_state(cfg, to, seed=4, compress=compress),
                         _cpu_mesh((4, 2)))
        got = convert.train_state_from_jax(jax.tree.map(np.asarray, js), ms)
        _leaves_equal(TP.port_leaves(got), TP.jax_leaves(js))


def test_resume_on_a_mesh_is_bitwise(tmp_path):
    cfg = configs.get_reduced("spadas_trajlm")
    oc = topt.OptConfig(**OPT)
    mesh = _cpu_mesh((4, 2))
    ms, p_shard = _on_mesh(_state(cfg, oc), mesh)
    step = tts.make_train_step(cfg, oc, param_shardings=p_shard)
    pipe = _pipe(cfg)
    for _ in range(3):
        ms, _ = step(ms, pipe.next_batch())
    ckpt.save(tmp_path, 3, ms, extra={"pipeline": pipe.state.as_dict()})
    want = []
    for _ in range(3):
        ms, m = step(ms, pipe.next_batch())
        want.append(float(m["loss"]))
    fresh, _ = _on_mesh(_state(cfg, oc, seed=11), mesh)
    restored, extra = ckpt.restore(tmp_path, fresh)
    assert int(restored.step) == 3
    pipe2 = _pipe(cfg, tok.PipelineState.from_dict(extra["pipeline"]))
    got = []
    for _ in range(3):
        restored, m = step(restored, pipe2.next_batch())
        got.append(float(m["loss"]))
    assert got == want
    _leaves_equal(TP.port_leaves(restored), TP.port_leaves(ms))


@pytest.mark.parametrize("opt_kw,compress", [(None, False),
                                             ({"state_dtype": "int8"}, True)],
                         ids=["fp32", "int8_compress"])
def test_checkpoints_cross_between_one_device_and_a_mesh(tmp_path, opt_kw,
                                                         compress):
    cfg = configs.get_reduced("spadas_trajlm")
    oc = topt.OptConfig(**OPT, **(opt_kw or {}))
    mesh = _cpu_mesh((4, 2))
    one = _state(cfg, oc, compress=compress)
    step = tts.make_train_step(cfg, oc, compress=compress)
    pipe = _pipe(cfg)
    for _ in range(2):
        one, _ = step(one, pipe.next_batch())
    ckpt.save(tmp_path / "one", 2, one)
    like, p_shard = _on_mesh(_state(cfg, oc, seed=5, compress=compress),
                             mesh)
    onto_mesh, _ = ckpt.restore(tmp_path / "one", like)
    _leaves_equal(TP.port_leaves(onto_mesh), TP.port_leaves(one))
    # a one-device like placed by shardings= on restore
    placed, _ = ckpt.restore(tmp_path / "one", _state(
        cfg, oc, seed=6, compress=compress), shardings=p_shard)
    assert placed.params.mesh == mesh
    _leaves_equal(TP.port_leaves(placed), TP.port_leaves(one))
    # and back: the mesh state steps on, is saved, restores on one device
    mstep = tts.make_train_step(cfg, oc, compress=compress,
                                param_shardings=p_shard)
    b = pipe.next_batch()
    onto_mesh, _ = mstep(onto_mesh, b)
    ckpt.save(tmp_path / "mesh", 3, onto_mesh)
    back, _ = ckpt.restore(tmp_path / "mesh", _state(cfg, oc, seed=8,
                                                     compress=compress))
    assert not convert.on_mesh(back)
    _leaves_equal(TP.port_leaves(back), TP.port_leaves(onto_mesh))
    back, m = step(back, pipe.next_batch())
    assert np.isfinite(float(m["loss"]))


def test_async_snapshot_of_a_mesh_state_is_a_copy(tmp_path, monkeypatch):
    cfg = configs.get_reduced("spadas_trajlm")
    oc = topt.OptConfig(**OPT)
    ms, p_shard = _on_mesh(_state(cfg, oc), _cpu_mesh((4, 2)))
    step = tts.make_train_step(cfg, oc, param_shardings=p_shard)
    pipe = _pipe(cfg)
    ms, _ = step(ms, pipe.next_batch())
    want = TP.port_leaves(ms)
    release, write = threading.Event(), ckpt._write

    def held_write(*args):
        assert release.wait(60)
        return write(*args)

    monkeypatch.setattr(ckpt, "_write", held_write)
    saver = ckpt.AsyncSaver()
    saver.save(tmp_path, 1, ms)
    for _ in range(2):
        ms, _ = step(ms, pipe.next_batch())
    release.set()
    saver.wait()
    restored, _ = ckpt.restore(tmp_path, _state(cfg, oc, seed=9))
    _leaves_equal(TP.port_leaves(restored), want)


def test_remesh_after_device_losses_steps_on():
    """8 devices in (4, 2), 2 lost: the plan keeps model = 2 and shrinks
    data to 3; the state moved by ``reshard_tree`` keeps every leaf, and
    its step (batch 8 over 3 groups: computed once, over the model axis)
    is within ``TP_RTOL`` of the one-device step from the same state, its
    params within ``INT8_OVER_SHARE`` (a first AdamW step moves each
    element by about lr times the sign of its gradient: 1.0 % of them
    flip under the bf16 sums), its new moments within ``_state_close``'s
    bounds."""
    cfg = configs.get_reduced("spadas_trajlm")
    oc = topt.OptConfig(**OPT, state_dtype="int8", q_block=64)
    devices = [torch.device("cpu")] * 8
    mesh = mesh_lib.make_test_mesh(devices=devices)
    ms, p_shard = _on_mesh(_state(cfg, oc), mesh)
    pipe = _pipe(cfg)
    ms, _ = tts.make_train_step(cfg, oc, param_shardings=p_shard)(
        ms, pipe.next_batch())
    plan = elastic.plan_remesh(mesh.shape, failed=2)
    assert plan.new_shape == {"data": 3, "model": 2}
    survivors = devices[:6]
    new_mesh = elastic.make_mesh_from_plan(plan, survivors)
    new_shard = sh.param_shardings(ms.params.tensors, new_mesh)
    before = TP.port_leaves(ms)
    moved = elastic.reshard_tree(ms, new_shard)
    assert moved.params.mesh == new_mesh
    assert len(moved.params.tensors["embed.table"].shards) == 6
    _leaves_equal(TP.port_leaves(moved), before)
    one = elastic.reshard_tree(moved, "cpu")
    assert not convert.on_mesh(one)
    b = pipe.next_batch()
    moved, m2 = tts.make_train_step(cfg, oc, param_shardings=new_shard)(
        moved, b)
    one, m1 = tts.make_train_step(cfg, oc)(one, b)
    _metrics_close(m1, m2)
    got, want = TP.port_leaves(moved), TP.port_leaves(one)
    _params_close(got, want, OPT["lr"], INT8_OVER_SHARE)
    _state_close(got, want)
    # the dict form: tensors and Sharded arrays onto new shardings
    d = elastic.reshard_tree({"w": ms.params.tensors["embed.table"]},
                             {"w": new_shard["embed.table"]})
    assert torch.equal(dist.gather(d["w"]),
                       dist.gather(ms.params.tensors["embed.table"]))


def test_trainer_on_the_test_mesh(tmp_path, capsys):
    run = train.run(SMALL + ["--mesh", "test", "--steps", "4",
                             "--ckpt-every", "2",
                             "--ckpt-dir", str(tmp_path)])
    assert "Spadas curated" in capsys.readouterr().out
    assert len(run.losses) == 4 and all(np.isfinite(run.losses))
    assert run.state.params.mesh.shape == {"data": 4, "model": 2}
    assert int(run.state.step) == 4
    steps = sorted(d.name for d in (tmp_path / "spadas-trajlm").iterdir())
    assert steps == ["step_00000002", "step_00000004"]
    one = train.run(SMALL + ["--steps", "4", "--ckpt-dir",
                             str(tmp_path / "one")])
    np.testing.assert_allclose(run.losses, one.losses, atol=LOSS_ATOL,
                               rtol=0)
    resumed = train.main(SMALL + ["--mesh", "test", "--steps", "4",
                                  "--ckpt-dir", str(tmp_path), "--resume"])
    assert resumed == []          # the run ended at step 4: nothing to do


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_trainer_on_the_production_meshes(tmp_path, mesh):
    args = SMALL[:-2] + ["--steps", "1", "--ckpt-dir", str(tmp_path)]
    run = train.run(args + ["--mesh", mesh])
    n = 256 if mesh == "single" else 512
    assert len(run.state.params.mesh.flat) == n
    one = train.run(args)
    assert abs(run.losses[0] - one.losses[0]) <= LOSS_ATOL


def test_trainer_mesh_needs_devices(tmp_path):
    """No device list and no card: the mesh is the visible cards, none;
    a list shorter than the mesh raises, naming ``devices=``."""
    args = SMALL[2:] + ["--mesh", "test", "--ckpt-dir", str(tmp_path)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.run(args)
    with pytest.raises(ValueError, match="devices="):
        train.run(args, devices=["cpu"] * 4)


def test_trainer_grid_mesh(tmp_path):
    """``--mesh DxM``: a (data, model) grid of any extents over that many
    entries of the CPU, training over the model axis; other forms are
    refused by the parser."""
    mesh = train.make_mesh("1x4", "cpu")
    assert mesh.shape == {"data": 1, "model": 4}
    assert mesh.flat == [torch.device("cpu")] * 4
    assert train.parse_args(["--mesh", "2x3"]).mesh == "2x3"
    with pytest.raises(SystemExit):
        train.parse_args(["--mesh", "4by2"])
    run = train.run(SMALL[:-2] + ["--steps", "2", "--mesh", "1x4",
                                  "--ckpt-dir", str(tmp_path)])
    assert run.state.params.mesh.shape == {"data": 1, "model": 4}
    assert tts.computes_on_model_axis(run.state.params.cfg,
                                      run.state.params.mesh)
    assert len(run.losses) == 2 and all(np.isfinite(run.losses))

"""The training slice as a whole on the CPU: the port's train step against
the JAX package's over ten steps, and the trainer
``repro_torch.launch.train`` (curation, checkpoints, ``--resume``) with
the examples that call it.

* Ten steps of the reduced spadas_trajlm from the JAX state carried
  across, fed the same token batches (the trainer's pipeline: a curated
  lake tokenized), lr 1e-3 after 5 warm-up steps: each step's loss within
  2e-3 of the JAX one (5x the largest gap seen, 3.8e-4; the loss falls by
  ~0.4 over the ten steps, so the runs move).
* The trainer on the CPU: curation runs (``curate`` on the device it is
  given), the checkpoints land every ``--ckpt-every`` steps in the JAX
  layout, and a run stopped at step 3 and resumed with ``--resume`` gives
  the uninterrupted run's losses for steps 4-6 (bitwise on the CPU; held
  to ``rtol=1e-5``, the JAX package's crash-resume bound).
"""
import json
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_train_parity as TP
from repro_torch.launch import train
from repro_torch.train import train_step as tts
from torch_lm_parity import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--reduced", "--batch", "2", "--seq", "64",
         "--lake-size", "24", "--log-every", "1"]


def test_ten_steps_track_jax():
    jcfg, cfg, jo, to, js, st = TP.states(
        "spadas_trajlm", {"lr": 1e-3, "warmup_steps": 5})
    pipe = train.build_pipeline(cfg, train.parse_args(
        ["--reduced", "--lake-size", "24", "--batch", "4", "--seq", "64"]),
        "cpu")
    jstep, tstep = TP.jax_step(jcfg, jo), tts.make_train_step(cfg, to)
    jl, tl = [], []
    for _ in range(10):
        b = pipe.next_batch()
        js, jm = jstep(js, jax.tree.map(jnp.asarray, b))
        st, tm = tstep(st, b)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, atol=2e-3, rtol=0)
    assert np.mean(tl[-3:]) < np.mean(tl[:3]) - 0.1
    assert int(st.step) == 10


def test_trainer_curates_checkpoints_and_resumes(tmp_path, capsys):
    whole = train.run(SMALL + ["--steps", "6", "--ckpt-every", "3",
                               "--ckpt-dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert "Spadas curated" in out and "[train] step 6 loss=" in out
    assert len(whole.losses) == len(whole.step_s) == 6
    assert all(np.isfinite(whole.losses)) and int(whole.state.step) == 6
    run_dir = tmp_path / "a" / "spadas-trajlm"
    assert sorted(d.name for d in run_dir.iterdir()) == [
        "step_00000003", "step_00000006"]
    manifest = json.loads((run_dir / "step_00000003" / "manifest.json")
                          .read_text())
    assert manifest["extra"]["step"] == 3
    assert manifest["extra"]["pipeline"]["cursor"] > 0
    assert ".params/blocks/0/attn/wq" in manifest["leaves"]

    first = train.main(SMALL + ["--steps", "3", "--ckpt-every", "3",
                                "--ckpt-dir", str(tmp_path / "b")])
    resumed = train.main(SMALL + ["--steps", "6", "--ckpt-every", "3",
                                  "--ckpt-dir", str(tmp_path / "b"),
                                  "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert first == whole.losses[:3]
    np.testing.assert_allclose(resumed, whole.losses[3:], rtol=1e-5)


def test_trainer_compress_grads_and_synthetic_corpus(tmp_path):
    """--compress-grads on the trajectory LM, and a config without the
    curated pipeline (a synthetic corpus of token ids)."""
    losses = train.main(SMALL + ["--steps", "2", "--compress-grads",
                                 "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 2 and all(np.isfinite(losses))
    losses = train.main(["--device", "cpu", "--reduced", "--arch",
                         "mamba2_780m", "--batch", "2", "--seq", "64",
                         "--steps", "2", "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_trainer_refuses_what_it_cannot_run(tmp_path):
    with pytest.raises(ValueError, match="devices="):
        train.run(SMALL + ["--mesh", "test", "--ckpt-dir", str(tmp_path)],
                  devices=["cpu"] * 4)
    for arch in ("musicgen_medium", "llama3_2_vision_11b"):
        with pytest.raises(ValueError, match="token ids only"):
            train.main(["--device", "cpu", "--reduced", "--arch", arch,
                        "--steps", "1", "--ckpt-dir", str(tmp_path)])


def test_examples_on_cpu(tmp_path, monkeypatch):
    """``examples/data_discovery_torch.py`` and
    ``examples/train_lm_torch.py`` (3 steps of the reduced LM; the example
    checks that the loss fell), run from a scratch directory, where the
    example writes its checkpoints."""
    monkeypatch.chdir(tmp_path)
    disc = runpy.run_path(str(REPO / "examples" / "data_discovery_torch.py"))
    selected, info, pipe = disc["main"](["--device", "cpu"])
    assert selected[0] == 0 and info["deduped_away"] >= 1
    assert pipe.next_batch()["tokens"].shape == (4, 128)
    ex = runpy.run_path(str(REPO / "examples" / "train_lm_torch.py"))
    losses = ex["main"](["--device", "cpu", "--steps", "3"])
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert (tmp_path / "results" / "ckpt_example" / "spadas-trajlm"
            / "step_00000003" / "COMMITTED").exists()

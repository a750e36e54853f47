"""Step-atomic checkpoints in the JAX package's layout (no external deps).

Counterpart of ``repro.checkpoint.ckpt``, writing and reading the same
files, so that a checkpoint written by either package restores in the
other:

  <dir>/step_<N>/
    manifest.json     — leaf shapes and dtypes, int8 moments' shapes,
                        the caller's extra (data-pipeline cursor, step)
    shard_<i>.npz     — flat leaf arrays (numpy), chunked by size
    COMMITTED         — atomic commit marker (written last)

The leaves of a port ``TrainState`` are written under the JAX keys, block
leaves stacked over the repeats (``repro_torch.models.convert``); any
other tree is a nested dict of tensors (or QTensors) whose keys are
joined with "/".  Properties, as in the JAX package:

  * step-atomic: the step is written into ``.tmp_step_<N>`` and renamed
    once its COMMITTED marker is in; ``restore`` takes the newest
    committed step;
  * elastic: arrays are logical (whole), so a restore puts them on any
    device (``devices=``) or mesh (``shardings=``); a state on a mesh
    saves its leaves gathered whole, so a checkpoint written on a mesh
    restores on one device and the reverse;
  * async: ``AsyncSaver`` copies the state to the host on the caller's
    thread, then writes in a background thread while training goes on.

The port updates its tensors in place, so the snapshot is a real copy
(``.to("cpu", copy=True)``; ``.cpu()`` of a CPU tensor is the tensor
itself) and, for a tensor on the card, a blocking one: it waits for the
step's work and no later step can reach the written values.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import convert
from repro_torch.train.optimizer import QTensor
from repro_torch.train.train_step import TrainState, reshard_state

_MAX_SHARD_BYTES = 1 << 30


def _leaves(tree) -> dict:
    """key -> tensor or QTensor, the JAX package's keys for a
    ``TrainState``, "/"-joined dict keys otherwise."""
    if isinstance(tree, TrainState):
        return convert.state_leaves(tree)
    return convert.tree_leaves(tree)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _snapshot(tree) -> dict:
    """Host copies of every leaf: key -> numpy array, or a QTensor of
    numpy arrays.  Blocks until a card's tensors are copied."""
    out = {}
    for key, leaf in _leaves(tree).items():
        if isinstance(leaf, QTensor):
            out[key] = QTensor(_host(leaf.codes), _host(leaf.scales),
                               tuple(leaf.shape))
        else:
            out[key] = _host(leaf)
    return out


def _write(ckpt_dir: Path, step: int, host: dict, extra: dict | None) -> Path:
    step_dir = ckpt_dir / f"step_{step:08d}"
    tmp_dir = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp_dir.exists():
        shutil.rmtree(tmp_dir)
    tmp_dir.mkdir(parents=True)

    manifest: dict[str, Any] = {"step": step, "extra": extra or {},
                                "leaves": {}, "qtensors": {}}
    shard_idx, shard_bytes, shard_buf = 0, 0, {}

    def flush():
        nonlocal shard_idx, shard_bytes, shard_buf
        if shard_buf:
            np.savez(tmp_dir / f"shard_{shard_idx}.npz", **shard_buf)
            shard_idx += 1
            shard_bytes, shard_buf = 0, {}

    def add(key, a):
        nonlocal shard_bytes
        manifest["leaves"][key] = {
            "shard": shard_idx, "shape": list(a.shape), "dtype": str(a.dtype)}
        shard_buf[key.replace("/", "__")] = a
        shard_bytes += a.nbytes
        if shard_bytes > _MAX_SHARD_BYTES:
            flush()

    for key, leaf in host.items():
        if isinstance(leaf, QTensor):
            manifest["qtensors"][key] = {"shape": list(leaf.shape)}
            add(key + "/codes", leaf.codes)
            add(key + "/scales", leaf.scales)
        else:
            add(key, leaf)
    flush()

    (tmp_dir / "manifest.json").write_text(json.dumps(manifest))
    (tmp_dir / "COMMITTED").write_text(str(time.time()))
    if step_dir.exists():
        shutil.rmtree(step_dir)
    tmp_dir.rename(step_dir)
    return step_dir


def save(ckpt_dir: str | Path, step: int, tree: Any,
         extra: dict | None = None) -> Path:
    """Synchronous save with atomic commit; returns the step's
    directory."""
    return _write(Path(ckpt_dir), step, _snapshot(tree), extra)


class AsyncSaver:
    """Snapshot to the host, then a background write; at most one in
    flight.  ``save`` returns once the snapshot is taken."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def _run(self, *args):
        try:
            _write(*args)
        except BaseException as e:      # re-raised by wait()
            self._error = e

    def save(self, ckpt_dir, step, tree, extra=None):
        self.wait()
        host = _snapshot(tree)
        self._thread = threading.Thread(
            target=self._run, args=(Path(ckpt_dir), step, host, extra),
            daemon=True)
        self._thread.start()

    def wait(self):
        """Wait for the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for d in ckpt_dir.iterdir():
        if d.name.startswith("step_") and (d / "COMMITTED").exists():
            steps.append(int(d.name.split("_")[1]))
    return max(steps) if steps else None


def _device_of(devices):
    """The device a restore puts the state on: ``devices`` itself, or the
    first of a list (a mesh's lead device)."""
    if devices is None:
        return None
    if isinstance(devices, (list, tuple)):
        devices = devices[0]
    return resolve_device(devices)


def _rebuild(like, get, dev, path=()):
    """``like``'s nested dicts with every tensor / QTensor leaf read."""
    key = "/".join(path)
    if isinstance(like, dict):
        return {k: _rebuild(v, get, dev, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, QTensor):
        return QTensor(*(torch.from_numpy(get(f"{key}/{part}").copy()).to(
            dev or getattr(like, part).device)
            for part in ("codes", "scales")), like.shape)
    return torch.from_numpy(np.array(get(key))).to(dev or like.device)


def restore(ckpt_dir: str | Path, tree_like: Any, step: int | None = None,
            devices=None, shardings: dict | None = None) -> tuple[Any, dict]:
    """Restore into the structure of ``tree_like``: a port ``TrainState``
    (its model is overwritten in place, see
    ``convert.load_state``; on a mesh, its blocks) or a nested dict of
    tensors.  The leaves go to ``devices`` (a device, or a list whose
    first device takes the state), else where ``tree_like``'s lie.  With
    ``shardings`` (param name -> NamedSharding) the restored
    ``TrainState`` is placed by them on their mesh, whether ``tree_like``
    is on one device or on a mesh.  Returns (tree, extra)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    step_dir = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    shards: dict[int, Any] = {}

    def get(key):
        info = manifest["leaves"][key]
        si = info["shard"]
        if si not in shards:
            shards[si] = np.load(step_dir / f"shard_{si}.npz")
        return shards[si][key.replace("/", "__")]

    dev = _device_of(devices)
    try:
        if isinstance(tree_like, TrainState):
            tree = convert.load_state(tree_like, get, dev)
        else:
            tree = _rebuild(tree_like, get, dev)
    finally:
        for f in shards.values():
            f.close()
    if shardings is not None:
        tree = reshard_state(tree, shardings)
    return tree, manifest["extra"]

"""Elastic scaling + failure handling.

Counterpart of ``repro.runtime.elastic``.  After device losses the job
resumes on the surviving devices from the last committed checkpoint,
which stores logical (unsharded) arrays, so moving a state onto the new
devices needs no format migration.

``plan_remesh`` is a copy of the JAX package's: it computes the next mesh
after excluding failed devices, keeping the model axis intact (tensor
parallelism needs a full ring) and shrinking the data/pod axes, which only
changes the gradient all-reduce span; the per-device batch is rescaled to
keep the global batch.  ``make_mesh_from_plan`` lays the plan over a
device list as a :class:`repro_torch.core.distributed.Mesh`, and
``reshard_tree`` moves a state onto the new mesh's shardings (or onto one
device), so that ``plan_remesh`` -> ``make_mesh_from_plan`` ->
``reshard_tree`` resumes training on the survivors.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.distributed import (Mesh, Sharded, gather, grid_mesh,
                                          place)
from repro_torch.device import resolve_device
from repro_torch.models import convert
from repro_torch.train import train_step as ts


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    old_shape: dict
    new_shape: dict
    lost_devices: int
    per_device_batch_factor: float  # batch rescale to keep global batch

    @property
    def new_axis_sizes(self) -> tuple:
        return tuple(self.new_shape.values())


def plan_remesh(mesh_shape: dict, failed: int) -> RemeshPlan:
    """Shrink the mesh after `failed` device losses.

    Policy: keep 'model' intact; round ('pod' x 'data') DOWN to the largest
    size expressible as pod' x data' with pod' in {1, .., pod}."""
    model = mesh_shape.get("model", 1)
    pod = mesh_shape.get("pod", 1)
    data = mesh_shape.get("data", 1)
    total_replicas = pod * data
    avail = pod * data * model - failed
    max_replicas = avail // model
    if max_replicas < 1:
        raise RuntimeError("not enough devices for one model replica")
    # prefer keeping pod structure if possible
    best = None
    for p in range(pod, 0, -1):
        d = max_replicas // p
        if d >= 1:
            best = (p, d)
            break
    new = {}
    if "pod" in mesh_shape:
        new["pod"] = best[0]
    new["data"] = best[1]
    new["model"] = model
    new_replicas = best[0] * best[1]
    return RemeshPlan(
        old_shape=dict(mesh_shape),
        new_shape=new,
        lost_devices=failed,
        per_device_batch_factor=total_replicas / new_replicas,
    )


def make_mesh_from_plan(plan: RemeshPlan, devices: list) -> Mesh:
    """The plan's mesh over the first devices of ``devices`` (row-major:
    the last axis varies fastest); fewer devices than the plan needs
    raise."""
    return grid_mesh(plan.new_axis_sizes, tuple(plan.new_shape), devices,
                     "make_mesh_from_plan")


def reshard_tree(tree, new_shardings):
    """Move a state onto the new mesh's shardings, as the JAX package's
    ``device_put`` with shardings derived for the new mesh does:

      * a ``TrainState`` (on one device or on a mesh) and ``new_shardings``
        its param shardings (name -> NamedSharding): the state placed by
        them (``train_step.reshard_state``);
      * a dict of tensors or Sharded arrays, and a dict of NamedShardings
        with the same keys: each leaf gathered whole and placed;
      * any tree and a device: every leaf moved onto that one device
        (tensors, a QTensor's codes and scales among them, are copied
        there, a module is moved in place, a mesh state is gathered
        there); dicts, lists, tuples and NamedTuples keep their
        structure."""
    if isinstance(new_shardings, dict):
        if isinstance(tree, ts.TrainState):
            return ts.reshard_state(tree, new_shardings)
        return {k: place(gather(x) if isinstance(x, Sharded) else x,
                         new_shardings[k]) for k, x in tree.items()}
    dev = resolve_device(new_shardings)
    if isinstance(tree, ts.TrainState) and convert.on_mesh(tree):
        return ts.unshard_state(tree, dev)
    if isinstance(tree, nn.Module):
        return tree.to(dev)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: reshard_tree(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(reshard_tree(x, dev) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(reshard_tree(x, dev) for x in tree)
    return tree

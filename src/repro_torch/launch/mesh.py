"""Device meshes: the trainer's test and production grids, and the
serving mesh.

Counterpart of ``repro.launch.mesh``.  A mesh is a named grid of devices
(``repro_torch.core.distributed.Mesh``) over the visible cards, or over
``devices`` where the caller lists them (``["cpu"] * 8`` in the tests,
``["cuda:0"] * 8`` to hold eight coordinates on one card).  A list
shorter than the mesh raises; it never yields a smaller mesh.

  test        (data=4, model=2), or (pod=2, data=2, model=2)
  production  (data=16, model=16) = 256 devices, or
              (pod=2, data=16, model=16) = 512
  grid        (data=D, model=M), any extents
"""
from __future__ import annotations

from repro_torch.core.distributed import grid_mesh, visible_cards

#: extents by ``multi_pod``
PRODUCTION_SHAPES = {False: (16, 16), True: (2, 16, 16)}
TEST_SHAPES = {False: (4, 2), True: (2, 2, 2)}


def _mesh(shape, multi_pod: bool, devices, what: str):
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = visible_cards() if devices is None else list(devices)
    return grid_mesh(shape, axes, devs, what)


def make_production_mesh(*, multi_pod: bool = False, devices=None):
    return _mesh(PRODUCTION_SHAPES[multi_pod], multi_pod, devices,
                 "make_production_mesh")


def make_test_mesh(*, multi_pod: bool = False, devices=None):
    """Small mesh of 8 devices (same axis names)."""
    return _mesh(TEST_SHAPES[multi_pod], multi_pod, devices,
                 "make_test_mesh")


def make_grid_mesh(data: int, model: int, devices=None):
    """A (data, model) mesh of any extents, the axis names of the test
    and production meshes."""
    return _mesh((data, model), False, devices, "make_grid_mesh")


def make_serving_mesh(n_replicas: int = 1, n_data: int | None = None,
                      devices=None):
    """(replica, data) mesh for the search serving stack: an alias of
    :func:`repro_torch.engine.replicated.replica_mesh`, so launch scripts
    build serving meshes without importing engine internals.  Over the
    visible cards unless ``devices`` lists others; ``n_data=None`` spreads
    the data axis over the rest."""
    from repro_torch.engine.replicated import replica_mesh

    return replica_mesh(n_replicas, n_data, devices)

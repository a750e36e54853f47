"""Serving meshes.

Counterpart of the serving part of ``repro.launch.mesh``
(``make_serving_mesh``); the JAX package's TPU dry-run meshes belong to
the LM stack and are not ported here.
"""
from __future__ import annotations


def make_serving_mesh(n_replicas: int = 1, n_data: int | None = None,
                      devices=None):
    """(replica, data) mesh for the search serving stack: an alias of
    :func:`repro_torch.engine.replicated.replica_mesh`, so launch scripts
    build serving meshes without importing engine internals.  Over the
    visible cards unless ``devices`` lists others; ``n_data=None`` spreads
    the data axis over the rest."""
    from repro_torch.engine.replicated import replica_mesh

    return replica_mesh(n_replicas, n_data, devices)

"""Logical-axis sharding rules for model internals.

Counterpart of ``repro.models.sharding_rules``: layers there annotate
activations with LOGICAL axis names (``shard(x, "batch", "seq", None)``),
and a process-global rule table set by the launcher maps each name to
physical mesh axes.  The port's layers carry no annotations (the eager
modules run whole on one device); the rule table and the spec that
``shard`` constrains to are kept, so that a mesh step splits its work as
the JAX constraints do: :func:`spec_for` is that spec, and the mesh train
step splits its batch by ``spec_for(shape, "batch", "seq")``, the
constraint the JAX embedding puts on its output.

The ``tp`` name places compute too: the mesh train step of a config
whose blocks are all ``attn`` splits attention heads, the SwiGLU
``d_ff`` and the vocabulary over the axis it maps to (``model``), where
``spec_for`` splits them (``models.layers``' ``*_tp`` pieces).  The
``kv``, ``expert``, ``seq`` and ``kvseq`` names resolve, but no compute
uses them (ROADMAP item 14k).
"""
from __future__ import annotations

import math

from repro_torch.core.distributed import Mesh, PartitionSpec as P, spec_axes

# default rule table: logical name -> physical mesh axis (or None)
_RULES: dict[str, object] = {
    "batch": ("pod", "data"),   # data parallel over pod x data
    "fsdp": "data",             # parameter shard axis (ZeRO-3)
    "tp": "model",              # tensor parallel (heads / ffn / vocab)
    "seq": None,                # sequence axis (set to "model" for SP)
    "expert": None,             # expert axis ("model" under EP)
    "kv": None,                 # kv-heads axis
    "kvseq": None,              # cache time axis ("model" for long contexts)
}


def set_rules(**kw) -> None:
    _RULES.update(kw)


def get_rules() -> dict:
    return dict(_RULES)


def logical_to_spec(axes: tuple) -> P:
    return P(*(None if a is None else _RULES.get(a) for a in axes))


# the active mesh, set by the launcher (launch/train.py)
_MESH: Mesh | None = None


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


def spec_for(shape, *axes, mesh: Mesh | None = None) -> P | None:
    """The spec JAX's ``shard(x, *axes)`` constrains an array of
    ``shape`` to on ``mesh`` (the active mesh by default), or None where
    there is no mesh (no constraint).  Each logical name maps by the
    rules; a tuple of axes keeps the ones the mesh has; an axis that does
    not divide its dim is dropped (replicated); where two names map to
    one mesh axis, the first keeps it and the later ones replicate."""
    mesh = _MESH if mesh is None else mesh
    if mesh is None:
        return None
    names, sizes = mesh.axis_names, mesh.shape
    phys = []
    for a in axes:
        m = None if a is None else _RULES.get(a)
        if isinstance(m, tuple):
            m = tuple(ax for ax in m if ax in names) or None
        elif m is not None and m not in names:
            m = None
        phys.append(m)
    phys = [None if m is not None and shape[i] % math.prod(
        sizes[a] for a in spec_axes(m)) else m for i, m in enumerate(phys)]
    used: set = set()
    deduped = []
    for m in phys:
        axes_of = spec_axes(m)
        if any(a in used for a in axes_of):
            deduped.append(None)
            continue
        used.update(axes_of)
        deduped.append(m)
    return P(*deduped)

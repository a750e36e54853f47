"""Parameter, state and batch shardings from the JAX package's rules.

Counterpart of ``repro.launch.sharding``, rule for rule:
  * params: TP over 'model' on the head/ffn/vocab dim, FSDP (ZeRO-3) over
    'data' on the other dim; replicated where a dim does not divide;
  * optimizer moments mirror the param shardings (int8 codes: the
    param's last-axis split moves to the blocks dim);
  * batch: ('pod', 'data') on the batch dim; KV caches likewise, with the
    time axis sharded over 'model' for the long-context cells.

The rules key off the JAX package's leaf PATHS.  A port parameter maps to
its JAX leaf by ``models.convert.jax_key``; a block leaf is stacked over
the pattern's repeats there, with the repeat dim never split, so the
port's per-repeat tensor takes the JAX spec without its first entry.

The placement itself (``place``, ``gather``, the spec and sharding types)
is in ``repro_torch.core.distributed`` and is re-exported here.
``cache_sharding`` places the decode caches of the dry-run's serving
cells (``launch/specs.py``).
"""
from __future__ import annotations

import math
import re

from repro_torch.core.distributed import (  # noqa: F401  (re-exported)
    Mesh, NamedSharding, PartitionSpec as P, Sharded, gather, gather_tree,
    place, place_tree, spec_axes, tree_bytes)
from repro_torch.models.convert import leaf_groups
from repro_torch.train.optimizer import QTensor

# (regex on '/'-joined path) -> spec for the LAST ndim dims of the leaf.
# Leading stacked dims (scan repeats) are always replicated (None).
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed/table$",            ("model", "data")),   # (vocab, d)
    (r"head/table$",             ("model", "data")),
    (r"(wq|wk|wv)$",             ("data", "model")),   # (d, heads*hd)
    (r"wo$",                     ("model", "data")),   # (heads*hd, d)
    (r"(wg|wu)$",                ("data", "model")),   # (d, ff) [+E lead]
    (r"wd$",                     ("model", "data")),   # (ff, d) [+E lead]
    (r"router$",                 ("data", None)),
    (r"in_proj$",                ("data", "model")),
    (r"out_proj$",               ("model", "data")),
    (r"conv_w$",                 (None, "model")),
    (r"conv_b$",                 ("model",)),
    (r"(A_log|D|dt_bias)$",      ("model",)),
    (r"(norm_scale|scale|xgate)$", (None,)),
]

_MOE_LEAF = re.compile(r"moe/(wg|wu|wd)$")


def _divisible(dim: int, mesh: Mesh, axis) -> bool:
    return dim % math.prod(mesh.shape[a] for a in spec_axes(axis)) == 0


def spec_for_param(path_s: str, shape: tuple, mesh: Mesh,
                   rules: dict | None = None) -> P:
    """PartitionSpec for one JAX param leaf; replicates non-divisible
    dims."""
    rules = rules or {}
    expert_axis = rules.get("expert")  # None (TP-MoE) or "model" (EP)
    no_fsdp = rules.get("no_fsdp", False)  # serving: params TP-only resident
    for pat, tail in _PARAM_RULES:
        if re.search(pat, path_s):
            tail = list(tail)
            if no_fsdp:
                tail = [None if t == "data" else t for t in tail]
            if _MOE_LEAF.search(path_s):
                if expert_axis == "model":
                    # EP: experts over model; drop model from the tail
                    tail = [None if t == "model" else t for t in tail]
                    tail = [expert_axis] + tail
                else:
                    tail = [None] + tail
            ndim = len(shape)
            full = ([None] * (ndim - len(tail)) + tail)[:ndim]
            # replicate any axis that doesn't divide
            full = [a if _divisible(shape[i], mesh, a) else None
                    for i, a in enumerate(full)]
            return P(*full)
    return P()  # replicate by default (norm scales, scalars)


def _qtensor_specs(parent: P, q: QTensor, mesh: Mesh) -> tuple:
    """(codes spec, scales spec) of an int8 state whose param has spec
    ``parent``: lead dims keep it; the param's last-axis split moves to
    the n_blocks dim (when it divides), the block dim stays local."""
    tail = list(parent) + [None] * (len(q.shape) - len(parent))
    nb = q.codes.shape[-2]
    last = tail[-1] if _divisible(nb, mesh, tail[-1]) else None
    return P(*tail[:-1], last, None), P(*tail[:-1], last)


def param_shardings(params: dict, mesh: Mesh,
                    rules: dict | None = None) -> dict:
    """NamedShardings for a dict of the port's parameter names (params,
    float32 moments or error feedback: tensors of any device, ``meta``
    too; int8 moments: QTensors, which get a QTensor of the codes' and
    the scales' shardings).  Each name takes the spec of its JAX leaf
    (stacked over the repeats for a block parameter), without the repeat
    dim."""
    out = {}
    for key, names in leaf_groups(params).items():
        stacked = key.startswith("blocks/")
        lead = (len(names),) if stacked else ()
        for n in names:
            leaf = params[n]
            shape = lead + tuple(leaf.shape)
            spec = spec_for_param(key, shape, mesh, rules)
            if isinstance(leaf, QTensor):
                specs = _qtensor_specs(spec, leaf._replace(shape=shape), mesh)
                if stacked:
                    specs = tuple(P(*s[1:]) for s in specs)
                out[n] = QTensor(NamedSharding(mesh, specs[0]),
                                 NamedSharding(mesh, specs[1]), leaf.shape)
            else:
                out[n] = NamedSharding(mesh, P(*spec[1:]) if stacked
                                       else spec)
    return out


def moment_sharding(param_sharding: NamedSharding, q: QTensor) -> QTensor:
    """The shardings of an int8 state ``q`` whose param is placed by
    ``param_sharding`` (what :func:`param_shardings` gives it)."""
    mesh = param_sharding.mesh
    c, s = _qtensor_specs(param_sharding.spec, q, mesh)
    return QTensor(NamedSharding(mesh, c), NamedSharding(mesh, s), q.shape)


def batch_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def spec_for_batch_leaf(shape: tuple, mesh: Mesh) -> P:
    """Batch-dim sharding for an input leaf, replicate if non-divisible."""
    ba = batch_axes(mesh)
    size = math.prod(mesh.shape[a] for a in ba)
    if shape and shape[0] % size == 0 and shape[0] > 0:
        return P(ba, *([None] * (len(shape) - 1)))
    return P(*([None] * len(shape)))



def cache_sharding(shape: tuple, mesh: Mesh, *, shard_time: bool) -> P:
    """KV cache (R, B, T, KH, hd) / SSM state (R, B, H, P, N) sharding:
    the batch axes on B where they divide; on a 5-d leaf the model axis on
    the time axis (``shard_time``, where it divides and T exceeds it) or
    else on the kv heads; on a 4-d leaf (int8 KV scales (R, B, T, KH),
    conv state (R, B, W-1, C)) likewise on dim 2 or else dim 3."""
    ba = batch_axes(mesh)
    bsz = math.prod(mesh.shape[a] for a in ba)
    b_ax = ba if (len(shape) > 1 and shape[1] % bsz == 0) else None
    spec = [None, b_ax] + [None] * (len(shape) - 2)
    if len(shape) in (4, 5):
        m = mesh.shape["model"]
        if shard_time and shape[2] % m == 0 and shape[2] > m:
            spec[2] = "model"
        elif shape[3] % m == 0:
            spec[3] = "model"
    return P(*spec)

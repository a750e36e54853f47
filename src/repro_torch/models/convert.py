"""The JAX package's LM parameters as the port's state dict.

``params_from_jax`` takes the parameter pytree of
``repro.models.model.init_params`` with numpy leaves
(``jax.tree.map(numpy.asarray, params)``): ``blocks`` is a tuple over the
pattern positions of dicts whose leaves are stacked ``(n_repeats, ...)``.
It returns the state dict of
:class:`~repro_torch.models.model.LanguageModel`, whose block at repeat r
and pattern position i is ``blocks.{r}.{i}`` with the JAX names below it,
so that both packages compute with the same weights in the tests.

The training side is mapped too.  A port parameter ``blocks.{r}.{i}.<path>``
is repeat r of the JAX leaf ``blocks/{i}/<path>`` (stacked over the
repeats); any other ``a.b`` is ``a/b`` (:func:`jax_key`).  On that mapping
rest :func:`state_leaves` and :func:`load_state`, which read and fill a
port ``TrainState`` under the JAX package's checkpoint keys
(``.params/...``, ``.opt/.m/...``, ``.opt/.v/...``, ``.opt/.count``,
``.err/...``, ``.step``; an int8 moment ``<key>/codes`` and
``<key>/scales``), so that a checkpoint written by either package
restores in the other, and :func:`train_state_from_jax`, which carries a
JAX ``TrainState`` (numpy leaves) into the port.  A state on a mesh reads
and fills the same keys: its leaves are gathered whole, or read whole and
placed by its shardings.  Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core.distributed import (Sharded, gather, gather_tree,
                                          place_tree, tree_shardings, write)
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import QTensor


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _leaves(tree, prefix=""):
    """(dotted path, leaf) of a nested dict, in its order."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def params_from_jax(params, cfg: ModelConfig) -> dict:
    """State dict (CPU float32 tensors) for ``LanguageModel(cfg)``."""
    sd = {"final_norm.scale": _t(params["final_norm"]["scale"])}
    if cfg.embed_input:
        sd["embed.table"] = _t(params["embed"]["table"])
    if not cfg.tie_embeddings:
        sd["head.table"] = _t(params["head"]["table"])
    blocks = params["blocks"]
    if len(blocks) != len(cfg.block_pattern):
        raise ValueError(f"{cfg.name}: {len(blocks)} pattern positions in "
                         f"the parameters, {len(cfg.block_pattern)} in the "
                         f"config")
    for i, pos in enumerate(blocks):
        for path, leaf in _leaves(pos):
            for r in range(cfg.n_repeats):
                sd[f"blocks.{r}.{i}.{path}"] = _t(leaf[r])
    return sd


# ---------------------------------------------------------------------------
# the training state under the JAX package's names
# ---------------------------------------------------------------------------


def jax_key(name: str) -> tuple[str, int | None]:
    """A port parameter name -> (its JAX leaf's key, the repeat it is of
    that stacked leaf, or None for a leaf outside the blocks)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return "/".join(["blocks", parts[2], *parts[3:]]), int(parts[1])
    return "/".join(parts), None


def leaf_groups(names) -> dict:
    """JAX leaf key -> the port names that make it, repeats in order."""
    groups: dict = {}
    for name in names:
        key, r = jax_key(name)
        names_of = groups.setdefault(key, [])
        if r is not None and r != len(names_of):
            raise ValueError(f"{name}: repeat {r} out of order")
        names_of.append(name)
    return groups


def jax_ranks(params: dict) -> dict:
    """name -> the rank of the parameter's leaf in the JAX tree: a block
    parameter has the repeat axis in front."""
    return {n: p.ndim + (jax_key(n)[1] is not None)
            for n, p in params.items()}


def _stacked(key: str, parts: list):
    """The JAX leaf ``key`` from its per-repeat parts (a QTensor's codes
    and scales stacked alike; blocking is along the last axis)."""
    if not key.startswith("blocks/"):
        return parts[0]
    if isinstance(parts[0], QTensor):
        return QTensor(torch.stack([q.codes for q in parts]),
                       torch.stack([q.scales for q in parts]),
                       (len(parts),) + tuple(parts[0].shape))
    return torch.stack(parts)


def on_mesh(state) -> bool:
    """Whether a port ``TrainState`` is held on a mesh (its ``params`` a
    ``train_step.MeshParams``, not the model itself)."""
    return not isinstance(state.params, nn.Module)


def state_leaves(state) -> dict:
    """Every leaf of a port ``TrainState`` under its JAX checkpoint key,
    block leaves stacked over the repeats (new tensors; the others are the
    state's own).  A state on a mesh gives the same leaves, each gathered
    whole onto the mesh's lead device."""
    if on_mesh(state):
        params = {n: gather(x) for n, x in state.params.tensors.items()}
        m, v = gather_tree(state.opt.m), gather_tree(state.opt.v)
        err = None if state.err is None else gather_tree(state.err)
    else:
        params = {n: p.detach() for n, p in state.params.named_parameters()}
        m, v, err = state.opt.m, state.opt.v, state.err
    groups = leaf_groups(params)
    out = {}

    def put(prefix, tree):
        for key, names in groups.items():
            out[prefix + key] = _stacked(key, [tree[n] for n in names])

    put(".params/", params)
    put(".opt/.m/", m)
    put(".opt/.v/", v)
    out[".opt/.count"] = state.opt.count
    if err is not None:
        put(".err/", err)
    out[".step"] = state.step
    return out


def _tensor(a, like, dev, what: str) -> torch.Tensor:
    """``a`` as a tensor on ``dev`` of ``like``'s dtype (``like``: a
    tensor, or a Sharded array, whose whole shape ``a`` must have)."""
    a = np.asarray(a)
    if tuple(a.shape) != tuple(like.shape):
        raise ValueError(f"{what}: shape {a.shape}, expected "
                         f"{tuple(like.shape)}")
    dtype = like.shards[0].dtype if isinstance(like, Sharded) else like.dtype
    return torch.from_numpy(a.copy()).to(device=dev, dtype=dtype)


def load_state(like, get, device=None):
    """``like`` (a port ``TrainState``) filled from ``get(key)``, which
    returns the numpy array of a JAX checkpoint key.  The model of
    ``like`` is moved to the device (``device``, else where it lies) and
    its parameters overwritten in place; the other leaves are new tensors
    there, of ``like``'s structure (float32 or int8 moments, error
    feedback or none).  A ``like`` on a mesh keeps its mesh and
    shardings: each leaf is read whole on the host and placed (its
    parameters' blocks overwritten in place; ``device`` is not used).  A
    missing key raises ``KeyError``, a shape that differs
    ``ValueError``."""
    mesh = on_mesh(like)
    if mesh:
        dev = torch.device("cpu")
        params = like.params.tensors
    else:
        model = like.params
        dev = torch.device(device) if device is not None else model.device
        model.to(dev)
        params = dict(model.named_parameters())
    groups = leaf_groups(params)

    def repeats(a, key, names):
        if len(a) != len(names):
            raise ValueError(f"{key}: {len(a)} repeats, expected "
                             f"{len(names)}")
        return a

    def read(prefix, tree):
        out = {}
        for key, names in groups.items():
            stacked = key.startswith("blocks/")
            first = tree[names[0]]
            if isinstance(first, QTensor):
                codes = get(prefix + key + "/codes")
                scales = get(prefix + key + "/scales")
                if stacked:
                    repeats(codes, prefix + key, names)
                for r, n in enumerate(names):
                    q = tree[n]
                    out[n] = QTensor(
                        _tensor(codes[r] if stacked else codes, q.codes, dev,
                                prefix + key + "/codes"),
                        _tensor(scales[r] if stacked else scales, q.scales,
                                dev, prefix + key + "/scales"), q.shape)
            else:
                a = get(prefix + key)
                if stacked:
                    repeats(a, prefix + key, names)
                for r, n in enumerate(names):
                    out[n] = _tensor(a[r] if stacked else a, tree[n], dev,
                                     prefix + key)
        return out

    if mesh:
        lead = like.step.device

        def placed(prefix, tree):
            return place_tree(read(prefix, tree), tree_shardings(tree))

        with torch.no_grad():
            for n, t in read(".params/", params).items():
                write(params[n], t)
        opt = like.opt._replace(
            m=placed(".opt/.m/", like.opt.m), v=placed(".opt/.v/", like.opt.v),
            count=_tensor(get(".opt/.count"), like.opt.count, lead,
                          ".opt/.count"))
        err = None if like.err is None else placed(".err/", like.err)
        return like._replace(opt=opt, err=err, step=_tensor(
            get(".step"), like.step, lead, ".step"))
    with torch.no_grad():
        for n, t in read(".params/", params).items():
            params[n].copy_(t)
    opt = like.opt._replace(
        m=read(".opt/.m/", like.opt.m), v=read(".opt/.v/", like.opt.v),
        count=_tensor(get(".opt/.count"), like.opt.count, dev, ".opt/.count"))
    err = None if like.err is None else read(".err/", like.err)
    return like._replace(params=model, opt=opt, err=err,
                         step=_tensor(get(".step"), like.step, dev, ".step"))


def tree_leaves(tree, prefix: str = "") -> dict:
    """The leaves of a nested tree of dicts, tuples and NamedTuples (the
    JAX package's pytrees with numpy leaves) under the keys its
    checkpoint gives them: dict keys in sorted order, tuple indices, and
    a NamedTuple's fields as ``.field``, joined with "/"; None has no
    leaf, and a QTensor is one leaf."""
    out = {}

    def walk(x, path):
        if x is None:
            return
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            if {"codes", "scales"} <= set(x._fields):      # a QTensor
                out["/".join(path)] = x
                return
            for f in x._fields:
                walk(getattr(x, f), path + ["." + f])
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], path + [str(k)])
        elif isinstance(x, (tuple, list)):
            for i, y in enumerate(x):
                walk(y, path + [str(i)])
        else:
            out["/".join(path)] = x

    walk(tree, [prefix] if prefix else [])
    return out


def _getter(leaves: dict):
    """``get(key)`` over ``tree_leaves``' output: a QTensor leaf answers
    for ``<key>/codes`` and ``<key>/scales``."""
    def get(key):
        if key in leaves:
            return np.asarray(leaves[key])
        base, part = key.rsplit("/", 1)
        return np.asarray(getattr(leaves[base], part))
    return get


def train_state_from_jax(jax_state, like, device=None):
    """A JAX ``TrainState`` (``jax.tree.map(numpy.asarray, state)``) as a
    port ``TrainState`` of ``like``'s structure (see :func:`load_state`):
    parameters, moments (float32, or int8 codes and scales), ``count``,
    the compression error and ``step``."""
    return load_state(like, _getter(tree_leaves(jax_state)), device)

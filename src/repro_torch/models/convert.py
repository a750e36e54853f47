"""The JAX package's LM parameters as the port's state dict.

``params_from_jax`` takes the parameter pytree of
``repro.models.model.init_params`` with numpy leaves
(``jax.tree.map(numpy.asarray, params)``): ``blocks`` is a tuple over the
pattern positions of dicts whose leaves are stacked ``(n_repeats, ...)``.
It returns the state dict of
:class:`~repro_torch.models.model.LanguageModel`, whose block at repeat r
and pattern position i is ``blocks.{r}.{i}`` with the JAX names below it,
so that both packages compute with the same weights in the tests.
Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


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

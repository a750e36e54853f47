"""The JAX package's LM parameters as the port's state dict.

``params_from_jax`` takes the parameter pytree of
``repro.models.model.init_params`` with numpy leaves
(``jax.tree.map(numpy.asarray, params)``): per pattern position a dict
stacked ``(n_repeats, ...)``.  It returns the state dict of
:class:`~repro_torch.models.model.LanguageModel`, so that both packages
compute with the same weights in the tests.  Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import check_supported


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def params_from_jax(params, cfg: ModelConfig) -> dict:
    """State dict (CPU float32 tensors) for ``LanguageModel(cfg)``."""
    check_supported(cfg)
    sd = {"embed.table": _t(params["embed"]["table"]),
          "final_norm.scale": _t(params["final_norm"]["scale"])}
    if not cfg.tie_embeddings:
        sd["head.table"] = _t(params["head"]["table"])
    (blocks,) = params["blocks"]          # one pattern position: ATTN
    for r in range(cfg.n_repeats):
        sd[f"blocks.{r}.ln1.scale"] = _t(blocks["ln1"]["scale"][r])
        for w in ("wq", "wk", "wv", "wo"):
            sd[f"blocks.{r}.attn.{w}"] = _t(blocks["attn"][w][r])
        if cfg.d_ff > 0:
            sd[f"blocks.{r}.ln2.scale"] = _t(blocks["ln2"]["scale"][r])
            for w in ("wg", "wu", "wd"):
                sd[f"blocks.{r}.mlp.{w}"] = _t(blocks["mlp"][w][r])
    return sd

"""Assigned architecture configs (one module per arch) + registry.

A copy of ``repro.configs`` whose modules build the port's own
:class:`~repro_torch.models.config.ModelConfig`, so that the port imports
nothing of the JAX package.  The port's model
(``repro_torch.models.model``) serves every one of them.

Every config is from public literature; the ``[source]`` tag from the
assignment is recorded in each module.  ``get(name)`` returns the full
config; ``get_reduced(name)`` returns the same-family shrunken config used
by the CPU smoke tests (few layers/width/experts, tiny vocab).
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = [
    "mamba2_780m",
    "grok_1_314b",
    "arctic_480b",
    "internlm2_20b",
    "yi_9b",
    "llama3_8b",
    "deepseek_coder_33b",
    "musicgen_medium",
    "jamba_v0_1_52b",
    "llama3_2_vision_11b",
    "spadas_trajlm",          # paper-native: trajectory LM over spatial data
]


def normalize(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{normalize(name)}")
    return mod.CONFIG


def get_reduced(name: str):
    mod = importlib.import_module(f"repro_torch.configs.{normalize(name)}")
    return mod.reduced()


def all_configs():
    return {a: get(a) for a in ARCH_IDS}

"""Spadas on PyTorch: the unified multi-granularity spatial index and its
dataset and point searches (RangeS, top-k IA, GBO, ApproHaus and ExactHaus;
RangeP, NNP; dataset->point pipelines), on NVIDIA H100s: one card, or a
mesh of devices whose shards each hold a slice of the repository.

A port of the JAX package ``repro`` that keeps its module layout, so each
function here has a counterpart of the same name there.  It imports
``torch`` and numpy only.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; the CPU path runs the plain PyTorch versions of
the kernels and exists for tests.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]

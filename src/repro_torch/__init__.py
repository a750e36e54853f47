"""Spadas on PyTorch: the unified multi-granularity spatial index and its
dataset and point searches (RangeS, top-k IA, GBO, ApproHaus and ExactHaus;
RangeP, NNP; dataset->point pipelines), on one NVIDIA H100.

A port of the JAX package ``repro`` that keeps its module layout, so each
function here has a counterpart of the same name there.  It imports
``torch`` and numpy only.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; the CPU path runs the plain PyTorch versions of
the kernels and exists for tests.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]

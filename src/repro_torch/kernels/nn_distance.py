"""Wrapper of the per-point nearest-neighbour CUDA kernel.

Counterpart of ``repro.kernels.nn_distance`` (the Pallas ``_nn_kernel``),
with the sqrt and query mask of ``repro.kernels.ops.nn_distance`` fused in.
Takes CUDA tensors only and raises on anything else;
``repro_torch.kernels.ops.nn_distance`` routes CPU tensors to the plain
version.  Source: ``repro_torch/csrc/nn_distance.cu``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hausdorff import MAX_COORDS, _stream, check_cuda


def nn_distance(q: torch.Tensor, d: torch.Tensor, q_valid: torch.Tensor,
                d_valid: torch.Tensor):
    """Nearest valid D point of every Q point: q (nq, W), d (nd, W) float32,
    q_valid (nq,), d_valid (nd,) bool -> (dists (nq,) float32, idx (nq,)
    int32); first index on ties, 0.0 and -1 for an invalid Q row."""
    f32, b8 = torch.float32, torch.bool
    dev = check_cuda("nn_distance",
                     {"q": q, "d": d, "q_valid": q_valid, "d_valid": d_valid},
                     {"q": f32, "d": f32, "q_valid": b8, "d_valid": b8})
    nq, W = q.shape
    nd = d.shape[0]
    if (d.shape != (nd, W) or q_valid.shape != (nq,)
            or d_valid.shape != (nd,) or not 1 <= W <= MAX_COORDS
            or min(nq, nd) < 1):
        raise ValueError(f"nn_distance: shapes q {tuple(q.shape)}, "
                         f"d {tuple(d.shape)}, q_valid "
                         f"{tuple(q_valid.shape)}, d_valid "
                         f"{tuple(d_valid.shape)}")
    dist = torch.empty((nq,), dtype=f32, device=dev)
    idx = torch.empty((nq,), dtype=torch.int32, device=dev)
    fn = _build.kernel("nn_distance")
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), d.data_ptr(), q_valid.data_ptr(),
                d_valid.data_ptr(), nq, nd, W, dist.data_ptr(),
                idx.data_ptr(), _stream(dev))
    _build.launched("nn_distance", rc)
    return dist, idx

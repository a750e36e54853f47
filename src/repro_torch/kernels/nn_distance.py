"""Wrapper of the per-point nearest-neighbour CUDA kernel.

Counterpart of ``repro.kernels.nn_distance`` (the Pallas ``_nn_kernel``),
with the sqrt and query mask of ``repro.kernels.ops.nn_distance`` fused in.
``nn_distance_batched`` is the kernel with the pair axis that
``repro.kernels.ops.nn_distance_batched`` (a vmap) gives it, one launch for
P (query, dataset) pairs; ``nn_distance`` is one pair of it.  Takes CUDA
tensors only and raises on anything else; ``repro_torch.kernels.ops``
routes CPU tensors to the plain version.  Source:
``repro_torch/csrc/nn_distance.cu``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hausdorff import (MAX_COORDS, MAX_GRID_Y,
                                           PAIR_ROWS_PER_BLOCK, _stream,
                                           check_cuda)


def nn_distance_batched(qs: torch.Tensor, ds: torch.Tensor,
                        qs_valid: torch.Tensor, ds_valid: torch.Tensor):
    """Nearest valid D_p point of every Q_p point, for P pairs, one launch:
    qs (P, nq, W), ds (P, nd, W) float32, qs_valid (P, nq), ds_valid
    (P, nd) bool -> (dists (P, nq) float32, idx (P, nq) int32); first
    index on ties, 0.0 and -1 for an invalid Q row."""
    f32, b8 = torch.float32, torch.bool
    dev = check_cuda("nn_distance",
                     {"qs": qs, "ds": ds, "qs_valid": qs_valid,
                      "ds_valid": ds_valid},
                     {"qs": f32, "ds": f32, "qs_valid": b8, "ds_valid": b8})
    P, nq, W = qs.shape
    nd = ds.shape[1]
    if (ds.shape != (P, nd, W) or qs_valid.shape != (P, nq)
            or ds_valid.shape != (P, nd) or not 1 <= W <= MAX_COORDS
            or min(P, nq, nd) < 1 or nq > MAX_GRID_Y * PAIR_ROWS_PER_BLOCK):
        raise ValueError(f"nn_distance: shapes qs {tuple(qs.shape)}, "
                         f"ds {tuple(ds.shape)}, qs_valid "
                         f"{tuple(qs_valid.shape)}, ds_valid "
                         f"{tuple(ds_valid.shape)}")
    dist = torch.empty((P, nq), dtype=f32, device=dev)
    idx = torch.empty((P, nq), dtype=torch.int32, device=dev)
    fn = _build.kernel("nn_distance")
    with torch.cuda.device(dev):
        rc = fn(qs.data_ptr(), qs_valid.data_ptr(), ds.data_ptr(),
                ds_valid.data_ptr(), P, nq, nd, W, dist.data_ptr(),
                idx.data_ptr(), _stream(dev))
    _build.launched("nn_distance", rc)
    return dist, idx


def nn_distance(q: torch.Tensor, d: torch.Tensor, q_valid: torch.Tensor,
                d_valid: torch.Tensor):
    """Nearest valid D point of every Q point: q (nq, W), d (nd, W) float32,
    q_valid (nq,), d_valid (nd,) bool -> (dists (nq,) float32, idx (nq,)
    int32).  The JAX package's signature; one pair of
    ``nn_distance_batched``."""
    dist, idx = nn_distance_batched(q[None], d[None], q_valid[None],
                                    d_valid[None])
    return dist[0], idx[0]

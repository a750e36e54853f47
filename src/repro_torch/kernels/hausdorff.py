"""Wrappers of the two directed-Hausdorff CUDA kernels.

Counterparts of ``repro.kernels.hausdorff``: ``min_sq_dists`` replaces the
Pallas ``_min_dist_kernel`` (one (Q, D) pair), ``hausdorff_grid`` replaces
``_min_dist_grid_kernel`` with the epilogue of ``ops.directed_hausdorff_grid``
fused in (one launch per ExactHaus phase-2 chunk).  Both take CUDA tensors
only and raise on anything else; ``repro_torch.kernels.ops`` routes CPU
tensors to the plain versions.  Sources: ``repro_torch/csrc/``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_COORDS = 8


def check_cuda(name: str, tensors: dict, dtypes: dict) -> torch.device:
    """Check what a kernel takes: contiguous CUDA tensors of the stated
    dtypes on one device.  Returns that device."""
    dev = None
    for key, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} must be a CUDA tensor, "
                             f"got {t.device}")
        if t.dtype != dtypes[key]:
            raise ValueError(f"{name}: {key} must be {dtypes[key]}, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def min_sq_dists(q: torch.Tensor, d: torch.Tensor,
                 d_valid: torch.Tensor) -> torch.Tensor:
    """Per-Q-row min squared distance to any valid D row.

    q (nq, W), d (nd, W) float32, d_valid (nd,) bool -> (nq,) float32,
    BIG where D has no valid row."""
    f32, b8 = torch.float32, torch.bool
    dev = check_cuda("min_sq_dists", {"q": q, "d": d, "d_valid": d_valid},
                     {"q": f32, "d": f32, "d_valid": b8})
    nq, W = q.shape
    nd = d.shape[0]
    if d.shape != (nd, W) or d_valid.shape != (nd,) or not 1 <= W <= MAX_COORDS:
        raise ValueError(f"min_sq_dists: shapes q {tuple(q.shape)}, "
                         f"d {tuple(d.shape)}, d_valid {tuple(d_valid.shape)}")
    out = torch.empty((nq,), dtype=f32, device=dev)
    fn = _build.kernel("min_sq_dists")
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), d.data_ptr(), d_valid.data_ptr(), nq, nd, W,
                out.data_ptr(), _stream(dev))
    _build.launched("min_sq_dists", rc)
    return out


def hausdorff_grid(q: torch.Tensor, ds: torch.Tensor, q_valid: torch.Tensor,
                   ds_valid: torch.Tensor) -> torch.Tensor:
    """H(Q_b -> D_{b,c}) for every pair of a (B, C) grid, one launch.

    q (B, nq, W), ds (B, C, nd, W) float32; q_valid (B, nq), ds_valid
    (B, C, nd) bool -> (B, C) float32."""
    f32, b8 = torch.float32, torch.bool
    dev = check_cuda("hausdorff_grid",
                     {"q": q, "ds": ds, "q_valid": q_valid,
                      "ds_valid": ds_valid},
                     {"q": f32, "ds": f32, "q_valid": b8, "ds_valid": b8})
    B, C, nd, W = ds.shape
    nq = q.shape[1]
    if (q.shape != (B, nq, W) or q_valid.shape != (B, nq)
            or ds_valid.shape != (B, C, nd) or not 1 <= W <= MAX_COORDS):
        raise ValueError(
            f"hausdorff_grid: shapes q {tuple(q.shape)}, ds {tuple(ds.shape)}"
            f", q_valid {tuple(q_valid.shape)}, "
            f"ds_valid {tuple(ds_valid.shape)}")
    out = torch.empty((B, C), dtype=f32, device=dev)
    fn = _build.kernel("hausdorff_grid")
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), q_valid.data_ptr(), ds.data_ptr(),
                ds_valid.data_ptr(), B, C, nq, nd, W, out.data_ptr(),
                _stream(dev))
    _build.launched("hausdorff_grid", rc)
    return out

"""Wrapper of the fused multi-level Eq. 4 bound-grid CUDA kernel.

Counterpart of ``repro.kernels.bound_matrix.bound_grid`` (the Pallas
``_bound_grid_kernel``).  Takes CUDA tensors only and raises on anything
else; ``repro_torch.kernels.ops.bound_grid`` routes CPU tensors to the plain
version.  Source: ``repro_torch/csrc/bound_grid.cu``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hausdorff import _stream, check_cuda

MAX_LEVELS = 32


def bound_grid(oq, rq, q_ok, od, rd, d_ok, *, levels):
    """Per-level (LB, UB), each (L, B, S) float32, for query trees
    oq (B, N, W) / rq, q_ok (B, N) against corpus trees od (S, N, W) /
    rd, d_ok (S, N); ``levels`` is a tuple of (start, stop) node slices
    inside [0, N)."""
    f32, b8 = torch.float32, torch.bool
    dev = check_cuda("bound_grid",
                     {"oq": oq, "rq": rq, "q_ok": q_ok, "od": od, "rd": rd,
                      "d_ok": d_ok},
                     {"oq": f32, "rq": f32, "q_ok": b8, "od": f32,
                      "rd": f32, "d_ok": b8})
    B, N, W = oq.shape
    S = od.shape[0]
    L = len(levels)
    if (rq.shape != (B, N) or q_ok.shape != (B, N) or od.shape != (S, N, W)
            or rd.shape != (S, N) or d_ok.shape != (S, N)):
        raise ValueError(f"bound_grid: shapes oq {tuple(oq.shape)}, "
                         f"od {tuple(od.shape)}")
    if not 1 <= L <= MAX_LEVELS or any(
            not 0 <= a < b <= N for a, b in levels):
        raise ValueError(f"bound_grid: bad levels {levels} for N={N}")
    starts = (ctypes.c_int * L)(*[a for a, _ in levels])
    stops = (ctypes.c_int * L)(*[b for _, b in levels])
    LB = torch.empty((L, B, S), dtype=f32, device=dev)
    UB = torch.empty((L, B, S), dtype=f32, device=dev)
    fn = _build.kernel("bound_grid")
    with torch.cuda.device(dev):
        rc = fn(oq.data_ptr(), rq.data_ptr(), q_ok.data_ptr(), od.data_ptr(),
                rd.data_ptr(), d_ok.data_ptr(), ctypes.addressof(starts),
                ctypes.addressof(stops), L, B, S, N, W, LB.data_ptr(),
                UB.data_ptr(), _stream(dev))
    _build.launched("bound_grid", rc)
    return LB, UB

"""Wrappers of the Eq. 4 bound CUDA kernels.

Counterparts of ``repro.kernels.bound_matrix``: ``bound_grid`` replaces the
Pallas ``_bound_grid_kernel`` (fused multi-level bounds for every
(query, slot) pair), ``bound_matrices`` replaces ``_bound_kernel`` (the
(lb, ub) matrices between two node frontiers), batched over pairs, and
``bound_row_ub`` is the same kernel's arithmetic fused with the pruned
NNP's masked row min, so only the (P, nq) row bounds are written.  All
take CUDA tensors only and raise on anything else;
``repro_torch.kernels.ops`` routes CPU tensors to the plain versions.
Sources: ``repro_torch/csrc/bound_grid.cu``, ``bound_matrices.cu``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, autotune
from repro_torch.kernels.hausdorff import MAX_COORDS, _stream, check_cuda

MAX_LEVELS = 32
MAX_GRID_YZ = 65535
#: query rows one block of the matrix form covers (kMatRows in the source)
MATRIX_ROWS = 16


def bound_grid(oq, rq, q_ok, od, rd, d_ok, *, levels, config=None):
    """Per-level (LB, UB), each (L, B, S) float32, for query trees
    oq (B, N, W) / rq, q_ok (B, N) against corpus trees od (S, N, W) /
    rd, d_ok (S, N); ``levels`` is a tuple of (start, stop) node slices
    inside [0, N).  The launch shape is ``config``, else the table's for
    (B, S) on this device (``autotune.resolve``)."""
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
            or rd.shape != (S, N) or d_ok.shape != (S, N)
            or not 1 <= W <= MAX_COORDS):
        raise ValueError(f"bound_grid: shapes oq {tuple(oq.shape)}, "
                         f"od {tuple(od.shape)}")
    if not 1 <= L <= MAX_LEVELS or any(
            not 0 <= a < b <= N for a, b in levels):
        raise ValueError(f"bound_grid: bad levels {levels} for N={N}")
    cfg = autotune.resolve("bound_grid", (B, S), dev, config)
    starts = (ctypes.c_int * L)(*[a for a, _ in levels])
    stops = (ctypes.c_int * L)(*[b for _, b in levels])
    LB = torch.empty((L, B, S), dtype=f32, device=dev)
    UB = torch.empty((L, B, S), dtype=f32, device=dev)
    fn = _build.kernel("bound_grid")
    with torch.cuda.device(dev):
        rc = fn(oq.data_ptr(), rq.data_ptr(), q_ok.data_ptr(), od.data_ptr(),
                rd.data_ptr(), d_ok.data_ptr(), ctypes.addressof(starts),
                ctypes.addressof(stops), L, B, S, N, W,
                autotune.variant("bound_grid", cfg), LB.data_ptr(),
                UB.data_ptr(), _stream(dev))
    _build.launched("bound_grid", rc)
    return LB, UB


def _check_frontiers(name, oq, rq, od, rd, extra=None):
    """Check two batches of node frontiers, oq (P, nq, W) / rq (P, nq)
    and od (P, nd, W) / rd (P, nd), plus ``extra`` tensors and dtypes.
    Returns (device, P, nq, nd, W)."""
    f32 = torch.float32
    tensors = {"oq": oq, "rq": rq, "od": od, "rd": rd}
    dtypes = {"oq": f32, "rq": f32, "od": f32, "rd": f32}
    for key, (t, dtype) in (extra or {}).items():
        tensors[key], dtypes[key] = t, dtype
    dev = check_cuda(name, tensors, dtypes)
    P, nq, W = oq.shape
    nd = od.shape[1]
    if (rq.shape != (P, nq) or od.shape != (P, nd, W)
            or rd.shape != (P, nd) or not 1 <= W <= MAX_COORDS
            or min(P, nq, nd) < 1
            or -(-nq // MATRIX_ROWS) > MAX_GRID_YZ):
        raise ValueError(f"{name}: shapes oq {tuple(oq.shape)}, "
                         f"rq {tuple(rq.shape)}, od {tuple(od.shape)}, "
                         f"rd {tuple(rd.shape)}")
    return dev, P, nq, nd, W


def bound_matrices(oq, rq, od, rd, *, with_lb=True):
    """Eq. 4 (lb, ub), each (P, nq, nd) float32, for P pairs of node
    frontiers: oq (P, nq, W) / rq (P, nq) against od (P, nd, W) /
    rd (P, nd).  With ``with_lb=False`` the kernel writes ub only and lb is
    None.  One launch for each ``MAX_GRID_YZ`` pairs (the grid's limit on
    the pair axis)."""
    dev, P, nq, nd, W = _check_frontiers("bound_matrices", oq, rq, od, rd)
    f32 = torch.float32
    lb = torch.empty((P, nq, nd), dtype=f32, device=dev) if with_lb else None
    ub = torch.empty((P, nq, nd), dtype=f32, device=dev)
    fn = _build.kernel("bound_matrices")
    with torch.cuda.device(dev):
        for p0 in range(0, P, MAX_GRID_YZ):
            s = slice(p0, p0 + MAX_GRID_YZ)
            rc = fn(oq[s].data_ptr(), rq[s].data_ptr(), od[s].data_ptr(),
                    rd[s].data_ptr(), min(MAX_GRID_YZ, P - p0), nq, nd, W,
                    lb[s].data_ptr() if with_lb else None, ub[s].data_ptr(),
                    _stream(dev))
            _build.launched("bound_matrices", rc)
    return lb, ub


def bound_row_ub(oq, rq, od, rd, d_ok):
    """(P, nq) float32: for each query node, the least Eq. 4 ub over its
    pair's corpus nodes, an unoccupied one (d_ok (P, nd) bool, False)
    counting as BIG.  One launch; the (P, nq, nd) matrix is never
    stored."""
    dev, P, nq, nd, W = _check_frontiers(
        "bound_row_ub", oq, rq, od, rd, {"d_ok": (d_ok, torch.bool)})
    if d_ok.shape != (P, nd) or P > MAX_GRID_YZ:
        raise ValueError(f"bound_row_ub: shapes d_ok {tuple(d_ok.shape)}, "
                         f"od {tuple(od.shape)}")
    out = torch.empty((P, nq), dtype=torch.float32, device=dev)
    fn = _build.kernel("bound_row_ub")
    with torch.cuda.device(dev):
        rc = fn(oq.data_ptr(), rq.data_ptr(), od.data_ptr(), rd.data_ptr(),
                d_ok.data_ptr(), P, nq, nd, W, out.data_ptr(), _stream(dev))
    _build.launched("bound_row_ub", rc)
    return out

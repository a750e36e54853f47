"""Wrappers of the two directed-Hausdorff CUDA kernels.

Counterparts of ``repro.kernels.hausdorff``: ``min_sq_dists_pairs``
replaces the Pallas ``_min_dist_kernel`` with the pair axis the JAX
oracle's vmap gives it (one query set against P datasets, one launch), and
``min_sq_dists`` is the JAX-shaped one-pair op as one call into it.
``hausdorff_grid`` replaces ``_min_dist_grid_kernel`` with the epilogue of
``ops.directed_hausdorff_grid`` fused in: ``hausdorff_lanes`` evaluates
the live lanes of an ExactHaus phase-2 chunk straight from the resident
corpus (one launch per chunk), and ``hausdorff_grid`` is the JAX-shaped
grid op as one call into it.  The kernel wrappers take CUDA tensors only
and raise on anything else; ``repro_torch.kernels.ops`` routes CPU tensors
to the plain versions.
Sources: ``repro_torch/csrc/``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_COORDS = 8
#: query rows one block of the lanes kernel covers (kRowsPerBlock in
#: csrc/hausdorff_grid.cu); callers round their row count up to it
ROWS_PER_BLOCK = 256
MAX_GRID_Y = 65535
#: query rows one block of the pair kernels covers (kRowsPerBlock in
#: csrc/min_sq_dists.cu and csrc/nn_distance.cu)
PAIR_ROWS_PER_BLOCK = 64


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


def min_sq_dists_pairs(q: torch.Tensor, ds: torch.Tensor,
                       q_valid: torch.Tensor | None,
                       ds_valid: torch.Tensor) -> torch.Tensor:
    """Per-row min squared distance of one query set to each of P datasets,
    one launch.

    q (nq, W) float32 and q_valid (nq,) bool, or None where every row is
    valid; ds (P, nd, W) float32, ds_valid (P, nd) bool -> (P, nq)
    float32: from BIG (BIG where D_p has no valid point), and BIG on
    invalid rows, whose work is skipped."""
    f32, b8 = torch.float32, torch.bool
    tensors = {"q": q, "ds": ds, "ds_valid": ds_valid}
    dtypes = {"q": f32, "ds": f32, "ds_valid": b8, "q_valid": b8}
    if q_valid is not None:
        tensors["q_valid"] = q_valid
    dev = check_cuda("min_sq_dists", tensors, dtypes)
    nq, W = q.shape
    P, nd = ds_valid.shape
    if (ds.shape != (P, nd, W)
            or (q_valid is not None and q_valid.shape != (nq,))
            or not 1 <= W <= MAX_COORDS or min(P, nq, nd) < 1
            or nq > MAX_GRID_Y * PAIR_ROWS_PER_BLOCK):
        raise ValueError(
            f"min_sq_dists: shapes q {tuple(q.shape)}, ds {tuple(ds.shape)}"
            f", q_valid {None if q_valid is None else tuple(q_valid.shape)}"
            f", ds_valid {tuple(ds_valid.shape)}")
    out = torch.empty((P, nq), dtype=f32, device=dev)
    fn = _build.kernel("min_sq_dists")
    with torch.cuda.device(dev):
        rc = fn(q.data_ptr(), 0 if q_valid is None else q_valid.data_ptr(),
                ds.data_ptr(), ds_valid.data_ptr(), P, nq, nd, W,
                out.data_ptr(), _stream(dev))
    _build.launched("min_sq_dists", rc)
    return out


def min_sq_dists(q: torch.Tensor, d: torch.Tensor,
                 d_valid: torch.Tensor) -> torch.Tensor:
    """Per-Q-row min squared distance to any valid D row: q (nq, W), d
    (nd, W) float32, d_valid (nd,) bool -> (nq,) float32, BIG where D has
    no valid row.  The JAX package's signature; one pair of
    ``min_sq_dists_pairs``."""
    return min_sq_dists_pairs(q, d[None], None, d_valid[None])[0]


def compact_rows(q: torch.Tensor, q_valid: torch.Tensor):
    """Each query's valid rows first, in their order: q (B, nq, W), q_valid
    (B, nq) -> (q_c (B, nq, W), n_q (B,) int32), where q_c[b, :n_q[b]] are
    query b's valid rows.  A stable sort, a gather and a count."""
    order = torch.sort((~q_valid).view(torch.uint8), dim=-1,
                       stable=True).indices
    q_c = torch.gather(q, 1, order[..., None].expand(q.shape))
    return q_c, q_valid.sum(dim=-1, dtype=torch.int32)


def valid_extent(valid: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """(S,) int32: one past the last valid point of each slot of
    valid (S, nd), 0 for a slot with none.  Taken ``block`` slots at a
    time, so the reversed copy stays small beside the corpus."""
    nd = valid.shape[-1]
    parts = []
    for v in valid.split(block):
        last = torch.argmax(v.flip(-1).view(torch.uint8), dim=-1)
        parts.append(torch.where(v.any(dim=-1), nd - last, 0))
    return torch.cat(parts).to(torch.int32)


def hausdorff_lanes(q_c: torch.Tensor, n_q: torch.Tensor, pts: torch.Tensor,
                    pts_valid: torch.Tensor, extent: torch.Tensor,
                    ids: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """H(Q_b -> D_{ids[b, c]}) for the live lanes of a (B, C) grid, read
    from the resident corpus, one launch.

    q_c (B, nqp, W) float32 with query b's valid rows first, n_q (B,)
    int32 their counts; pts (S, nd, W) float32, pts_valid (S, nd) bool;
    extent (S,) int32, no valid point of slot s at or past extent[s];
    ids (B, C) int64 slot ids, live (B, C) bool -> (B, C) float32: BIG on
    dead lanes, -BIG on live lanes of a query with no valid row."""
    f32, b8, i32 = torch.float32, torch.bool, torch.int32
    dev = check_cuda("hausdorff_grid",
                     {"q_c": q_c, "n_q": n_q, "pts": pts,
                      "pts_valid": pts_valid, "extent": extent, "ids": ids,
                      "live": live},
                     {"q_c": f32, "n_q": i32, "pts": f32, "pts_valid": b8,
                      "extent": i32, "ids": torch.int64, "live": b8})
    B, nqp, W = q_c.shape
    S, nd = pts_valid.shape
    C = ids.shape[-1]
    if (n_q.shape != (B,) or pts.shape != (S, nd, W)
            or extent.shape != (S,) or ids.shape != (B, C)
            or live.shape != (B, C) or not 1 <= W <= MAX_COORDS
            or min(B, C, nqp, S, nd) < 1
            or nqp > MAX_GRID_Y * ROWS_PER_BLOCK):
        raise ValueError(
            f"hausdorff_grid: shapes q_c {tuple(q_c.shape)}, n_q "
            f"{tuple(n_q.shape)}, pts {tuple(pts.shape)}, pts_valid "
            f"{tuple(pts_valid.shape)}, extent {tuple(extent.shape)}, ids "
            f"{tuple(ids.shape)}, live {tuple(live.shape)}")
    out = torch.empty((B, C), dtype=f32, device=dev)
    fn = _build.kernel("hausdorff_grid")
    with torch.cuda.device(dev):
        rc = fn(q_c.data_ptr(), n_q.data_ptr(), pts.data_ptr(),
                pts_valid.data_ptr(), extent.data_ptr(), ids.data_ptr(),
                live.data_ptr(), B, C, nqp, S, nd, W, out.data_ptr(),
                _stream(dev))
    _build.launched("hausdorff_grid", rc)
    return out


def hausdorff_grid(q: torch.Tensor, ds: torch.Tensor, q_valid: torch.Tensor,
                   ds_valid: torch.Tensor) -> torch.Tensor:
    """H(Q_b -> D_{b,c}) for every pair of a (B, C) grid, one launch of the
    lanes kernel: ds viewed as B * C slots, every lane live.

    q (B, nq, W), ds (B, C, nd, W) float32; q_valid (B, nq), ds_valid
    (B, C, nd) bool -> (B, C) float32."""
    f32, b8 = torch.float32, torch.bool
    check_cuda("hausdorff_grid",
               {"q": q, "ds": ds, "q_valid": q_valid, "ds_valid": ds_valid},
               {"q": f32, "ds": f32, "q_valid": b8, "ds_valid": b8})
    B, C, nd, W = ds.shape
    nq = q.shape[1]
    if (q.shape != (B, nq, W) or q_valid.shape != (B, nq)
            or ds_valid.shape != (B, C, nd) or not 1 <= W <= MAX_COORDS):
        raise ValueError(
            f"hausdorff_grid: shapes q {tuple(q.shape)}, ds {tuple(ds.shape)}"
            f", q_valid {tuple(q_valid.shape)}, "
            f"ds_valid {tuple(ds_valid.shape)}")
    q_c, n_q = compact_rows(q, q_valid)
    pts_valid = ds_valid.reshape(B * C, nd)
    ids = torch.arange(B * C, device=q.device).view(B, C)
    return hausdorff_lanes(q_c, n_q, ds.reshape(B * C, nd, W), pts_valid,
                           valid_extent(pts_valid), ids,
                           torch.ones((B, C), dtype=b8, device=q.device))

"""Wrapper of the GBO popcount(AND) CUDA kernel.

Counterpart of ``repro.kernels.set_intersect`` (the Pallas
``_intersect_kernel``).  Takes CUDA tensors only and raises on anything
else; ``repro_torch.kernels.ops.set_intersect_counts`` routes CPU tensors
to the plain version.  Source: ``repro_torch/csrc/set_intersect.cu``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hausdorff import _stream, check_cuda

#: query rows of one block's tile (``kRows`` in the source)
ROWS = 64
MAX_GRID_Y = 65535


def intersect_counts(sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """(na, nb) int32 totals of popcount(sa[i, w] & sb[j, w]) over the
    words, for signature stacks sa (na, W) and sb (nb, W) of int64 words."""
    i64 = torch.int64
    dev = check_cuda("set_intersect", {"sa": sa, "sb": sb},
                     {"sa": i64, "sb": i64})
    na, W = sa.shape
    nb = sb.shape[0]
    if (sb.shape != (nb, W) or min(na, nb, W) < 1
            or -(-na // ROWS) > MAX_GRID_Y):
        raise ValueError(f"set_intersect: shapes sa {tuple(sa.shape)}, "
                         f"sb {tuple(sb.shape)}")
    out = torch.empty((na, nb), dtype=torch.int32, device=dev)
    fn = _build.kernel("set_intersect")
    with torch.cuda.device(dev):
        rc = fn(sa.data_ptr(), sb.data_ptr(), na, nb, W, out.data_ptr(),
                _stream(dev))
    _build.launched("set_intersect", rc)
    return out

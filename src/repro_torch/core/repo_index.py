"""Upper-level repository index (paper Section V-B).

Counterpart of ``repro.core.repo_index``.  The dataset root nodes of a
repository are organised into the same balanced ball tree as the bottom
level.  Each upper node keeps the Def. 16 tuple: a ball bounding every point
beneath it, the merged MBR, the OR of its children's z-order signatures and
a live count.  The repository is padded to ``B_pad = f_up * 2**depth_up``
slots; ``order`` maps tree slots back to dataset slots.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import index as index_lib
from repro_torch.core.index import DatasetIndex
from repro_torch.kernels.ref import ieee_sqrt


class RepoIndex(NamedTuple):
    order: torch.Tensor     # (B_pad,) int64: tree slot j holds dataset order[j]
    ds_valid: torch.Tensor  # (B_pad,) in tree order
    centers: torch.Tensor   # (n_nodes, d)
    radii: torch.Tensor     # (n_nodes,)
    box_lo: torch.Tensor    # (n_nodes, d)
    box_hi: torch.Tensor    # (n_nodes, d)
    sigs: torch.Tensor      # (n_nodes, W) int64 words holding uint32 values
    counts: torch.Tensor    # (n_nodes,) int32 datasets under each node

    @property
    def depth(self) -> int:
        return int(math.log2(self.centers.shape[-2] + 1)) - 1

    def level_slice(self, level: int) -> slice:
        start = (1 << level) - 1
        return slice(start, start + (1 << level))


def _or_reduce(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over axis 1 of (n, m, W) integer words, by pairwise
    folding (PyTorch has no OR reduction)."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        y = x[:, :h] | x[:, h:2 * h]
        x = torch.cat([y, x[:, 2 * h:]], dim=1) if x.shape[1] % 2 else y
    return x[:, 0]


def depth_for_repo(n_datasets: int, f_up: int) -> int:
    return index_lib.depth_for(n_datasets, f_up)


def build_repo_index(ds_centers, ds_radii, ds_lo, ds_hi, ds_sigs, ds_valid,
                     depth: int) -> RepoIndex:
    """Build the upper tree over B_pad dataset root nodes.

    Inputs are in dataset-slot order; the result is in tree order, with
    ``order`` giving the permutation."""
    B_pad, d = ds_centers.shape
    perm = torch.sort((~ds_valid).to(torch.uint8), stable=True).indices[None]
    for level in range(depth):
        perm = index_lib._split_level(ds_centers[None], ds_valid[None], perm,
                                      level)
    perm = perm[0]
    c, r, lo, hi = ds_centers[perm], ds_radii[perm], ds_lo[perm], ds_hi[perm]
    sg, v = ds_sigs[perm], ds_valid[perm]

    inf = float("inf")
    centers, radii, blos, bhis, sigs, counts = [], [], [], [], [], []
    for level in range(depth + 1):
        nseg = 1 << level
        seg = B_pad >> level
        cs = c.reshape(nseg, seg, d)
        rs = r.reshape(nseg, seg)
        los = lo.reshape(nseg, seg, d)
        his = hi.reshape(nseg, seg, d)
        sgs = sg.reshape(nseg, seg, -1)
        vs = v.reshape(nseg, seg)
        w = vs.to(c.dtype)
        cnt = w.sum(dim=1)
        o = (cs * w[..., None]).sum(dim=1) / torch.clamp_min(cnt, 1.0)[:, None]
        # the ball bounds every point beneath: r = max(|o - o_i| + r_i)
        diff = cs - o[:, None, :]
        di = ieee_sqrt((diff * diff).sum(dim=-1)) + rs
        rr = torch.amax(torch.where(vs, di, 0.0), dim=1)
        l2 = torch.amin(torch.where(vs[..., None], los, inf), dim=1)
        h2 = torch.amax(torch.where(vs[..., None], his, -inf), dim=1)
        ss = _or_reduce(torch.where(vs[..., None], sgs, 0))
        empty = cnt == 0
        o = torch.where(empty[:, None], 0.0, o)
        rr = torch.where(empty, 0.0, rr)
        l2 = torch.where(empty[:, None], inf, l2)
        h2 = torch.where(empty[:, None], -inf, h2)
        centers.append(o)
        radii.append(rr)
        blos.append(l2)
        bhis.append(h2)
        sigs.append(ss)
        counts.append(cnt.to(torch.int32))

    return RepoIndex(order=perm, ds_valid=v, centers=torch.cat(centers),
                     radii=torch.cat(radii), box_lo=torch.cat(blos),
                     box_hi=torch.cat(bhis), sigs=torch.cat(sigs),
                     counts=torch.cat(counts))


class Repository(NamedTuple):
    """The full unified index: batched bottom-level trees plus the upper
    tree.  Dataset arrays are in dataset-slot order; ``repo.order`` maps
    upper-tree slots to dataset slots."""

    ds_index: DatasetIndex      # batched over B_pad (slot order)
    ds_sigs: torch.Tensor       # (B_pad, W) int64 words
    ds_valid: torch.Tensor      # (B_pad,) slot validity
    repo: RepoIndex
    space_lo: torch.Tensor      # (2,) global grid bounds for z-order
    space_hi: torch.Tensor      # (2,)

    @property
    def n_slots(self) -> int:
        return self.ds_sigs.shape[0]

    @property
    def device(self) -> torch.device:
        return self.ds_valid.device

    def roots(self):
        """Per-dataset root stats in slot order: (centers, radii, box_lo,
        box_hi)."""
        idx = self.ds_index
        return (idx.centers[:, 0, :], idx.radii[:, 0], idx.box_lo[:, 0, :],
                idx.box_hi[:, 0, :])

    def nbytes(self) -> int:
        """Bytes of every tensor the repository holds."""
        def tensors(x):
            if isinstance(x, torch.Tensor):
                yield x
            elif isinstance(x, tuple):
                for y in x:
                    yield from tensors(y)
        return sum(t.numel() * t.element_size() for t in tensors(self))

"""End-to-end unified index construction (paper Alg. 1).

Counterpart of ``repro.core.build``.  ``build_repository`` takes raw point
sets and returns a populated :class:`Repository` on the chosen device:
bottom-level balanced ball trees, parameter-free outlier removal, z-order
signatures and the upper tree.  It runs on ``cuda`` unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import index as index_lib
from repro_torch.core import outliers as outliers_lib
from repro_torch.core import repo_index as repo_lib
from repro_torch.core import zorder
from repro_torch.core.index import DatasetIndex
from repro_torch.core.repo_index import Repository
from repro_torch.device import resolve_device


def pad_batch(datasets: Sequence[np.ndarray], leaf_capacity: int,
              depth: int | None = None, *, device=None):
    """Pad a ragged list of (n_i, d) arrays into (B, n_pad, d) points plus
    (B, n_pad) validity on ``device``; one host pad, one upload each."""
    dev = resolve_device(device)
    d = datasets[0].shape[1]
    n_max = max(int(x.shape[0]) for x in datasets)
    if depth is None:
        depth = index_lib.depth_for(n_max, leaf_capacity)
    n_pad = leaf_capacity * (1 << depth)
    B = len(datasets)
    pts = np.zeros((B, n_pad, d), np.float32)
    val = np.zeros((B, n_pad), bool)
    for i, x in enumerate(datasets):
        n = x.shape[0]
        pts[i, :n] = x
        val[i, :n] = True
    return (torch.from_numpy(pts).to(dev), torch.from_numpy(val).to(dev),
            depth)


def build_repository(
    datasets: Sequence[np.ndarray],
    *,
    leaf_capacity: int = 16,
    repo_leaf_capacity: int | None = None,
    theta: int = 5,
    remove_outliers: bool = True,
    device=None,
) -> tuple[Repository, dict]:
    """Construct the unified index over a repository of raw point sets.

    Returns (repository, info); info carries the outlier threshold and the
    shape bookkeeping."""
    dev = resolve_device(device)
    if repo_leaf_capacity is None:
        repo_leaf_capacity = leaf_capacity
    pts, val, depth_b = pad_batch(datasets, leaf_capacity, device=dev)
    B = pts.shape[0]

    idx = index_lib.build_index_batch(pts, val, depth_b)
    del pts, val

    r_prime = None
    if remove_outliers:
        idx, r_prime = outliers_lib.remove_outliers(idx)

    # global space bounds (for the Def. 4 grid) from the live points
    space_lo = torch.amin(idx.box_lo[:, 0, :2], dim=0)
    space_hi = torch.amax(idx.box_hi[:, 0, :2], dim=0)

    ds_sigs = zorder.signature(idx.points, idx.valid, space_lo, space_hi,
                               theta)

    # pad the repository to B_pad slots
    depth_u = repo_lib.depth_for_repo(B, repo_leaf_capacity)
    B_pad = repo_leaf_capacity * (1 << depth_u)

    def pad_to(x):
        pad = torch.zeros((B_pad - B,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, pad])

    idx = DatasetIndex(*[pad_to(f) for f in idx])
    ds_sigs = pad_to(ds_sigs)
    ds_valid = torch.zeros((B_pad,), dtype=torch.bool, device=dev)
    ds_valid[:B] = True

    lo = torch.where(ds_valid[:, None], idx.box_lo[:, 0, :], float("inf"))
    hi = torch.where(ds_valid[:, None], idx.box_hi[:, 0, :], -float("inf"))
    repo = repo_lib.build_repo_index(idx.centers[:, 0, :], idx.radii[:, 0],
                                     lo, hi, ds_sigs, ds_valid, depth_u)

    repository = Repository(ds_index=idx, ds_sigs=ds_sigs, ds_valid=ds_valid,
                            repo=repo, space_lo=space_lo, space_hi=space_hi)
    info = {
        "bottom_depth": depth_b,
        "upper_depth": depth_u,
        "n_datasets": B,
        "n_slots": B_pad,
        "outlier_threshold": r_prime,
        "theta": theta,
        "leaf_capacity": leaf_capacity,
    }
    return repository, info


def build_query_index(points: np.ndarray, *, leaf_capacity: int = 16,
                      theta: int = 5, space_lo=None, space_hi=None,
                      device=None):
    """Index one query set Q (no outlier removal: Q is the user's
    exemplar).  Returns (index row, signature or None)."""
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    pts, valid, depth = index_lib.pad_points(pts, leaf_capacity)
    q_idx = index_lib.build_index(pts, valid, depth)
    q_sig = None
    if space_lo is not None:
        q_sig = zorder.signature(q_idx.points[None], q_idx.valid[None],
                                 space_lo, space_hi, theta)[0]
    return q_idx, q_sig

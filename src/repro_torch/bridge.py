"""Carry an index between the JAX package and the port, through numpy.

``*_to_torch`` take a ``DatasetIndex``, ``RepoIndex`` or ``Repository`` of
the JAX package (any object with the same field names whose leaves convert
with ``numpy.asarray``) and return the port's tensors on ``device``;
``to_numpy`` turns a port structure back into numpy leaves with the JAX
package's dtypes.  The tests use it to run both packages on one index.

Dtypes that differ between the packages: signatures are ``uint32`` words in
JAX and int64 tensors holding the same values here; the upper tree's
``order`` is int32 in JAX and int64 here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.index import DatasetIndex
from repro_torch.core.repo_index import RepoIndex, Repository
from repro_torch.device import resolve_device


def _tensor(x, dev: torch.device, np_dtype=None) -> torch.Tensor:
    a = np.array(x, dtype=np_dtype)     # a writable copy
    return torch.from_numpy(a).to(dev)


def index_to_torch(idx, device=None) -> DatasetIndex:
    dev = resolve_device(device)
    return DatasetIndex(*[_tensor(getattr(idx, f), dev)
                          for f in DatasetIndex._fields])


def repo_index_to_torch(up, device=None) -> RepoIndex:
    dev = resolve_device(device)
    cast = {"order": np.int64, "sigs": np.int64}
    return RepoIndex(*[_tensor(getattr(up, f), dev, cast.get(f))
                       for f in RepoIndex._fields])


def repository_to_torch(repo, device=None) -> Repository:
    dev = resolve_device(device)
    return Repository(
        ds_index=index_to_torch(repo.ds_index, dev),
        ds_sigs=_tensor(repo.ds_sigs, dev, np.int64),
        ds_valid=_tensor(repo.ds_valid, dev),
        repo=repo_index_to_torch(repo.repo, dev),
        space_lo=_tensor(repo.space_lo, dev),
        space_hi=_tensor(repo.space_hi, dev),
    )


def to_numpy(x):
    """A port DatasetIndex / RepoIndex / Repository with numpy leaves in the
    JAX package's dtypes (signatures uint32, ``order`` int32)."""
    def arr(t, np_dtype=None):
        a = t.detach().cpu().numpy()
        return a if np_dtype is None else a.astype(np_dtype)

    if isinstance(x, DatasetIndex):
        return DatasetIndex(*[arr(t) for t in x])
    if isinstance(x, RepoIndex):
        cast = {"order": np.int32, "sigs": np.uint32}
        return RepoIndex(*[arr(getattr(x, f), cast.get(f))
                           for f in RepoIndex._fields])
    if isinstance(x, Repository):
        return Repository(ds_index=to_numpy(x.ds_index),
                          ds_sigs=arr(x.ds_sigs, np.uint32),
                          ds_valid=arr(x.ds_valid), repo=to_numpy(x.repo),
                          space_lo=arr(x.space_lo), space_hi=arr(x.space_hi))
    raise TypeError(f"to_numpy: unsupported {type(x)!r}")

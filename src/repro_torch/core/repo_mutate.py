"""Incremental repository mutation under a pinned geometry.

Counterpart of ``repro.core.repo_mutate``.  ``build_repository`` (Alg. 1)
derives four repository-global quantities from the whole collection: the
bottom tree depth (largest dataset), the Def. 4 grid bounds (union of the
root boxes), the pooled Eq. 3 outlier threshold r' and the slot count.  A
live repository cannot re-derive them per mutation without rebuilding
everything, so they are pinned once as a :class:`RepoGeometry` and every
slot goes through one row pipeline:

  * :func:`init_live` — the cold build in Alg. 1's op order, emitting its
    geometry;
  * :func:`build_row` — the canonical per-dataset build: pad, ball tree,
    outlier refine at the pinned r', z-order signature at the pinned
    bounds, always as a BATCH OF 1.  Batch-of-1 everywhere is a
    correctness rule: the sums of ``index._node_stats`` and the kneedle
    sort are reductions, and PyTorch's CPU and CUDA reduction kernels pick
    their split and vectorisation by shape, so a row of a (B, ...) build
    can differ from a (1, ...) build in the last ulp of a center or
    radius.  :func:`init_live` and :func:`build_frozen` therefore build
    every row through :func:`build_row` too, and a live ingest is bitwise
    equal to a cold rebuild by construction;
  * :func:`update_slots` — the functional multi-slot update (ingest,
    delete and replace are one scatter and one upper-tree rebuild for N
    coalesced mutations; a deleted slot is zeroed entirely, as the cold
    builder's ``pad_to(..., 0)`` padding).  It returns new tensors and
    never writes into the repository it was given, which a query may still
    be reading;
  * :func:`build_frozen` — the bit-identity oracle: a cold,
    slot-preserving build from ``{slot j: dataset_j or None}`` under the
    same geometry.

The slot count starts at the cold build's (``slot_headroom`` doublings
more) and doubles through :meth:`RepoGeometry.grown` and
:func:`grow_slots`.  The bottom point capacity is pinned at init: an
oversize dataset is a ``ValueError``.

A row build is three stages: the bottom tree, the outlier removal at the
pinned r', the signature at the pinned grid (:func:`init_live` runs each
over every dataset before it can derive the next one's operand).  A
stage of a batch-of-1 row has one shape per geometry and hundreds of
small launches, so on the card it is captured once per (stage, static
operand, device, operand shapes and dtypes) as a CUDA graph and replayed
per row (:class:`_GraphedStage`): the graph replays the very
kernels an eager call launches, on the same shapes, so its rows are the
eager rows bit for bit, without the host's launch cost per op.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; the only host-to-device traffic of a row build is its
padded payload, ``point_capacity * (4 * dim + 1)`` bytes.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, replace
from functools import lru_cache
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


@dataclass(frozen=True)
class RepoGeometry:
    """The cold-build quantities a live repository pins at creation.

    ``space_lo`` / ``space_hi`` and ``r_prime`` are exact Python floats of
    the builder's float32 values (float32 -> float64 -> float32 round-trips
    exactly), so re-materialising them reproduces the cold build's
    arithmetic bit for bit."""

    leaf_capacity: int          # leaf fanout f of the bottom trees
    bottom_depth: int           # pinned bottom tree depth
    repo_leaf_capacity: int     # leaf fanout f_up of the upper tree
    upper_depth: int            # current slot tier: n_slots = f_up * 2**d_u
    theta: int                  # z-order grid resolution
    space_lo: tuple             # (2,) pinned Def. 4 grid bounds
    space_hi: tuple
    r_prime: float | None       # pinned Eq. 3 threshold; None: no removal
    dim: int = 2

    @property
    def point_capacity(self) -> int:
        return self.leaf_capacity * (1 << self.bottom_depth)

    @property
    def n_slots(self) -> int:
        return self.repo_leaf_capacity * (1 << self.upper_depth)

    @property
    def sig_words(self) -> int:
        return zorder.num_words(self.theta)

    @property
    def n_nodes(self) -> int:
        return (1 << (self.bottom_depth + 1)) - 1

    def grown(self) -> "RepoGeometry":
        """The next tier: the slot count doubles, everything else stays."""
        return replace(self, upper_depth=self.upper_depth + 1)

    def space_bounds(self, device=None):
        """The pinned grid bounds as float32 tensors on ``device``."""
        return _bounds(self.space_lo, self.space_hi, resolve_device(device))


@lru_cache(maxsize=16)
def _bounds(space_lo: tuple, space_hi: tuple, dev: torch.device):
    # uploaded once per (geometry, device), not once per row build
    return (torch.tensor(space_lo, dtype=torch.float32, device=dev),
            torch.tensor(space_hi, dtype=torch.float32, device=dev))


def _floats(x: torch.Tensor) -> tuple:
    return tuple(float(v) for v in x.reshape(-1).cpu().numpy())


def _cat_rows(rows) -> DatasetIndex:
    """Batch-of-1 (or batched) rows stacked along the slot axis."""
    return DatasetIndex(*[torch.cat(xs, dim=0) for xs in zip(*rows)])


def _host_pad(points: np.ndarray, geom: RepoGeometry):
    """One dataset padded on the host to the pinned (1, point_capacity,
    dim) layout (zeros past the real points, as ``pad_batch``) with its
    validity mask."""
    n = int(points.shape[0])
    if n > geom.point_capacity:
        raise ValueError(
            f"dataset with {n} points exceeds the pinned point capacity "
            f"{geom.point_capacity} (leaf_capacity={geom.leaf_capacity}, "
            f"bottom_depth={geom.bottom_depth}); build the live "
            f"repository with a larger point_capacity")
    pts = np.zeros((1, geom.point_capacity, geom.dim), np.float32)
    val = np.zeros((1, geom.point_capacity), bool)
    pts[0, :n] = points
    val[0, :n] = True
    return torch.from_numpy(pts), torch.from_numpy(val)


def _tree_stage(depth: int, pts: torch.Tensor,
                val: torch.Tensor) -> DatasetIndex:
    """Row stage: the bottom tree of one padded dataset."""
    return index_lib.build_index_batch(pts, val, depth)


def _outlier_stage(r_prime: float, *tree: torch.Tensor) -> DatasetIndex:
    """Row stage: Eq. 3's outlier removal at the pinned r' (a Python float
    compares exactly: r' is a float32 value)."""
    return outliers_lib.remove_outliers(DatasetIndex(*tree),
                                        r_prime=r_prime)[0]


def _signature_stage(theta: int, pts: torch.Tensor, val: torch.Tensor,
                     lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Row stage: the z-order signature at resolution ``theta`` inside the
    pinned grid bounds ``lo``, ``hi``."""
    return zorder.signature(pts, val, lo, hi, theta)


def _clone(x):
    """A stage's output (a tensor or a DatasetIndex), cloned."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    return type(x)(*[t.clone() for t in x])


class _GraphedStage:
    """A row stage captured as a CUDA graph at its first call and replayed
    on every later one.  Each call copies its operands (host or device
    tensors of the stage's one signature) into the graph's static inputs,
    replays it on the current stream and returns clones of its outputs;
    a lock serialises callers, since the static buffers are shared.  The
    graph reads nothing it does not own: its static inputs (the grid
    bounds among them) and the buffers allocated under capture."""

    def __init__(self, fn, key, dev: torch.device):
        self._fn, self._key, self._dev = fn, key, dev
        self._graph = None
        self._lock = threading.Lock()

    def _capture(self, args) -> None:
        self._in = [torch.empty(a.shape, dtype=a.dtype, device=self._dev)
                    .copy_(a) for a in args]
        main = torch.cuda.current_stream(self._dev)
        side = torch.cuda.Stream(self._dev)
        side.wait_stream(main)
        # one eager pass first: lazy initialisations (library handles)
        # must not happen under capture
        with torch.cuda.stream(side):
            self._fn(self._key, *self._in)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._out = self._fn(self._key, *self._in)
        self._graph = graph

    def __call__(self, *args):
        with self._lock:
            if self._graph is None:
                self._capture(args)
            else:
                for x, a in zip(self._in, args):
                    x.copy_(a)
            self._graph.replay()
            return _clone(self._out)


@lru_cache(maxsize=16)
def _graphed(fn, key, dev: torch.device, spec: tuple) -> _GraphedStage:
    """The graph of stage ``fn`` for everything that decides it: the static
    ``key``, the device (with its index) and each operand's (shape,
    dtype) in ``spec``."""
    return _GraphedStage(fn, key, dev)


def _stage(fn, key, dev: torch.device):
    """Row stage ``fn`` with its static ``key`` on ``dev``: the stage's CUDA
    graph on the card, the eager stage elsewhere."""
    if dev.type != "cuda":
        return lambda *args: fn(key, *[a.to(dev) for a in args])
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    def call(*args):
        spec = tuple((tuple(a.shape), a.dtype) for a in args)
        return _graphed(fn, key, dev, spec)(*args)

    return call


def _refine(tree: DatasetIndex, geom: RepoGeometry, dev: torch.device):
    """The refine of a built tree under the pinned geometry: outlier
    removal (when r' is pinned), then the signature."""
    if geom.r_prime is not None:
        tree = _stage(_outlier_stage, geom.r_prime, dev)(*tree)
    sign = _stage(_signature_stage, geom.theta, dev)
    return tree, sign(tree.points, tree.valid, *geom.space_bounds(dev))


def build_row(points: np.ndarray, geom: RepoGeometry, *, device=None):
    """The canonical row build: one dataset -> (batch-of-1 DatasetIndex,
    signature (1, W)) under the pinned geometry."""
    dev = resolve_device(device)
    pts, val = _host_pad(np.asarray(points, np.float32), geom)
    tree = _stage(_tree_stage, geom.bottom_depth, dev)(pts, val)
    return _refine(tree, geom, dev)


def build_rows(datasets: Sequence[np.ndarray], geom: RepoGeometry, *,
               device=None):
    """:func:`build_row` per dataset, stacked: (DatasetIndex over
    len(datasets), signatures (B, W))."""
    dev = resolve_device(device)
    rows = [build_row(ds, geom, device=dev) for ds in datasets]
    return (_cat_rows([r[0] for r in rows]),
            torch.cat([r[1] for r in rows], dim=0))


def zero_slot_row(geom: RepoGeometry, *, device=None):
    """The all-zero row a deleted slot holds: the cold builder's
    ``pad_to(..., 0)`` padding of a never-filled slot, not an empty built
    tree (whose node boxes would carry +-inf).  (row, signature (W,))."""
    dev = resolve_device(device)
    n_pad, d, n_nodes = geom.point_capacity, geom.dim, geom.n_nodes

    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    row = DatasetIndex(points=z((n_pad, d)), valid=z((n_pad,), torch.bool),
                       centers=z((n_nodes, d)), radii=z((n_nodes,)),
                       box_lo=z((n_nodes, d)), box_hi=z((n_nodes, d)),
                       counts=z((n_nodes,), torch.int32))
    return row, z((geom.sig_words,), torch.int64)


def upper_from_roots(centers, radii, lo, hi, sigs, valid,
                     upper_depth: int) -> repo_lib.RepoIndex:
    """The Section V-B upper tree from per-slot root summaries: the cold
    builder's inf-masked boxes into ``build_repo_index``."""
    lo = torch.where(valid[:, None], lo, float("inf"))
    hi = torch.where(valid[:, None], hi, -float("inf"))
    return repo_lib.build_repo_index(centers, radii, lo, hi, sigs, valid,
                                     upper_depth)


def upper_tree(ds_index: DatasetIndex, ds_sigs: torch.Tensor,
               ds_valid: torch.Tensor, geom: RepoGeometry
               ) -> repo_lib.RepoIndex:
    """:func:`upper_from_roots` fed from full slot tensors."""
    return upper_from_roots(ds_index.centers[:, 0, :], ds_index.radii[:, 0],
                            ds_index.box_lo[:, 0, :],
                            ds_index.box_hi[:, 0, :], ds_sigs, ds_valid,
                            geom.upper_depth)


def assemble(ds_index: DatasetIndex, ds_sigs: torch.Tensor,
             ds_valid: torch.Tensor, geom: RepoGeometry) -> Repository:
    """A Repository from full slot tensors: the upper tree rebuilt, the
    pinned space bounds attached."""
    lo, hi = geom.space_bounds(ds_valid.device)
    return Repository(ds_index=ds_index, ds_sigs=ds_sigs, ds_valid=ds_valid,
                      repo=upper_tree(ds_index, ds_sigs, ds_valid, geom),
                      space_lo=lo, space_hi=hi)


def _scatter_rows(rows: DatasetIndex, sigs: torch.Tensor, slots,
                  geom: RepoGeometry):
    """Zero slot tensors of the tier with ``rows`` written at ``slots``."""
    dev = sigs.device
    B = geom.n_slots
    js = torch.as_tensor(np.asarray(slots, np.int64), device=dev)
    ds_index = DatasetIndex(*[
        torch.zeros((B,) + tuple(r.shape[1:]), dtype=r.dtype,
                    device=dev).index_copy_(0, js, r) for r in rows])
    ds_sigs = torch.zeros((B, geom.sig_words), dtype=torch.int64,
                          device=dev).index_copy_(0, js, sigs)
    ds_valid = torch.zeros((B,), dtype=torch.bool, device=dev)
    ds_valid[js] = True
    return ds_index, ds_sigs, ds_valid


def build_frozen(slot_datasets: Sequence, geom: RepoGeometry, *,
                 device=None) -> Repository:
    """The bit-identity oracle: a cold, slot-preserving build.

    ``slot_datasets[j]`` is the dataset resident in slot j, or None for a
    hole (never filled or deleted: both are all-zero rows).  After any
    mutation sequence the live repository equals ``build_frozen`` of the
    current slot contents bit for bit, and so does every op on it."""
    dev = resolve_device(device)
    if len(slot_datasets) > geom.n_slots:
        raise ValueError(f"{len(slot_datasets)} slots > capacity "
                         f"{geom.n_slots}")
    filled = [(j, ds) for j, ds in enumerate(slot_datasets)
              if ds is not None]
    if not filled:
        zero_row, _ = zero_slot_row(geom, device=dev)
        B = geom.n_slots
        ds_index = DatasetIndex(*[z.expand((B,) + tuple(z.shape)).clone()
                                  for z in zero_row])
        return assemble(
            ds_index,
            torch.zeros((B, geom.sig_words), dtype=torch.int64, device=dev),
            torch.zeros((B,), dtype=torch.bool, device=dev), geom)
    rows, sigs = build_rows([ds for _, ds in filled], geom, device=dev)
    return assemble(*_scatter_rows(rows, sigs, [j for j, _ in filled], geom),
                    geom)


def init_live(
    datasets: Sequence[np.ndarray],
    *,
    leaf_capacity: int = 16,
    repo_leaf_capacity: int | None = None,
    theta: int = 5,
    remove_outliers: bool = True,
    point_capacity: int | None = None,
    slot_headroom: int = 0,
    device=None,
) -> tuple[Repository, RepoGeometry]:
    """The cold build in Alg. 1's op order, pinning its geometry, with every
    row built as a batch of 1, so the result equals :func:`build_frozen` of
    the same datasets bit for bit.

    The global quantities keep their cold derivations: the bottom depth
    from the largest dataset, r' from the pooled leaf radii of all bottom
    trees (Eq. 3), the grid bounds from the union of the refined root
    boxes.  ``point_capacity`` reserves bottom-tree headroom for larger
    later datasets.  The upper tree's fanout is ``repo_leaf_capacity``
    (``leaf_capacity`` when None), and ``slot_headroom`` doubles the
    first slot tier that many times."""
    dev = resolve_device(device)
    if repo_leaf_capacity is None:
        repo_leaf_capacity = leaf_capacity
    n_max = max(int(x.shape[0]) for x in datasets)
    depth_b = index_lib.depth_for(n_max, leaf_capacity)
    if point_capacity is not None:
        if point_capacity < n_max:
            raise ValueError(f"point_capacity {point_capacity} < largest "
                             f"initial dataset ({n_max} points)")
        depth_b = max(depth_b,
                      index_lib.depth_for(point_capacity, leaf_capacity))
    B = len(datasets)
    # the bottom layout is all the tree stage needs; bounds, r' and the
    # upper depth are filled in once derived
    geom = RepoGeometry(leaf_capacity=leaf_capacity, bottom_depth=depth_b,
                        repo_leaf_capacity=repo_leaf_capacity, upper_depth=0,
                        theta=theta, space_lo=(), space_hi=(), r_prime=None)
    tree = _stage(_tree_stage, depth_b, dev)
    built = [tree(*_host_pad(np.asarray(ds, np.float32), geom))
             for ds in datasets]

    r_prime = None
    if remove_outliers:
        # Eq. 3 over the pooled leaf radii of every bottom tree; the
        # float32 threshold is held as an exact Python float BEFORE the
        # refine, so init uses the very operand every later ingest uses
        leaf_r = torch.cat([index_lib.leaf_radii(b).reshape(-1)
                            for b in built])
        leaf_c = torch.cat([index_lib.leaf_counts(b).reshape(-1)
                            for b in built])
        r_prime = float(outliers_lib.kneedle_threshold(leaf_r, leaf_c > 0))
        refine = _stage(_outlier_stage, r_prime, dev)
        built = [refine(*b) for b in built]

    space_lo = torch.amin(torch.cat([b.box_lo[:, 0, :2] for b in built]),
                          dim=0)
    space_hi = torch.amax(torch.cat([b.box_hi[:, 0, :2] for b in built]),
                          dim=0)
    geom = replace(geom,
                   upper_depth=repo_lib.depth_for_repo(B, repo_leaf_capacity)
                   + slot_headroom,
                   space_lo=_floats(space_lo), space_hi=_floats(space_hi),
                   r_prime=r_prime)

    sign = _stage(_signature_stage, theta, dev)
    lo, hi = geom.space_bounds(dev)
    sigs = torch.cat([sign(b.points, b.valid, lo, hi) for b in built],
                     dim=0)
    rows = _cat_rows(built)
    del built
    return assemble(*_scatter_rows(rows, sigs, np.arange(B), geom),
                    geom), geom


def scatter_slots(repo: Repository, slots: torch.Tensor, rows: DatasetIndex,
                  sigs: torch.Tensor, valids: torch.Tensor):
    """New slot tensors with the (N, ...) ``rows`` / ``sigs`` / ``valids``
    written at ``slots`` (out of place: ``repo`` is not touched).  A scatter
    is pure data movement, so N rows in one call equal N single-row
    scatters as long as ``slots`` holds no conflicting duplicates (callers
    dedup last-write-wins; padding a group by repeating its last entry
    writes the same bits twice)."""
    ds_index = DatasetIndex(*[a.index_copy(0, slots, r)
                              for a, r in zip(repo.ds_index, rows)])
    return (ds_index, repo.ds_sigs.index_copy(0, slots, sigs),
            repo.ds_valid.index_copy(0, slots, valids))


def update_slots(repo: Repository, slots: torch.Tensor, rows: DatasetIndex,
                 sigs: torch.Tensor, valids: torch.Tensor, *,
                 geom: RepoGeometry) -> Repository:
    """The functional multi-slot update: one scatter and one upper-tree
    rebuild for N mutations (ingest, replace and delete mixed; a delete is
    a zero row with ``valids[i]`` False).  The repository it was given
    stays intact, so a query already reading it keeps a consistent
    snapshot while later queries see the successor."""
    return assemble(*scatter_slots(repo, slots, rows, sigs, valids), geom)


def pad_slots(repo: Repository, n_slots: int):
    """The slot tensors zero-padded to ``n_slots`` rows on the device, slot
    order kept; nothing crosses from the host."""
    cur = repo.n_slots
    if n_slots < cur:
        raise ValueError(f"grow target {n_slots} < current {cur} slots")

    def pad(x):
        z = torch.zeros((n_slots - cur,) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
        return torch.cat([x, z], dim=0)

    return (DatasetIndex(*[pad(x) for x in repo.ds_index]),
            pad(repo.ds_sigs), pad(repo.ds_valid))


def grow_slots(repo: Repository, geom: RepoGeometry) -> Repository:
    """Zero rows appended up to the next tier (``geom`` is the grown
    geometry) and the upper tree rebuilt at its depth."""
    return assemble(*pad_slots(repo, geom.n_slots), geom)

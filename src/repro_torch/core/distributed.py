"""Multi-device Spadas: a mesh as a list of devices, and its collectives.

Counterpart of ``repro.core.distributed``.  The JAX package runs one
controller over the local devices of one process (``shard_map`` over a
``Mesh``); the port does the same without a process group: a
:class:`Mesh` is a list of ``torch.device`` (a nested list for a
(replica, data) grid), a per-shard value is a Python list in shard order,
and the work between collectives is a Python loop over the shards, each
step enqueued on its shard's device.  Several shards may share one device
(``["cuda:0"] * 4``, or ``["cpu"] * 8`` in the tests): the counterpart of
forcing host devices in JAX.

A collective takes the per-shard list, gathers onto the first shard's
device (the mesh's lead device, or a replica group's) with ``.to`` and
returns one tensor there, what JAX calls replicated.  Every collective
here is a selection or an integer sum, so it is exact: ``all_gather``
(concatenation in shard order, which is ascending global slot id),
``pmin`` / ``pmax``, ``psum_int`` and ``owner_select`` (the row of the
shard that owns it; JAX adds zeros from the other shards, which is exact
too, but selecting also keeps a ``-0.0``).  A one-shard list comes back
as it is, so a one-shard mesh runs the local program op for op.

A mesh also holds arrays split over it, as JAX's ``NamedSharding``
places them (the train state on a mesh): :class:`PartitionSpec` names
the mesh axes each dim is split over, :class:`NamedSharding` pairs it
with a mesh, and a :class:`Sharded` array is one tensor per mesh
coordinate, each on that coordinate's device (``place``, the counterpart
of ``jax.device_put``; ``gather``, of ``numpy.asarray``).  Coordinates
that differ only along axes the spec does not name hold copies.

Also here, as in the JAX package: ``global_kth_smallest`` (the tau
reduction of sharded ExactHaus and of the joinable refine),
``sharded_topk_bounds``, ``sharded_topk_gbo`` and the ring ops
``ring_hausdorff`` / ``ring_nn_distance``, whose point sets are sharded
and whose D shards visit every Q shard in turn.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from functools import cached_property
from typing import NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import BIG

#: The mesh's axis names.  In the JAX package they name the ``shard_map``
#: axes its collectives run over; here the collectives take per-shard
#: lists, so the names only label a mesh: a 1-D mesh is over ``data``, a
#: 2-D one over (``replica``, ``data``).
DATA_AXIS = "data"
REPLICA_AXIS = "replica"


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def _shape_of(devices) -> tuple:
    if isinstance(devices, (list, tuple)):
        if not devices:
            raise ValueError("Mesh: an axis may not be empty")
        inner = [_shape_of(d) for d in devices]
        if any(s != inner[0] for s in inner):
            raise ValueError("Mesh: the device grid must be rectangular")
        return (len(devices),) + inner[0]
    return ()


def _resolve(devices):
    if isinstance(devices, (list, tuple)):
        return tuple(_resolve(d) for d in devices)
    dev = resolve_device(devices)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class Mesh:
    """A grid of devices with one name per axis: ``devices`` is a tuple
    (nested once per further axis) of ``torch.device``.  Entries may
    repeat: several shards then share a device.  A CUDA device that is
    not present raises, as every entry point of the port does."""

    devices: tuple
    axis_names: tuple

    def __post_init__(self):
        dims = _shape_of(self.devices)
        names = tuple(self.axis_names)
        if len(dims) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"Mesh: axis names {names} do not fit a device "
                             f"grid of shape {dims}")
        object.__setattr__(self, "devices", _resolve(self.devices))
        object.__setattr__(self, "axis_names", names)

    @cached_property
    def _dims(self) -> tuple:
        return _shape_of(self.devices)

    @cached_property
    def _flat(self) -> tuple:
        def walk(x):
            return ([d for y in x for d in walk(y)] if isinstance(x, tuple)
                    else [x])
        return tuple(walk(self.devices))

    @property
    def shape(self) -> dict:
        """Axis name -> extent, in axis order."""
        return dict(zip(self.axis_names, self._dims))

    @property
    def flat(self) -> list:
        """Every device, row-major."""
        return list(self._flat)

    @property
    def lead(self) -> torch.device:
        """The first device: queries arrive and results return there."""
        return self.flat[0]


def visible_cards() -> list:
    """One ``cuda:i`` per visible card; raises when there is none."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def take_devices(n: int, devices: list, what: str) -> list:
    """The first ``n`` of ``devices``: a request larger than the list is an
    error, never a smaller mesh."""
    if n > len(devices):
        raise ValueError(
            f"{what}: {n} devices requested but only {len(devices)} given "
            f"(pass devices=[...] to place several shards on one device)")
    return devices[:n]


def shard(x: torch.Tensor, devices, dim: int = 0) -> list:
    """Split ``x`` into ``len(devices)`` equal parts along ``dim``, each
    placed on its device: a per-shard list."""
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(f"shard: extent {x.shape[dim]} does not split "
                         f"into {n} shards")
    return [p.to(d) for p, d in zip(torch.chunk(x, n, dim=dim), devices)]


def grid_mesh(sizes, names, devices, what: str) -> Mesh:
    """The mesh of extents ``sizes`` and axis names ``names`` over the
    first devices of ``devices`` (row-major: the last axis varies
    fastest); fewer devices than it needs raise, naming ``what``."""
    sizes = tuple(sizes)
    flat = take_devices(math.prod(sizes), list(devices), what)

    def grid(items, dims):
        if not dims:
            return items[0]
        step = len(items) // dims[0]
        return tuple(grid(items[i * step:(i + 1) * step], dims[1:])
                     for i in range(dims[0]))

    return Mesh(grid(flat, sizes), tuple(names))


# ---------------------------------------------------------------------------
# arrays split over a mesh
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: for each leading dim of an array, the mesh
    axes it is split over (None: not split; an axis name; or a tuple of
    names, the first the major one).  Dims past its length are not
    split.  A tuple of one name is that name, as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return "P" + tuple.__repr__(self)


class NamedSharding(NamedTuple):
    """JAX's ``NamedSharding``: a mesh and the spec of an array on it."""
    mesh: Mesh
    spec: PartitionSpec


class Sharded(NamedTuple):
    """An array placed on a mesh: one tensor per mesh coordinate, in
    ``mesh.flat`` order, each on that coordinate's device and holding the
    block ``shard_slices`` gives it."""
    shards: list
    sharding: NamedSharding
    shape: tuple


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def mesh_coords(mesh: Mesh) -> list:
    """Every coordinate of ``mesh`` (axis name -> index), in
    ``mesh.flat`` order."""
    names, sizes = tuple(mesh.shape), tuple(mesh.shape.values())
    return [dict(zip(names, c))
            for c in itertools.product(*(range(n) for n in sizes))]


def shard_slices(shape, sharding: NamedSharding, coord: dict) -> tuple:
    """The block of an array of ``shape`` that coordinate ``coord`` holds
    under ``sharding``: one slice per dim.  A dim whose extent the split
    does not divide raises."""
    sizes = sharding.mesh.shape
    out, used = [], set()
    for i, extent in enumerate(shape):
        axes = spec_axes(sharding.spec[i]) if i < len(sharding.spec) else ()
        if used & set(axes):
            raise ValueError(f"spec {sharding.spec}: a mesh axis splits two "
                             f"dims")
        used.update(axes)
        n, pos = 1, 0
        for a in axes:
            n, pos = n * sizes[a], pos * sizes[a] + coord[a]
        if extent % n:
            raise ValueError(f"spec {sharding.spec}: dim {i} of {tuple(shape)}"
                             f" does not split into {n}")
        size = extent // n
        out.append(slice(pos * size, (pos + 1) * size))
    return tuple(out)


def place(x: torch.Tensor, sharding: NamedSharding) -> Sharded:
    """``x`` split by ``sharding``: each coordinate's block copied to its
    device (copies, also where coordinates share a device)."""
    mesh = sharding.mesh
    shards = [x[shard_slices(x.shape, sharding, c)].to(
        d, copy=True, memory_format=torch.contiguous_format)
        for c, d in zip(mesh_coords(mesh), mesh.flat)]
    return Sharded(shards, sharding, tuple(x.shape))


def _blocks(x: Sharded):
    """(coordinate index, block slices) of each distinct block of ``x``,
    from the first coordinate that holds it."""
    seen = set()
    for i, c in enumerate(mesh_coords(x.sharding.mesh)):
        idx = shard_slices(x.shape, x.sharding, c)
        key = tuple((sl.start, sl.stop) for sl in idx)
        if key not in seen:
            seen.add(key)
            yield i, idx


def gather(x: Sharded, device=None, out: torch.Tensor | None = None
           ) -> torch.Tensor:
    """The whole array of ``x``: written into ``out``, or into a new
    tensor on ``device`` (the mesh's lead device by default), each block
    once."""
    if out is None:
        out = torch.empty(x.shape, dtype=x.shards[0].dtype,
                          device=x.sharding.mesh.lead if device is None
                          else device)
    for i, idx in _blocks(x):
        out[idx].copy_(x.shards[i])
    return out


def gather_block(x: Sharded, idx: tuple, out: torch.Tensor) -> torch.Tensor:
    """The region ``idx`` (one slice per dim) of ``x`` written into
    ``out`` (a tensor of its shape, on any device) from the distinct
    blocks of ``x`` that lie inside it, which tile it."""
    for i, bidx in _blocks(x):
        if all(b.start >= r.start and b.stop <= r.stop
               for b, r in zip(bidx, idx)):
            out[tuple(slice(b.start - r.start, b.stop - r.start)
                      for b, r in zip(bidx, idx))].copy_(x.shards[i])
    return out


def write(x: Sharded, whole: torch.Tensor) -> None:
    """Overwrite every coordinate's block of ``x`` (in place) with its
    block of ``whole``."""
    for c, s in zip(mesh_coords(x.sharding.mesh), x.shards):
        s.copy_(whole[shard_slices(x.shape, x.sharding, c)])


# A tree below is a dict whose leaves are tensors (or Sharded arrays), or
# NamedTuples of them (a QTensor's codes and scales): each tensor field of
# such a leaf is placed or gathered, its other fields kept.


def _is_part(x) -> bool:
    return isinstance(x, (torch.Tensor, Sharded))


def _map_leaf(fn, x, *rest):
    if _is_part(x):
        return fn(x, *rest)
    return x._replace(**{f: fn(getattr(x, f), *(getattr(r, f) for r in rest))
                         for f in x._fields if _is_part(getattr(x, f))})


def place_tree(tree: dict, shardings: dict) -> dict:
    """Each leaf of ``tree`` placed by its sharding in ``shardings`` (a
    NamedSharding, or for a NamedTuple leaf a NamedTuple of them)."""
    return {n: _map_leaf(place, x, shardings[n]) for n, x in tree.items()}


def gather_tree(tree: dict, device=None) -> dict:
    """Each Sharded leaf of ``tree`` whole on ``device`` (the mesh's lead
    device by default)."""
    return {n: _map_leaf(lambda s: gather(s, device), x)
            for n, x in tree.items()}


def tree_shardings(tree: dict) -> dict:
    """The sharding of each Sharded leaf of ``tree``."""
    return {n: _map_leaf(lambda s: s.sharding, x) for n, x in tree.items()}


def tree_bytes(*trees) -> list:
    """Resident bytes of each mesh coordinate (``mesh.flat`` order) over
    the Sharded leaves of ``trees``."""
    out = None
    for tree in trees:
        for x in tree.values():
            parts = [x] if _is_part(x) else [
                getattr(x, f) for f in x._fields if _is_part(getattr(x, f))]
            for part in parts:
                b = [s.numel() * s.element_size() for s in part.shards]
                out = b if out is None else [u + v for u, v in zip(out, b)]
    return out or []


# ---------------------------------------------------------------------------
# collectives over per-shard lists
# ---------------------------------------------------------------------------


def _stack(xs) -> torch.Tensor:
    lead = xs[0].device
    return torch.stack([x.to(lead) for x in xs])


def all_gather(xs, dim: int = -1) -> torch.Tensor:
    """Concatenate the shards' tensors along ``dim`` in shard order (which
    is ascending global id), on the first shard's device."""
    if len(xs) == 1:
        return xs[0]
    lead = xs[0].device
    return torch.cat([x.to(lead) for x in xs], dim=dim)


def pmin(xs) -> torch.Tensor:
    """Elementwise minimum over the shards (a selection: exact)."""
    return xs[0] if len(xs) == 1 else torch.amin(_stack(xs), dim=0)


def pmax(xs) -> torch.Tensor:
    """Elementwise maximum over the shards (a selection: exact)."""
    return xs[0] if len(xs) == 1 else torch.amax(_stack(xs), dim=0)


def psum_int(xs) -> torch.Tensor:
    """Elementwise sum over the shards of integer tensors (exact)."""
    if xs[0].is_floating_point():
        raise TypeError("psum_int sums integers only")
    if len(xs) == 1:
        return xs[0]
    return _stack(xs).sum(dim=0, dtype=xs[0].dtype)


def owner_select(xs, owner: torch.Tensor) -> torch.Tensor:
    """Row b of shard ``owner[b]``: the owner-exclusive merge of RangeP,
    NNP and the join re-rank, whose shards each evaluate every row and
    only the owner's row is right.  xs: per-shard (B, ...) tensors; owner
    (B,) int64 on the first shard's device."""
    if len(xs) == 1:
        return xs[0]
    rows = torch.arange(owner.shape[0], device=owner.device)
    return _stack(xs)[owner, rows]


def any_per_shard(flags) -> list:
    """Whether each shard's flag tensor has a True, as Python bools: one
    host read for the whole mesh (a lockstep loop's continue test)."""
    if len(flags) == 1:
        return [bool(flags[0].any())]
    return _stack([f.any() for f in flags]).tolist()


def global_kth_smallest(xs, k: int) -> torch.Tensor:
    """kth-smallest along the last axis of a vector sharded in pieces xs.

    Each shard contributes its min(k, shard) smallest; their union always
    holds the global k smallest, so sorting the gathered candidates and
    taking position k - 1 (clamped) selects what a sort of the whole
    vector would: an element of it, bit for bit.  With one shard this is
    the local ``kthvalue`` (clamped at the shard's extent)."""
    if len(xs) == 1:
        x = xs[0]
        return torch.kthvalue(x, min(k, x.shape[-1]), dim=-1).values
    small = [torch.sort(x, dim=-1).values[..., :min(k, x.shape[-1])]
             for x in xs]
    cat = torch.sort(all_gather(small, dim=-1), dim=-1).values
    return cat[..., min(k - 1, cat.shape[-1] - 1)]


# ---------------------------------------------------------------------------
# repository-sharded bound pass and GBO
# ---------------------------------------------------------------------------


def sharded_topk_bounds(q_center, q_radius, ds_centers, ds_radii, ds_valid,
                        k: int):
    """Phase-0 ExactHaus root bounds, the repository sharded.

    q_center (W,) and q_radius (0-dim) on the lead device; ds_centers,
    ds_radii and ds_valid per-shard lists of (S, W), (S,) and (S,).
    Returns (tau, lbs, ubs): tau the kth-smallest UB over every shard (on
    the lead device), lbs / ubs the per-shard bounds, BIG on invalid
    slots."""
    lbs, ubs = [], []
    for dc, dr, dv in zip(ds_centers, ds_radii, ds_valid):
        qc = q_center.to(dc.device)
        cd = ref.ieee_sqrt(ref.unrolled_sq_dists(dc, qc[None, :]))
        lb = torch.clamp_min(cd - dr, 0.0)
        ub = ref.ieee_sqrt(cd * cd + dr * dr) + q_radius.to(dc.device)
        lbs.append(torch.where(dv, lb, BIG))
        ubs.append(torch.where(dv, ub, BIG))
    return global_kth_smallest(ubs, k), lbs, ubs


def sharded_topk_gbo(q_sig, ds_sigs, ds_valid, k: int):
    """Top-k GBO with the signatures sharded: per shard one
    ``ops.set_intersect_counts`` launch and a stable top-k, then the O(k)
    merge of the gathered (count, global id) lists.  q_sig (W,) int64
    words on the lead device; ds_sigs / ds_valid per-shard lists.  Returns
    (vals (k,), ids (k,)) on the lead device; invalid slots count -1."""
    vals, gids, base = [], [], 0
    for sg, dv in zip(ds_sigs, ds_valid):
        counts = ops.set_intersect_counts(q_sig.to(sg.device)[None], sg)[0]
        counts = torch.where(dv, counts, -1)
        s, i = torch.sort(counts, descending=True, stable=True)
        vals.append(s[:k])
        gids.append(i[:k] + base)
        base += sg.shape[0]
    s, pos = torch.sort(all_gather(vals), descending=True, stable=True)
    return s[:k], all_gather(gids)[pos[:k]]


# ---------------------------------------------------------------------------
# ring Hausdorff and ring NNP: both point sets sharded
# ---------------------------------------------------------------------------


def _hops(n: int, s: int) -> list:
    """The D shards shard s holds in turn: its own, then the next ones."""
    return [(s + i) % n for i in range(n)]


def ring_hausdorff(qs, qs_valid, ds, ds_valid) -> torch.Tensor:
    """Directed Hausdorff H(Q -> D) with both point sets sharded (per-shard
    lists of (nq, W), (nq,), (nd, W), (nd,)).

    Q shards stay put; each hop moves the next D shard to this shard's
    device and folds one ``min_sq_dists`` launch into the running per-row
    minimum.  The max over valid rows and shards ends it.  Min and max are
    selections, so the result is bitwise ``ops.directed_hausdorff`` of
    the whole sets.  Returns a 0-dim tensor on the lead device."""
    n = len(qs)
    local = []
    for s, (q, qv) in enumerate(zip(qs, qs_valid)):
        mins = None
        for j in _hops(n, s):
            d = ds[j].to(q.device)
            dv = ds_valid[j].to(q.device)
            m = ops.min_sq_dists_pairs(q, d[None], qv, dv[None])[0]
            mins = m if mins is None else torch.minimum(mins, m)
        nnd = torch.where(qv, ref.ieee_sqrt(mins), -BIG)
        local.append(torch.amax(nnd))
    return pmax(local)


def ring_nn_distance(qs, qs_valid, ds, ds_valid):
    """Per-Q-point nearest D point with both sets sharded (lists as in
    :func:`ring_hausdorff`, D shards of one extent): per-shard lists of
    (dists (nq,), idx (nq,) int32), idx a global D row.

    Each hop is one ``nn_distance`` launch of this Q shard against the
    visiting D shard.  The merge keeps the least squared distance and, on
    equal ones, the smaller global row, so ties resolve as the unsharded
    op's first argmin does; the squared distance of each hop's winner is
    recomputed from its coordinates (the same arithmetic as the kernel),
    since two squared distances may share one rounded root.  Invalid Q
    rows get 0.0 and -1."""
    n = len(qs)
    nd = ds[0].shape[0]
    out = []
    for s, (q, qv) in enumerate(zip(qs, qs_valid)):
        best = arg = dist = None
        for j in _hops(n, s):
            d = ds[j].to(q.device)
            dv = ds_valid[j].to(q.device)
            hd, hi = ops.nn_distance_batched(q[None], d[None], qv[None],
                                             dv[None])
            hd, hi = hd[0], hi[0]
            loc = hi.clamp_min(0).long()
            key = torch.where(dv[loc], ref.unrolled_sq_dists(q, d[loc]), BIG)
            gid = loc.to(torch.int32) + j * nd
            if best is None:
                best, arg, dist = key, gid, hd
                continue
            better = (key < best) | ((key == best) & (gid < arg))
            best = torch.where(better, key, best)
            arg = torch.where(better, gid, arg)
            dist = torch.where(better, hd, dist)
        out.append((torch.where(qv, dist, 0.0), torch.where(qv, arg, -1)))
    return out

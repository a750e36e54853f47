"""LiveRepository: online ingest, delete and replace under serving traffic.

Counterpart of ``repro.engine.live``.  It makes the resident repository a
live catalog, on one device or on a mesh:

  * ``ingest(points) -> ds_id`` builds the new dataset's bottom tree and
    signature on the device under the pinned cold-build geometry
    (:mod:`repro_torch.core.repo_mutate`), writes it into a free slot and
    rebuilds the small upper tree: no full rebuild, and the only upload is
    the dataset's padded points;
  * ``delete(ds_id)`` zeroes the slot (bitwise a never-filled slot) and
    returns it to the free list; ``replace(ds_id, points)`` is an ingest
    into the same slot;
  * the slot count is tiered like the engine's bucket ladder: when ingests
    outrun the free list it doubles (zeros appended on the device) and the
    dispatcher's layout epoch is bumped.

Versioning is epoch-based, as in the JAX package: the engine's data epoch
moves on every publish and is part of every dataset-op result key (the
purged rows are booked in ``stats.epoch_invalidations``); per-slot epochs
version point-op rows, so a RangeP or NNP row keyed on dataset j survives
mutations of every other dataset.

The correctness bar is bit-identity: after any mutation sequence the
resident repository, and every op's result on it, equals a cold engine
over :func:`repro_torch.core.repo_mutate.build_frozen` of the current slot
contents (``frozen_repository()``).

A mutation runs in two stages:

  * **prepare** (:meth:`LiveRepository.prepare_group`): validation, slot
    reservation, the row builds and their payload uploads.  Nothing a query
    can observe changes, so a server runs it on a side thread while a query
    segment is in flight.  A prepare that fails returns its reserved slot;
    :meth:`abort_group` abandons a whole group.
  * **publish** (:meth:`LiveRepository.publish_group`): one batched slot
    write and one upper-tree rebuild for the whole group
    (:func:`repro_torch.core.repo_mutate.update_slots`), then the swap of
    ``dispatch.repo``.  A run of N mutations with no query between them
    publishes once and moves the data epoch once.

Publishes are functional: the successor repository is made of new tensors
and the published one is never written, so a query that already read it
keeps a consistent snapshot.  Both threads enqueue on the device's default
stream (a thread's current stream is the default one unless it sets
another, and neither does), so stream order serialises a prepare's row
builds with the dispatcher's queries and no tensor crosses streams.

On a mesh (``mesh=``: a 1-D ``data_mesh`` or a (replica, data)
``replica_mesh``) the engine's dispatcher holds the repository as shards
(:mod:`repro_torch.engine.sharded`, :mod:`repro_torch.engine.replicated`)
and a mutation touches only what it must:

  * **owner writes**: a publish writes each slot j into its owner shard
    ``j // shard_slots`` at local row ``j % shard_slots`` (in every
    replica group), out of place, on that shard's tensors alone; the
    other shards keep their slot tensors, the same storage;
  * **one upper tree**: the root summaries of one group's shards are
    gathered in shard order onto the lead device, trimmed to the logical
    slot count, and the tree is built there at the local shape, as
    ``build_frozen`` builds it (PyTorch's reductions split by shape, so a
    tree built per shard or at the padded shape could differ in a last
    bit), then copied to every shard;
  * **shard-aligned growth**: the grown tier has ``ceil(n_slots / n) * n``
    physical rows, logical slot j stays at physical row j, and shard i
    takes rows ``[i * S, (i + 1) * S)`` of the old shards followed by the
    zero tier, by device-to-device copies;
  * the successor layouts are installed with one attribute write
    (``dispatch.install``), the mesh's linearisation point.

After any mutation sequence every shard is bitwise
``shard_repository(build_frozen(...))`` of the same slot contents, and
every op equals the local live engine's.
"""
from __future__ import annotations

import heapq
import threading
import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import repo_mutate
from repro_torch.core.index import DatasetIndex
from repro_torch.core.repo_index import RepoIndex, Repository
from repro_torch.device import resolve_device
from repro_torch.engine.engine import QueryEngine
from repro_torch.engine.sharded import ShardLayout, gather_repository

__all__ = ["LiveRepository", "PreparedGroup", "PreparedMutation"]


@dataclass
class PreparedMutation:
    """One mutation after its prepare stage: the target slot (reserved for
    an ingest), the built batch-of-1 row and signature (the zero row for a
    delete), or the error its prepare raised (every reservation then
    already returned)."""
    op: str
    slot: int | None = None
    points: np.ndarray | None = None    # host copy (slot-data ground truth)
    row: DatasetIndex | None = None     # batch-of-1 row on the device
    sig: torch.Tensor | None = None     # (1, W) signature words
    valid: bool = False
    error: Exception | None = None


@dataclass
class PreparedGroup:
    """An ordered run of prepared mutations awaiting one coalesced publish
    (or :meth:`LiveRepository.abort_group`)."""
    items: list = field(default_factory=list)
    published: bool = False
    aborted: bool = False


def _slots(shard: Repository) -> tuple:
    """A shard's slot tensors: the bottom-tree fields, signatures,
    validity."""
    return (*shard.ds_index, shard.ds_sigs, shard.ds_valid)


def _with_slots(shard: Repository, tensors) -> Repository:
    """``shard`` with the slot tensors :func:`_slots` lists replaced."""
    return shard._replace(ds_index=DatasetIndex(*tensors[:-2]),
                          ds_sigs=tensors[-2], ds_valid=tensors[-1])


class LiveRepository:
    """A mutable, versioned repository serving through a QueryEngine.

    ``mesh=None`` serves from one device; a 1-D mesh selects sharded
    dispatch and a (replica, data) mesh replica-parallel dispatch, and
    mutation works the same on all three.  ``point_capacity`` reserves
    bottom-tree headroom for datasets larger than any initial one (an
    oversize ingest raises); ``repo_leaf_capacity`` is the upper tree's
    fanout (``leaf_capacity`` by default) and ``slot_headroom`` doubles
    the first slot tier that many times.  ``clock`` is the timebase of the
    publish accounting (tests inject virtual time).  The remaining
    keywords (``result_cache_size``, ``default_chunk``) go to
    :class:`~repro_torch.engine.engine.QueryEngine`.  It runs on ``cuda``
    unless given ``device="cpu"``; on a mesh, rows are built on the
    mesh's lead device, and ``device`` may only name its kind."""

    #: rows per slot write inside one publish; larger groups are chunked.
    #: A chunk is padded to a power of two, so the writes take at most
    #: log2(MAX_GROUP) + 1 shapes per tier.
    MAX_GROUP = 16

    def __init__(
        self,
        datasets: Sequence[np.ndarray],
        *,
        mesh=None,
        leaf_capacity: int = 16,
        repo_leaf_capacity: int | None = None,
        theta: int = 5,
        remove_outliers: bool = True,
        point_capacity: int | None = None,
        slot_headroom: int = 0,
        clock=time.perf_counter,
        device=None,
        **engine_kwargs,
    ):
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = mesh.lead
            if (device is not None
                    and resolve_device(device).type != self.device.type):
                raise ValueError(f"device {device!r} is not the kind of the "
                                 f"mesh's devices ({self.device})")
        self.mesh = mesh
        self._clock = clock
        repo, geom = repo_mutate.init_live(
            datasets, leaf_capacity=leaf_capacity,
            repo_leaf_capacity=repo_leaf_capacity, theta=theta,
            remove_outliers=remove_outliers, point_capacity=point_capacity,
            slot_headroom=slot_headroom, device=self.device)
        self.geometry = geom
        self.engine = QueryEngine(repo, leaf_capacity=leaf_capacity,
                                  mesh=mesh, **engine_kwargs)
        del repo                 # on a mesh the shards are the only copy
        B = len(datasets)
        #: data epoch of the published repository (monotone, starts at 0)
        self.epoch = 0
        #: per-slot epoch: the data epoch at which the slot last changed
        self.slot_epochs = np.zeros(geom.n_slots, np.int64)
        #: host-to-device bytes moved by mutations: ingest and replace
        #: payloads only (delete and tier growth upload nothing)
        self.bytes_uploaded = 0
        self.mutations = 0
        self._live: set = set(range(B))
        self._free: list = list(range(B, geom.n_slots))
        heapq.heapify(self._free)
        # host copies of the current slot contents: the ground truth the
        # frozen oracle rebuilds from
        self._slot_data = {j: np.asarray(ds, np.float32)
                           for j, ds in enumerate(datasets)}
        # the inner lock guards the free list, the live set and the
        # publish; direct ingest / delete / replace also serialise on the
        # outer one (each is a group-of-1 prepare + publish), so a server
        # can prepare a group while a query segment runs
        self._lock = threading.Lock()
        self._api_lock = threading.Lock()
        zr, zs = repo_mutate.zero_slot_row(geom, device=self.device)
        # batch-of-1 zero row: deletes share the batched slot write
        self._zero_row1 = (DatasetIndex(*[x[None] for x in zr]), zs[None])
        #: tiers reserved virtually by prepare (free list extended past the
        #: current slot count) and not yet materialised by a publish
        self._grows_pending = 0
        self.engine.set_repo_epoch(0, self.slot_epochs)

    # -- views -------------------------------------------------------------

    @property
    def repo(self) -> Repository | None:
        """The currently published repository on one device; ``None`` on a
        mesh (as ``engine.repo``), where :attr:`shards` is the resident
        state and :meth:`gathered_repository` makes a copy for checks."""
        return self.engine.dispatch.repo if self.mesh is None else None

    def gathered_repository(self) -> Repository:
        """The published logical repository: on a mesh, a copy of the first
        replica group's shards gathered on the lead device (the whole
        repository, for checks); on one device, :attr:`repo` itself."""
        if self.mesh is None:
            return self.repo
        return gather_repository(self.engine.dispatch.layouts[0],
                                 self.device)

    @property
    def shards(self) -> tuple:
        """On a mesh, the published shard Repositories of every replica
        group, in the order of ``mesh.flat``."""
        return tuple(sh for L in self.engine.dispatch.layouts
                     for sh in L.shards)

    @property
    def stats(self):
        return self.engine.stats

    @property
    def live_ids(self) -> set:
        return set(self._live)

    @property
    def n_slots(self) -> int:
        return self.geometry.n_slots

    def search(self, queries):
        """Answer a declarative batch at the current epoch (see
        :meth:`QueryEngine.search`)."""
        return self.engine.search(queries)

    def slot_datasets(self) -> list:
        """Current slot contents, None for holes: the input of
        :func:`~repro_torch.core.repo_mutate.build_frozen`."""
        return [self._slot_data.get(j) for j in range(self.geometry.n_slots)]

    def frozen_repository(self) -> Repository:
        """The cold-built oracle of the current live state, on the same
        device; bitwise equal to :attr:`repo` by construction."""
        return repo_mutate.build_frozen(self.slot_datasets(), self.geometry,
                                        device=self.device)

    # -- mutations ---------------------------------------------------------

    def ingest(self, points) -> int:
        """Add a dataset; returns its slot id (stable until deleted).  The
        slot tier grows first when the free list is empty."""
        return self._apply_one("ingest", None, points)

    def delete(self, ds_id: int) -> None:
        """Remove a dataset: its slot is zeroed and returned to the free
        list."""
        self._apply_one("delete", int(ds_id), None)

    def replace(self, ds_id: int, points) -> None:
        """Swap a live dataset's contents: the slot keeps its id, its
        per-slot epoch moves, and every cached row that read it retires."""
        self._apply_one("replace", int(ds_id), points)

    def _apply_one(self, op, ds_id, points):
        with self._api_lock:
            group = self.prepare_group([(op, ds_id, points)])
            item = group.items[0]
            if item.error is not None:
                group.published = True      # nothing reserved to return
                raise item.error
            return self.publish_group(group)[0]

    # -- prepare stage -----------------------------------------------------

    def prepare_group(self, specs) -> PreparedGroup:
        """Prepare a run of mutations ``[(op, ds_id, points), ...]``:
        validation, slot reservation, the row builds and their payload
        uploads, without publishing anything.

        Items validate against a group-local view of the live set (pending
        ingests in, pending deletes out), so each outcome matches a
        sequential apply.  A failing item records its error, returns its
        reservation and leaves the rest of the group publishable."""
        items = []
        with self._lock:
            view_live = set(self._live)
        for op, ds_id, points in specs:
            try:
                if op == "ingest":
                    items.append(self._prepare_ingest(points, view_live))
                elif op == "replace":
                    items.append(
                        self._prepare_replace(int(ds_id), points, view_live))
                elif op == "delete":
                    items.append(self._prepare_delete(int(ds_id), view_live))
                else:
                    raise ValueError(f"unknown mutation op {op!r}")
            except Exception as e:  # noqa: BLE001 — recorded per item
                items.append(PreparedMutation(op, error=e))
        return PreparedGroup(items)

    def _prepare_ingest(self, points, view_live):
        # reserve first, so items of one group never collide; any failure
        # past the reservation puts the slot back
        with self._lock:
            slot = self._reserve_slot()
        try:
            pts = self._check_points(points)
            row, sig = self._build_payload(pts)
        except Exception:
            with self._lock:
                heapq.heappush(self._free, slot)
            raise
        view_live.add(slot)
        return PreparedMutation("ingest", slot=slot, points=pts, row=row,
                                sig=sig, valid=True)

    def _prepare_replace(self, ds_id, points, view_live):
        if ds_id not in view_live:
            raise KeyError(f"dataset id {ds_id} is not live")
        pts = self._check_points(points)
        row, sig = self._build_payload(pts)
        return PreparedMutation("replace", slot=ds_id, points=pts, row=row,
                                sig=sig, valid=True)

    def _prepare_delete(self, ds_id, view_live):
        if ds_id not in view_live:
            raise KeyError(f"dataset id {ds_id} is not live")
        view_live.discard(ds_id)
        row, sig = self._zero_row1
        return PreparedMutation("delete", slot=ds_id, row=row, sig=sig,
                                valid=False)

    def _build_payload(self, pts):
        geom = self.geometry
        # the canonical batch-of-1 row build, the one the frozen oracle
        # uses; its padded payload is a mutation's only upload
        row, sig = repo_mutate.build_row(pts, geom, device=self.device)
        with self._lock:
            self.bytes_uploaded += geom.point_capacity * (4 * geom.dim + 1)
        return row, sig

    def _reserve_slot(self) -> int:
        """Pop a free slot (the caller holds ``_lock``).  An empty free list
        extends virtually into the next tier, ids past the current slot
        count; the growth itself waits for the publish."""
        if not self._free:
            base = self.geometry.n_slots << self._grows_pending
            self._grows_pending += 1
            for s in range(base, 2 * base):
                heapq.heappush(self._free, s)
        return heapq.heappop(self._free)

    def abort_group(self, group: PreparedGroup) -> None:
        """Abandon a prepared, unpublished group: every ingest reservation
        returns to the free list and the group is consumed."""
        if group.published or group.aborted:
            raise RuntimeError("group already consumed")
        group.aborted = True
        with self._lock:
            for p in group.items:
                if p.error is None and p.op == "ingest":
                    heapq.heappush(self._free, p.slot)
                    p.error = RuntimeError("prepare aborted")

    # -- publish stage -----------------------------------------------------

    def publish_group(self, group: PreparedGroup):
        """Install a prepared group as one coalesced publish per
        :attr:`MAX_GROUP` chunk: one slot write and one upper-tree rebuild,
        the data epoch moved once.  Returns per-item outcomes in stream
        order: the slot id for an ingest, the dataset id for a replace,
        None for a delete, or the item's prepare exception."""
        if group.published or group.aborted:
            raise RuntimeError("group already consumed")
        group.published = True
        outcomes: list = [p.error for p in group.items]
        applied = [(i, p) for i, p in enumerate(group.items)
                   if p.error is None]
        with self._lock:
            for lo in range(0, len(applied), self.MAX_GROUP):
                self._publish_chunk(
                    [p for _, p in applied[lo:lo + self.MAX_GROUP]])
        for i, p in applied:
            outcomes[i] = None if p.op == "delete" else p.slot
        return outcomes

    def _publish_chunk(self, chunk) -> None:
        """One coalesced install (the caller holds ``_lock``): materialise
        the tier growth the prepare stage reserved, dedup the writes by slot
        (the last write wins), pad to a power of two by repeating the last
        write (the same bits written twice), write, then apply the host
        bookkeeping in stream order and publish the successor epoch."""
        t0 = self._clock()
        top = max(p.slot for p in chunk)
        while top >= self.geometry.n_slots:
            self._grow()
        last: dict = {}
        for p in chunk:                      # insertion order kept, the
            last[p.slot] = p                 # value is the LAST write
        writes = list(last.values())
        bucket = 1
        while bucket < len(writes):
            bucket *= 2
        writes = writes + [writes[-1]] * (bucket - len(writes))
        dev = self.device
        slots = torch.tensor([p.slot for p in writes], dtype=torch.int64,
                             device=dev)
        rows = DatasetIndex(*[torch.cat(xs, dim=0)
                              for xs in zip(*[p.row for p in writes])])
        sigs = torch.cat([p.sig for p in writes], dim=0)
        valids = torch.tensor([p.valid for p in writes], dtype=torch.bool,
                              device=dev)
        if self.mesh is None:
            new = repo_mutate.update_slots(self.repo, slots, rows, sigs,
                                           valids, geom=self.geometry)
        else:
            new = self._owner_writes([p.slot for p in writes], rows, sigs,
                                     valids)
        for p in chunk:
            if p.op == "delete":
                self._live.discard(p.slot)
                self._slot_data.pop(p.slot, None)
                heapq.heappush(self._free, p.slot)
            else:
                self._live.add(p.slot)
                self._slot_data[p.slot] = p.points
        self.mutations += len(chunk)
        self._publish(new, touched=tuple(last))
        self.engine.stats.record_publish(self._clock() - t0,
                                         coalesced=len(chunk) - 1)

    # -- internals ---------------------------------------------------------

    def _check_points(self, points) -> np.ndarray:
        points = np.asarray(points, np.float32)
        geom = self.geometry
        if points.ndim != 2 or points.shape[1] != geom.dim:
            raise ValueError(f"expected (n, {geom.dim}) points, got "
                             f"{points.shape}")
        if points.shape[0] == 0:
            raise ValueError("cannot ingest an empty dataset")
        if points.shape[0] > geom.point_capacity:
            raise ValueError(
                f"dataset with {points.shape[0]} points exceeds the pinned "
                f"point capacity {geom.point_capacity}; rebuild the live "
                f"repository with point_capacity >= {points.shape[0]}")
        return points

    def _grow(self) -> None:
        """Materialise the tier the prepare stage reserved virtually: zeros
        appended on the device (no upload; shard-aligned on a mesh), the
        dispatcher's slot count and layout epoch moved, and the grown state
        published as its own data epoch (dataset-op rows change width with
        the slot axis; point-op rows survive, since no slot's contents
        changed)."""
        old_n = self.geometry.n_slots
        geom = self.geometry.grown()
        disp = self.engine.dispatch
        if self.mesh is None:
            grown = repo_mutate.grow_slots(self.repo, geom)
            disp.n_slots = geom.n_slots
        else:
            grown = self._regrid(geom)
        self.geometry = geom
        self.slot_epochs = np.concatenate(
            [self.slot_epochs, np.zeros(geom.n_slots - old_n, np.int64)])
        self._grows_pending -= 1
        disp.repo_epoch += 1
        self._publish(grown, touched=())

    # -- the mesh ------------------------------------------------------------

    def _owner_writes(self, slots: list, rows: DatasetIndex,
                      sigs: torch.Tensor, valids: torch.Tensor) -> tuple:
        """The successor layouts of a publish on a mesh: in every replica
        group, write ``k`` of the chunk lands in its owner shard
        ``slots[k] // S`` at local row ``slots[k] % S`` (out of place,
        ``index_copy`` on that shard's slot tensors); shards that own no
        write keep theirs.  Then the one upper tree (:meth:`_with_tree`)."""
        payload = (*rows, sigs, valids)
        layouts = []
        for L in self.engine.dispatch.layouts:
            S = L.shard_slots
            owned: dict = {}
            for k, j in enumerate(slots):
                owned.setdefault(j // S, []).append(k)
            shards = list(L.shards)
            for i, ks in owned.items():
                dev = shards[i].device
                pick = torch.tensor(ks, dtype=torch.int64, device=self.device)
                local = torch.tensor([slots[k] % S for k in ks],
                                     dtype=torch.int64, device=dev)
                shards[i] = _with_slots(shards[i], [
                    a.index_copy(0, local, r.index_select(0, pick).to(dev))
                    for a, r in zip(_slots(shards[i]), payload)])
            layouts.append(L._replace(shards=tuple(shards)))
        return self._with_tree(layouts, self.geometry)

    def _regrid(self, geom: repo_mutate.RepoGeometry) -> tuple:
        """The grown tier on a mesh, shard-aligned: ``n_phys = ceil(n_slots
        / n) * n`` physical rows, logical slot j at physical row j, shard i
        holding rows ``[i * S, (i + 1) * S)`` of the old shards' slices in
        order followed by zero rows (the all-gather and slice of the JAX
        package, as device-to-device copies)."""
        layouts = []
        for L in self.engine.dispatch.layouts:
            n = len(L.shards)
            n_phys = -(-geom.n_slots // n) * n
            old_s, new_s = L.shard_slots, n_phys // n
            old = [_slots(sh) for sh in L.shards]
            shards = []
            for i, sh in enumerate(L.shards):
                lo, hi = i * new_s, (i + 1) * new_s
                # (old shard k, its local rows a:b) inside [lo, hi)
                spans = [(k, max(lo, k * old_s) - k * old_s,
                          min(hi, (k + 1) * old_s) - k * old_s)
                         for k in range(n)
                         if max(lo, k * old_s) < min(hi, (k + 1) * old_s)]
                zeros = new_s - sum(b - a for _, a, b in spans)

                def grown(f, dev=sh.device):
                    x = old[0][f]
                    return torch.cat(
                        [old[k][f][a:b].to(dev) for k, a, b in spans]
                        + [torch.zeros((zeros,) + tuple(x.shape[1:]),
                                       dtype=x.dtype, device=dev)])

                shards.append(_with_slots(sh, [grown(f)
                                               for f in range(len(old[0]))]))
            layouts.append(ShardLayout(tuple(shards), geom.n_slots, n_phys))
        return self._with_tree(layouts, geom)

    def _with_tree(self, layouts, geom) -> tuple:
        """The layouts with the upper tree of their slot contents: the root
        summaries of the first group's shards gathered in shard order onto
        the lead device and trimmed to the logical slots, the tree built
        there once at the local shape, then copied to every shard."""
        parts = [(*sh.roots(), sh.ds_sigs, sh.ds_valid)
                 for sh in layouts[0].shards]
        roots = [torch.cat([p[f].to(self.device) for p in parts])[
            :geom.n_slots] for f in range(len(parts[0]))]
        tree = repo_mutate.upper_from_roots(*roots, geom.upper_depth)
        return tuple(L._replace(shards=tuple(
            sh._replace(repo=RepoIndex(*[x.to(sh.device) for x in tree]))
            for sh in L.shards)) for L in layouts)

    def _publish(self, state, touched) -> None:
        """Install the successor state and its epoch: a repository on one
        device (the swap of ``dispatch.repo``), the replica groups' layouts
        on a mesh (``dispatch.install``).  That one write is the
        linearisation point: later dispatches read the successor, running
        ones keep what they read.  The epoch install then purges the
        retired result rows."""
        if self.mesh is None:
            self.engine.dispatch.repo = state
            self.engine.repo = state
        else:
            self.engine.dispatch.install(state)
        self.engine._n_valid = len(self._live)
        self.epoch += 1
        for s in touched:
            self.slot_epochs[s] = self.epoch
        self.engine.set_repo_epoch(self.epoch, self.slot_epochs,
                                   touched=touched)

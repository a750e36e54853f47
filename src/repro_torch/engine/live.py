"""LiveRepository: online ingest, delete and replace under serving traffic.

Counterpart of ``repro.engine.live`` for one device.  It makes the resident
repository a live catalog:

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

The live repository on a mesh (the JAX package's ``mesh=``: shard-aligned
growth, owner writes) is not ported (ROADMAP.md queue 1 item 12b); the
frozen sharded and replicated engines are
(:mod:`repro_torch.engine.sharded`, :mod:`repro_torch.engine.replicated`).
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
from repro_torch.core.repo_index import Repository
from repro_torch.device import resolve_device
from repro_torch.engine.engine import QueryEngine

__all__ = ["LiveRepository", "PreparedGroup", "PreparedMutation"]

MULTI_DEVICE_ITEM = "ROADMAP.md queue 1 item 12b"


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


class LiveRepository:
    """A mutable, versioned repository serving through a QueryEngine.

    ``point_capacity`` reserves bottom-tree headroom for datasets larger
    than any initial one (an oversize ingest raises).  ``clock`` is the
    timebase of the publish accounting (tests inject virtual time).  The
    remaining keywords (``result_cache_size``, ``default_chunk``) go to
    :class:`~repro_torch.engine.engine.QueryEngine`.  It runs on ``cuda``
    unless given ``device="cpu"``."""

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
        theta: int = 5,
        remove_outliers: bool = True,
        point_capacity: int | None = None,
        clock=time.perf_counter,
        device=None,
        **engine_kwargs,
    ):
        if mesh is not None:
            raise NotImplementedError(
                f"LiveRepository(mesh=...): the live repository on a mesh "
                f"is not ported to repro_torch yet ({MULTI_DEVICE_ITEM})")
        self.device = resolve_device(device)
        self._clock = clock
        repo, geom = repo_mutate.init_live(
            datasets, leaf_capacity=leaf_capacity, theta=theta,
            remove_outliers=remove_outliers, point_capacity=point_capacity,
            device=self.device)
        self.geometry = geom
        self.engine = QueryEngine(repo, leaf_capacity=leaf_capacity,
                                  **engine_kwargs)
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
    def repo(self) -> Repository:
        """The currently published repository."""
        return self.engine.dispatch.repo

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
        new_repo = repo_mutate.update_slots(self.repo, slots, rows, sigs,
                                            valids, geom=self.geometry)
        for p in chunk:
            if p.op == "delete":
                self._live.discard(p.slot)
                self._slot_data.pop(p.slot, None)
                heapq.heappush(self._free, p.slot)
            else:
                self._live.add(p.slot)
                self._slot_data[p.slot] = p.points
        self.mutations += len(chunk)
        self._publish(new_repo, touched=tuple(last))
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
        appended on the device (no upload), the dispatcher's slot count and
        layout epoch moved, and the grown state published as its own data
        epoch (dataset-op rows change width with the slot axis; point-op
        rows survive, since no slot's contents changed)."""
        old_n = self.geometry.n_slots
        geom = self.geometry.grown()
        grown = repo_mutate.grow_slots(self.repo, geom)
        self.geometry = geom
        self.slot_epochs = np.concatenate(
            [self.slot_epochs, np.zeros(geom.n_slots - old_n, np.int64)])
        self._grows_pending -= 1
        disp = self.engine.dispatch
        disp.n_slots = geom.n_slots
        disp.repo_epoch += 1
        self._publish(grown, touched=())

    def _publish(self, new_repo: Repository, touched) -> None:
        """Install the successor repository and its epoch.  The swap of
        ``dispatch.repo`` is the linearisation point: later dispatches read
        the successor, running ones keep the old tensors.  The epoch
        install then purges the retired result rows."""
        self.engine.dispatch.repo = new_repo
        self.engine.repo = new_repo
        self.engine._n_valid = len(self._live)
        self.epoch += 1
        for s in touched:
            self.slot_epochs[s] = self.epoch
        self.engine.set_repo_epoch(self.epoch, self.slot_epochs,
                                   touched=touched)

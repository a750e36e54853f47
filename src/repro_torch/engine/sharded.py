"""ShardedQueryEngine: the batched engine over a repository whose dataset
slots are split across the devices of a mesh.

Counterpart of ``repro.engine.sharded``.  The scale-out unit is the slot:
:func:`shard_repository` pads the slot axis to a multiple of the shard
count with empty slots and gives each shard a contiguous slice of
``ds_index``, ``ds_sigs`` and ``ds_valid`` on its own device, with a copy
of the small upper tree and the space bounds.  No shard holds the whole
repository, so resident bytes per shard are ~1/N (:func:`repo_device_bytes`).

A mesh is a list of devices (``core.distributed.Mesh``): the visible
cards by default, one shard each; several shards may share a device when
the caller lists it several times (``devices=["cuda:0"] * 4`` on one
card, ``["cpu"] * 8`` in the tests).  :class:`ShardedDispatcher` runs each
op as a Python loop over the shards, each step enqueued on its shard's
device, with the collectives of ``core.distributed`` between steps:

  * ``topk_ia`` / ``topk_gbo`` / ``topk_hausdorff_approx`` /
    ``topk_hausdorff`` / the joinable ops: per-shard scores, a local
    stable top-k with global ids, and the O(k) merge of
    :mod:`repro_torch.engine.merge`;
  * ``range_search``: the per-slot root test ``hit & valid`` on each
    slice, concatenated (the upper-tree traversal can never reject a
    dataset whose own MBR overlaps the box: every ancestor box contains
    it, and ancestors of a valid slot hold counts > 0);
  * ``range_points`` / ``nnp`` / the join re-rank: every shard evaluates
    the whole padded batch against its gather of the requested slots
    (ids clipped into its slice) and the owner's rows are selected
    (``distributed.owner_select``).  The rows are not regrouped by owner,
    so every per-shard call has the local engine's batch shape;
  * ApproHaus: the Lemma 1 dataset stopping level and the radius term of
    eps_eff are repository-wide, reduced by ``pmin`` / ``pmax``;
  * ExactHaus and the joinable refine run in lockstep
    (``search.bound_phases_shards`` / ``search.phase2_shards``,
    ``join_search.topk_join_scores_shards``): each query's tau is reduced
    over the shards after every chunk, with one host read per chunk for
    the whole mesh.

Bit-identity with the local :class:`~repro_torch.engine.engine.QueryEngine`
(values, ids, masks) holds because every per-slot value is computed by
the same arithmetic on the same rows, every reduction across slots is a
selection or an integer sum, and the stable per-shard top-k merged in
shard order breaks ties toward the smaller global id as the local stable
sort does.  ExactHaus's ``evaluated`` and the joinable counters depend on
the split by design, and equal the JAX package's sharded engine at the
same shard count.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import distributed, geometry, join_search
from repro_torch.core import point_search, search
from repro_torch.core.distributed import DATA_AXIS, Mesh
from repro_torch.core.index import DatasetIndex
from repro_torch.core.repo_index import RepoIndex, Repository
from repro_torch.engine import batched_ops, merge
from repro_torch.engine.engine import QueryEngine
from repro_torch.kernels import ops
from repro_torch.kernels.ref import BIG


def data_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh with one repository-sharding axis over the first
    ``n_devices`` of ``devices`` (all of them by default; the visible
    cards when ``devices`` is None, which raises without a card).  A
    request larger than the list is an error, never a smaller mesh."""
    devs = distributed.visible_cards() if devices is None else list(devices)
    if n_devices is not None:
        devs = distributed.take_devices(n_devices, devs, "data_mesh")
    return Mesh(tuple(devs), (DATA_AXIS,))


def _pad_slots(x: torch.Tensor, n_padded: int) -> torch.Tensor:
    if x.shape[0] == n_padded:
        return x
    pad = torch.zeros((n_padded - x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def shard_repository(repo: Repository, mesh: Mesh):
    """Split a Repository's dataset-slot axis across a 1-D mesh.

    The slot axis is padded to a multiple of the shard count with empty
    slots (zeros: counts 0 and valid False, masked exactly like the
    builder's own padding); shard i gets slots [i * S_shard, (i + 1) *
    S_shard) as copies on its device, and a copy of the upper tree and
    space bounds.  Returns (list of shard Repositories, padded slot
    count)."""
    devices = mesh.devices
    if mesh.axis_names != (DATA_AXIS,):
        raise ValueError(f"shard_repository: a 1-D mesh over {DATA_AXIS!r} "
                         f"is needed, got axes {mesh.axis_names}")
    n = len(devices)
    n_padded = -(-repo.n_slots // n) * n
    per = n_padded // n

    def part(x, i, dev):
        return _pad_slots(x, n_padded)[i * per:(i + 1) * per].to(
            dev, copy=True)

    def whole(x, dev):
        return x.to(dev, copy=True)

    shards = []
    for i, dev in enumerate(devices):
        shards.append(Repository(
            ds_index=DatasetIndex(*[part(x, i, dev) for x in repo.ds_index]),
            ds_sigs=part(repo.ds_sigs, i, dev),
            ds_valid=part(repo.ds_valid, i, dev),
            repo=RepoIndex(*[whole(x, dev) for x in repo.repo]),
            space_lo=whole(repo.space_lo, dev),
            space_hi=whole(repo.space_hi, dev)))
    return shards, n_padded


def repo_device_bytes(shards) -> list:
    """Resident repository bytes of each shard, in shard order: the slot
    slices count 1/N of the repository's, the upper tree and space bounds
    count whole on every shard."""
    return [sh.nbytes() for sh in shards]


class ShardLayout(NamedTuple):
    """One epoch of a sharded repository's placement: the shard
    Repositories in shard order (slot slice i on shard i), the logical
    slot count and the count padded to a multiple of the shards."""

    shards: tuple
    n_slots: int
    n_slots_sharded: int

    @property
    def shard_slots(self) -> int:
        return self.n_slots_sharded // len(self.shards)


def split_layout(repo: Repository, mesh: Mesh) -> ShardLayout:
    """The layout of ``repo`` split over a 1-D mesh
    (:func:`shard_repository`)."""
    shards, n_padded = shard_repository(repo, mesh)
    return ShardLayout(tuple(shards), repo.n_slots, n_padded)


def gather_repository(layout: ShardLayout, device) -> Repository:
    """The logical repository of a layout, gathered onto ``device``: the
    shards' slot slices concatenated in shard order and trimmed to the
    logical slots, with the first shard's upper tree and space bounds.  A
    copy, the inverse of :func:`shard_repository`."""
    shards = layout.shards

    def cat(xs):
        return torch.cat([x.to(device) for x in xs])[:layout.n_slots]

    first = shards[0]
    return Repository(
        ds_index=DatasetIndex(*[cat(xs) for xs in
                                zip(*[sh.ds_index for sh in shards])]),
        ds_sigs=cat([sh.ds_sigs for sh in shards]),
        ds_valid=cat([sh.ds_valid for sh in shards]),
        repo=RepoIndex(*[x.to(device) for x in first.repo]),
        space_lo=first.space_lo.to(device),
        space_hi=first.space_hi.to(device))


def _to(x, dev):
    if isinstance(x, DatasetIndex):
        return DatasetIndex(*[t.to(dev) for t in x])
    return x.to(dev)


class ShardedDispatcher:
    """Builds the sharded callables the QueryEngine dispatches through.

    Same call contracts as :class:`~repro_torch.engine.engine.
    LocalDispatcher`: each ``build_*`` returns a callable over the
    query-side operands (on the mesh's lead device), returning outputs
    there.  The shards are the only repository copy it keeps.  A builder
    reads :attr:`layout` once: the callable runs on that epoch, whatever
    is installed meanwhile."""

    name = "sharded"
    #: layout epoch, bumped by a live tier growth
    repo_epoch = 0

    def __init__(self, repo: Repository, mesh: Mesh):
        self.mesh = mesh
        self.layout = split_layout(repo, mesh)

    @classmethod
    def bound(cls, mesh: Mesh, layout: ShardLayout) -> "ShardedDispatcher":
        """A dispatcher over ``mesh`` holding ``layout`` (a replica group's
        builders at one epoch), without splitting a repository."""
        self = cls.__new__(cls)
        self.mesh, self.layout = mesh, layout
        return self

    # the current layout's parts, for inspection
    shards = property(lambda self: self.layout.shards)
    n_slots = property(lambda self: self.layout.n_slots)
    n_slots_sharded = property(lambda self: self.layout.n_slots_sharded)
    shard_slots = property(lambda self: self.layout.shard_slots)

    @property
    def n_shards(self) -> int:
        return len(self.mesh.devices)

    @property
    def layouts(self) -> tuple:
        """The layout of each replica group: this one's alone."""
        return (self.layout,)

    def install(self, layouts) -> None:
        """Install a successor layout: one attribute write."""
        (self.layout,) = layouts

    @property
    def device(self) -> torch.device:
        return self.mesh.lead

    @staticmethod
    def _each(L: ShardLayout, fn, *args):
        """fn(shard index, shard, *args moved to its device), per shard."""
        return [fn(i, sh, *[_to(a, sh.device) for a in args])
                for i, sh in enumerate(L.shards)]

    @staticmethod
    def _merge(lists, k: int):
        return merge.all_gather_topk([v for v, _ in lists],
                                     [g for _, g in lists], k)

    @classmethod
    def _owner_rows(cls, L: ShardLayout, ds_ids):
        """(owner shard (B,), per shard the gathered rows of the requested
        slots, ids clipped into its slice: only the owner's are right)."""
        S = L.shard_slots
        owner = ds_ids // S

        def gather(i, sh, ids):
            lid = torch.clamp(ids - i * S, 0, S - 1)
            return DatasetIndex(*[x[lid] for x in sh.ds_index])

        return owner, cls._each(L, gather, ds_ids)

    # -- dataset granularity ----------------------------------------------

    def build_range_search(self):
        L = self.layout

        def shard_mask(i, sh, r_lo, r_hi):
            _, _, lo, hi = sh.roots()
            hit = geometry.box_overlaps(lo[None], hi[None], r_lo[:, None],
                                        r_hi[:, None])
            return hit & sh.ds_valid[None, :]

        def call(r_lo, r_hi):
            masks = self._each(L, shard_mask, r_lo, r_hi)
            return distributed.all_gather(masks, dim=1)[:, :L.n_slots], None

        return call

    def build_topk_ia(self, k: int):
        L = self.layout
        S = L.shard_slots

        def shard_top(i, sh, q_lo, q_hi):
            _, _, lo, hi = sh.roots()
            ia = geometry.intersect_area(lo[None], hi[None], q_lo[:, None],
                                         q_hi[:, None])
            ia = torch.where(sh.ds_valid[None, :], ia, -1.0)
            return merge.local_topk(ia, k, i * S)

        def call(q_lo, q_hi):
            vals, ids = self._merge(self._each(L, shard_top, q_lo, q_hi), k)
            return vals, merge.sentinel_ids(vals, ids)

        return call

    def build_topk_gbo(self, k: int):
        L = self.layout
        S = L.shard_slots

        def shard_top(i, sh, q_sigs):
            counts = ops.set_intersect_counts(q_sigs, sh.ds_sigs)
            counts = torch.where(sh.ds_valid[None, :], counts, -1)
            return merge.local_topk(counts, k, i * S)

        def call(q_sigs):
            vals, ids = self._merge(self._each(L, shard_top, q_sigs), k)
            return vals, merge.sentinel_ids(vals, ids)

        return call

    def build_topk_hausdorff_approx(self, k: int):
        L = self.layout
        S = L.shard_slots

        def call(q_batch: DatasetIndex, eps):
            dq = q_batch.depth
            dd = L.shards[0].ds_index.depth
            # Lemma 1's dataset stopping level over the whole repository:
            # AND of the shards' level tests (padded slots hold counts 0
            # and pass, as builder padding does)
            ds_ok = distributed.pmin([
                search._levels_ok(sh.ds_index.radii, sh.ds_index.counts, dd,
                                  eps).all(dim=0).to(torch.int32)
                for sh in L.shards]).bool()
            q_oks = search._levels_ok(q_batch.radii, q_batch.counts, dq, eps)
            lq = search._level_for_eps(q_oks, dq)
            ld, lq_max = torch.stack(
                [search._level_for_eps(ds_ok, dd), lq.max()]).tolist()
            oq, rq, cq, in_frontier = batched_ops._gather_frontier(
                q_batch.centers, q_batch.radii, q_batch.counts, lq,
                1 << lq_max)
            q_ok = (cq > 0) & in_frontier

            def shard_top(i, sh, oq, q_ok):
                od, rd, cd = search._level_arrays(sh.ds_index, ld)
                d_ok = cd > 0
                vals = search.frontier_scores(oq, q_ok, od, d_ok)
                vals = torch.where(sh.ds_valid[None, :], vals, BIG)
                neg, gids = merge.local_topk(-vals, k, i * S)
                return neg, gids, torch.amax(torch.where(d_ok, rd, 0.0))

            parts = self._each(L, shard_top, oq, q_ok)
            neg, ids = self._merge([(n, g) for n, g, _ in parts], k)
            # the eps_eff radius term: max of the shards' maxima (exact)
            r_d = distributed.pmax([r for _, _, r in parts])
            r_q = torch.amax(torch.where(q_ok, rq, 0.0), dim=-1)
            eps_eff = torch.maximum(
                torch.tensor(eps, dtype=torch.float32, device=r_q.device),
                torch.maximum(r_q, r_d))
            return -neg, ids, eps_eff

        return call

    def build_topk_hausdorff(self, k: int, refine_levels: int, chunk: int):
        """ExactHaus in lockstep: per-shard bound phases and one phase-2
        loop for the whole batch over every shard, then the O(k) merge.
        Shard-padded slots carry BIG like invalid ones and lose every
        smallest-index tie, so k <= n_slots never surfaces a pad id."""
        L = self.layout
        S = L.shard_slots

        def call(q_batch: DatasetIndex):
            q_shards = [_to(q_batch, sh.device) for sh in L.shards]
            LBs, tau, cands, nodes, cand_after = search.bound_phases_shards(
                L.shards, q_shards, k, refine_levels, L.n_slots)
            exacts, evaluated = search.phase2_shards(
                LBs, cands, tau, q_batch, [sh.ds_index for sh in L.shards],
                k, chunk)
            lists = [merge.local_topk(
                -torch.where(sh.ds_valid[None, :], ex, BIG), k, i * S)
                for i, (sh, ex) in enumerate(zip(L.shards, exacts))]
            neg, ids = self._merge(lists, k)
            return -neg, ids, nodes, cand_after, evaluated

        return call

    def _build_topk_join(self, k: int, mode: str, chunk: int):
        L = self.layout
        S = L.shard_slots

        def call(q_pts, q_val):
            exacts, nodes, cand, evaluated = (
                join_search.topk_join_scores_shards(
                    L.shards, q_pts, q_val, k, mode, chunk))
            vals, ids = self._merge(
                [merge.local_topk(ex, k, i * S)
                 for i, ex in enumerate(exacts)], k)
            return (vals, merge.sentinel_ids(vals, ids), nodes, cand,
                    evaluated)

        return call

    def build_topk_overlap(self, k: int, chunk: int):
        return self._build_topk_join(k, "overlap", chunk)

    def build_topk_coverage(self, k: int, chunk: int):
        return self._build_topk_join(k, "coverage", chunk)

    # -- point granularity and the join re-rank ---------------------------

    def build_range_points(self):
        L = self.layout

        def call(ds_ids, r_lo, r_hi):
            owner, rows = self._owner_rows(L, ds_ids)
            parts = [point_search.range_points_core(
                d_sel, r_lo.to(d_sel.points.device),
                r_hi.to(d_sel.points.device)) for d_sel in rows]
            return tuple(distributed.owner_select(list(xs), owner)
                         for xs in zip(*parts))

        return call

    def build_nnp(self):
        L = self.layout

        def call(ds_ids, q_batch: DatasetIndex):
            owner, rows = self._owner_rows(L, ds_ids)
            parts = [point_search.nnp_pruned_core(
                _to(q_batch, d_sel.points.device), d_sel) for d_sel in rows]
            return tuple(distributed.owner_select(list(xs), owner)
                         for xs in zip(*parts))

        return call

    def build_join_rerank(self, mode: str):
        L = self.layout

        def call(ds_ids, q_pts, q_val):
            owner, rows = self._owner_rows(L, ds_ids)
            scores = [join_search.pair_scores(
                sh, d_sel.points, d_sel.valid, q_pts.to(sh.device),
                q_val.to(sh.device), mode)
                for sh, d_sel in zip(L.shards, rows)]
            return distributed.owner_select(scores, owner)

        return call


class ShardedQueryEngine(QueryEngine):
    """QueryEngine whose resident repository is split over a 1-D mesh.

    Same bucket ladder, result cache, query construction, planner and
    :class:`~repro_torch.engine.engine.EngineStats`; only dispatch
    differs.  Without ``mesh``, one shard per visible card (a one-card
    machine gets a one-shard mesh, which runs the local program)."""

    def __init__(self, repo: Repository, *, mesh: Mesh | None = None,
                 **kwargs):
        if mesh is None:
            mesh = data_mesh()
        super().__init__(repo, mesh=mesh, **kwargs)

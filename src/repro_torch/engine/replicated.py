"""Replica-parallel serving: dispatch over a (replica, data) grid of devices.

Counterpart of ``repro.engine.replicated``.  The data axis scales memory
(each shard holds 1/D of the slots); the replica axis scales throughput:
:func:`replica_mesh` arranges R x D devices as a grid, every row of it
(a replica group) holds the whole repository split over its D devices,
and :class:`ReplicatedDispatcher` splits each dispatch's query rows over
the R groups.  Each group runs the 1-D sharded pipeline of
:class:`~repro_torch.engine.sharded.ShardedDispatcher` on its own rows.

Bit-identity with the local engine holds for every R and row split:
inside a group the program is the 1-D sharded one, whose collectives
span that group's shards only; and every per-row computation depends on
its own row alone, so splitting the rows, padding them to a multiple of R
by repeating row 0, and concatenating the groups' outputs in replica
order reproduces the unsplit batch (ExactHaus's shared phase-2 frontier
is per-query lockstep; the joinable refine's shared order changes only
its counters).  The engine stack above is untouched: the result cache
short-circuits before the rows are split, and the planner books the
replica row-blocks each dispatch group spans (:meth:`row_subgroups`,
``EngineStats.replica_subgroups`` and ``group_counts``).

The R groups' :class:`~repro_torch.engine.sharded.ShardLayout` values
are one tuple, :attr:`ReplicatedDispatcher.layouts`, read once per build
(each group's builders then run on a dispatcher bound to its entry,
:meth:`ShardedDispatcher.bound`) and replaced by a live publish or tier growth with one attribute write:
a dispatch never sees group 0 at one epoch and group 1 at the next.
"""
from __future__ import annotations

import torch

from repro_torch.core import distributed
from repro_torch.core.distributed import DATA_AXIS, REPLICA_AXIS, Mesh
from repro_torch.core.index import DatasetIndex
from repro_torch.core.repo_index import Repository
from repro_torch.engine.engine import QueryEngine
from repro_torch.engine.sharded import ShardedDispatcher, split_layout


def replica_mesh(n_replicas: int, n_data: int | None = None,
                 devices=None) -> Mesh:
    """An R x D (replica, data) grid over the first R x D of ``devices``
    (the visible cards when None, which raises without a card).
    ``n_data=None`` spreads the data axis over the rest
    (``len(devices) // n_replicas``).  A request larger than the list is
    an error, never a smaller mesh."""
    if n_replicas < 1:
        raise ValueError(f"replica_mesh: n_replicas must be >= 1, "
                         f"got {n_replicas}")
    devs = distributed.visible_cards() if devices is None else list(devices)
    if n_data is None:
        n_data = max(1, len(devs) // n_replicas)
    devs = distributed.take_devices(n_replicas * n_data, devs,
                                    f"replica_mesh({n_replicas} x {n_data})")
    grid = tuple(tuple(devs[r * n_data:(r + 1) * n_data])
                 for r in range(n_replicas))
    return Mesh(grid, (REPLICA_AXIS, DATA_AXIS))


def _rows(x, sel):
    if isinstance(x, DatasetIndex):
        return DatasetIndex(*[t[sel] for t in x])
    return x[sel]


class ReplicatedDispatcher:
    """Sharded dispatch with the query rows split over replica groups: one
    :class:`ShardedDispatcher` per row of the mesh, each holding its own
    shard copies on its own devices."""

    name = "replicated"
    #: layout epoch, bumped by a live tier growth
    repo_epoch = 0

    def __init__(self, repo: Repository, mesh: Mesh):
        if mesh.axis_names != (REPLICA_AXIS, DATA_AXIS):
            raise ValueError(
                f"ReplicatedDispatcher: a ({REPLICA_AXIS!r}, {DATA_AXIS!r}) "
                f"mesh is needed, got axes {mesh.axis_names}; build one with "
                f"replica_mesh()")
        self.mesh = mesh
        self._rows = [Mesh(row, (DATA_AXIS,)) for row in mesh.devices]
        #: the groups' layouts, in replica order
        self.layouts = tuple(split_layout(repo, m) for m in self._rows)
        self.n_replicas = len(self._rows)
        self.n_shards = len(self._rows[0].devices)

    @property
    def groups(self) -> list:
        """Each replica group's dispatcher, bound to the current layouts
        (read once, so the groups of one build share an epoch)."""
        return [ShardedDispatcher.bound(m, L)
                for m, L in zip(self._rows, self.layouts)]

    def install(self, layouts) -> None:
        """Install the groups' successor layouts together: one attribute
        write."""
        self.layouts = tuple(layouts)

    # the current layout's slot counts (every group's are the same)
    n_slots = property(lambda self: self.layouts[0].n_slots)
    n_slots_sharded = property(lambda self: self.layouts[0].n_slots_sharded)
    shard_slots = property(lambda self: self.layouts[0].shard_slots)

    @property
    def device(self) -> torch.device:
        return self.mesh.lead

    def row_subgroups(self, batch: int, bucket: int) -> int:
        """Replica row-blocks a ``batch``-row dispatch at ``bucket`` rows
        spans: the padded bucket splits into ``n_replicas`` equal blocks,
        and the first ceil(batch / block) of them carry real rows."""
        n_rep = self.n_replicas
        block = -(-bucket // n_rep)
        return min(n_rep, -(-batch // block))

    def _split(self, calls):
        """One callable from the groups' callables: the rows (padded to a
        multiple of R by repeating row 0) go out in R equal blocks, and
        the groups' outputs come back concatenated in replica order and
        cut to the caller's rows.  Keyword operands (ApproHaus's eps) are
        scalars every group receives whole."""
        n_rep = self.n_replicas
        lead = self.device

        def call(*args, **kw):
            first = args[0]
            rows = (first.points if isinstance(first, DatasetIndex)
                    else first).shape[0]
            block = -(-rows // n_rep)
            idx = torch.arange(block * n_rep, device=lead)
            idx = torch.where(idx < rows, idx, 0)
            outs = [fn(*[_rows(a, idx[r * block:(r + 1) * block])
                         for a in args], **kw)
                    for r, fn in enumerate(calls)]
            if not isinstance(outs[0], tuple):
                return torch.cat([o.to(lead) for o in outs])[:rows]
            return tuple(
                None if parts[0] is None
                else torch.cat([p.to(lead) for p in parts])[:rows]
                for parts in zip(*outs))

        return call

    def _build(self, name: str, *statics):
        return self._split([getattr(g, name)(*statics) for g in self.groups])

    def build_range_search(self):
        return self._build("build_range_search")

    def build_topk_ia(self, k: int):
        return self._build("build_topk_ia", k)

    def build_topk_gbo(self, k: int):
        return self._build("build_topk_gbo", k)

    def build_topk_hausdorff_approx(self, k: int):
        return self._build("build_topk_hausdorff_approx", k)

    def build_topk_hausdorff(self, k: int, refine_levels: int, chunk: int):
        return self._build("build_topk_hausdorff", k, refine_levels, chunk)

    def build_topk_overlap(self, k: int, chunk: int):
        return self._build("build_topk_overlap", k, chunk)

    def build_topk_coverage(self, k: int, chunk: int):
        return self._build("build_topk_coverage", k, chunk)

    def build_range_points(self):
        return self._build("build_range_points")

    def build_nnp(self):
        return self._build("build_nnp")

    def build_join_rerank(self, mode: str):
        return self._build("build_join_rerank", mode)


class ReplicatedQueryEngine(QueryEngine):
    """QueryEngine serving from R replica groups of D data shards each.

    Without ``mesh``, builds ``replica_mesh(n_replicas, n_data)`` over the
    visible cards (``n_data=None``: all the rest).  ``n_replicas=1`` is
    the 1-D sharded layout."""

    def __init__(self, repo: Repository, *, n_replicas: int = 1,
                 n_data: int | None = None, mesh: Mesh | None = None,
                 **kwargs):
        if mesh is None:
            mesh = replica_mesh(n_replicas, n_data)
        super().__init__(repo, mesh=mesh, **kwargs)

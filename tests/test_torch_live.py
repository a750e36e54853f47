"""The port's live repository (``repro_torch.core.repo_mutate``,
``repro_torch.engine.live``) on the CPU, at the pinned sizes of
``tests/test_mutation_properties.py`` (leaf 8, point capacity 32).

* **Against itself**: ``init_live`` and every state a mutation sequence
  reaches are bitwise equal to the port's ``build_frozen`` of the current
  slot contents, and a mixed batch with every op (the joinable ones
  included) on the live engine is bitwise equal (vals, ids, masks) to the
  same batch on a cold engine over that build.
* **Against the JAX package** on the same sequence of ingests, deletes,
  replaces, coalesced groups, failing items, searches and replays: slot
  ids, outcomes and error types, epochs, per-slot epochs, live ids,
  uploaded bytes, result-cache hits and misses, invalidations, coalesced
  mutations and publishes exactly; the repository as in
  ``tests/test_torch_index.py`` (exact fields exact, centers and radii to
  ``rtol=1e-6``); search ids and masks exactly, vals to ``rtol=1e-6``
  (jitted XLA:CPU may contract ``d0*d0 + d1*d1`` into an FMA).  The JAX
  runs are made once, in a module fixture.
* Slot ids also equal a host model of the free list (a heap of free slots,
  extended a tier at a time).
"""
import heapq

import jax
import numpy as np
import pytest
import torch

from repro.engine import LiveRepository as JLive
from repro.engine import Query as JQuery
from repro_torch import bridge
from repro_torch.core import repo_mutate
from repro_torch.core.distributed import DATA_AXIS, Mesh
from repro_torch.engine import LiveRepository, Query, QueryEngine
from repro_torch.engine.sharded import shard_repository

N_INIT = 6
LEAF = 8
POINT_CAP = 32
WHOLE_LO = np.float32([-60, -60])
WHOLE_HI = np.float32([60, 60])
RTOL = 1e-6
EXACT_DS = ("points", "valid", "counts", "box_lo", "box_hi")
CLOSE_DS = ("centers", "radii")
EXACT_UP = ("order", "ds_valid", "box_lo", "box_hi", "sigs", "counts")
CLOSE_UP = ("centers", "radii")
JAX_SEEDS = (0, 1)


def _mk_dataset(rng, n=None):
    n = int(rng.integers(8, 28)) if n is None else n
    c = rng.uniform(-40, 40, 2)
    return (c + rng.normal(0, rng.uniform(1, 4), (n, 2))).astype(np.float32)


def _live(init, **kw):
    kw.setdefault("leaf_capacity", LEAF)
    kw.setdefault("point_capacity", POINT_CAP)
    return LiveRepository(init, device="cpu", **kw)


def _mixed_specs(rng, live_ids):
    """A mixed batch over the live set, every op of ``OPS``, as
    (op, kwargs) specs that either package's ``Query`` takes."""
    ids = sorted(live_ids)
    lo = np.sort(rng.uniform(-50, 30, (2, 2)).astype(np.float32), axis=0)
    qpts = _mk_dataset(rng)[:12]
    return [
        ("range_search", dict(r_lo=lo[0], r_hi=lo[1])),
        ("topk_ia", dict(r_lo=lo[0], r_hi=lo[1], k=int(rng.integers(1, 5)))),
        ("topk_hausdorff_approx", dict(q=qpts, k=2, eps=0.05)),
        ("topk_hausdorff", dict(q=qpts, k=3)),
        ("range_points", dict(ds_id=int(rng.choice(ids)), r_lo=WHOLE_LO,
                              r_hi=WHOLE_HI)),
        ("nnp", dict(ds_id=int(rng.choice(ids)), q=qpts)),
        ("topk_overlap", dict(q=qpts, k=3)),
        ("topk_coverage", dict(q=qpts, k=2)),
    ]


def _queries(specs, cls=Query):
    return [cls(op=op, **kw) for op, kw in specs]


def _np(x):
    return None if x is None else np.asarray(x)


def assert_repo_bitwise(a, b):
    """Two port repositories, every tensor bit for bit."""
    for x, y in zip(jax.tree.leaves(tuple(bridge.to_numpy(a))),
                    jax.tree.leaves(tuple(bridge.to_numpy(b)))):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def assert_results_bitwise(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.op == b.op
        for name in ("vals", "ids", "mask"):
            x, y = _np(getattr(a, name)), _np(getattr(b, name))
            assert (x is None) == (y is None), (a.op, name)
            if x is not None:
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (
                    a.op, name)


def assert_shards_match(live, frozen):
    """Every replica group's layout of a live repository on a mesh against
    ``shard_repository`` of the frozen oracle over that group's devices:
    slot counts, and every shard bit for bit."""
    mesh = live.mesh
    rows = ([Mesh(r, (DATA_AXIS,)) for r in mesh.devices]
            if len(mesh.axis_names) == 2 else [mesh])
    layouts = live.engine.dispatch.layouts
    assert len(layouts) == len(rows)
    for L, row in zip(layouts, rows):
        want, n_padded = shard_repository(frozen, row)
        assert (L.n_slots, L.n_slots_sharded) == (live.n_slots, n_padded)
        assert len(L.shards) == len(want)
        for got, w in zip(L.shards, want):
            assert_repo_bitwise(got, w)


def check_bit_identity(live, rng):
    """The tentpole bar: the resident repository equals the frozen oracle
    bit for bit, and a mixed batch (joinable ops included) on the live
    engine equals the same batch on a cold engine over it.  On a mesh,
    every shard of every replica group also equals the frozen oracle split
    over that group (``shard_repository``)."""
    frozen = live.frozen_repository()
    assert_repo_bitwise(live.gathered_repository(), frozen)
    if live.mesh is not None:
        assert_shards_match(live, frozen)
    qs = _queries(_mixed_specs(rng, live.live_ids))
    cold = QueryEngine(frozen, leaf_capacity=LEAF)
    assert_results_bitwise(live.search(qs), cold.search(qs))


class SlotModel:
    """The free-list rule both packages keep: the smallest free slot; an
    empty list extends by the next tier (virtually, until a publish grows
    the repository); deleted slots return at publish."""

    def __init__(self, n_init, n_slots):
        self.n_slots = n_slots
        self.free = list(range(n_init, n_slots))
        self.pending = 0
        self.live = set(range(n_init))

    def reserve(self):
        if not self.free:
            base = self.n_slots << self.pending
            self.pending += 1
            self.free.extend(range(base, 2 * base))
            heapq.heapify(self.free)
        return heapq.heappop(self.free)

    def publish(self, items):
        """items: (op, slot) of one published group, in stream order."""
        top = max(s for _, s in items)
        while top >= self.n_slots:
            self.n_slots *= 2
            self.pending = max(0, self.pending - 1)
        for op, s in items:
            if op == "delete":
                self.live.discard(s)
                heapq.heappush(self.free, s)
            else:
                self.live.add(s)


# -- the port against itself ------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_init_live_equals_build_frozen(seed):
    rng = np.random.default_rng(seed)
    init = [_mk_dataset(rng) for _ in range(4 + seed)]
    live = _live(init, remove_outliers=bool(seed % 2 == 0))
    slots = list(init) + [None] * (live.n_slots - len(init))
    assert_repo_bitwise(live.repo, repo_mutate.build_frozen(
        slots, live.geometry, device="cpu"))
    check_bit_identity(live, rng)


def _run_interleaving(seed, steps=12, mesh=None, checkpoints=None):
    """The port of the JAX package's random interleaving: ingest, delete,
    replace, search and replay, with the full bar checked after every
    step (after the steps in ``checkpoints`` and the last one, when
    given, as the JAX package's mesh runs do)."""
    rng = np.random.default_rng(seed)
    init = [_mk_dataset(rng) for _ in range(N_INIT)]
    live = _live(init, result_cache_size=64, mesh=mesh)
    model = {j: init[j] for j in range(N_INIT)}
    slots = SlotModel(N_INIT, live.n_slots)
    last = None
    mutated_since_search = True
    prev_epoch = live.epoch
    for step in range(steps):
        kind = int(rng.integers(0, 5))
        if kind == 0:
            ds = _mk_dataset(rng)
            want = slots.reserve()
            sid = live.ingest(ds)
            slots.publish([("ingest", sid)])
            assert sid == want and sid not in model
            model[sid] = ds
            mutated_since_search = True
        elif kind == 1 and len(model) > 1:
            sid = int(rng.choice(sorted(model)))
            live.delete(sid)
            slots.publish([("delete", sid)])
            del model[sid]
            mutated_since_search = True
        elif kind == 2:
            sid = int(rng.choice(sorted(model)))
            ds = _mk_dataset(rng)
            live.replace(sid, ds)
            model[sid] = ds
            mutated_since_search = True
        elif kind == 3:
            last = _queries(_mixed_specs(rng, live.live_ids))
            live.search(last)
            mutated_since_search = False
        elif last is not None and all(q.ds_id is None or q.ds_id in model
                                      for q in last):
            h0 = live.stats.result_cache_hits
            again = live.search(last)
            if not mutated_since_search:
                assert live.stats.result_cache_hits >= h0 + len(last)
            cold = QueryEngine(live.frozen_repository(), leaf_capacity=LEAF)
            assert_results_bitwise(again, cold.search(last))
        assert live.epoch >= prev_epoch
        prev_epoch = live.epoch
        assert live.live_ids == set(model) == slots.live
        assert live.n_slots == slots.n_slots
        for j in range(live.n_slots):
            assert (live._slot_data.get(j) is None) == (model.get(j) is None)
        if checkpoints is None or step in checkpoints or step == steps - 1:
            check_bit_identity(live, rng)
    return live


@pytest.mark.parametrize("seed", range(6))
def test_interleaving_matches_frozen(seed):
    _run_interleaving(seed)


def _group_specs(rng, live_ids, n):
    """A random run of n mutations, valid as a group: in-group deletes
    leave the view, so no later item names a dead id."""
    specs, view = [], set(live_ids)
    for _ in range(n):
        kind = int(rng.integers(0, 3))
        if kind == 0 or len(view) <= 1:
            specs.append(("ingest", None, _mk_dataset(rng)))
        elif kind == 1:
            sid = int(rng.choice(sorted(view)))
            view.discard(sid)
            specs.append(("delete", sid, None))
        else:
            specs.append(("replace", int(rng.choice(sorted(view))),
                          _mk_dataset(rng)))
    return specs


@pytest.mark.parametrize("seed", range(4))
def test_concurrent_prepare_at_stream_position(seed):
    """The serving schedule without threads: a group is prepared, a query
    batch runs with it in flight (and must see the pre-publish snapshot
    bit for bit), then the group publishes as one data epoch."""
    _run_concurrent_prepare(seed)


def _run_concurrent_prepare(seed, mesh=None, rounds=6, checkpoints=None):
    rng = np.random.default_rng(100 + seed)
    init = [_mk_dataset(rng) for _ in range(N_INIT)]
    live = _live(init, result_cache_size=64, mesh=mesh)
    model = {j: init[j] for j in range(N_INIT)}
    disp = live.engine.dispatch
    for round_ in range(rounds):
        specs = _group_specs(rng, model, int(rng.integers(1, 5)))
        epoch0, layout0 = live.epoch, disp.repo_epoch
        mc0 = live.stats.mutations_coalesced
        before = live.frozen_repository()
        group = live.prepare_group(specs)
        assert all(p.error is None for p in group.items)
        assert live.epoch == epoch0 and live.live_ids == set(model)
        qs = _queries(_mixed_specs(rng, live.live_ids))
        assert_results_bitwise(live.search(qs), QueryEngine(
            before, leaf_capacity=LEAF).search(qs))
        outcomes = live.publish_group(group)
        for (op, ds_id, pts), out in zip(specs, outcomes):
            if op == "ingest":
                assert out not in model
                model[out] = pts
            elif op == "delete":
                assert out is None
                del model[ds_id]
            else:
                assert out == ds_id
                model[ds_id] = pts
        grows = disp.repo_epoch - layout0
        assert live.epoch == epoch0 + 1 + grows
        assert live.stats.mutations_coalesced == mc0 + len(specs) - 1
        assert live.live_ids == set(model)
        if (checkpoints is None or round_ in checkpoints
                or round_ == rounds - 1):
            check_bit_identity(live, rng)


def test_deleted_slot_is_the_zero_row():
    """A deleted slot holds zeros everywhere, node boxes included, as a
    never-filled slot of the cold build does (not an empty built tree with
    +-inf boxes)."""
    rng = np.random.default_rng(3)
    init = [_mk_dataset(rng) for _ in range(5)]
    live = _live(init)
    live.delete(1)
    repo = live.repo
    for f, x in zip(repo.ds_index._fields, repo.ds_index):
        assert not x[1].any(), f
        assert torch.equal(x[1], x[7]), f       # 7: never filled
    assert not repo.ds_sigs[1].any() and not bool(repo.ds_valid[1])
    zr, zs = repo_mutate.zero_slot_row(live.geometry, device="cpu")
    for a, b in zip(zr, repo.ds_index):
        assert torch.equal(a, b[1])
    assert torch.equal(zs, repo.ds_sigs[1])
    check_bit_identity(live, rng)


def test_update_slots_is_functional():
    """A publish builds new tensors: the repository a running query holds
    is not written.  ``update_slots`` with one row gives the same
    repository as the live replace."""
    rng = np.random.default_rng(4)
    live = _live([_mk_dataset(rng) for _ in range(5)])
    old = live.repo
    snap = bridge.to_numpy(old)
    new0 = _mk_dataset(rng)
    live.replace(0, new0)
    row, sig = repo_mutate.build_row(new0, live.geometry, device="cpu")
    one = repo_mutate.update_slots(old, torch.tensor([0]), row, sig,
                                   torch.tensor([True]), geom=live.geometry)
    assert_repo_bitwise(one, live.repo)
    live.delete(2)
    live.ingest(_mk_dataset(rng))
    assert live.repo is not old
    for x, y in zip(jax.tree.leaves(tuple(snap)),
                    jax.tree.leaves(tuple(bridge.to_numpy(old)))):
        assert x.tobytes() == y.tobytes()


# -- the port against the JAX package on the same sequence ------------------


N_JAX_INIT = 7         # one free slot: the sequences cross the tier
N_SLOTS0 = 8           # the tier of N_JAX_INIT datasets at leaf 8


def _jax_sequence(seed, steps=14):
    """A sequence of steps drawn against the host model: single mutations,
    coalesced groups (two writes to one slot, a failing item, ingests that
    may cross the tier), bad inputs, searches and replays."""
    rng = np.random.default_rng(1000 + seed)
    init = [_mk_dataset(rng) for _ in range(N_JAX_INIT)]
    model = SlotModel(N_JAX_INIT, N_SLOTS0)
    out = []
    for step in range(steps):
        # a group early (it crosses the tier), a search mid-way and at the
        # end, whatever the draws
        kind = {2: 3, steps // 2: 4, steps - 1: 4}.get(
            step, int(rng.integers(0, 7)))
        ids = sorted(model.live)
        if kind == 0:
            out.append(("ingest", None, _mk_dataset(rng)))
            model.publish([("ingest", model.reserve())])
        elif kind == 1 and len(ids) > 2:
            sid = int(rng.choice(ids))
            out.append(("delete", sid, None))
            model.publish([("delete", sid)])
        elif kind == 2:
            out.append(("replace", int(rng.choice(ids)), _mk_dataset(rng)))
        elif kind == 3:
            a = int(rng.choice(ids))
            n_new = int(rng.integers(2, 5))
            specs = [("replace", a, _mk_dataset(rng)),
                     ("ingest", None, _mk_dataset(rng)),
                     ("delete", 10 ** 6, None),
                     ("replace", a, _mk_dataset(rng))]
            specs += [("ingest", None, _mk_dataset(rng))
                      for _ in range(n_new - 1)]
            out.append(("group", None, specs))
            model.publish([("replace", a)] + [("ingest", model.reserve())
                                              for _ in range(n_new)])
        elif kind == 4:
            out.append(("search", None, _mixed_specs(rng, model.live)))
        elif kind == 5:
            out.append(("replay", None, None))
        else:
            bad = [("ingest", None, np.zeros((0, 2), np.float32)),
                   ("ingest", None, _mk_dataset(rng, POINT_CAP + 1)),
                   ("ingest", None, np.zeros((5, 3), np.float32)),
                   ("delete", 10 ** 6, None)]
            out.append(bad[step % len(bad)])
    return init, out


def _observe(live, disp_epoch):
    s = live.stats
    return dict(epoch=live.epoch, slot_epochs=list(map(int, live.slot_epochs)),
                live=sorted(live.live_ids), n_slots=live.n_slots,
                layout=disp_epoch, bytes=live.bytes_uploaded,
                hits=s.result_cache_hits, misses=s.result_cache_misses,
                invalidations=s.epoch_invalidations,
                coalesced=s.mutations_coalesced,
                publishes=len(s.publish_seconds), mutations=live.mutations)


def _outcome(x):
    return type(x).__name__ if isinstance(x, Exception) else x


def _run_steps(live, steps, query_cls, disp_epoch, snapshot):
    """Run a step list on a live repository of either package; per step:
    (outcome, observations, repository snapshot, search results)."""
    trace = []
    last = None
    for op, ds_id, arg in steps:
        outcome, results = None, None
        if op == "group":
            group = live.prepare_group(arg)
            outcome = [_outcome(o) for o in live.publish_group(group)]
        elif op == "search":
            last = _queries(arg, query_cls)
            results = live.search(last)
        elif op == "replay":
            if last is not None and all(
                    q.ds_id is None or q.ds_id in live.live_ids
                    for q in last):
                results = live.search(last)
        else:
            try:
                fn = getattr(live, op)
                outcome = (fn(arg) if op == "ingest"
                           else fn(ds_id) if op == "delete"
                           else fn(ds_id, arg))
            except (KeyError, ValueError) as e:
                outcome = _outcome(e)
        res = None if results is None else [
            (r.op, _np(r.vals), _np(r.ids), _np(r.mask)) for r in results]
        trace.append((outcome, _observe(live, disp_epoch(live)),
                      snapshot(live.repo), res))
    return trace


@pytest.fixture(scope="module")
def jax_traces():
    traces = {}
    for seed in JAX_SEEDS:
        init, steps = _jax_sequence(seed)
        live = JLive(init, leaf_capacity=LEAF, point_capacity=POINT_CAP,
                     result_cache_size=64)
        geom = live.geometry
        traces[seed] = (init, steps, geom, _run_steps(
            live, steps, JQuery,
            lambda lv: getattr(lv.engine.dispatch, "repo_epoch", 0),
            lambda repo: jax.tree.map(np.asarray, repo)))
    return traces


def _close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want[np.isfinite(want)]).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


def _assert_repo_like_jax(got, want):
    for f in EXACT_DS:
        np.testing.assert_array_equal(getattr(got.ds_index, f),
                                      getattr(want.ds_index, f), err_msg=f)
    for f in CLOSE_DS:
        _close(getattr(got.ds_index, f), getattr(want.ds_index, f))
    np.testing.assert_array_equal(got.ds_sigs, want.ds_sigs)
    np.testing.assert_array_equal(got.ds_valid, want.ds_valid)
    for f in EXACT_UP:
        np.testing.assert_array_equal(getattr(got.repo, f),
                                      getattr(want.repo, f), err_msg=f)
    for f in CLOSE_UP:
        _close(getattr(got.repo, f), getattr(want.repo, f))
    np.testing.assert_array_equal(got.space_lo, want.space_lo)
    np.testing.assert_array_equal(got.space_hi, want.space_hi)


@pytest.mark.parametrize("seed", JAX_SEEDS)
def test_matches_jax_on_same_sequence(jax_traces, seed):
    init, steps, jgeom, want = jax_traces[seed]
    live = _live(init, result_cache_size=64)
    assert live.n_slots == N_SLOTS0
    # the pinned geometry: r' comes from node radii (sums), the rest exact
    geom = live.geometry
    np.testing.assert_allclose(geom.r_prime, jgeom.r_prime, rtol=RTOL)
    assert (geom.bottom_depth, geom.upper_depth, geom.space_lo,
            geom.space_hi) == (jgeom.bottom_depth, jgeom.upper_depth,
                               jgeom.space_lo, jgeom.space_hi)
    got = _run_steps(live, steps, Query,
                     lambda lv: lv.engine.dispatch.repo_epoch,
                     bridge.to_numpy)
    # the slot ids also follow the free-list model
    model = SlotModel(N_JAX_INIT, N_SLOTS0)
    kinds = set()
    for (op, ds_id, arg), (g_out, g_obs, g_repo, g_res), \
            (w_out, w_obs, w_repo, w_res) in zip(steps, got, want):
        kinds.add(op)
        assert g_out == w_out, (op, g_out, w_out)
        assert g_obs == w_obs, (op, g_obs, w_obs)
        _assert_repo_like_jax(g_repo, w_repo)
        assert (g_res is None) == (w_res is None)
        for (gop, gv, gi, gm), (wop, wv, wi, wm) in zip(g_res or [],
                                                        w_res or []):
            assert gop == wop
            for x, y in ((gi, wi), (gm, wm)):
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y, err_msg=gop)
            if wv is not None:
                np.testing.assert_allclose(gv, wv, rtol=RTOL, err_msg=gop)
        if op == "ingest" and not isinstance(g_out, str):
            sid = model.reserve()
            model.publish([("ingest", sid)])
            assert g_out == sid
        elif op == "delete" and not isinstance(g_out, str):
            model.publish([("delete", ds_id)])
        elif op == "group":
            items = []
            for (gop, gid, _), out in zip(arg, g_out):
                if isinstance(out, str):
                    continue
                if gop == "ingest":
                    items.append(("ingest", model.reserve()))
                    assert out == items[-1][1]
                else:
                    items.append((gop, gid))
            model.publish(items)
        assert sorted(model.live) == g_obs["live"]
    assert {"ingest", "group", "search"} <= kinds
    assert got[-1][1]["layout"] >= 1            # the tier grew


# -- tiers, validation, the prepare / publish pipeline ----------------------


def test_tier_growth_and_layout_epoch():
    rng = np.random.default_rng(10)
    live = _live([_mk_dataset(rng) for _ in range(4)], result_cache_size=16)
    n0 = live.n_slots
    assert live.engine.dispatch.repo_epoch == 0
    live.search([Query(op="range_search", r_lo=WHOLE_LO, r_hi=WHOLE_HI)])
    while live.n_slots == n0:
        live.ingest(_mk_dataset(rng))
    assert live.n_slots == 2 * n0
    assert live.engine.dispatch.repo_epoch == 1
    assert live.engine.dispatch.n_slots == live.n_slots == live.repo.n_slots
    assert len(live.slot_epochs) == live.n_slots
    check_bit_identity(live, rng)


def test_mutations_upload_only_the_payload():
    rng = np.random.default_rng(4)
    live = _live([_mk_dataset(rng) for _ in range(6)])
    geom = live.geometry
    per = geom.point_capacity * (4 * geom.dim + 1)
    assert per == POINT_CAP * 9
    assert live.bytes_uploaded == 0
    live.ingest(_mk_dataset(rng))
    live.replace(1, _mk_dataset(rng))
    live.delete(3)                              # uploads nothing
    assert live.bytes_uploaded == 2 * per
    n = 2
    while live.n_slots == 8:                    # growth uploads nothing
        live.ingest(_mk_dataset(rng))
        n += 1
    assert live.bytes_uploaded == n * per


def test_validation_errors_leave_state_untouched():
    rng = np.random.default_rng(12)
    ds = [_mk_dataset(rng) for _ in range(3)]
    live = _live(ds)
    epoch = live.epoch
    with pytest.raises(ValueError):
        live.ingest(np.zeros((0, 2), np.float32))
    with pytest.raises(ValueError):
        live.ingest(np.zeros((5, 3), np.float32))
    with pytest.raises(ValueError):
        live.ingest(np.zeros((POINT_CAP + 1, 2), np.float32))
    with pytest.raises(KeyError):
        live.delete(2 ** 20)
    live.delete(1)
    with pytest.raises(KeyError):
        live.delete(1)
    with pytest.raises(KeyError):
        live.replace(1, ds[0])
    assert live.epoch == epoch + 1
    assert live.live_ids == {0, 2}
    assert sorted(live._free) == [1] + list(range(3, live.n_slots))
    assert live.bytes_uploaded == 0
    check_bit_identity(live, rng)


def test_point_capacity_headroom():
    rng = np.random.default_rng(13)
    ds = [_mk_dataset(rng) for _ in range(3)]
    with pytest.raises(ValueError):
        _live(ds, point_capacity=4)
    live = _live(ds, point_capacity=128)
    assert live.geometry.point_capacity == 128
    live.ingest(_mk_dataset(rng, 100))
    with pytest.raises(ValueError):
        live.ingest(_mk_dataset(rng, 129))
    check_bit_identity(live, rng)


def test_failed_prepare_returns_its_slot(monkeypatch):
    rng = np.random.default_rng(15)
    live = _live([_mk_dataset(rng) for _ in range(3)])
    free0, bytes0, epoch0 = sorted(live._free), live.bytes_uploaded, \
        live.epoch

    def poisoned(points, geom, *, device=None):
        raise RuntimeError("poisoned payload")

    monkeypatch.setattr(repo_mutate, "build_row", poisoned)
    with pytest.raises(RuntimeError):
        live.ingest(_mk_dataset(rng))
    group = live.prepare_group([("ingest", None, _mk_dataset(rng))])
    assert isinstance(group.items[0].error, RuntimeError)
    monkeypatch.undo()
    assert sorted(live._free) == free0
    assert live.bytes_uploaded == bytes0 and live.epoch == epoch0
    assert live.ingest(_mk_dataset(rng)) == free0[0]
    check_bit_identity(live, rng)


def test_abort_group_returns_every_reservation():
    rng = np.random.default_rng(17)
    live = _live([_mk_dataset(rng) for _ in range(3)])
    free0, epoch0 = sorted(live._free), live.epoch
    extra = [_mk_dataset(rng) for _ in range(3)]
    group = live.prepare_group([("ingest", None, extra[0]),
                                ("ingest", None, extra[1]),
                                ("replace", 0, extra[2])])
    assert [p.slot for p in group.items[:2]] == free0[:2]
    live.abort_group(group)
    with pytest.raises(RuntimeError):
        live.publish_group(group)
    with pytest.raises(RuntimeError):
        live.abort_group(group)
    assert sorted(live._free) == free0
    assert live.epoch == epoch0 and live.live_ids == {0, 1, 2}
    assert [live.ingest(extra[0]), live.ingest(extra[1])] == free0[:2]
    check_bit_identity(live, rng)


def test_group_past_the_tier_grows_at_publish():
    """Ingests prepared past the tier reserve ids of the next tier
    virtually; the publish grows the repository once, as its own epoch."""
    rng = np.random.default_rng(21)
    live = _live([_mk_dataset(rng) for _ in range(7)])
    group = live.prepare_group([("ingest", None, _mk_dataset(rng))
                                for _ in range(3)])
    assert [p.slot for p in group.items] == [7, 8, 9]
    assert live.n_slots == 8 and live.epoch == 0
    assert live.publish_group(group) == [7, 8, 9]
    assert live.n_slots == 16 and live.engine.dispatch.repo_epoch == 1
    assert live.epoch == 2                      # the growth, the group
    assert live.stats.mutations_coalesced == 2
    assert list(live.slot_epochs[7:10]) == [2, 2, 2]
    check_bit_identity(live, rng)


def test_point_rows_survive_other_mutations():
    """Point-op rows keyed on an untouched slot survive a publish; dataset
    rows and rows of a touched slot retire and are booked."""
    rng = np.random.default_rng(6)
    live = _live([_mk_dataset(rng) for _ in range(6)], result_cache_size=16)
    qpts = _mk_dataset(rng)[:10]
    q = [Query(op="nnp", ds_id=2, q=qpts),
         Query(op="range_points", ds_id=2, r_lo=WHOLE_LO, r_hi=WHOLE_HI),
         Query(op="range_search", r_lo=WHOLE_LO, r_hi=WHOLE_HI)]
    live.search(q)
    misses = live.stats.result_cache_misses
    live.replace(4, _mk_dataset(rng))
    assert live.stats.epoch_invalidations == 1          # the dataset row
    live.search(q)
    assert live.stats.result_cache_hits == 2
    assert live.stats.result_cache_misses == misses + 1
    live.replace(2, _mk_dataset(rng))
    assert live.stats.epoch_invalidations == 4
    with pytest.raises(ValueError):
        live.engine.set_repo_epoch(1)
    cold = QueryEngine(live.frozen_repository(), leaf_capacity=LEAF)
    assert_results_bitwise(live.search(q), cold.search(q))

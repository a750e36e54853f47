"""The port's live repository on a mesh (``LiveRepository(mesh=...)``) on
the CPU, at the JAX package's sizes (``make_datasets(7, seed=1)``, leaf 8,
four extra datasets from seed 7).

* **The bar**, on ``["cpu"] * n`` meshes of 1, 3 and 8 shards and (2, 2)
  and (2, 4) replica grids, after ingest, delete, replace and growth past
  the tier: every shard of every replica group is bitwise
  ``shard_repository(build_frozen(...))`` of the same slot contents, and a
  batch of every op (pipelines included) is bitwise equal (vals, ids,
  masks) to the local live engine driven through the same sequence and to
  a cold engine on the same mesh.  Mutation outcomes, uploaded bytes (the
  payloads only) and the engine counters equal the local twin's; slot
  bodies stay split (the JAX package's residency bound).
* **Owner writes**: a publish gives new slot tensors to the owner shards
  only; every other shard keeps the same storage.
* **The layout snapshot**: a dispatcher call built before a publish or a
  tier growth (or whose lockstep phase-2 loop is under way when one
  lands) answers at the old epoch, bitwise as a cold engine over it; the
  next dispatch answers at the new one.  Sharded and replicated.
* **Interleavings** and the **concurrent-prepare** schedule of
  ``tests/test_torch_live.py`` on a 3-shard mesh and a (2, 4) grid.
* **Against the JAX package**: its ``LiveRepository`` on ``data_mesh(3)``
  and ``replica_mesh(2, 4)`` (and one with ``slot_headroom=1`` on
  ``data_mesh(3)``) runs the same mutation sequence and query batch in one
  ``conftest.run_py`` subprocess with 8 forced host devices for the
  module.  Outcomes, epochs and counts exactly; ids and masks exactly;
  vals and the repository's centers and radii to ``rtol=1e-6`` (jitted
  XLA:CPU may contract ``d0*d0 + d1*d1`` into an FMA), every other field
  exactly.  ``repo_leaf_capacity`` is held against the JAX package on one
  device, in process.

The JAX engine's ``cache_hits + cache_misses == dispatches`` counts its
executable cache, which the port does not have (eager PyTorch compiles
nothing); its counterpart here is that every answered query is a
result-cache hit or miss, with the mesh engine's counters equal to the
local one's.
"""
import numpy as np
import pytest
import torch

from conftest import run_py
from repro.engine import LiveRepository as JLive
from repro.engine import Query as JQuery
from repro_torch import bridge
from repro_torch.core import search, zorder
from repro_torch.engine import (LiveRepository, Pipeline, Query, QueryEngine,
                                data_mesh, replica_mesh)
from repro_torch.engine.sharded import repo_device_bytes
from test_live_repository import make_datasets
from test_torch_live import (_assert_repo_like_jax, _run_concurrent_prepare,
                             _run_interleaving, assert_repo_bitwise,
                             assert_shards_match)
from test_torch_sharded import assert_results_bitwise
from torch_lm_parity import one_torch_thread  # noqa: F401

LEAF = 8
RTOL = 1e-6
#: the meshes of the bar: shard counts, and (replica, data) grids
MESHES = ("1", "3", "8", "2x2", "2x4")
#: searches the stress test runs while publishes land
SEARCHES = 40
#: seconds the JAX subprocess may take (it compiles the mesh programs)
JAX_TIMEOUT = 400


def _mesh(kind: str):
    if "x" in kind:
        r, d = map(int, kind.split("x"))
        return replica_mesh(r, d, ["cpu"] * (r * d))
    return data_mesh(devices=["cpu"] * int(kind))


def _twins(mesh, **kw):
    """A live repository on ``mesh`` and its local twin, over the same
    seven datasets."""
    kw = {"leaf_capacity": LEAF, "result_cache_size": 64, "device": "cpu",
          **kw}
    ds = make_datasets(7, seed=1)
    return LiveRepository(ds, mesh=mesh, **kw), LiveRepository(ds, **kw)


def every_op_batch(live, seed, Q=Query, P=Pipeline):
    """Every op of ``OPS`` (two rows each, one with k past the live count),
    and a dataset -> point and a dataset -> dataset pipeline."""
    rng = np.random.default_rng(seed)
    ids = sorted(live.live_ids)
    geom = live.geometry
    qs = make_datasets(2, seed=50 + seed, n_points=12)
    lo = np.float32([-45, -45]) + rng.uniform(0, 20, (2, 2)).astype(
        np.float32)
    hi = lo + np.float32(40)
    g_lo = torch.tensor(geom.space_lo, dtype=torch.float32)
    g_hi = torch.tensor(geom.space_hi, dtype=torch.float32)
    batch = []
    for i, q in enumerate(qs):
        k = (3, live.n_slots)[i]
        pts = torch.as_tensor(q)[None]
        sig = zorder.signature(pts, torch.ones(pts.shape[:2], dtype=bool),
                               g_lo, g_hi, geom.theta)[0].numpy()
        batch += [
            Q(op="range_search", r_lo=lo[i], r_hi=hi[i]),
            Q(op="topk_ia", r_lo=lo[i], r_hi=hi[i], k=k),
            Q(op="topk_gbo", q_sig=sig.astype(np.uint32), k=k),
            Q(op="topk_hausdorff_approx", q=q, k=3, eps=0.5),
            Q(op="topk_hausdorff", q=q, k=k),
            Q(op="range_points", ds_id=ids[i], r_lo=lo[i], r_hi=hi[i]),
            Q(op="nnp", ds_id=ids[-1 - i], q=q),
            Q(op="topk_overlap", q=q, k=k),
            Q(op="topk_coverage", q=q, k=3)]
    if P is not None:
        batch += [P(Q(op="topk_ia", r_lo=lo[0], r_hi=hi[0], k=3),
                    Q(op="range_points", r_lo=lo[1], r_hi=hi[1])),
                  P(Q(op="topk_ia", r_lo=lo[1], r_hi=hi[1], k=4),
                    Q(op="topk_overlap", q=qs[0], k=2))]
    return batch


def check_bar(live, local, seed):
    """The live mesh against the frozen oracle split over it, and a batch
    of every op against the local twin and a cold engine on the mesh."""
    frozen = live.frozen_repository()
    assert_repo_bitwise(local.repo, frozen)
    assert_shards_match(live, frozen)
    batch = every_op_batch(live, seed)
    got = live.search(batch)
    assert_results_bitwise(got, local.search(batch))
    cold = QueryEngine(frozen, leaf_capacity=LEAF, mesh=live.mesh,
                       result_cache_size=0)
    assert_results_bitwise(got, cold.search(batch))


def _counters(live):
    s = live.stats
    return (s.queries, s.dispatches, s.result_cache_hits,
            s.result_cache_misses, s.epoch_invalidations, s.plan_groups,
            live.epoch, live.mutations, live.bytes_uploaded,
            list(live.slot_epochs), sorted(live.live_ids))


@pytest.mark.parametrize("kind", MESHES)
def test_mesh_bar_through_growth(kind):
    mesh = _mesh(kind)
    live, local = _twins(mesh)
    n_shards = len(mesh.devices[0]) if "x" in kind else len(mesh.devices)
    extra = make_datasets(4, seed=7)
    for lv in (live, local):
        assert lv.ingest(extra[0]) == 7
        lv.delete(2)
        lv.replace(4, extra[1])
    check_bar(live, local, 0)

    # growth past the tier: shard-aligned, still bitwise
    seed = 80
    while live.n_slots == 8:
        ds = make_datasets(1, seed=seed)[0]
        seed += 1
        assert live.ingest(ds) == local.ingest(ds)
    assert live.n_slots == local.n_slots == 16
    disp = live.engine.dispatch
    assert disp.repo_epoch == local.engine.dispatch.repo_epoch == 1
    n_phys = -(-16 // n_shards) * n_shards
    assert all(L.n_slots_sharded == n_phys for L in disp.layouts)
    check_bar(live, local, 1)

    # slot bodies stay split: no shard holds more than its slice plus the
    # upper tree and bounds every shard holds whole
    per = repo_device_bytes(live.shards)
    assert len(per) == len(mesh.flat)
    total = sum(per)
    body = sum(x.numel() * x.element_size() for x in local.repo.ds_index)
    assert max(per) <= (total - body) + body // n_shards + body // 8

    # every answered query is a result-cache hit or miss (pipeline stages
    # are booked outside the cache, so the batch has none); a repeat is
    # all hits
    batch = every_op_batch(live, 2, Query, None)
    s = live.stats
    h0, m0, q0 = s.result_cache_hits, s.result_cache_misses, s.queries
    for lv in (live, local):
        lv.search(batch)
        lv.search(batch)
    hits, misses = s.result_cache_hits - h0, s.result_cache_misses - m0
    assert hits + misses == s.queries - q0 == 2 * len(batch)
    assert hits >= len(batch)
    assert _counters(live) == _counters(local)
    per_payload = live.geometry.point_capacity * (4 * live.geometry.dim + 1)
    assert live.bytes_uploaded == (2 + seed - 80) * per_payload


def _storage(sh):
    return [x.data_ptr() for x in (*sh.ds_index, sh.ds_sigs, sh.ds_valid)]


@pytest.mark.parametrize("kind", ["3", "2x2"])
def test_publish_writes_only_the_owner_shards(kind):
    """A replace, then a coalesced group (a replace, a delete, an ingest)
    give new slot tensors to the shards that own a written slot alone, in
    every replica group; every shard gets the rebuilt upper tree; a delete
    uploads nothing."""
    live, local = _twins(_mesh(kind))
    extra = make_datasets(4, seed=7)
    S = live.engine.dispatch.layouts[0].shard_slots
    n = len(live.engine.dispatch.layouts[0].shards)
    owners_seen = set()
    for round_, specs in enumerate((
            [("replace", 4, extra[0])],
            [("replace", 5, extra[1]), ("delete", 4, None),
             ("ingest", None, extra[2])])):
        before = [(_storage(sh), sh.repo.radii.data_ptr())
                  for sh in live.shards]
        outs = live.publish_group(live.prepare_group(specs))
        assert outs == local.publish_group(local.prepare_group(specs))
        owners = {(ds_id if out is None else out) // S
                  for (_, ds_id, _), out in zip(specs, outs)}
        owners_seen |= owners
        for i, (sh, (slots, tree)) in enumerate(zip(live.shards, before)):
            if i % n in owners:
                assert all(a != b for a, b in zip(_storage(sh), slots))
            else:
                assert _storage(sh) == slots
            assert sh.repo.radii.data_ptr() != tree
        check_bar(live, local, round_)
    assert len(owners_seen) < n                 # some shard stayed put
    per_payload = live.geometry.point_capacity * (4 * live.geometry.dim + 1)
    assert live.bytes_uploaded == 3 * per_payload


# -- the layout snapshot ----------------------------------------------------


def _dispatch(disp, q_batch):
    """Two builds of one epoch: ExactHaus (lockstep phase 2) and RangeS."""
    exact = disp.build_topk_hausdorff(3, 2, 2)
    ranges = disp.build_range_search()
    lo, hi = torch.tensor([[-50.0, -50.0]]), torch.tensor([[50.0, 50.0]])
    return lambda: (exact(q_batch), ranges(lo, hi)[0])


def _same(got, want):
    for a, b in zip(got[0] + (got[1],), want[0] + (want[1],)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["3", "2x2"])
def test_call_answers_at_its_build_epoch(kind, monkeypatch):
    """A dispatcher call built before a publish and a tier growth answers
    at the old epoch (its RangeS masks keep the old slot width), bitwise
    as a cold engine on the same mesh over the old state; so does a call
    whose lockstep phase-2 loop is under way when a publish lands.  The
    next dispatch sees the new epoch."""
    mesh = _mesh(kind)
    live, _ = _twins(mesh)
    q = make_datasets(1, seed=9, n_points=12)[0]
    q_batch = live.engine.build_queries([q])
    disp = live.engine.dispatch

    def cold(frozen):
        return _dispatch(QueryEngine(frozen, leaf_capacity=LEAF, mesh=mesh)
                         .dispatch, q_batch)()

    extra = make_datasets(4, seed=7)
    old = cold(live.frozen_repository())
    call = _dispatch(disp, q_batch)
    assert live.ingest(extra[0]) == 7
    assert live.ingest(extra[1]) == 8            # the tier grows to 16
    assert disp.repo_epoch == 1
    got = call()
    assert got[1].shape[1] == 8
    _same(got, old)
    new = cold(live.frozen_repository())
    _same(_dispatch(disp, q_batch)(), new)

    # a publish inside a running lockstep loop (slot 0 becomes the query
    # itself, the nearest dataset): the loop keeps its shards
    real = search.phase2_shards
    landed = []

    def publish_first(*args, **kw):
        if not landed:
            landed.append(live.replace(0, q))
        return real(*args, **kw)

    monkeypatch.setattr(search, "phase2_shards", publish_first)
    _same(_dispatch(disp, q_batch)(), new)
    assert landed
    monkeypatch.undo()
    final = cold(live.frozen_repository())
    assert not torch.equal(final[0][0], new[0][0])   # the replace shows
    _same(_dispatch(disp, q_batch)(), final)


@pytest.mark.parametrize("kind", ["3", "2x2"])
def test_publishes_never_tear_a_dispatch(kind):
    """One thread publishes a two-slot replace (slots 0 and 6: two shards)
    back and forth between two states while another thread searches, the
    interpreter switching threads every microsecond.  Every answer
    equals a cold engine's over one of the two states: a dispatch that
    read slot 0's shard at one epoch and slot 6's at the other would
    match neither.  (Each dispatch group reads one epoch; two groups of
    one ``search()`` may read two, on one device as on a mesh.)"""
    import sys
    import threading

    live, _ = _twins(_mesh(kind), result_cache_size=0)
    extra = make_datasets(4, seed=7)
    states = ([("replace", 0, extra[0]), ("replace", 6, extra[1])],
              [("replace", 0, extra[2]), ("replace", 6, extra[3])])
    lo, hi = np.float32([-60, -60]), np.float32([60, 60])
    q = make_datasets(1, seed=9, n_points=12)[0]
    batch = [Query(op="topk_ia", r_lo=lo, r_hi=hi, k=8),
             Query(op="topk_hausdorff_approx", q=q, k=8, eps=0.5),
             Query(op="topk_hausdorff", q=q, k=8, chunk=1)]
    want = []
    for specs in states:
        live.publish_group(live.prepare_group(specs))
        want.append(QueryEngine(live.frozen_repository(), leaf_capacity=LEAF,
                                result_cache_size=0).search(batch))

    def same(a, b):
        return np.array_equal(a.vals, b.vals) and np.array_equal(a.ids, b.ids)

    assert not any(same(a, b) for a, b in zip(*want))
    stop, answers, errors = threading.Event(), [], []

    def publish():
        r = 0
        try:
            while not stop.is_set():
                live.publish_group(live.prepare_group(states[r % 2]))
                r += 1
        except Exception as e:          # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    writer = threading.Thread(target=publish)
    try:
        writer.start()
        for _ in range(SEARCHES):
            answers.append(live.search(batch))
    finally:
        stop.set()
        writer.join(timeout=120)
        sys.setswitchinterval(interval)
    assert not writer.is_alive() and not errors
    for got in answers:
        for i, r in enumerate(got):
            assert same(r, want[0][i]) or same(r, want[1][i]), r.op


# -- interleavings and the prepare / publish schedule -----------------------


@pytest.mark.parametrize("kind", ["3", "2x4"])
def test_interleaving_on_a_mesh(kind):
    """``tests/test_torch_live.py``'s random interleaving on a mesh, as the
    JAX package's mesh runs: the full bar (shards included) after step 4
    and the last; every replay against a cold engine."""
    _run_interleaving(3, steps=10, mesh=_mesh(kind), checkpoints=(4,))


@pytest.mark.parametrize("kind", ["3", "2x4"])
def test_concurrent_prepare_on_a_mesh(kind):
    """Groups prepared while a batch runs on the pre-publish snapshot,
    then published as one epoch through the owner writes; the full bar
    after round 2 and the last, as the JAX package's mesh runs."""
    _run_concurrent_prepare(5, mesh=_mesh(kind), rounds=6, checkpoints=(2,))


# -- against the JAX package --------------------------------------------------

_JAX_SIDE = """
import numpy as np, jax
from repro.engine import LiveRepository, Pipeline, Query, data_mesh, replica_mesh
from test_live_repository import make_datasets
from test_torch_live_mesh import MUTATIONS, every_op_batch

out = {{}}
for name, mesh, kw in (("sharded", data_mesh(3), {{}}),
                       ("replicated", replica_mesh(2, 4), {{}}),
                       ("headroom", data_mesh(3), {{"slot_headroom": 1}})):
    live = LiveRepository(make_datasets(7, seed=1), mesh=mesh,
                          leaf_capacity=8, result_cache_size=16, **kw)
    outcomes = []
    for specs in MUTATIONS:
        outs = live.publish_group(live.prepare_group(specs))
        outcomes += [-1 if o is None else o for o in outs]
    res = live.search(every_op_batch(live, 3, Query, None))
    out[name + "/outcomes"] = np.asarray(outcomes)
    out[name + "/obs"] = np.asarray([live.epoch, live.n_slots,
                                     live.engine.dispatch.repo_epoch,
                                     live.bytes_uploaded, live.mutations,
                                     live.stats.mutations_coalesced])
    out[name + "/slot_epochs"] = np.asarray(live.slot_epochs)
    out[name + "/live"] = np.asarray(sorted(live.live_ids))
    for p, x in jax.tree_util.tree_flatten_with_path(live.repo)[0]:
        key = "/".join(getattr(k, "name", str(k)) for k in p)
        out[name + "/repo/" + key] = np.asarray(x)
    for i, r in enumerate(res):
        for f in ("vals", "ids", "mask"):
            if getattr(r, f) is not None:
                out[f"{{name}}/res/{{i}}/{{f}}"] = np.asarray(getattr(r, f))
np.savez({path!r}, **out)
print("JAX_SIDE_OK")
"""

#: the mutation sequence both packages run: single mutations, then a
#: coalesced group whose ingests cross the 8-slot tier
MUTATIONS = (
    [("ingest", None, make_datasets(1, seed=7)[0])],
    [("delete", 2, None)],
    [("replace", 4, make_datasets(2, seed=7)[1])],
    [("ingest", None, make_datasets(3, seed=7)[2]),
     ("ingest", None, make_datasets(4, seed=7)[3]),
     ("replace", 0, make_datasets(1, seed=11)[0]),
     ("delete", 5, None)],
)


@pytest.fixture(scope="module")
def jax_mesh_runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_live_mesh") / "side.npz")
    out = run_py(_JAX_SIDE.format(path=path), devices=8, timeout=JAX_TIMEOUT)
    assert "JAX_SIDE_OK" in out
    return dict(np.load(path))


def _jax_repo(z, name, n_slots):
    """The JAX live repository of one run, its slot axis cut to the
    logical slots (JAX pads it to the shard count)."""
    from repro.core.index import DatasetIndex as JIndex
    from repro.core.repo_index import RepoIndex as JRepoIndex

    def part(prefix, cls, cut):
        return cls(*[z[f"{name}/repo/{prefix}{f}"][:n_slots] if cut
                     else z[f"{name}/repo/{prefix}{f}"] for f in cls._fields])

    from repro.core.repo_index import Repository as JRepository
    return JRepository(
        ds_index=part("ds_index/", JIndex, True),
        ds_sigs=z[f"{name}/repo/ds_sigs"][:n_slots],
        ds_valid=z[f"{name}/repo/ds_valid"][:n_slots],
        repo=part("repo/", JRepoIndex, False),
        space_lo=z[f"{name}/repo/space_lo"],
        space_hi=z[f"{name}/repo/space_hi"])


@pytest.mark.parametrize("name,kind,kw", [
    ("sharded", "3", {}), ("replicated", "2x4", {}),
    ("headroom", "3", {"slot_headroom": 1})])
def test_matches_jax_live_mesh(jax_mesh_runs, name, kind, kw):
    z = jax_mesh_runs
    live = LiveRepository(make_datasets(7, seed=1), mesh=_mesh(kind),
                          leaf_capacity=LEAF, result_cache_size=16,
                          device="cpu", **kw)
    outcomes = []
    for specs in MUTATIONS:
        outs = live.publish_group(live.prepare_group(specs))
        outcomes += [-1 if o is None else o for o in outs]
    np.testing.assert_array_equal(outcomes, z[f"{name}/outcomes"])
    np.testing.assert_array_equal(
        [live.epoch, live.n_slots, live.engine.dispatch.repo_epoch,
         live.bytes_uploaded, live.mutations,
         live.stats.mutations_coalesced], z[f"{name}/obs"])
    np.testing.assert_array_equal(live.slot_epochs, z[f"{name}/slot_epochs"])
    np.testing.assert_array_equal(sorted(live.live_ids), z[f"{name}/live"])
    _assert_repo_like_jax(bridge.to_numpy(live.gathered_repository()),
                          _jax_repo(z, name, live.n_slots))
    res = live.search(every_op_batch(live, 3, Query, None))
    for i, r in enumerate(res):
        for f in ("ids", "mask"):
            key = f"{name}/res/{i}/{f}"
            assert (getattr(r, f) is None) == (key not in z), (r.op, f)
            if key in z:
                np.testing.assert_array_equal(getattr(r, f), z[key],
                                              err_msg=r.op)
        key = f"{name}/res/{i}/vals"
        if key in z:
            np.testing.assert_allclose(r.vals, z[key], rtol=RTOL,
                                       err_msg=r.op)
    if name == "headroom":
        assert live.n_slots == 16 and live.engine.dispatch.repo_epoch == 0


def test_repo_leaf_capacity_matches_jax():
    """An upper tree of fanout 4 over 8-point leaves: the same geometry,
    repository and every-op batch as the JAX package's."""
    ds = make_datasets(7, seed=1)
    jlive = JLive(ds, leaf_capacity=LEAF, repo_leaf_capacity=4,
                  result_cache_size=0)
    live = LiveRepository(ds, leaf_capacity=LEAF, repo_leaf_capacity=4,
                          result_cache_size=0, device="cpu")
    jg, g = jlive.geometry, live.geometry
    assert (g.repo_leaf_capacity, g.upper_depth, g.n_slots) == (
        jg.repo_leaf_capacity, jg.upper_depth, jg.n_slots) == (4, 1, 8)
    extra = make_datasets(4, seed=7)
    for lv in (live, jlive):
        lv.ingest(extra[0])
        lv.ingest(extra[1])                 # past the tier: 16 slots
        lv.delete(3)
    assert live.n_slots == jlive.n_slots == 16
    _assert_repo_like_jax(bridge.to_numpy(live.repo),
                          jax_tree(jlive.repo))
    got = live.search(every_op_batch(live, 4, Query, None))
    want = jlive.search(every_op_batch(live, 4, JQuery, None))
    for a, b in zip(got, want):
        for f in ("ids", "mask"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, np.asarray(y), err_msg=a.op)
        if b.vals is not None:
            np.testing.assert_allclose(a.vals, np.asarray(b.vals),
                                       rtol=RTOL, err_msg=a.op)


def jax_tree(repo):
    import jax
    return jax.tree.map(np.asarray, repo)

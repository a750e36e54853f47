"""The port's serving front end, ``repro_torch.launch.serve_search``.

Mirrors the single-device tests of ``tests/test_serve_search.py``: mixed op
kinds in one drain, each request's rows reaching its own future, the
timeout flush of a partial batch, both drain policies, the injected clock,
poisoned-row isolation and ``stop()`` failing queued requests.  Every
served result is held against a direct ``QueryEngine.search`` of the same
item.  The live lane (the live cases of ``tests/test_serve_search.py`` and
``tests/test_mutation_properties.py``): each query segment is answered at
its stream position, bitwise as a cold engine over the frozen build of
that position, and adjacent mutations coalesce into one publish.  The
multi-device options serve from a sharded or replicated engine over a CPU
mesh, the live repository too (``--live`` with a mesh option, or
``LiveRepository(mesh=...)``), each response equal to the local live
server's.  The traffic generator gives the JAX package's stream for the same
seed, with and without a mutation lane.
"""
import time

import numpy as np
import pytest
import torch

from conftest import make_clustered_datasets
from repro.launch import serve_search as jserve
from repro_torch import bridge
from repro_torch.core import repo_mutate
from repro_torch.core.build import build_repository
from repro_torch.engine import LiveRepository, Query, QueryEngine
from repro_torch.launch import serve_search
from repro_torch.launch.serve_search import (OPS, Mutation, Request,
                                             SearchServer, _legacy_result,
                                             _to_query, make_traffic)
from test_torch_live import LEAF, POINT_CAP, _mixed_specs, _mk_dataset

THETA = 5
K = 4
WAIT = 120          # seconds any future may take before a test fails


@pytest.fixture(scope="module")
def env():
    datasets = make_clustered_datasets(17, seed=4, n_points=(20, 60))
    repo, _ = build_repository(datasets, leaf_capacity=16, theta=THETA,
                               remove_outliers=False, device="cpu")
    return datasets, repo


def _server(engine, **kw):
    return SearchServer(engine, device="cpu", **kw)


def _assert_same(got, want):
    """A served response against the same shape built from a direct
    search: arrays exactly, stats and nested results field by field."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif hasattr(want, "extras"):                  # a pipeline result
        for f in ("vals", "ids", "mask"):
            _assert_same(getattr(got, f), getattr(want, f))
        for key in ("ds_ids", "valid"):
            _assert_same(got.extras[key], want.extras[key])
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _direct(engine, op, payload):
    return _legacy_result(engine.search([_to_query(op, payload)])[0])


def test_mixed_ops_one_drain(env):
    """A burst of every op kind and all three pipeline kinds, pre-filled
    before the dispatcher starts, drains as one engine.search call: 11
    stage-1 groups and 3 stage-2 groups.  Each response equals a direct
    search of its item."""
    datasets, repo = env
    engine = QueryEngine(repo)
    server = _server(engine, max_batch=64, max_wait_ms=250.0)
    traffic = make_traffic(repo.space_lo, repo.space_hi, datasets, 27,
                           seed=3)   # >= 2 of each kind
    assert {op for op, _ in traffic} == set(OPS)
    reqs = [Request(op, _to_query(op, p)) for op, p in traffic]
    for r in reqs:
        server._queue.put(r)
    server.start()
    try:
        results = [r.future.result(timeout=WAIT) for r in reqs]
    finally:
        server.stop()
    assert server.stats.requests == 27
    assert server.stats.batches == 14
    assert server.stats.batch_size_sum == 27
    assert engine.stats.pipeline_stage1 == engine.stats.pipeline_stage2 == 6
    direct = QueryEngine(repo, result_cache_size=0)
    n_valid = int(repo.ds_valid.sum())
    for (op, payload), res in zip(traffic, results):
        want = _direct(direct, op, payload)
        if op in ("topk_overlap", "topk_coverage"):
            # the counters of a joinable query depend on the batch it
            # shared (the refine order is the batch's); vals and ids do not
            s = res[2]
            assert 0 < s.candidates_after_bounds <= s.exact_evaluations \
                <= n_valid
            res, want = res[:2], want[:2]
        _assert_same(res, want)
        if op == "topk_hausdorff":
            assert res[2].exact_evaluations > 0


def test_request_response_id_mapping(env):
    datasets, repo = env
    engine = QueryEngine(repo)
    server = _server(QueryEngine(repo), max_batch=16,
                     max_wait_ms=100.0).start()
    try:
        rng = np.random.default_rng(7)
        lo = rng.uniform(-60, 40, (9, 2)).astype(np.float32)
        hi = lo + rng.uniform(5, 40, (9, 2)).astype(np.float32)
        futures = [server.submit("topk_ia", q_lo=lo[i], q_hi=hi[i], k=K)
                   for i in range(9)]
        got = [f.result(timeout=WAIT) for f in futures]
    finally:
        server.stop()
    for i, res in enumerate(got):
        _assert_same(res, _direct(engine, "topk_ia",
                                  dict(q_lo=lo[i], q_hi=hi[i], k=K)))


def test_queue_timeout_flush(env):
    """A partial batch far below max_batch flushes after max_wait."""
    datasets, repo = env
    server = _server(QueryEngine(repo), max_batch=1024,
                     max_wait_ms=5.0).start()
    try:
        rng = np.random.default_rng(11)
        lo = rng.uniform(-60, 40, (3, 2)).astype(np.float32)
        futures = [server.submit("range_search", r_lo=lo[i], r_hi=lo[i] + 5)
                   for i in range(3)]
        for f in futures:
            f.result(timeout=WAIT)
    finally:
        server.stop()
    assert server.stats.requests == 3
    assert server.stats.batches >= 1


def test_adaptive_drain_and_latency_stats(env):
    datasets, repo = env
    engine = QueryEngine(repo)
    server = _server(engine, max_batch=16, max_wait_ms=100.0,
                     adaptive=True).start()
    try:
        rng = np.random.default_rng(23)
        lo = rng.uniform(-60, 40, (6, 2)).astype(np.float32)
        futures = [server.submit("range_search", r_lo=lo[i], r_hi=lo[i] + 8)
                   for i in range(6)]
        got = [f.result(timeout=WAIT) for f in futures]
        assert engine.stats.latency_ewma["range_search"] > 0.0
        # a lone request once the EWMAs exist takes the sized window
        lone = server.submit("range_search", r_lo=lo[0], r_hi=lo[0] + 8)
        lone_res = lone.result(timeout=WAIT)
    finally:
        server.stop()
    direct = QueryEngine(repo)
    for i, res in enumerate(got):
        _assert_same(res, _direct(direct, "range_search",
                                  dict(r_lo=lo[i], r_hi=lo[i] + 8)))
    _assert_same(lone_res, got[0])
    assert server.stats.requests == 7
    assert server.stats.op_ewma["range_search"] > 0.0
    assert server.stats.p99_ms >= server.stats.p50_ms >= 0.0


def test_depth_scaled_drain_bound(env):
    """Adaptive drains of a backlog deeper than max_batch grow to
    OVERFILL x max_batch; the static policy keeps max_batch.  _drain runs
    on unstarted, pre-filled servers."""
    datasets, repo = env
    engine = QueryEngine(repo)

    def prefill(adaptive, n):
        server = _server(engine, max_batch=8, max_wait_ms=2.0,
                         adaptive=adaptive)
        for _ in range(n):
            server._queue.put(Request("range_search", None))
        return server

    assert len(prefill(True, 3 * 8)._drain()) == 3 * 8
    assert len(prefill(True, 5 * 8)._drain()) == SearchServer.OVERFILL * 8
    assert len(prefill(True, 4)._drain()) == 4
    assert len(prefill(False, 3 * 8)._drain()) == 8


def test_submit_unknown_op_and_stopped_server(env):
    datasets, repo = env
    server = _server(QueryEngine(repo), max_batch=8)
    with pytest.raises(RuntimeError):
        server.submit("range_search", r_lo=np.zeros(2), r_hi=np.ones(2))
    server.start()
    try:
        with pytest.raises(ValueError):
            server.submit("not_an_op")
    finally:
        server.stop()


def test_poisoned_request_isolated(env):
    """A malformed request sharing a drain fails only its own future."""
    datasets, repo = env
    engine = QueryEngine(repo)
    server = _server(engine, max_batch=16, max_wait_ms=200.0)
    rng = np.random.default_rng(13)
    lo = rng.uniform(-60, 40, (2, 2)).astype(np.float32)
    hi = lo + 5.0
    good1 = Request("topk_ia", Query(op="topk_ia", r_lo=lo[0], r_hi=hi[0],
                                     k=K))
    # same (op, k) group, wrong box rank: poisons the group's stack
    bad = Request("topk_ia", Query(op="topk_ia", r_lo=np.zeros(3, np.float32),
                                   r_hi=np.ones(3, np.float32), k=K))
    good2 = Request("range_search", Query(op="range_search", r_lo=lo[1],
                                          r_hi=hi[1]))
    for r in (good1, bad, good2):
        server._queue.put(r)                    # one drain
    server.start()
    try:
        v, j = good1.future.result(timeout=WAIT)
        assert v.shape == (K,)
        mask = good2.future.result(timeout=WAIT)
        with pytest.raises(Exception):
            bad.future.result(timeout=WAIT)
        # the dispatcher survived the poisoned drain
        after = server.submit("topk_ia", q_lo=lo[1], q_hi=hi[1], k=K)
        after_res = after.result(timeout=WAIT)
    finally:
        server.stop()
    direct = QueryEngine(repo)
    _assert_same((v, j), _direct(direct, "topk_ia",
                                 dict(q_lo=lo[0], q_hi=hi[0], k=K)))
    _assert_same(mask, _direct(direct, "range_search",
                               dict(r_lo=lo[1], r_hi=hi[1])))
    _assert_same(after_res, _direct(direct, "topk_ia",
                                    dict(q_lo=lo[1], q_hi=hi[1], k=K)))


def test_stop_fails_queued_requests(env):
    datasets, repo = env
    server = _server(QueryEngine(repo), max_batch=8).start()
    server.stop()                        # the dispatcher has exited
    req = Request("range_search", None)
    server._queue.put(req)               # lands after the dispatcher died
    server.stop()                        # the second stop fails it
    assert req.future.done()
    with pytest.raises(RuntimeError):
        req.future.result(timeout=0)
    assert not server._thread.is_alive()


class _FakeClock:
    """Virtual time: each call returns the current instant, then advances
    by ``step`` (0: pinned)."""

    def __init__(self, t=0.0, step=0.0):
        self.t, self.step = t, step

    def __call__(self):
        now = self.t
        self.t += self.step
        return now


def test_clock_injected_static_drain_deadline(env):
    """The static deadline reads the injected clock: virtual time jumping
    past max_wait lets a pre-filled partial batch drain at once, with no
    real wait against the 5-second window."""
    datasets, repo = env
    clk = _FakeClock(t=100.0, step=10.0)
    server = _server(QueryEngine(repo), max_batch=64, max_wait_ms=5000.0,
                     adaptive=False, clock=clk)
    for _ in range(3):
        server._queue.put(Request("range_search", None, t_submit=clk()))
    t0 = time.perf_counter()
    batch = server._drain()
    assert len(batch) == 3
    assert time.perf_counter() - t0 < 2.0
    assert clk.t > 100.0


def test_clock_injected_latency_accounting(env):
    datasets, repo = env
    clk = _FakeClock(t=50.0, step=0.0)
    server = _server(QueryEngine(repo), max_batch=8, max_wait_ms=20.0,
                     adaptive=False, clock=clk).start()
    try:
        lo = np.float32([-10, -10])
        futures = [server.submit("range_search", r_lo=lo, r_hi=-lo)
                   for _ in range(3)]
        for f in futures:
            f.result(timeout=WAIT)
    finally:
        server.stop()
    assert server.stats.latencies == [0.0, 0.0, 0.0]
    assert server.stats.p99_ms == server.stats.p50_ms == 0.0


def _assert_same_stream(got, want):
    def same(a, b):
        if isinstance(b, dict):
            assert set(a) == set(b)
            for key in b:
                same(a[key], b[key])
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b

    assert [op for op, _ in got] == [op for op, _ in want]
    for (_, a), (_, b) in zip(got, want):
        same(a, b)


def test_make_traffic_matches_jax(env):
    """The same seed gives the JAX package's request stream: ops, boxes,
    query sets, GBO signatures and eps."""
    datasets, repo = env
    _assert_same_stream(
        make_traffic(repo.space_lo, repo.space_hi, datasets, 36, seed=5),
        jserve.make_traffic(bridge.to_numpy(repo), datasets, 36, seed=5))


def test_make_traffic_mutation_lane_matches_jax(env):
    """With ``mutate_every=4`` too: the same ingests, deletes and replaces
    (ids and jittered points) at the same positions, and the same queries
    around them."""
    datasets, repo = env
    got = make_traffic(repo.space_lo, repo.space_hi, datasets, 36, seed=5,
                       mutate_every=4)
    _assert_same_stream(got, jserve.make_traffic(
        bridge.to_numpy(repo), datasets, 36, seed=5, mutate_every=4))
    assert [op for op, _ in got[4::4]] == [
        "ingest", "delete", "replace"] * 2 + ["ingest", "delete"]


#: the stream the live-mesh serving cases and their local reference run
LIVE_ARGS = ["--device", "cpu", "--datasets", "10", "--requests", "20",
             "--live", "--mutate-every", "4"]


def _recorded_main(argv):
    """``serve_search.main(argv)`` with the measured stream's responses
    recorded in submission order: (server stats, [(op, response)])."""
    recorded = []

    class Recording(SearchServer):
        def submit(self, op, **payload):
            recorded.append((op, super().submit(op, **payload)))
            return recorded[-1][1]

        def submit_mutation(self, op, **payload):
            recorded.append((op, super().submit_mutation(op, **payload)))
            return recorded[-1][1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serve_search, "SearchServer", Recording)
        stats = serve_search.main(argv)
    return stats, [(op, f.result(timeout=WAIT)) for op, f in recorded]


@pytest.fixture(scope="module")
def local_live_stream():
    """The local live server's responses to ``LIVE_ARGS``'s stream."""
    return _recorded_main(LIVE_ARGS)[1]


def _serve_live_mesh():
    """``LiveRepository(mesh=data_mesh(devices=["cpu"] * 3))`` (its rows
    built on the mesh's lead device) behind a SearchServer, on the stream
    ``main`` measures for ``LIVE_ARGS``: (server stats, [(op, response)])."""
    from repro_torch.data import synthetic
    from repro_torch.engine import data_mesh

    lake = synthetic.trajectory_repository(10, seed=0)
    live = LiveRepository(lake, leaf_capacity=16, theta=5,
                          mesh=data_mesh(devices=["cpu"] * 3))
    assert live.device == torch.device("cpu")
    traffic = make_traffic(live.geometry.space_lo, live.geometry.space_hi,
                           lake, 20, mutate_every=4)
    server = SearchServer(live=live, device="cpu").start()
    try:
        futures = [(op, server.submit_mutation(op, **p)
                    if op in serve_search.MUTATION_OPS
                    else server.submit(op, **p)) for op, p in traffic]
        got = [(op, f.result(timeout=WAIT)) for op, f in futures]
    finally:
        server.stop()
    return server.stats, got


@pytest.mark.parametrize("call,item", [
    pytest.param(c, "12b", id=f"{c}-12")
    for c in ("--sharded", "--replicas", "--data-shards", "live_mesh")])
def test_unported_lanes_name_their_item(local_live_stream, call, item):
    """The live repository on a mesh (ROADMAP item 12b) serves: ``--live``
    with ``--sharded``, ``--replicas 2`` or ``--data-shards 3``, and a
    ``LiveRepository(mesh=...)`` behind a server, each on a CPU mesh with
    a mutation every 4th request.  Every
    response equals the local live server's on the same stream: the
    mutations' outcomes, and each query (ExactHaus and the joinable ops
    by vals and ids: their counters depend on the split)."""
    assert item == "12b"
    if call == "live_mesh":
        stats, got = _serve_live_mesh()
    else:
        arg = {"--replicas": ["2"], "--data-shards": ["3"]}.get(call, [])
        stats, got = _recorded_main(LIVE_ARGS + [call, *arg])
    assert stats.requests == 16 and stats.mutations == 4
    want = local_live_stream
    assert [op for op, _ in got] == [op for op, _ in want]
    for (op, res), (_, ref) in zip(got, want):
        if op in ("topk_hausdorff", "topk_overlap", "topk_coverage"):
            res, ref = res[:2], ref[:2]
        _assert_same(res, ref)


@pytest.mark.parametrize("flags,name,groups,shards", [
    (["--sharded"], "sharded", 1, serve_search.CPU_SHARDS),
    (["--replicas", "2"], "replicated", 2, serve_search.CPU_SHARDS),
    (["--sharded", "--data-shards", "3"], "sharded", 1, 3)])
def test_main_serves_on_a_cpu_mesh(capsys, flags, name, groups, shards):
    stats = serve_search.main(["--device", "cpu", "--requests", "24",
                               "--datasets", "12", *flags])
    assert stats.requests == 24
    out = capsys.readouterr().out
    assert (f"[serve_search] {name} engine: {groups} replica group(s) x "
            f"{shards} data shard(s)") in out
    assert "[serve_search] device: cpu" in out


def test_server_over_a_sharded_engine(env):
    """A burst of every request kind, pre-filled as one drain, through a
    server over a 3-shard engine: each response equals a direct search of
    the local engine (a joinable query's counters depend on its batch and
    its split, so there vals and ids), and the drain forms the local
    server's 14 dispatch groups."""
    from repro_torch.engine import ShardedQueryEngine, data_mesh

    datasets, repo = env
    engine = ShardedQueryEngine(repo, mesh=data_mesh(devices=["cpu"] * 3))
    server = _server(engine, max_batch=64, max_wait_ms=250.0)
    traffic = make_traffic(repo.space_lo, repo.space_hi, datasets, 27,
                           seed=3)
    reqs = [Request(op, _to_query(op, p)) for op, p in traffic]
    for r in reqs:
        server._queue.put(r)
    server.start()
    try:
        got = [r.future.result(timeout=WAIT) for r in reqs]
    finally:
        server.stop()
    assert server.stats.batches == 14
    local = QueryEngine(repo, result_cache_size=0)
    for (op, p), res in zip(traffic, got):
        want = _direct(local, op, p)
        if op in ("topk_hausdorff", "topk_overlap", "topk_coverage"):
            res, want = res[:2], want[:2]
        _assert_same(res, want)


def test_main_serves_on_the_cpu_when_told(env, capsys):
    stats = serve_search.main(["--device", "cpu", "--requests", "24",
                               "--datasets", "12"])
    assert stats.requests == 24
    out = capsys.readouterr().out
    assert "[serve_search] device: cpu" in out


def test_main_serves_a_live_stream_on_the_cpu(capsys):
    stats = serve_search.main(["--device", "cpu", "--live", "--mutate-every",
                               "8", "--requests", "24", "--datasets", "12"])
    assert stats.requests == 22 and stats.mutations == 2
    out = capsys.readouterr().out
    assert "mutation lane: 2 applied" in out
    with pytest.raises(SystemExit):
        serve_search.main(["--device", "cpu", "--mutate-every", "8"])


# -- live serving: the mutation lane ----------------------------------------


def _leaves(res):
    """A served response flattened to its arrays (stats dropped)."""
    if isinstance(res, tuple) and not hasattr(res, "_fields"):
        return [x for r in res for x in _leaves(r)]
    return [res] if isinstance(res, np.ndarray) else []


def _assert_segment(got, cold, queries):
    """A served segment against the same items on a cold engine, array by
    array and bit for bit."""
    want = cold.search(queries)
    for a, b in zip(got, want):
        la, lb = _leaves(a), _leaves(_legacy_result(b))
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def _cold(slots, geom):
    return QueryEngine(repo_mutate.build_frozen(slots, geom, device="cpu"),
                       leaf_capacity=geom.leaf_capacity)


def test_server_coalesced_runs_fake_clock():
    """The scheduler under an injected clock (virtual seconds, no sleeps):
    a pre-filled drain [queries, M, M, queries, M, queries] answers every
    segment at its stream position, the adjacent pair of mutations
    coalesces into one publish whose prepare overlapped the segment before
    it, and the publish and overlap accounting reads the fake clock."""

    class _TickClock:
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            self.t += 1.0
            return self.t

    rng = np.random.default_rng(17)
    tick = _TickClock()
    init = [_mk_dataset(rng) for _ in range(6)]
    live = LiveRepository(init, leaf_capacity=LEAF, clock=tick,
                          point_capacity=POINT_CAP, result_cache_size=64,
                          device="cpu")
    model = {j: init[j] for j in range(6)}

    def seg():
        # point targets avoid the id the stream deletes
        qs = [Query(op=op, **kw)
              for op, kw in _mixed_specs(rng, set(model) - {2})]
        return [Request(q.op, q, t_submit=0.0) for q in qs]

    d0, d1 = _mk_dataset(rng), _mk_dataset(rng)
    segs = [seg(), seg(), seg()]
    muts = [Mutation("ingest", points=d0, t_submit=0.0),
            Mutation("replace", ds_id=1, points=d1, t_submit=0.0),
            Mutation("delete", ds_id=2, t_submit=0.0)]
    server = SearchServer(live=live, max_batch=64, max_wait_ms=250.0,
                          clock=tick, device="cpu")
    for item in (*segs[0], muts[0], muts[1], *segs[1], muts[2], *segs[2]):
        server._queue.put(item)
    server.start()
    try:
        got = [[r.future.result(timeout=WAIT) for r in s] for s in segs]
        sid = muts[0].future.result(timeout=WAIT)
        assert muts[1].future.result(timeout=WAIT) == 1
        assert muts[2].future.result(timeout=WAIT) is None
    finally:
        server.stop()
    assert not server._thread.is_alive()
    assert sid == 6
    assert live.epoch == 2
    assert live.stats.mutations_coalesced == 1
    assert len(live.stats.publish_seconds) == 2
    assert server.stats.mutations == 3
    assert all(t >= 1.0 for t in live.stats.publish_seconds)
    assert live.stats.publish_p99_ms >= live.stats.publish_p50_ms >= 1e3
    assert live.stats.prepare_overlap_seconds >= 0.0
    assert all(t >= 1.0 for t in server.stats.mutation_latencies)

    states = [dict(model)]
    model[sid] = d0
    model[1] = d1
    states.append(dict(model))
    del model[2]
    states.append(dict(model))
    assert live.live_ids == set(model)
    for state, s, res in zip(states, segs, got):
        _assert_segment(res, _cold([state.get(j) for j in range(
            live.n_slots)], live.geometry), [r.query for r in s])


def _segment_queries(ds_id, probe_lo, probe_hi):
    """Three queries repeated verbatim in every segment, so a stale row of
    an earlier epoch would be served if the epoch keys were broken; the
    point probe's box hugs dataset ``ds_id``'s original points."""
    lo = np.float32([20, 20])
    return [
        ("range_search", dict(r_lo=lo, r_hi=lo + 40.0)),
        ("topk_ia", dict(q_lo=np.float32([-60, -60]),
                         q_hi=np.float32([60, 60]), k=3)),
        ("range_points", dict(ds_id=ds_id, r_lo=probe_lo, r_hi=probe_hi)),
    ]


def test_live_interleaved_mutation_drain():
    """Mutations submitted mid-burst take effect at their stream position:
    one pre-filled drain of [queries, replace, the same queries, ingest,
    delete, the same queries]; each segment equals a cold engine over the
    frozen build of its position, and the replaced dataset's probe
    changes."""
    datasets = make_clustered_datasets(10, seed=5, n_points=(20, 50))
    live = LiveRepository(datasets, leaf_capacity=16, theta=THETA,
                          result_cache_size=64, device="cpu")
    n_slots = live.n_slots
    new0 = datasets[0] + np.float32(30.0)          # visibly moved
    fresh = datasets[3] + np.float32(7.0)
    ingest_slot = min(set(range(n_slots)) - live.live_ids)
    traffic = _segment_queries(
        ds_id=0, probe_lo=datasets[0].min(0) - np.float32(1.0),
        probe_hi=datasets[0].max(0) + np.float32(1.0))
    reqs = [[Request(op, _to_query(op, p)) for op, p in traffic]
            for _ in range(3)]
    muts = [Mutation("replace", ds_id=0, points=new0),
            Mutation("ingest", points=fresh),
            Mutation("delete", ds_id=1)]
    server = SearchServer(live=live, max_batch=64, max_wait_ms=250.0,
                          device="cpu")
    for item in (*reqs[0], muts[0], *reqs[1], muts[1], muts[2], *reqs[2]):
        server._queue.put(item)
    server.start()
    try:
        got = [[r.future.result(timeout=WAIT) for r in seg] for seg in reqs]
        assert muts[0].future.result(timeout=WAIT) == 0
        assert muts[1].future.result(timeout=WAIT) == ingest_slot
        assert muts[2].future.result(timeout=WAIT) is None
    finally:
        server.stop()
    # the adjacent ingest + delete coalesce into one publish; the replace,
    # between queries, publishes alone
    assert live.epoch == 2
    assert server.stats.mutations == 3
    assert live.stats.mutations_coalesced == 1
    assert len(live.stats.publish_seconds) == 2

    slots0 = list(datasets) + [None] * (n_slots - len(datasets))
    slots1 = [new0] + slots0[1:]
    queries = [_to_query(op, p) for op, p in traffic]
    _assert_segment(got[0], _cold(slots0, live.geometry), queries)
    _assert_segment(got[1], _cold(slots1, live.geometry), queries)
    _assert_segment(got[2], QueryEngine(live.frozen_repository(),
                                        leaf_capacity=16), queries)
    assert not np.array_equal(got[0][2], got[1][2])


def test_live_poisoned_row_fallback_and_lane_errors():
    """A poisoned query sharing a drain with healthy queries and a mutation
    fails only its own future: the mutation publishes, the healthy futures
    resolve with post-mutation results and the dispatcher survives.  No
    live repository: RuntimeError; an unknown mutation: ValueError; a
    mutation that fails: only its own future."""
    datasets = make_clustered_datasets(8, seed=9, n_points=(20, 40))
    live = LiveRepository(datasets, leaf_capacity=16, theta=THETA,
                          device="cpu")
    fresh = datasets[4] + np.float32(4.0)
    ingest_slot = min(set(range(live.n_slots)) - live.live_ids)
    server = SearchServer(live=live, max_batch=16, max_wait_ms=200.0,
                          device="cpu").start()
    try:
        with pytest.raises(ValueError):
            server.submit_mutation("compact")
        lo = np.float32([-200, -200])
        good1 = server.submit("topk_ia", q_lo=lo, q_hi=-lo, k=3)
        bad = server.submit("topk_ia", q_lo=np.zeros(3, np.float32),
                            q_hi=np.ones(3, np.float32), k=3)
        mfut = server.submit_mutation("ingest", points=fresh)
        good2 = server.submit("range_search", r_lo=lo, r_hi=-lo)
        assert good1.result(timeout=WAIT)[0].shape == (3,)
        with pytest.raises(Exception):
            bad.result(timeout=WAIT)
        assert mfut.result(timeout=WAIT) == ingest_slot
        mask = good2.result(timeout=WAIT)
        bad_mut = server.submit_mutation("delete", ds_id=999)
        with pytest.raises(KeyError):
            bad_mut.result(timeout=WAIT)
        after = server.submit("range_search", r_lo=lo, r_hi=-lo)
        cold = QueryEngine(live.frozen_repository(), leaf_capacity=16)
        want = cold.search([Query(op="range_search", r_lo=lo,
                                  r_hi=-lo)])[0].mask
        np.testing.assert_array_equal(after.result(timeout=WAIT), want)
        assert mask[ingest_slot]               # good2 saw the ingest
    finally:
        server.stop()


def test_mutation_lane_needs_live(env):
    datasets, repo = env
    server = _server(QueryEngine(repo), max_batch=8).start()
    try:
        with pytest.raises(RuntimeError):
            server.submit_mutation("ingest", points=datasets[0])
    finally:
        server.stop()
    with pytest.raises(ValueError):
        SearchServer(device="cpu")

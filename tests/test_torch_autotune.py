"""The port's launch-shape table (``repro_torch.kernels.autotune``) and
``QueryEngine.tune`` (``repro_torch.engine.tune``), on the CPU.

Mirrors ``tests/test_autotune.py``: untuned defaults are the shapes the
kernels were built with, explicit arguments beat the table and the table
beats the defaults, shape buckets share entries, the epoch moves on every
table change, and a measured sweep installs the fastest candidate and
caches it, but keeps the default where the gain, judged round by round,
is inside the spread of the rounds.  The table is keyed on the device: a CPU entry never serves a
card, and one card's name never serves another's.

``QueryEngine.tune()`` on a small CPU repository tunes the ExactHaus chunk
only (the plain versions have no launch shape), restores the result cache,
and leaves vals and ids bitwise equal under chunks 16, 32 and 64; they
match the JAX engine's: ids exactly, vals to ``rtol=1e-6`` as in
``tests/test_torch_exacthaus.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import make_clustered_datasets
from repro.core.build import build_repository as jbuild
from repro.engine import Query as JQuery
from repro.engine import QueryEngine as JEngine
from repro_torch.core.build import build_repository
from repro_torch.engine import Query, QueryEngine
from repro_torch.kernels import _build, autotune, hausdorff
from repro_torch.kernels.autotune import KernelConfig
from torch_lm_parity import one_torch_thread  # noqa: F401

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
#: source, variant macro and the config fields its columns hold
SOURCES = {
    "hausdorff_grid": ("hausdorff_grid.cu", "HAUSDORFF_GRID_VARIANTS",
                       ("warps", "rows")),
    "min_sq_dists": ("min_sq_dists.cu", "MIN_SQ_DISTS_VARIANTS",
                     ("warps", "rows", "acc")),
    "bound_grid": ("bound_grid.cu", "BOUND_GRID_VARIANTS",
                   ("slots", "queries", "reg")),
}
K = 5
RTOL = 1e-6


@pytest.fixture(autouse=True)
def _clean_table():
    """Each test sees an untuned table."""
    autotune.clear()
    autotune._device_id.cache_clear()
    yield
    autotune.clear()
    autotune._device_id.cache_clear()


def _compiled_variants(op):
    src, macro, names = SOURCES[op]
    text = (CSRC / src).read_text()
    body = re.search(rf"#define {macro}\(X\)((?:[^\n]*\\\n)*[^\n]*)",
                     text).group(1)
    rows = [tuple(int(v) for v in m.split(","))
            for m in re.findall(r"X\(([\d,\s]+)\)", body)]
    assert [r[0] for r in rows] == list(range(len(rows)))
    return [KernelConfig(**dict(zip(names, r[1:]))) for r in rows]


@pytest.mark.parametrize("op", sorted(SOURCES))
def test_defaults_equal_the_compiled_constants(op):
    """VARIANTS lists each source's instantiated shapes in its order, at
    most four, the default first; the Python constants that mirror the
    default's row block agree, and the entry point takes the variant."""
    compiled = _compiled_variants(op)
    assert list(autotune.VARIANTS[op]) == compiled
    assert 1 <= len(compiled) <= 4
    assert len(set(compiled)) == len(compiled)
    assert autotune.DEFAULTS[op] == compiled[0]
    assert autotune.resolve(op, (100, 100), "cpu") == compiled[0]
    sym = _build.KERNELS[op][1]
    text = (CSRC / SOURCES[op][0]).read_text()
    sig = text[text.index(f'extern "C" int {sym}('):]
    assert "int variant" in sig[:sig.index("{")]


def test_row_blocks_follow_the_shape():
    d = autotune.DEFAULTS
    assert autotune.rows_per_block("hausdorff_grid", d["hausdorff_grid"]) \
        == hausdorff.ROWS_PER_BLOCK == 256
    assert autotune.rows_per_block("min_sq_dists", d["min_sq_dists"]) \
        == hausdorff.PAIR_ROWS_PER_BLOCK == 64
    rows = {autotune.rows_per_block("hausdorff_grid", c)
            for c in autotune.VARIANTS["hausdorff_grid"]}
    assert rows == {128, 256, 512}
    assert autotune.rows_per_block(
        "min_sq_dists", KernelConfig(warps=8, rows=4, acc=2)) == 128


def test_explicit_args_beat_table_beat_defaults():
    shape = (64, 64)
    assert autotune.resolve("hausdorff_grid", shape, "cpu") == \
        KernelConfig(warps=4, rows=2)
    autotune.set_config("hausdorff_grid", shape, "cpu",
                        KernelConfig(warps=2, rows=2))
    assert autotune.resolve("hausdorff_grid", shape, "cpu") == \
        KernelConfig(warps=2, rows=2)
    # an explicit config replaces the entry
    assert autotune.resolve("hausdorff_grid", shape, "cpu",
                            KernelConfig(warps=4, rows=1)) == \
        KernelConfig(warps=4, rows=1)
    # the other ops and shapes keep the defaults
    assert autotune.resolve("hausdorff_grid", (4096, 4096), "cpu") == \
        autotune.DEFAULTS["hausdorff_grid"]
    assert autotune.resolve("min_sq_dists", shape, "cpu") == \
        autotune.DEFAULTS["min_sq_dists"]
    # a shape the source is not built at is refused, explicit or installed
    with pytest.raises(ValueError, match="no variant"):
        autotune.resolve("hausdorff_grid", shape, "cpu",
                         KernelConfig(warps=4, rows=3))
    with pytest.raises(ValueError, match="no variant"):
        autotune.set_config("bound_grid", shape, "cpu",
                            KernelConfig(slots=256, queries=4, reg=8))


def test_bucketing_shares_entries():
    cfg = KernelConfig(slots=64, queries=4, reg=8)
    autotune.set_config("bound_grid", (24, 12000), "cpu", cfg)
    # (24, 12000) buckets to (32, 16384): the whole bucket reads the entry
    assert autotune.resolve("bound_grid", (32, 16384), "cpu") == cfg
    assert autotune.resolve("bound_grid", (17, 8193), "cpu") == cfg
    assert autotune.resolve("bound_grid", (8, 16384), "cpu") == \
        autotune.DEFAULTS["bound_grid"]
    assert autotune.resolve("bound_grid", (32, 8192), "cpu") == \
        autotune.DEFAULTS["bound_grid"]


def test_table_is_keyed_on_the_device(monkeypatch):
    """A CPU entry serves no card; a card's entry serves cards of its name
    only."""
    names = {0: "NVIDIA H100 80GB HBM3", 1: "NVIDIA A100-SXM4-80GB",
             2: "NVIDIA H100 80GB HBM3"}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: names[i])
    cfg = KernelConfig(warps=4, rows=4)
    shape = (4096, 4096)
    autotune.set_config("hausdorff_grid", shape, "cpu", cfg)
    assert autotune.table_key("hausdorff_grid", shape, "cpu")[:2] == \
        ("cpu", "cpu")
    assert autotune.resolve("hausdorff_grid", shape, "cuda:0") == \
        autotune.DEFAULTS["hausdorff_grid"]
    autotune.set_config("hausdorff_grid", shape, "cuda:0",
                        KernelConfig(warps=2, rows=2))
    assert autotune.table_key("hausdorff_grid", shape, "cuda:0")[:2] == \
        ("cuda", names[0])
    assert autotune.resolve("hausdorff_grid", shape, "cuda:2") == \
        KernelConfig(warps=2, rows=2)
    assert autotune.resolve("hausdorff_grid", shape, "cuda:1") == \
        autotune.DEFAULTS["hausdorff_grid"]
    assert autotune.resolve("hausdorff_grid", shape, "cpu") == cfg


def test_epoch_bumps_on_table_changes():
    e0 = autotune.epoch()
    autotune.set_config("min_sq_dists", (64, 64), "cpu",
                        KernelConfig(warps=4, rows=2, acc=2))
    assert autotune.epoch() == e0 + 1
    autotune.clear()
    assert autotune.epoch() == e0 + 2
    assert autotune.resolve("min_sq_dists", (64, 64), "cpu") == \
        autotune.DEFAULTS["min_sq_dists"]


def test_ensure_tuned_picks_fastest_and_caches():
    cands = list(autotune.VARIANTS["min_sq_dists"])
    cost = {cands[0]: 0.5, cands[1]: 0.3, cands[2]: 0.1, cands[3]: 0.4}
    clock = [0.0]
    runs = []

    def runner(cfg):
        runs.append(cfg)
        clock[0] += cost[cfg]

    cfg, info = autotune.ensure_tuned("min_sq_dists", (64, 64), "cpu",
                                      runner, cands, repeats=2,
                                      timer=lambda: clock[0])
    assert cfg == cands[2] and info["chosen"] == 2
    assert info["timings_s"] == pytest.approx([0.5, 0.3, 0.1, 0.4])
    assert len(runs) == 2 * len(cands) + len(cands)   # warm-up + timed
    assert autotune.resolve("min_sq_dists", (64, 64), "cpu") == cands[2]
    rep = autotune.report()
    (entry,) = rep["entries"].values()
    assert entry == {"variant": 2, "warps": 8, "rows": 4, "acc": 2}
    # a second sweep short-circuits on the cached entry
    n = len(runs)
    cfg2, info2 = autotune.ensure_tuned("min_sq_dists", (64, 64), "cpu",
                                        runner, cands, repeats=2,
                                        timer=lambda: clock[0])
    assert info2 is None and len(runs) == n and cfg2 == cfg
    # force re-measures
    cost[cands[0]] = 0.0
    cfg3, info3 = autotune.ensure_tuned("min_sq_dists", (64, 64), "cpu",
                                        runner, cands, repeats=2,
                                        force=True, timer=lambda: clock[0])
    assert cfg3 == cands[0] and info3["chosen"] == 0


@pytest.mark.parametrize("samples, default, want", [
    # the gain (0.3 at the median ratio) is inside the ratios' spread
    # (0.34): the default stays
    ([[1.0, 0.8, 1.2], [0.9, 0.9, 0.9], [0.7, 0.75, 0.72]], 0, 0),
    # both gains are past their spreads: the fastest wins
    ([[1.0, 1.0, 1.0], [0.9, 0.9, 0.9], [0.5, 0.52, 0.51]], 0, 2),
    # inside the challenger's own spread (gain 0.3, ratios 0.4 to 0.9)
    ([[1.0, 1.0, 1.0], [0.4, 0.7, 0.9]], 0, 0),
    # a gain equal to the spread is not past it
    ([[1.0, 1.0, 1.0], [0.75, 0.5, 0.75]], 0, 0),
    # a round the host slowed for every candidate falls out of the ratios
    ([[1.0, 1.0, 2.0], [0.5, 0.5, 1.0]], 0, 1),
    # with no default the fastest median wins
    ([[1.0, 0.8, 1.2], [0.9, 0.9, 0.9], [0.7, 0.75, 0.72]], None, 2),
])
def test_pick_installs_only_past_the_spread(samples, default, want):
    best, medians, spreads = autotune.pick(samples, default)
    assert best == want
    assert medians == pytest.approx([float(np.median(s)) for s in samples])
    assert spreads == pytest.approx([max(s) - min(s) for s in samples])


def test_ensure_tuned_keeps_the_default_inside_the_noise():
    """Rounds that scatter the default's time more than a candidate gains
    leave the default installed; the rounds interleave the candidates."""
    cands = list(autotune.VARIANTS["min_sq_dists"])
    times = {cands[0]: iter([0.0, 1.0, 0.6, 1.4]),       # warm-up, rounds
             cands[1]: iter([0.0, 0.9, 0.9, 0.9]),
             cands[2]: iter([0.0, 0.8, 0.8, 0.8]),
             cands[3]: iter([0.0, 1.0, 1.0, 1.0])}
    clock, order = [0.0], []

    def runner(cfg):
        order.append(cands.index(cfg))
        clock[0] += next(times[cfg])

    cfg, info = autotune.ensure_tuned("min_sq_dists", (64, 64), "cpu",
                                      runner, cands, repeats=3,
                                      timer=lambda: clock[0])
    assert cfg == cands[0] and info["chosen"] == 0
    assert info["timings_s"] == pytest.approx([1.0, 0.9, 0.8, 1.0])
    assert info["spreads_s"] == pytest.approx([0.8, 0.0, 0.0, 0.0])
    assert order == [0, 1, 2, 3] * 4
    assert autotune.report()["entries"] != {}
    assert autotune.resolve("min_sq_dists", (64, 64), "cpu") == cands[0]


@pytest.fixture(scope="module")
def env():
    datasets = make_clustered_datasets(24, seed=4, n_points=(20, 150))
    q_sets = make_clustered_datasets(5, seed=8, n_points=(20, 150))
    jrepo, _ = jbuild(datasets, leaf_capacity=16, theta=5,
                      remove_outliers=False)
    jres = JEngine(jrepo, result_cache_size=0).search(
        [JQuery(op="topk_hausdorff", q=q, k=K) for q in q_sets])
    jres = [(np.asarray(r.vals), np.asarray(r.ids)) for r in jres]
    trepo, _ = build_repository(datasets, leaf_capacity=16, theta=5,
                                remove_outliers=False, device="cpu")
    return q_sets, trepo, jres


def test_engine_tune_on_the_cpu(env):
    """The chunk sweep runs through search(), installs default_chunk and
    restores the result cache; the kernel sweeps are plain only and
    install nothing."""
    q_sets, trepo, _ = env
    engine = QueryEngine(trepo, result_cache_size=7)
    e0 = autotune.epoch()
    report = engine.tune(batches=(2,), chunks=(16, 32, 64), chunk_batch=2,
                         repeats=1)
    assert autotune.epoch() == e0 and autotune.report()["entries"] == {}
    assert engine.result_cache_size == 7
    assert engine.default_chunk in (16, 32, 64)
    assert report["chunk"]["chosen"] == engine.default_chunk
    assert len(report["chunk"]["timings_s"]) == 3
    assert all(t > 0 for t in report["chunk"]["timings_s"])
    # 3 chunks x (warm-up + 1 repeat), each one dispatch: never memoized
    assert engine.stats.per_op["topk_hausdorff"]["dispatches"] == 6
    assert engine.stats.result_cache_hits == 0
    assert report["device"] == ["cpu", "cpu"]
    for row in [report["min_sq_dists"], report["hausdorff_grid"],
                *report["bound_grid"].values()]:
        assert row["plain_only"] and row["timings_s"] is None
    assert list(report["bound_grid"]) == ["2"]


def test_engine_tune_restores_the_cache_on_failure(env, monkeypatch):
    _, trepo, _ = env
    engine = QueryEngine(trepo, result_cache_size=5)

    def boom(queries):
        assert engine.result_cache_size == 0
        raise RuntimeError("search failed")

    monkeypatch.setattr(engine, "search", boom)
    with pytest.raises(RuntimeError, match="search failed"):
        engine.tune(batches=(2,), chunks=(16,), chunk_batch=2, repeats=1)
    assert engine.result_cache_size == 5 and engine.default_chunk == 32


def test_tuned_chunks_bitwise_and_match_jax(env):
    """vals and ids are bitwise the same under every chunk of the sweep
    and under the tuned default; they match the JAX engine's."""
    q_sets, trepo, jres = env
    engine = QueryEngine(trepo, result_cache_size=0)
    base = engine.search([Query(op="topk_hausdorff", q=q, k=K, chunk=32)
                          for q in q_sets])
    for chunk in (16, 64):
        res = engine.search([Query(op="topk_hausdorff", q=q, k=K,
                                   chunk=chunk) for q in q_sets])
        for r, b in zip(res, base):
            np.testing.assert_array_equal(r.vals.view(np.uint32),
                                          b.vals.view(np.uint32))
            np.testing.assert_array_equal(r.ids, b.ids)
    engine.tune(batches=(2,), chunks=(16, 32, 64), chunk_batch=2, repeats=1)
    tuned = engine.search([Query(op="topk_hausdorff", q=q, k=K)
                           for q in q_sets])
    for r, b, (jv, ji) in zip(tuned, base, jres):
        np.testing.assert_array_equal(r.vals.view(np.uint32),
                                      b.vals.view(np.uint32))
        np.testing.assert_array_equal(r.ids, b.ids)
        np.testing.assert_array_equal(r.ids, ji)
        np.testing.assert_allclose(r.vals, jv, rtol=RTOL)


def test_mesh_engine_tunes_through_its_first_shard(env):
    """On a CPU mesh the sweeps probe the first shard and the chunk sweep
    runs through the sharded engine's search(); results stay the local
    engine's."""
    from repro_torch.engine.sharded import ShardedQueryEngine, data_mesh

    q_sets, trepo, _ = env
    engine = ShardedQueryEngine(trepo, mesh=data_mesh(devices=["cpu"] * 3),
                                result_cache_size=0)
    report = engine.tune(batches=(2,), chunks=(16, 64), chunk_batch=2,
                         repeats=1)
    per_shard = engine.dispatch.layouts[0].shards[0].n_slots
    assert report["bound_grid"]["2"]["shape"] == (2, per_shard)
    assert per_shard < trepo.n_slots
    assert engine.default_chunk in (16, 64)
    want = QueryEngine(trepo, result_cache_size=0).search(
        [Query(op="topk_hausdorff", q=q, k=K) for q in q_sets])
    got = engine.search([Query(op="topk_hausdorff", q=q, k=K)
                         for q in q_sets])
    for r, w in zip(got, want):
        np.testing.assert_array_equal(r.vals.view(np.uint32),
                                      w.vals.view(np.uint32))
        np.testing.assert_array_equal(r.ids, w.ids)

"""The merges and collectives of the port's multi-device dispatch.

* ``merge_topk`` / ``local_topk`` / ``sentinel_ids`` against the JAX
  package's ``repro.engine.merge`` on seeded scores with many ties and
  all-sentinel rows, split into 1, 3 and 8 shards, and both against one
  stable sort of the whole vector: values and ids exactly.
* ``global_kth_smallest`` against a full sort, including k past a shard's
  extent and past the whole vector.
* The ring ops against the local oracles: ``ring_hausdorff`` bitwise
  ``ops.directed_hausdorff_pairs``, ``ring_nn_distance`` bitwise
  ``ops.nn_distance_batched`` (distances and first-argmin ids, with tied
  points across shards).
* ``sharded_topk_gbo`` / ``sharded_topk_bounds`` against the JAX
  package's ``repro.core.distributed`` forms at 1, 2 and 4 shards, on
  tied inputs: values and ids exactly, tau / lb / ub bitwise.  The JAX
  side runs once for the module in a subprocess with 4 forced host
  devices (``conftest.run_py``).
* ``owner_select``, ``psum_int``, ``pmin`` / ``pmax``; the Mesh.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_py
from repro.engine import merge as jmerge
from repro_torch.core import distributed
from repro_torch.core.distributed import Mesh
from repro_torch.engine import merge
from repro_torch.kernels import ops, ref
from torch_lm_parity import one_torch_thread  # noqa: F401


def _tied_scores(seed, rows=6, n=48):
    """Integer-valued float scores in a narrow range (many ties) with -1
    sentinels; row 0 is all sentinel."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 5, (rows, n)).astype(np.float32)
    s[rng.random((rows, n)) < 0.3] = -1.0
    s[0] = -1.0
    return s


@pytest.mark.parametrize("n_shards", [1, 3, 8])
@pytest.mark.parametrize("k", [1, 5, 16, 48])
def test_merge_matches_jax_and_a_stable_sort(n_shards, k):
    scores = _tied_scores(n_shards * 100 + k)
    n = scores.shape[1]
    per = n // n_shards
    t = torch.from_numpy(scores)
    parts = [t[:, i * per:(i + 1) * per] for i in range(n_shards)]
    lists = [merge.local_topk(p, k, i * per) for i, p in enumerate(parts)]
    vals, ids = merge.all_gather_topk([v for v, _ in lists],
                                      [g for _, g in lists], k)
    ids = merge.sentinel_ids(vals, ids)
    # the JAX package's merge over the same per-shard lists
    jl = [jmerge.local_topk(jnp.asarray(scores[:, i * per:(i + 1) * per]),
                            k, i * per) for i in range(n_shards)]
    jv, ji = jmerge.merge_topk(jnp.concatenate([v for v, _ in jl], -1),
                               jnp.concatenate([g for _, g in jl], -1), k)
    ji = jmerge.sentinel_ids(jv, ji)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    # and one stable descending sort of the whole vector
    order = np.argsort(-scores, axis=-1, kind="stable")[:, :k]
    want_v = np.take_along_axis(scores, order, -1)
    np.testing.assert_array_equal(vals.numpy(), want_v)
    np.testing.assert_array_equal(ids.numpy(),
                                  np.where(want_v < 0, -1, order))
    assert (ids[0] == -1).all()
    # shard_topk is the same merge
    v2, i2 = merge.shard_topk(parts, k)
    assert torch.equal(v2, vals) and torch.equal(merge.sentinel_ids(v2, i2),
                                                 ids)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
@pytest.mark.parametrize("k", [1, 4, 7, 24, 30])
def test_global_kth_smallest(n_shards, k):
    rng = np.random.default_rng(k + 10 * n_shards)
    x = rng.integers(0, 6, (5, 24)).astype(np.float32)
    x[1] = 3.4e38
    per = 24 // n_shards
    t = torch.from_numpy(x)
    got = distributed.global_kth_smallest(
        [t[:, i * per:(i + 1) * per] for i in range(n_shards)], k)
    want = np.sort(x, axis=-1)[:, min(k, 24) - 1]
    np.testing.assert_array_equal(got.numpy(), want)


def _ring_case(seed, nq=48, nd=64):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, 2)).astype(np.float32)
    d = rng.normal(loc=0.5, size=(nd, 2)).astype(np.float32)
    d[nd // 2:nd // 2 + 8] = d[:8]           # tied points across shards
    q[:4] = d[3:7]                           # zero distances
    qv = np.ones(nq, bool)
    qv[5] = False
    dv = np.ones(nd, bool)
    dv[nd - 6:] = False
    dv[2] = False
    return [torch.from_numpy(a) for a in (q, qv, d, dv)]


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_ring_hausdorff(n_shards):
    q, qv, d, dv = _ring_case(n_shards)
    devs = ["cpu"] * n_shards
    got = distributed.ring_hausdorff(
        distributed.shard(q, devs), distributed.shard(qv, devs),
        distributed.shard(d, devs), distributed.shard(dv, devs))
    want = ops.directed_hausdorff_pairs(q, d[None], qv, dv[None])[0]
    assert got.numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_ring_nn_distance(n_shards):
    q, qv, d, dv = _ring_case(10 + n_shards)
    devs = ["cpu"] * n_shards
    parts = distributed.ring_nn_distance(
        distributed.shard(q, devs), distributed.shard(qv, devs),
        distributed.shard(d, devs), distributed.shard(dv, devs))
    dist = torch.cat([p for p, _ in parts])
    idx = torch.cat([i for _, i in parts])
    want_d, want_i = ops.nn_distance_batched(q[None], d[None], qv[None],
                                             dv[None])
    assert dist.numpy().tobytes() == want_d[0].numpy().tobytes()
    np.testing.assert_array_equal(idx.numpy(), want_i[0].numpy())
    assert idx.dtype == torch.int32 and (idx[:4] >= 0).all()


# ---------------------------------------------------------------------------
# sharded_topk_gbo / sharded_topk_bounds against the JAX package's
# ---------------------------------------------------------------------------

JAX_SHARDS = (1, 2, 4)
N_SLOTS, N_WORDS, N_QUERIES, K_BOUNDS = 64, 32, 3, 5
#: seconds the JAX subprocess may take (it compiles a shard_map per call)
JAX_TIMEOUT = 240

_JAX_SIDE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core import distributed as jd

z = np.load({inp!r})
out = {{}}
for n in {shards}:
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    # the bounds run eagerly, op by op: under jit XLA:CPU contracts
    # cd * cd + dr * dr into an FMA and the last bit moves.  The integer
    # GBO is jitted once per mesh and reused by every query.
    gbo = jax.jit(lambda *a: jd.sharded_topk_gbo(mesh, "data", *a, {k}))
    for qi in range({nq}):
        tau, lb, ub = jd.sharded_topk_bounds(
            mesh, "data", jnp.asarray(z["qc"][qi]), jnp.asarray(z["qr"][qi]),
            jnp.asarray(z["dc"]), jnp.asarray(z["dr"]), jnp.asarray(z["dv"]),
            {k})
        vals, ids = gbo(z["qs"][qi], z["sg"], z["dv"])
        for name, x in (("tau", tau), ("lb", lb), ("ub", ub),
                        ("vals", vals), ("ids", ids)):
            out[f"{{name}}{{n}}_{{qi}}"] = np.asarray(x)
np.savez({out!r}, **out)
print("JAX_SIDE_OK")
"""


def _bounds_gbo_inputs():
    """Seeded slots with ties: sparse signatures (few bits per word) and
    rows cloned across shard boundaries, so GBO counts and root UBs tie;
    some slots invalid.  The queries are slots nudged off their centre."""
    rng = np.random.default_rng(3)
    S, W = N_SLOTS, N_WORDS
    bits = rng.random((S, W, 32)) < 0.05
    sg = (bits * (1 << np.arange(32, dtype=np.uint64))).sum(-1)
    sg = sg.astype(np.uint32)
    dc = (rng.normal(size=(S, 2)) * 9).astype(np.float32)
    dr = (rng.random(S) * 3).astype(np.float32)
    for a, b in ((1, 17), (2, 33), (5, 60), (20, 40), (9, 3)):
        sg[b], dc[b], dr[b] = sg[a], dc[a], dr[a]
    dv = np.ones(S, bool)
    dv[[4, 33, 58, 59, 61, 62, 63]] = False
    picks = [1, 7, 20]
    qs = sg[picks] | sg[[2, 9, 40]]
    qc = dc[picks] + np.float32(0.5)
    qr = dr[picks]
    return dict(sg=sg, dc=dc, dr=dr, dv=dv, qs=qs, qc=qc, qr=qr)


@pytest.fixture(scope="module")
def jax_bounds_gbo(tmp_path_factory):
    """The JAX package's sharded_topk_bounds / sharded_topk_gbo on the
    same inputs, on meshes of 1, 2 and 4 of 4 forced host devices: one
    subprocess for the module (``conftest.run_py``)."""
    tmp = tmp_path_factory.mktemp("jax_bounds_gbo")
    inp, outp = str(tmp / "in.npz"), str(tmp / "out.npz")
    data = _bounds_gbo_inputs()
    np.savez(inp, **data)
    out = run_py(_JAX_SIDE.format(inp=inp, out=outp, shards=JAX_SHARDS,
                                  nq=N_QUERIES, k=K_BOUNDS),
                 devices=max(JAX_SHARDS), timeout=JAX_TIMEOUT)
    assert "JAX_SIDE_OK" in out
    return data, np.load(outp)


@pytest.mark.parametrize("n_shards", JAX_SHARDS)
def test_sharded_topk_gbo_and_bounds(n_shards, jax_bounds_gbo):
    """GBO: per shard one set_intersect launch and a stable top-k, merged:
    the JAX package's values and global ids at the same shard count,
    exactly (ties among cloned rows included), and one stable sort of the
    unsharded counts.  Phase-0 root bounds: tau, lb and ub bitwise the
    JAX package's."""
    data, z = jax_bounds_gbo
    devs = ["cpu"] * n_shards
    sg = torch.from_numpy(data["sg"].astype(np.int64))
    dc, dr, dv = (torch.from_numpy(data[n]) for n in ("dc", "dr", "dv"))
    for qi in range(N_QUERIES):
        qs = torch.from_numpy(data["qs"][qi].astype(np.int64))
        vals, ids = distributed.sharded_topk_gbo(
            qs, distributed.shard(sg, devs), distributed.shard(dv, devs),
            K_BOUNDS)
        np.testing.assert_array_equal(vals.numpy(),
                                      z[f"vals{n_shards}_{qi}"])
        np.testing.assert_array_equal(ids.numpy(), z[f"ids{n_shards}_{qi}"])
        counts = torch.where(dv, ref.set_intersect_count(qs[None], sg)[0],
                             -1)
        s, i = torch.sort(counts, descending=True, stable=True)
        assert torch.equal(vals, s[:K_BOUNDS])
        assert torch.equal(ids, i[:K_BOUNDS])

        qc = torch.from_numpy(data["qc"][qi])
        qr = torch.tensor(data["qr"][qi])
        tau, lbs, ubs = distributed.sharded_topk_bounds(
            qc, qr, distributed.shard(dc, devs), distributed.shard(dr, devs),
            distributed.shard(dv, devs), K_BOUNDS)
        for got, name in ((tau, "tau"), (torch.cat(lbs), "lb"),
                          (torch.cat(ubs), "ub")):
            want = z[f"{name}{n_shards}_{qi}"]
            assert got.dtype == torch.float32
            assert got.numpy().tobytes() == want.tobytes(), name


def test_collectives():
    a = torch.tensor([[1, 5], [7, 2]], dtype=torch.int32)
    b = torch.tensor([[3, 4], [0, 9]], dtype=torch.int32)
    assert torch.equal(distributed.psum_int([a, b]), a + b)
    assert torch.equal(distributed.pmin([a, b]), torch.minimum(a, b))
    assert torch.equal(distributed.pmax([a, b]), torch.maximum(a, b))
    assert distributed.psum_int([a]) is a
    with pytest.raises(TypeError):
        distributed.psum_int([a.float(), b.float()])
    owner = torch.tensor([1, 0])
    assert torch.equal(distributed.owner_select([a, b], owner),
                       torch.stack([b[0], a[1]]))
    z = torch.tensor([-0.0, 0.0])
    picked = distributed.owner_select([z, -z], torch.tensor([0, 1]))
    # the owner's -0.0 survives (a sum with the other shard's 0.0 would not)
    assert picked.numpy().tobytes() == torch.tensor(
        [-0.0, -0.0]).numpy().tobytes()
    assert distributed.any_per_shard([a > 6, b > 9]) == [True, False]
    assert torch.equal(distributed.all_gather([a, b], dim=1),
                       torch.cat([a, b], dim=1))


def test_mesh():
    m = Mesh((("cpu", "cpu", "cpu"), ("cpu", "cpu", "cpu")),
             ("replica", "data"))
    assert m.shape == {"replica": 2, "data": 3}
    assert m.lead == torch.device("cpu") and len(m.flat) == 6
    with pytest.raises(ValueError, match="rectangular"):
        Mesh((("cpu",), ("cpu", "cpu")), ("replica", "data"))
    with pytest.raises(ValueError, match="do not fit"):
        Mesh(("cpu", "cpu"), ("replica", "data"))
    with pytest.raises(ValueError, match="does not split"):
        distributed.shard(torch.zeros(5), ["cpu"] * 2)

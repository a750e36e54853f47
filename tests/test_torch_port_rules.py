"""Rules the PyTorch port keeps.

* Nothing under ``src/repro_torch/`` or in ``chip_smoke.py`` imports
  ``jax`` or the JAX package ``repro`` (AST scan).
* A CPU tensor takes the plain version and books no kernel launch; a
  tensor on another device is refused.
* Entry points called without ``device="cpu"`` raise when no CUDA device
  is present: a missing card never silently means the CPU.  A mesh
  without a device list is the visible cards, so it raises too.
* ``chip_smoke.py`` fails without a card and never prints a result.
"""
import ast
import subprocess
import sys
import threading
from pathlib import Path

import jax  # noqa: F401  (both packages load in one process)
import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.core.build import build_query_index, build_repository
from repro_torch.core import repo_mutate
from repro_torch.engine import LiveRepository, QueryEngine
from repro_torch.kernels import (_build, bound_matrix, hausdorff,
                                 nn_distance, ops, set_intersect)
from repro_torch.launch import serve_search

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_join_and_serving_modules_are_scanned():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"src/repro_torch/core/join_search.py",
            "src/repro_torch/core/repo_mutate.py",
            "src/repro_torch/engine/live.py",
            "src/repro_torch/launch/__init__.py",
            "src/repro_torch/launch/serve_search.py",
            "src/repro_torch/core/distributed.py",
            "src/repro_torch/engine/merge.py",
            "src/repro_torch/engine/sharded.py",
            "src/repro_torch/engine/replicated.py",
            "src/repro_torch/launch/mesh.py"} <= names


def test_cpu_tensors_take_the_plain_path():
    ops.reset_launches()
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(9, 2)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(13, 2)).astype(np.float32))
    qv, dv = torch.ones(9, dtype=torch.bool), torch.ones(13, dtype=torch.bool)
    ops.directed_hausdorff(q, d, qv, dv)
    ops.directed_hausdorff_grid(q[None], d[None, None], qv[None],
                                dv[None, None])
    ops.directed_hausdorff_lanes(
        q[None], torch.tensor([9], dtype=torch.int32), d[None], dv[None],
        torch.tensor([13], dtype=torch.int32),
        torch.zeros((1, 1), dtype=torch.int64), qv[None, :1])
    n = torch.ones((1, 3), dtype=torch.bool)
    ops.bound_grid(q[None, :3], n.float(), n, d[None, :3], n.float(), n,
                   levels=((0, 1), (1, 3)))
    ops.nn_distance(q, d, qv, dv)
    ops.directed_hausdorff_pairs(q, d[None].expand(3, -1, -1), qv,
                                 dv[None].expand(3, -1))
    ops.nn_distance_batched(q[None], d[None], qv[None], dv[None])
    ops.bound_matrices(q[None], qv[None].float(), d[None], dv[None].float())
    ops.bound_row_ub(q[None], qv[None].float(), d[None], dv[None].float(),
                     dv[None])
    sig = torch.arange(6, dtype=torch.int64).reshape(3, 2)
    ops.set_intersect_counts(sig, sig)
    ops.plane_weighted_intersect(sig[:2, None], sig)
    assert ops.LAUNCHES == {"bound_grid": 0, "hausdorff_grid": 0,
                            "min_sq_dists": 0, "set_intersect": 0,
                            "nn_distance": 0, "bound_matrices": 0,
                            "bound_row_ub": 0}


def test_launch_counts_survive_threads():
    """A server's dispatcher thread and the caller may both launch kernels:
    no count may be lost when many threads book launches at once."""
    n_threads, per = 16, 2000
    old = sys.getswitchinterval()
    ops.reset_launches()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.launched("set_intersect", 0) for _ in range(per)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert ops.LAUNCHES["set_intersect"] == n_threads * per
    finally:
        sys.setswitchinterval(old)
        ops.reset_launches()


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros((4, 2))
    v = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensor"):
        hausdorff.min_sq_dists(q, q, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        hausdorff.hausdorff_grid(q[None], q[None, None], v[None],
                                 v[None, None])
    i32 = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        hausdorff.hausdorff_lanes(q[None], i32, q[None], v[None], i32,
                                  i32[None].long(), v[None, :1])
    with pytest.raises(ValueError, match="CUDA tensor"):
        bound_matrix.bound_grid(q[None], v[None].float(), v[None], q[None],
                                v[None].float(), v[None], levels=((0, 1),))
    with pytest.raises(ValueError, match="CUDA tensor"):
        set_intersect.intersect_counts(v[None].long(), v[None].long())
    with pytest.raises(ValueError, match="CUDA tensor"):
        nn_distance.nn_distance(q, q, v, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        hausdorff.min_sq_dists_pairs(q, q[None], v, v[None])
    with pytest.raises(ValueError, match="CUDA tensor"):
        nn_distance.nn_distance_batched(q[None], q[None], v[None], v[None])
    with pytest.raises(ValueError, match="CUDA tensor"):
        bound_matrix.bound_matrices(q[None], v[None].float(), q[None],
                                    v[None].float())
    with pytest.raises(ValueError, match="CUDA tensor"):
        bound_matrix.bound_row_ub(q[None], v[None].float(), q[None],
                                  v[None].float(), v[None])
    meta = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain path"):
        ops.directed_hausdorff(meta, meta, v, v)


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    pts = [np.ones((20, 2), np.float32), np.zeros((30, 2), np.float32)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_repository(pts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_query_index(pts[0])
    repo, _ = build_repository(pts, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.repository_to_torch(bridge.to_numpy(repo))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LiveRepository(pts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repo_mutate.init_live(pts)
    live = LiveRepository(pts, device="cpu")
    assert live.repo.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repo_mutate.build_frozen(live.slot_datasets(), live.geometry)


def test_meshes_need_a_card_unless_given_devices():
    """A mesh defaults to the visible cards: with none it raises, and it
    never falls back to the CPU or to fewer shards on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    from repro_torch.engine import (ReplicatedQueryEngine, ShardedQueryEngine,
                                    data_mesh, replica_mesh)
    from repro_torch.launch.mesh import make_serving_mesh

    for make in (data_mesh, lambda: replica_mesh(2, 2), make_serving_mesh):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        data_mesh(devices=["cpu", "cuda:0"])
    repo, _ = build_repository([np.ones((20, 2), np.float32)], device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedQueryEngine(repo)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicatedQueryEngine(repo, n_replicas=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_search.main(["--requests", "4", "--datasets", "4",
                           "--sharded"])


def test_server_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    pts = [np.ones((20, 2), np.float32), np.zeros((30, 2), np.float32)]
    repo, _ = build_repository(pts, device="cpu")
    engine = QueryEngine(repo)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_search.SearchServer(engine)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_search.main(["--requests", "4", "--datasets", "4"])
    server = serve_search.SearchServer(engine, device="cpu")
    assert not server._running


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    # alone in a directory, without the repository beside it
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, str(alone)], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout

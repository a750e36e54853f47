"""Shared test fixtures + the multi-device harness.

Spec note: XLA's host-platform device count is pinned at first jax init, so
the tier-1 session must NOT force it globally — smoke tests and benches see
exactly 1 device, and multi-device tests run in subprocesses via `run_py`.

The multi-device CI job opts in instead: it sets ``REPRO_HOST_DEVICES=N``
in the environment, and `repro.hostdev.apply()` below (which runs before
any test module imports jax) forces N host-platform devices for the whole
session.  Tests that need a mesh (tests/test_engine_sharded.py) then run
in-process; with the variable unset they transparently fall back to the
subprocess path.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

from repro import hostdev        # requires PYTHONPATH=src (tier-1 command)

hostdev.apply()

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where none is present")


def run_py(code: str, devices: int = 8, timeout: int = 560):
    """Run a python snippet in a subprocess with N forced host devices.

    PYTHONPATH includes src/, the repo root, and tests/ so snippets can
    import both the package and test helpers (e.g. the equivalence bodies
    in test_engine_sharded.py)."""
    env = dict(os.environ)
    env.pop("REPRO_HOST_DEVICES", None)   # the subprocess sets XLA_FLAGS
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = f"{REPO}/src:{REPO}:{REPO}/tests"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=timeout,
                       env=env, cwd=REPO)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    return r.stdout


def dispatch_device_check(module: str, fn_name: str, devices: int = 8,
                          timeout: int = 560):
    """Run check function `module.fn_name` in-process when the session
    already has >= `devices` devices, else in a forced-`devices`
    subprocess.

    The mesh-shaped tests (1-D data meshes AND 2-D replica x data meshes —
    any factorization whose device product is <= `devices`) share this so
    single-device tier-1 sessions still exercise every suite: the check
    body only sees jax.devices(), so an 8-device session serves a 4x2
    replica mesh and an 8-shard data mesh alike."""
    import importlib

    import jax
    if jax.device_count() >= devices:
        getattr(importlib.import_module(module), fn_name)()
    else:
        run_py(f"from {module} import {fn_name}\n{fn_name}()\n",
               devices=devices, timeout=timeout)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def make_clustered_datasets(n, seed=0, n_points=(40, 300), d=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 4))
        centers = rng.uniform(-50, 50, (k, d))
        npts = int(rng.integers(*n_points))
        idx = rng.integers(0, k, npts)
        pts = centers[idx] + rng.normal(size=(npts, d)) * rng.uniform(0.5, 2)
        out.append(pts.astype(np.float32))
    return out

"""Seeded synthetic spatial data repositories (numpy).

A copy of ``repro.data.synthetic``, kept in the port so that it imports
nothing of the JAX package: clustered POI-like sets (MultiOpen), taxi-
trajectory-like random walks (T-Drive / Porto / Chicago) and higher-
dimensional variants (Argoverse 3d, Chicago 11d).  The same seed gives the
same arrays as the JAX package's generators.
"""
from __future__ import annotations

import numpy as np


def poi_repository(n_datasets: int, *, seed: int = 0, d: int = 2,
                   n_points=(50, 800), outlier_frac: float = 0.01,
                   space: float = 100.0):
    """Gaussian-cluster datasets (MultiOpen-like) + GPS-failure outliers."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_datasets):
        n = int(rng.integers(*n_points))
        k = int(rng.integers(1, 4))
        centers = rng.uniform(0, space, (k, d))
        scales = rng.uniform(0.3, 3.0, k)
        idx = rng.integers(0, k, n)
        pts = centers[idx] + rng.normal(size=(n, d)) * scales[idx, None]
        n_out = int(np.ceil(n * outlier_frac)) if rng.random() < 0.5 else 0
        if n_out:
            # failed-GPS points pinned at [0, 0] or far away
            bad = np.zeros((n_out, d))
            if rng.random() < 0.5:
                bad = rng.uniform(3 * space, 5 * space, (n_out, d))
            pts = np.concatenate([pts, bad])
        out.append(pts.astype(np.float32))
    return out


def trajectory_repository(n_datasets: int, *, seed: int = 0,
                          n_points=(100, 1000), space: float = 100.0,
                          step: float = 0.5, d: int = 2):
    """Random-walk trajectories (T-Drive / Porto-like)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_datasets):
        n = int(rng.integers(*n_points))
        start = rng.uniform(0, space, d)
        steps = rng.normal(scale=step, size=(n, d))
        drift = rng.normal(scale=step * 0.2, size=d)
        pts = start + np.cumsum(steps + drift, axis=0)
        out.append(np.clip(pts, 0, space).astype(np.float32))
    return out


def highdim_repository(n_datasets: int, *, seed: int = 0, d: int = 11,
                       n_points=(50, 500), space: float = 100.0):
    """Chicago-like: 2 spatial dims + (d-2) attribute dims."""
    rng = np.random.default_rng(seed)
    base = poi_repository(n_datasets, seed=seed, d=2, n_points=n_points,
                          space=space, outlier_frac=0.0)
    out = []
    for pts in base:
        attrs = rng.normal(size=(pts.shape[0], d - 2)).astype(np.float32)
        out.append(np.concatenate([pts, attrs], axis=1))
    return out


REPOSITORIES = {
    "multiopen": lambda m, seed=0: poi_repository(m, seed=seed),
    "tdrive": lambda m, seed=1: trajectory_repository(m, seed=seed),
    "porto": lambda m, seed=2: trajectory_repository(
        m, seed=seed, n_points=(60, 400)),
    "argoverse": lambda m, seed=3: highdim_repository(m, seed=seed, d=3),
    "chicago": lambda m, seed=4: highdim_repository(m, seed=seed, d=11),
    "shapenet": lambda m, seed=5: poi_repository(
        m, seed=seed, d=3, outlier_frac=0.0),
}

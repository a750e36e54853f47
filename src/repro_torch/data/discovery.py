"""Spadas-driven data discovery feeding the training pipeline.

Counterpart of ``repro.data.discovery``.  Given a data lake (a repository
of spatial datasets) and an exemplar, the curator

  1. builds the unified index (outlier removal included) on the device it
     is given,
  2. runs top-k exemplar search (ExactHaus or GBO) to select training
     shards,
  3. deduplicates the selection with pairwise approximate Hausdorff
     (2-eps guarantee: near-duplicate shards poison LM training),
  4. tokenizes the survivors into the TokenPipeline.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import search, zorder
from repro_torch.core.build import build_query_index, build_repository
from repro_torch.core.index import DatasetIndex
from repro_torch.data import tokens as tok


def curate(
    datasets: list[np.ndarray],
    exemplar: np.ndarray,
    *,
    k: int = 32,
    theta: int = 6,
    metric: str = "hausdorff",
    device=None,
):
    """Select k exemplar-similar datasets, then drop near-duplicates: two
    datasets whose symmetric approximate Hausdorff is at most 4 eps, eps
    one cell of the signature grid.  Runs on ``cuda`` unless ``device``
    names another.

    Returns (selected dataset indices, repository, info dict)."""
    repo, info = build_repository(datasets, theta=theta, device=device)
    q_idx, q_sig = build_query_index(
        exemplar, theta=theta, space_lo=repo.space_lo,
        space_hi=repo.space_hi, device=repo.device)

    if metric == "hausdorff":
        vals, ids, stats = search.topk_hausdorff(repo, q_idx, k)
        info["search_stats"] = stats._asdict()
    elif metric == "gbo":
        vals, ids = search.topk_gbo(repo, q_sig, k)
    else:
        raise ValueError(metric)
    ids = [int(i) for i in ids.tolist() if int(i) < len(datasets)]

    # near-duplicate removal with the 2-eps approximate Hausdorff
    eps = float(zorder.default_epsilon(repo.space_lo, repo.space_hi, theta))
    kept: list[int] = []
    for i in ids:
        dup = False
        di = DatasetIndex(*[x[i] for x in repo.ds_index])
        for j in kept:
            dj = DatasetIndex(*[x[j] for x in repo.ds_index])
            h_ij = float(search.hausdorff_pair_approx(di, dj, eps))
            h_ji = float(search.hausdorff_pair_approx(dj, di, eps))
            if max(h_ij, h_ji) <= 4 * eps:   # sym-Hausdorff near-dup
                dup = True
                break
        if not dup:
            kept.append(i)
    info["selected"] = kept
    info["deduped_away"] = len(ids) - len(kept)
    return kept, repo, info


def pipeline_from_selection(
    datasets: list[np.ndarray], selected: list[int], repo,
    *, theta: int = 6, seq_len: int = 256, batch: int = 8, seed: int = 0,
) -> tok.TokenPipeline:
    docs = [
        tok.tokenize_trajectory(datasets[i], repo.space_lo, repo.space_hi,
                                theta)
        for i in selected
    ]
    return tok.TokenPipeline(docs, seq_len, batch, seed=seed)

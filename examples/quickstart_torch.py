"""Quickstart on the PyTorch port: the paper's Fig. 1 user journey.

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Builds the unified index over a synthetic repository, then runs every
search the paper supports: RangeS, top-k IA / GBO / ExactHaus / ApproHaus
(dataset granularity), RangeP and NNP (point granularity).  The same steps
as ``examples/quickstart.py``, on ``repro_torch``.
"""
import argparse

import torch

from repro_torch.core import point_search, search, zorder
from repro_torch.core.build import build_query_index, build_repository
from repro_torch.core.index import DatasetIndex
from repro_torch.data import synthetic
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    dev = resolve_device(ap.parse_args(argv).device)

    # a data lake of 120 spatial datasets (clustered POIs w/ GPS outliers)
    lake = synthetic.poi_repository(120, seed=0)
    repo, info = build_repository(lake, leaf_capacity=16, theta=5, device=dev)
    print(f"unified index: {info['n_datasets']} datasets, bottom depth "
          f"{info['bottom_depth']}, upper depth {info['upper_depth']}, "
          f"outlier threshold r'={float(info['outlier_threshold']):.2f}")

    # the user's exemplar dataset
    Q = lake[7]
    q_idx, q_sig = build_query_index(Q, space_lo=repo.space_lo,
                                     space_hi=repo.space_hi, theta=5,
                                     device=dev)
    q_lo = torch.as_tensor(Q.min(0), device=dev)
    q_hi = torch.as_tensor(Q.max(0), device=dev)

    # ---- coarse granularity: dataset search -------------------------------
    mask, stats = search.range_search(repo, q_lo, q_hi)
    print(f"RangeS: {int(mask.sum())} datasets overlap the query region "
          f"({stats.nodes_evaluated} node tests)")

    vals, ids = search.topk_ia(repo, q_lo, q_hi, 5)
    print(f"IA    top-5: {ids.tolist()}")

    vals, ids = search.topk_gbo(repo, q_sig, 5)
    print(f"GBO   top-5: {ids.tolist()} (overlaps {vals.tolist()})")

    vals, ids, hstats = search.topk_hausdorff(repo, q_idx, 5)
    print(f"Haus  top-5: {ids.tolist()} "
          f"(exact evals: {hstats.exact_evaluations} of "
          f"{info['n_datasets']} — {hstats.pruned_fraction:.0%} pruned)")

    eps = float(zorder.default_epsilon(repo.space_lo, repo.space_hi, 5))
    avals, aids, (lq, ld, eps_eff) = search.topk_hausdorff_approx(
        repo, q_idx, 5, eps)
    print(f"ApproHaus top-5: {aids.tolist()} (error <= {2 * eps_eff:.3f})")

    # ---- fine granularity: point search -----------------------------------
    best = int(ids[1])  # most similar dataset that isn't Q itself
    d_idx = DatasetIndex(*[x[best] for x in repo.ds_index])
    take, pstats = point_search.range_points(d_idx, q_lo, q_hi)
    print(f"RangeP: {int(take.sum())} points of dataset {best} in region "
          f"({pstats.pruned_fraction:.0%} of leaves pruned)")

    dist, idx, nstats = point_search.nnp_pruned(q_idx, d_idx)
    live = q_idx.valid.cpu().numpy()
    print(f"NNP: mean NN distance {float(dist.cpu().numpy()[live].mean()):.3f} "
          f"({nstats.pruned_fraction:.0%} of leaf pairs pruned)")


if __name__ == "__main__":
    main()

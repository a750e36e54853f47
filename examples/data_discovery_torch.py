"""Data-lake curation on the PyTorch port: Spadas as the data layer of the
training framework.

    PYTHONPATH=src python examples/data_discovery_torch.py --device cpu

The same lines as ``examples/data_discovery.py``: given a lake of
trajectory datasets and an exemplar, select the most similar shards
(top-k directed Hausdorff with batch pruning), drop near-duplicates with
the 2-eps approximate Hausdorff, and materialize a resumable token
pipeline, the deliverable the trainer consumes.  Without ``--device`` it
runs on the card (and raises where there is none).
"""
import argparse

import numpy as np

from repro_torch.data import discovery, synthetic


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    lake = synthetic.trajectory_repository(192, seed=0)
    # pollute the lake with near-duplicates to show dedup working
    rng = np.random.default_rng(1)
    for i in range(8):
        src = lake[i]
        dup = src + rng.normal(scale=1e-3, size=src.shape).astype(np.float32)
        lake.append(dup)

    exemplar = lake[0]
    selected, repo, info = discovery.curate(
        lake, exemplar, k=48, theta=6, metric="hausdorff",
        device=args.device)
    print(f"[discovery] lake={len(lake)} datasets; Hausdorff bound pass "
          f"pruned {info['search_stats']['pruned_fraction']:.0%} of exact "
          f"evaluations")
    print(f"[discovery] selected {len(selected)} shards, "
          f"deduped away {info['deduped_away']} near-duplicates")

    pipe = discovery.pipeline_from_selection(
        lake, selected, repo, theta=6, seq_len=128, batch=4)
    b = pipe.next_batch()
    print(f"[discovery] pipeline ready: batch tokens {b['tokens'].shape}, "
          f"vocab range [{b['tokens'].min()}, {b['tokens'].max()}]")
    print(f"[discovery] resumable state: {pipe.state.as_dict()}")
    return selected, info, pipe


if __name__ == "__main__":
    main()

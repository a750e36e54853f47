"""Serving scenario on the PyTorch port: a spatial point-query service and
trajectory-LM decode side by side.

    PYTHONPATH=src python examples/serve_points_torch.py               # the card
    PYTHONPATH=src python examples/serve_points_torch.py --device cpu

``examples/serve_points.py`` on ``repro_torch``: a resident Spadas
``QueryEngine`` answers declarative search requests (retrieval) while the
trajectory LM decodes (generation), the two workloads the deployment
hosts.  One mixed batch covers point queries (RangeP) and the paper's
dataset -> point pipeline (top-k datasets, then points inside the
winners) in one engine call; then the search server answers the same
specs through its micro-batching thread while the LM, on the main thread,
prefills prompts tokenized from the repository's trajectories and decodes
greedily.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.build import build_repository
from repro_torch.data import synthetic
from repro_torch.data.tokens import tokenize_trajectory
from repro_torch.device import resolve_device
from repro_torch.engine import Pipeline, Query, QueryEngine
from repro_torch.launch import serve as lm_serve
from repro_torch.launch.serve_search import SearchServer
from repro_torch.models.model import LanguageModel


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    ap.add_argument("--gen", type=int, default=16)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- retrieval side ---
    lake = synthetic.trajectory_repository(64, seed=0)
    repo, info = build_repository(lake, leaf_capacity=16, theta=5, device=dev)
    engine = QueryEngine(repo)

    rng = np.random.default_rng(0)
    n_requests = 16
    boxes = [rng.uniform(20, 80, 2).astype(np.float32)
             for _ in range(n_requests)]
    batch = [Query(op="range_points", ds_id=i % 64, r_lo=c - 2.0,
                   r_hi=c + 2.0) for i, c in enumerate(boxes)]
    c0 = boxes[0]
    batch.append(Pipeline(
        Query(op="topk_ia", r_lo=c0 - 10.0, r_hi=c0 + 10.0, k=3),
        Query(op="range_points", r_lo=c0 - 2.0, r_hi=c0 + 2.0)))

    engine.search(batch)                               # warm-up
    g0 = engine.stats.plan_groups
    _sync(dev)
    t0 = time.perf_counter()
    results = engine.search(batch)
    _sync(dev)
    dt = time.perf_counter() - t0
    hits = sum(int(np.asarray(r.mask).sum()) for r in results[:-1])
    pipe = results[-1]
    print(f"[retrieval] {n_requests} RangeP + 1 pipeline in {dt * 1e3:.1f} "
          f"ms ({hits} points returned; pipeline winners "
          f"{np.asarray(pipe.extras['ds_ids']).tolist()} -> "
          f"{int(np.asarray(pipe.mask).sum())} points, "
          f"{engine.stats.plan_groups - g0} dispatch groups planned)")

    # --- generation side, with the server answering meanwhile ---
    cfg = configs.get_reduced("spadas_trajlm")      # 4**5 + 64 tokens
    model = LanguageModel(cfg, device=dev, seed=0)
    lo, hi = repo.space_lo.cpu().numpy(), repo.space_hi.cpu().numpy()
    docs = [tokenize_trajectory(t, lo, hi, 5) for t in lake]
    prompts = np.stack([d[:32] for d in docs if len(d) >= 32][:8])
    lm_serve.generate(model, prompts[:, :8], 2)    # warm-up

    server = SearchServer(engine, max_batch=32, device=dev).start()
    try:
        futures = [server.submit_query(q) for q in batch]
        Q = lake[1][:256]
        futures.append(server.submit("nnp", ds_id=0, q=Q))
        t0 = time.perf_counter()
        out = lm_serve.generate(model, prompts, args.gen)
        _sync(dev)
        t_gen = time.perf_counter() - t0
        served = [f.result(timeout=600) for f in futures]
    finally:
        server.stop()
    # a served RangeP is its mask, a served pipeline its SearchResult
    for got, want in zip(served[:-2], results[:-1]):
        assert np.array_equal(got, want.mask)
    assert np.array_equal(served[-2].mask, pipe.mask)
    dist, idx = served[-1]
    print(f"[retrieval] served the same {len(batch)} specs and one NNP of "
          f"{len(Q)} points through the server while the LM decoded "
          f"(NNP mean distance {float(np.mean(dist)):.3f})")
    seqs = out.tokens.cpu().numpy()
    print(f"[generation] {cfg.name}: {prompts.shape[0]} prompts of "
          f"{prompts.shape[1]} trajectory tokens, {args.gen} greedy tokens "
          f"each in {t_gen * 1e3:.1f} ms; req 0: {seqs[0].tolist()}")


if __name__ == "__main__":
    main()

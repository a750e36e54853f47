"""End-to-end training on the PyTorch port: the trajectory LM trained on
data curated by the Spadas index.

    PYTHONPATH=src python examples/train_lm_torch.py --device cpu [--steps 300]

The same lines as ``examples/train_lm.py``: the reduced config for a quick
demonstration, ``--full`` for the full spadas-trajlm (~116M params), the
same trainer, longer.  Without ``--device`` it runs on the card (and raises
where there is none).
"""
import argparse

from repro_torch.launch import train as trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    argv = [
        "--arch", "spadas_trajlm",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "256",
        "--lake-size", "256",
        "--ckpt-dir", "results/ckpt_example",
        "--ckpt-every", "100",
    ]
    if not args.full:
        argv.append("--reduced")
    if args.device is not None:
        argv += ["--device", args.device]
    losses = trainer.main(argv)
    if not losses[-1] < losses[0]:
        raise RuntimeError("loss did not decrease")
    print(f"[example] trained {args.steps} steps, "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


if __name__ == "__main__":
    main()

"""Roofline analysis of the dry-run records (``launch/dryrun.py``), with
the terms of one NVIDIA H100 SXM.

Counterpart of ``benchmarks/roofline.py``, kept inside the package.
Hardware terms (NVIDIA's data sheet, SXM part, dense, at the full 700 W
power limit; a card set below it runs slower under load):

    peak bf16 compute  989e12 FLOP/s
    HBM bandwidth      3.35e12 B/s
    NVLink             450e9 B/s each way (assumed: no run of the port
                       has moved data between two cards)

Terms per (arch x shape):
    compute_s    = flops_per_device / peak
    memory_s     = bytes_per_device / HBM bandwidth
    collective_s = moved bytes per device / link rate
                   (serialized upper bound)

plus MODEL_FLOPS (6ND train / 2ND inference, N = active params) and the
useful-compute ratio MODEL_FLOPS / (flops_per_device x devices).  The JAX
module's scan-trip correction (``probe`` records) has no counterpart:
the port's records count every repeat.  ``analyze`` takes the terms as
arguments, the H100's by default.

Usage: python -m repro_torch.launch.roofline [--dir results/dryrun]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def model_flops(rec: dict) -> float:
    n_active = rec["model_params_active"]
    tokens = rec["batch"] * rec["seq"]
    if rec["cell_kind"] == "train":
        return 6.0 * n_active * tokens
    if rec["cell_kind"] == "prefill":
        return 2.0 * n_active * tokens
    # decode: one new token per sequence
    return 2.0 * n_active * rec["batch"]


def analyze(rec: dict, *, peak_flops: float = PEAK_FLOPS,
            hbm_bw: float = HBM_BW, link_bw: float = LINK_BW) -> dict:
    nd = rec["n_devices"]
    flops = rec["flops_per_device"]
    moved = rec.get("collective_moved_bytes_total",
                    rec.get("collective_bytes_total", 0))
    terms = {"compute_s": flops / peak_flops,
             "memory_s": rec["bytes_per_device"] / hbm_bw,
             "collective_s": moved / link_bw}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(rec)
    total = flops * nd
    useful = mf / total if total > 0 else float("nan")
    # useful model FLOPs over what the bottleneck term allows at peak
    step_s = max(terms.values())
    fraction = (mf / nd / peak_flops) / step_s if step_s > 0 else 0.0
    return {
        **terms,
        "bottleneck": bottleneck.replace("_s", ""),
        "model_flops": mf,
        "useful_ratio": useful,
        "roofline_fraction": fraction,
    }


def load_records(d: Path, mesh: str = "single", tag: str = "") -> list:
    recs = []
    for f in sorted(d.glob(f"*__{mesh}{'__' + tag if tag else ''}.json")):
        r = json.loads(f.read_text())
        if tag == "" and r.get("tag"):
            continue
        recs.append(r)
    return recs


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:8.2f}s "
    if x >= 1e-3:
        return f"{x*1e3:8.2f}ms"
    return f"{x*1e6:8.2f}us"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--tag", default="")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    recs = load_records(Path(args.dir), args.mesh, args.tag)
    rows = []
    print(f"H100 SXM terms: {PEAK_FLOPS:.4g} FLOP/s bf16, {HBM_BW:.4g} B/s "
          f"HBM, {LINK_BW:.4g} B/s NVLink each way (assumed), at 700 W")
    print(f"{'arch':<22}{'shape':<13}{'compute':>11}{'memory':>11}"
          f"{'collective':>11}  {'bound':<11}{'useful':>8}{'roofline%':>10}")
    for r in recs:
        if r.get("status") == "skipped":
            print(f"{r['arch']:<22}{r['shape']:<13}"
                  f"{'-- skipped (full-attention @512k, see DESIGN.md) --'}")
            rows.append(r)
            continue
        if r.get("status") != "ok":
            print(f"{r['arch']:<22}{r['shape']:<13}  ERROR")
            rows.append(r)
            continue
        a = analyze(r)
        rows.append({**r, "roofline": a})
        print(f"{r['arch']:<22}{r['shape']:<13}"
              f"{fmt_s(a['compute_s']):>11}{fmt_s(a['memory_s']):>11}"
              f"{fmt_s(a['collective_s']):>11}  {a['bottleneck']:<11}"
              f"{a['useful_ratio']:>8.2f}{a['roofline_fraction']*100:>9.1f}%")
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(rows, indent=2))
        print(f"wrote {args.json_out}")
    return rows


if __name__ == "__main__":
    main()

"""FID curves and best-checkpoint selection for a training run.

Reads the FID column of the run's ``metrics.csv`` (the training loop's;
the JAX package writes the same columns) or, failing that, the FID values
in its sample-grid names (``{iter:06d}_res{res}_fid_{fid}.png``, the
reference's naming), prints the best checkpoint and plots the curve:

  python -m gif_tpu_torch.scripts.plot_fid --run_dir runs/0
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import re

_NAME_RE = re.compile(r"(\d+)_res\d+_fid_([0-9.]+)\.png$")


def fid_from_sample_names(sample_dir: str) -> list:
    """Sorted (step, FID) pairs from the grid names under ``sample_dir``."""
    points = []
    for path in glob.glob(os.path.join(sample_dir, "*.png")):
        m = _NAME_RE.search(os.path.basename(path))
        if m:
            points.append((int(m.group(1)), float(m.group(2))))
    return sorted(points)


def fid_from_metrics_csv(path: str) -> list:
    """Sorted (step, FID) pairs of the rows of ``metrics.csv`` whose FID is
    not NaN."""
    points = []
    with open(path) as f:
        for row in csv.DictReader(f):
            fid = float(row.get("fid", "nan"))
            if fid == fid:  # not NaN
                points.append((int(row["step"]), fid))
    return sorted(points)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--run_dir", required=True, help="runs/{run_id} directory")
    p.add_argument("--out", default=None, help="output png (default run_dir/fid.png)")
    p.add_argument("--ylim", type=float, default=50.0, help="plot ceiling (the reference uses (0, 50))")
    args = p.parse_args(argv)

    points = []
    csv_path = os.path.join(args.run_dir, "metrics.csv")
    if os.path.exists(csv_path):
        points = fid_from_metrics_csv(csv_path)
    if not points:
        for sample_dir in glob.glob(os.path.join(args.run_dir, "sample", "*")):
            points += fid_from_sample_names(sample_dir)
        points = sorted(points)
    if not points:
        raise SystemExit(f"no FID data found under {args.run_dir}")

    best_step, best_fid = min(points, key=lambda sf: sf[1])
    print(f"best checkpoint: step {best_step} (FID {best_fid:.2f})")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; printed best checkpoint only")
        return
    steps, fids = zip(*points)
    plt.figure(figsize=(8, 4))
    plt.plot(steps, fids)
    plt.scatter([best_step], [best_fid], color="red", zorder=3)
    plt.ylim(0, args.ylim)
    plt.xlabel("iteration")
    plt.ylabel("FID")
    plt.grid(alpha=0.3)
    out = args.out or os.path.join(args.run_dir, "fid.png")
    plt.savefig(out, dpi=120, bbox_inches="tight")
    plt.close()
    print(f"wrote {out}")


if __name__ == "__main__":
    main()

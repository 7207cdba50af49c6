"""Perceptual-study batch CSVs, and the analysis and plots of their results.

The study pipeline around :mod:`gif_tpu_torch.scripts.mturk_stimuli`:

- ``csv``: HIT input CSVs from a stimulus directory.  The association
  study gets one ``image_url`` column; the comparison study gets ``GT,
  OPTION1, OPTION2`` with the two models swapped left / right at random per
  row (``--seed``) and the swap key saved beside the CSV.
- ``score``: the share of A/B answers that picked the full model (model
  A), undoing the swap, and a bar chart.
- ``likert``: the modal 5-point Likert score per identity of an
  association study, and their histogram.

  python -m gif_tpu_torch.scripts.mturk_results csv --study comparison \
      --stimulus_dir study_out --base_url https://bucket/ --out batch.csv
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from collections import defaultdict

import numpy as np

LIKERT = [
    "Strongly disagree",
    "Disagree",
    "Neither agree nor disagree",
    "Agree",
    "Strongly agree",
]


def comparison_rows(names, base_url: str, rng) -> tuple:
    """(rows, swapped): per stimulus the mesh render's URL and the two
    models' images, swapped left / right where one ``rng.integers(0, 2)``
    draw says so."""
    rows, swapped = [], []
    for n in names:
        swap = bool(rng.integers(0, 2))
        a = f"{base_url}model_a/{n}"
        b = f"{base_url}model_b/{n}"
        rows.append({"GT": f"{base_url}renders/{n}", "OPTION1": b if swap else a, "OPTION2": a if swap else b})
        swapped.append(swap)
    return rows, swapped


def score_comparison(result_rows) -> float:
    """The share of answers that picked model A (the full model), from rows
    with ``OPTION1`` / ``answer1`` columns: the A image is the one whose URL
    holds ``model_a``."""
    correct = 0
    for r in result_rows:
        ans1 = str(r["answer1"]).strip().lower() in ("1", "true", "yes")
        if ("model_a" in r["OPTION1"]) == ans1:
            correct += 1
    return correct / max(1, len(result_rows))


def likert_modal_scores(result_rows) -> dict:
    """The modal 1..5 rating per identity (the image name's prefix before
    its first ``_``), identities sorted."""
    per_id = defaultdict(list)
    cat_idx = {c: i + 1 for i, c in enumerate(LIKERT)}
    for r in result_rows:
        ident = os.path.basename(r["image_url"]).split("_")[0]
        per_id[ident].append(cat_idx[r["label"]])
    return {k: int(np.bincount(v).argmax()) for k, v in sorted(per_id.items())}


def _plot(out: str, draw) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    draw(plt)
    plt.savefig(out)
    plt.close()
    print(f"wrote {out}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("mode", choices=["csv", "score", "likert"])
    p.add_argument("--study", choices=["association", "comparison"], default="association")
    p.add_argument("--stimulus_dir", type=str, default="study_out")
    p.add_argument("--base_url", type=str, default="https://example.com/study/")
    p.add_argument("--results", type=str, default=None, help="downloaded result CSV (score / likert modes)")
    p.add_argument("--out", type=str, default=None,
                   help="output path; defaults to batch.csv (csv mode) or <mode>_plot.png (score / likert modes)")
    p.add_argument("--seed", type=int, default=2)
    args = p.parse_args(argv)
    if args.out is None:
        args.out = "batch.csv" if args.mode == "csv" else f"{args.mode}_plot.png"

    if args.mode == "csv":
        sub = "faces" if args.study == "association" else "model_a"
        names = sorted(os.listdir(os.path.join(args.stimulus_dir, sub)))
        rng = np.random.default_rng(args.seed)
        if args.study == "association":
            rows = [{"image_url": f"{args.base_url}faces/{n}"} for n in names]
        else:
            rows, swapped = comparison_rows(names, args.base_url, rng)
            with open(args.out + ".key.json", "w") as f:
                json.dump({"swapped": swapped}, f)
        with open(args.out, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {len(rows)} rows to {args.out}")
        return

    with open(args.results, newline="") as f:
        result_rows = list(csv.DictReader(f))

    if args.mode == "score":
        prob = score_comparison(result_rows)
        print(f"full-model detection probability: {prob:.3f}")

        def draw(plt):
            plt.bar(["full model"], [prob])
            plt.axhline(0.5, ls="--", c="gray")
            plt.ylabel("detection probability")
    else:
        scores = likert_modal_scores(result_rows)
        for k, v in scores.items():
            print(f"{k}: {v}")

        def draw(plt):
            plt.hist(list(scores.values()), bins=np.arange(0.5, 6), rwidth=0.8)
            plt.xlabel("modal Likert score")
            plt.ylabel("#identities")
    _plot(args.out, draw)


if __name__ == "__main__":
    main()

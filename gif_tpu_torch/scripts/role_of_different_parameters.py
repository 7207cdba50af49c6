"""Parameter-swap columns (the paper's figure 3).

Take FLAME vectors in pairs and progressively copy shape, then
expression, pose and texture from the second into the first, rendering and
generating each stage to show which image factors each parameter controls:

  python -m gif_tpu_torch.scripts.role_of_different_parameters --n_pairs 8 --out_dir fig3
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from gif_tpu_torch.scripts.generate_random_samples import add_common_args, load_params, setup


def interchange_params_and_make_batch(flame1: np.ndarray, flame2: np.ndarray) -> np.ndarray:
    """Rows: [flm1, shape<-2, +exp<-2, +pose<-2, +tex<-2, flm2]."""
    rows = [flame1.copy()]
    cur = flame1.copy()
    for lo, hi in ((0, 100), (100, 150), (150, 156), (159, 209)):
        cur[lo:hi] = flame2[lo:hi]
        rows.append(cur.copy())
    rows.append(flame2.copy())
    return np.stack(rows)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_common_args(p)
    p.add_argument("--data", type=str, default=None)
    p.add_argument("--n_pairs", type=int, default=8)
    p.add_argument("--out_dir", type=str, default="fig3_out")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from gif_tpu_torch.eval.sampling import FlameSampler, random_flame_params
    from gif_tpu_torch.utils import viz

    device, cfg, res = setup(args, batch_size=6)
    dataset_params = None
    if args.data and os.path.exists(args.data):
        dataset_params = np.load(args.data)["flame_params"]

    rng = np.random.default_rng(args.seed)
    sampler = FlameSampler(cfg, res, load_params(args, cfg), batch_size=6, device=device)
    for b in range(args.n_pairs):
        f2 = random_flame_params(rng, 2, dataset_params)
        batch = interchange_params_and_make_batch(f2[0], f2[1])
        idx = np.full(len(batch), rng.integers(0, args.vocab), np.int32)
        images, conds = sampler.sample(batch, idx)
        d = os.path.join(args.out_dir, f"pair_{b}")
        viz.save_set_of_images(d, "img_", (images + 1) / 2)
        viz.save_set_of_images(d, "rndr_", (conds[..., :3] + 1) / 2)
        if conds.shape[-1] > 3:
            viz.save_set_of_images(d, "norm_", (conds[..., 3:6] + 1) / 2)
    print(f"wrote {args.n_pairs} swap columns to {args.out_dir}")


if __name__ == "__main__":
    main()

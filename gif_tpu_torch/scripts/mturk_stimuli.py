"""Perceptual-study stimuli (MTurk-style), generated through the port.

Two studies, as the reference's mturk tooling makes them:

- ``association``: does a generated face match its FLAME render?  Each
  generated image is paired with its own condition render or, for about
  half of them, another sample's (a derangement), and the key is saved
  (``key.json``) for scoring.
- ``comparison``: the same FLAME conditions generated by two models, side
  by side (``model_a/``, ``model_b/``), for A/B preference collection.

  python -m gif_tpu_torch.scripts.mturk_stimuli association \
      --converted_ckpt trees.pkl --n 50 --out_dir study_out
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from gif_tpu_torch.scripts.generate_random_samples import add_common_args, load_params, setup


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("mode", choices=["association", "comparison"])
    add_common_args(p)
    p.add_argument("--ckpt_b", type=str, default=None,
                   help="second model (a port run's checkpoint directory) for comparison mode")
    p.add_argument("--converted_ckpt_b", type=str, default=None,
                   help="second model as a trees pickle")
    p.add_argument("--n", type=int, default=50)
    p.add_argument("--out_dir", type=str, default="study_out")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from gif_tpu_torch.eval.sampling import FlameSampler, random_flame_params
    from gif_tpu_torch.utils import viz

    if args.mode == "comparison" and not (args.ckpt_b or args.converted_ckpt_b):
        raise SystemExit("comparison mode needs --ckpt_b or --converted_ckpt_b")
    device, cfg, res = setup(args)
    rng = np.random.default_rng(args.seed)
    flame = random_flame_params(rng, args.n)
    indices = rng.integers(0, args.vocab, args.n).astype(np.int32)

    sampler = FlameSampler(cfg, res, load_params(args, cfg), device=device)
    images, conds = sampler.sample(flame, indices)

    os.makedirs(args.out_dir, exist_ok=True)
    if args.mode == "association":
        # Half the pairs get a deranged condition (the reference's
        # get_unique_shuffle_indices): a shift by 1..n-1.
        perm = (np.arange(args.n) + 1 + rng.integers(0, args.n - 1)) % args.n
        is_match = rng.random(args.n) < 0.5
        pair_cond = np.where(is_match[:, None, None, None], conds[..., :3], conds[perm][..., :3])
        viz.save_set_of_images(os.path.join(args.out_dir, "faces"), "s_", (images + 1) / 2)
        viz.save_set_of_images(os.path.join(args.out_dir, "renders"), "s_", (pair_cond + 1) / 2)
        with open(os.path.join(args.out_dir, "key.json"), "w") as f:
            json.dump({"is_match": is_match.tolist()}, f)
    else:
        # Model B's own flags: its converted_ckpt replaces model A's (the
        # loader reads converted_ckpt first, so leaving A's pickle in place
        # would compare A with itself).
        args_b = argparse.Namespace(**{**vars(args), "ckpt": args.ckpt_b, "converted_ckpt": args.converted_ckpt_b})
        sampler_b = FlameSampler(cfg, res, load_params(args_b, cfg), device=device)
        images_b, _ = sampler_b.sample(flame, indices)
        viz.save_set_of_images(os.path.join(args.out_dir, "model_a"), "s_", (images + 1) / 2)
        viz.save_set_of_images(os.path.join(args.out_dir, "model_b"), "s_", (images_b + 1) / 2)
    print(f"wrote {args.n} stimuli to {args.out_dir}")


if __name__ == "__main__":
    main()

"""Random conditional samples from a trained GIF generator.

Draw random shape / expression / pose with dataset-sourced camera,
texture and light (when ``--data`` is given), eye-centre the camera,
render the condition maps, generate, and save images, conditions and
params:

  python -m gif_tpu_torch.scripts.generate_random_samples \
      --converted_ckpt trees.pkl --n 128 --out_dir samples_out
"""

from __future__ import annotations

import argparse
import os

import numpy as np

TINY_HELP = "32px/16ch smoke config (CPU runs; pair with --flame_resources synthetic_small)"


def add_common_args(p: argparse.ArgumentParser) -> None:
    """The flags every generation script shares."""
    p.add_argument("--run_id", type=int, default=0)
    p.add_argument("--ckpt", type=str, default=None, help="checkpoint directory of a port training run")
    p.add_argument("--converted_ckpt", type=str, default=None,
                   help="trees pickle from the convert_checkpoint tools")
    p.add_argument("--flame_resources", type=str, default=None)
    p.add_argument("--vocab", type=int, default=69158)
    p.add_argument("--tiny", action="store_true", help=TINY_HELP)
    p.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")


def setup(args, **cfg_overrides):
    """(device, cfg, FLAME resources) of the parsed common flags; the
    device is resolved first, so a missing card refuses before anything
    loads."""
    from gif_tpu_torch.device import resolve_device
    from gif_tpu_torch.flame.resources import load_flame_resources
    from gif_tpu_torch.train.config import TINY_OVERRIDES, get_config

    device = resolve_device(args.device)
    cfg = get_config(args.run_id, embedding_vocab_size=args.vocab, **cfg_overrides,
                     **(TINY_OVERRIDES if args.tiny else {}))
    return device, cfg, load_flame_resources(args.flame_resources)


def load_params(args, cfg) -> dict:
    """The generator state_dict the flags name
    (:func:`gif_tpu_torch.eval.sampling.load_generator_params`)."""
    from gif_tpu_torch.eval.sampling import load_generator_params

    return load_generator_params(cfg, ckpt=args.ckpt, converted_ckpt=args.converted_ckpt)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_common_args(p)
    p.add_argument("--data", type=str, default=None, help="packed dataset npz for real cam/tex/light rows")
    p.add_argument("--n", type=int, default=128)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--out_dir", type=str, default="random_samples")
    p.add_argument("--seed", type=int, default=2)
    args = p.parse_args(argv)

    from gif_tpu_torch.eval.sampling import FlameSampler, random_flame_params
    from gif_tpu_torch.utils import viz

    device, cfg, res = setup(args, batch_size=args.batch)
    dataset_params = None
    if args.data and os.path.exists(args.data):
        dataset_params = np.load(args.data)["flame_params"]

    rng = np.random.default_rng(args.seed)
    flame = random_flame_params(rng, args.n, dataset_params)
    indices = rng.integers(0, args.vocab, args.n).astype(np.int32)

    sampler = FlameSampler(cfg, res, load_params(args, cfg), batch_size=args.batch, device=device)
    images, conds = sampler.sample(flame, indices)

    viz.save_set_of_images(os.path.join(args.out_dir, "images"), "img_", (images + 1) / 2)
    viz.save_set_of_images(os.path.join(args.out_dir, "conditions"), "cond_", (conds[..., :3] + 1) / 2)
    np.save(os.path.join(args.out_dir, "params.npy"), {"flame": flame, "indices": indices}, allow_pickle=True)
    print(f"wrote {args.n} samples to {args.out_dir}")


if __name__ == "__main__":
    main()

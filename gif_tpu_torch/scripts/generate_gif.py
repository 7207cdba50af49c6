"""Animate a FLAME parameter sequence into a GIF.

Interpolate linearly between random FLAME keyframes (or play a given
``--sequence``, e.g. speech-driven), render and generate each frame with a
fixed identity, and write the animation:

  python -m gif_tpu_torch.scripts.generate_gif --converted_ckpt trees.pkl --out face.gif
"""

from __future__ import annotations

import argparse

import numpy as np

from gif_tpu_torch.scripts.generate_random_samples import add_common_args, load_params, setup


def interpolate_keyframes(keys: np.ndarray, steps_per_seg: int) -> np.ndarray:
    """``steps_per_seg`` linear steps from each keyframe row towards the
    next, then the last keyframe: (steps * (K - 1) + 1, D)."""
    segs = []
    for a, b in zip(keys[:-1], keys[1:]):
        t = np.linspace(0, 1, steps_per_seg, endpoint=False)[:, None]
        segs.append(a[None] * (1 - t) + b[None] * t)
    segs.append(keys[-1:])
    return np.concatenate(segs, axis=0)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_common_args(p)
    p.add_argument("--sequence", type=str, default=None,
                   help="npy of (T, 236) FLAME params; default: random keyframe interpolation")
    p.add_argument("--n_keyframes", type=int, default=4)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--identity", type=int, default=0)
    p.add_argument("--out", type=str, default="animation.gif")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from gif_tpu_torch.eval.sampling import FlameSampler, random_flame_params
    from gif_tpu_torch.utils import viz

    device, cfg, res = setup(args)
    if args.sequence:
        seq = np.load(args.sequence).astype(np.float32)
    else:
        keys = random_flame_params(np.random.default_rng(args.seed), args.n_keyframes)
        seq = interpolate_keyframes(keys, args.steps)

    indices = np.full(len(seq), args.identity, np.int32)
    sampler = FlameSampler(cfg, res, load_params(args, cfg), device=device)
    images, _ = sampler.sample(seq, indices)
    viz.save_animation(viz.to_uint8(images), args.out)
    print(f"wrote {len(seq)}-frame animation to {args.out}")


if __name__ == "__main__":
    main()

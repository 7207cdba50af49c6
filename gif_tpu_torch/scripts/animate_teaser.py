"""Animated teaser: sweep each control axis in turn for one identity.

For a fixed identity, animate shape, expression, jaw pose, albedo and
light through a 0 -> +sigma -> -sigma -> 0 sweep, one frame per step, and
write the frames, their renders and the whole sequence as a GIF:

  python -m gif_tpu_torch.scripts.animate_teaser --converted_ckpt trees.pkl --out_dir anim
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from gif_tpu_torch import constants as cnst
from gif_tpu_torch.scripts.generate_random_samples import add_common_args, load_params, setup


def sweep_axis(base: np.ndarray, dim: int, sigma: float, steps: int) -> np.ndarray:
    """(T, 236): ``base`` with ``params[dim]`` swept along ``sigma *
    sin(t)``, t over one period."""
    t = np.linspace(0, 2 * np.pi, steps, endpoint=False)
    out = np.repeat(base[None], steps, axis=0)
    out[:, dim] = sigma * np.sin(t)
    return out


def build_sweep_sequence(base: np.ndarray, sigma: float, steps: int) -> np.ndarray:
    """Concatenated axis sweeps: the top two shape and expression
    components, the jaw, the top albedo component, a light band."""
    segs = [sweep_axis(base, d, sigma, steps) for d in (0, 1, 100, 101)]
    jaw = np.repeat(base[None], steps, axis=0)
    jaw[:, 153] = 0.15 * (1 - np.cos(np.linspace(0, 2 * np.pi, steps)))
    segs.append(jaw)
    segs.append(sweep_axis(base, cnst.DECA_IDX["tex"][0], sigma, steps))
    segs.append(sweep_axis(base, cnst.DECA_IDX["lit"][0] + 3, sigma, steps))
    return np.concatenate(segs, axis=0)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_common_args(p)
    p.add_argument("--identity", type=int, default=0)
    p.add_argument("--steps", type=int, default=24, help="frames per axis sweep")
    p.add_argument("--sigma", type=float, default=2.0)
    p.add_argument("--out_dir", type=str, default="teaser_anim")
    p.add_argument("--fps", type=int, default=15)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from gif_tpu_torch.eval.sampling import FlameSampler
    from gif_tpu_torch.utils import viz

    device, cfg, res = setup(args)
    rng = np.random.default_rng(args.seed)
    lit0 = cnst.DECA_IDX["lit"][0]
    tex0, tex1 = cnst.DECA_IDX["tex"]
    base = np.zeros(236, np.float32)
    base[lit0 : lit0 + 3] = 3.0
    base[tex0:tex1] = rng.standard_normal(50) * 0.3
    seq = build_sweep_sequence(base, args.sigma, args.steps)
    indices = np.full(len(seq), args.identity, np.int32)

    sampler = FlameSampler(cfg, res, load_params(args, cfg), device=device)
    images, conds = sampler.sample(seq, indices)

    viz.save_set_of_images(os.path.join(args.out_dir, "frames"), "", (images + 1) / 2)
    viz.save_set_of_images(os.path.join(args.out_dir, "renders"), "mesh_", (conds[..., :3] + 1) / 2)
    gif = os.path.join(args.out_dir, "teaser_animation.gif")
    viz.save_animation(viz.to_uint8(images), gif, fps=args.fps)
    print(f"wrote {len(seq)} frames + {gif}")


if __name__ == "__main__":
    main()

"""FID against the corruption of the FLAME conditioning.

For a range of corruption sigmas, perturb the shape, the expression and
jaw, or the pose of the conditioning FLAME parameters, generate
``--n_samples`` samples and report the FID per sigma (the reference's
compute_fid_for_models_like_style_gan.py): how tightly the generator
follows its 3D conditioning.  Generated batches stay on the device from
the sampler into Inception; only pool3 activations come back.  Without
``--data`` the reference set is the uncorrupted (sigma 0) generations.

  python -m gif_tpu_torch.scripts.compute_fid_for_models --ckpt runs/0/checkpoint \
      --data dataset.npz --inception_weights fid_inception.npz
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from gif_tpu_torch.scripts.generate_random_samples import add_common_args, load_params, setup


def corrupt_flame(flame: np.ndarray, sigma: float, mode: str, rng) -> np.ndarray:
    """Additive Gaussian corruption of one parameter group (shape,
    exp_jaw or pose); sigma 0 draws nothing."""
    out = flame.copy()
    if sigma == 0:
        return out
    if mode == "shape":
        out[:, 0:100] += rng.standard_normal((len(out), 100)) * sigma
    elif mode == "exp_jaw":
        out[:, 100:150] += rng.standard_normal((len(out), 50)) * sigma
        out[:, 153:156] += rng.standard_normal((len(out), 3)) * sigma * 0.1
    elif mode == "pose":
        out[:, 150:153] += rng.standard_normal((len(out), 3)) * sigma * 0.1
    else:
        raise ValueError(mode)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_common_args(p)
    p.add_argument("--data", type=str, default=None)
    p.add_argument("--inception_weights", type=str, required=False,
                   help="npz of converted InceptionV3 FID weights (gif_tpu_torch.tools.convert_inception)")
    p.add_argument("--n_samples", type=int, default=10_000)
    p.add_argument("--mode", choices=["shape", "exp_jaw", "pose"], default="shape")
    p.add_argument("--sigmas", type=float, nargs="+", default=[0.0, 0.1, 0.2, 0.4, 0.8, 1.0, 1.5, 2.0, 3.0, 5.0])
    p.add_argument("--out", type=str, default="fid_vs_corruption.json")
    args = p.parse_args(argv)

    from gif_tpu_torch.eval.fid import FidComputer, activation_statistics, frechet_distance
    from gif_tpu_torch.eval.sampling import FlameSampler, random_flame_params

    device, cfg, res = setup(args)
    if args.inception_weights and os.path.exists(args.inception_weights):
        from gif_tpu_torch.tools.convert_params import load_inception_npz

        inc_params = load_inception_npz(args.inception_weights)
    else:
        print("WARNING: random Inception weights — FID values are relative only")
        from gif_tpu_torch.eval.inception import random_fid_params

        inc_params = random_fid_params()
    fid_computer = FidComputer(inc_params, device=device)

    dataset_params = None
    real_images = None
    if args.data and os.path.exists(args.data):
        d = np.load(args.data, mmap_mode="r")
        dataset_params = np.asarray(d["flame_params"])
        # Stays uint8 (a mem-mapped slice): FidComputer.activations scales
        # per chunk on the device.
        real_images = d["images"][: args.n_samples]

    rng = np.random.default_rng(0)
    base = random_flame_params(rng, args.n_samples, dataset_params)
    indices = rng.integers(0, args.vocab, args.n_samples).astype(np.int32)

    sampler = FlameSampler(cfg, res, load_params(args, cfg), device=device)

    def generated_statistics(flame):
        # Streamed: each batch goes from the sampler into Inception on the
        # device; host memory holds (batch, 2048) activations only.
        acts = [fid_computer.activations_device(img)[:n_valid]
                for img, n_valid in sampler.sample_batches_device(flame, indices)]
        return activation_statistics(np.concatenate(acts, axis=0))

    if real_images is not None:
        mu_sigma_real = fid_computer.statistics(real_images)
    else:
        print("WARNING: no real images; using sigma=0 generations as the reference distribution")
        mu_sigma_real = generated_statistics(corrupt_flame(base, 0.0, args.mode, rng))

    results = {}
    for sigma in args.sigmas:
        flame = corrupt_flame(base, sigma, args.mode, rng)
        mu_g, s_g = generated_statistics(flame)
        fid = frechet_distance(*mu_sigma_real, mu_g, s_g)
        results[str(sigma)] = fid
        print(f"sigma {sigma}: FID {fid:.3f}")

    with open(args.out, "w") as f:
        json.dump({"mode": args.mode, "fid": results}, f, indent=2)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()

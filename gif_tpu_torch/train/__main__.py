"""Train GIF with the PyTorch port: ``python -m gif_tpu_torch.train``.

The flags and defaults of the JAX package's ``train.py``, on one device:

    python -m gif_tpu_torch.train --run_id 0 --data /path/to/dataset.npz
    python -m gif_tpu_torch.train --debug --device cpu --total_iters 3 \\
        --inception_weights random --fid_every 2

With no ``--data`` a synthetic dataset is used (smoke runs, throughput
work).  FID needs InceptionV3 weights (``--inception_weights``: an npz of
converted weights, or ``random`` for a relative FID); without them training
runs and logs NaN FID.  ``--device`` defaults to ``cuda``.  Not here yet:
multi-process training, ``--converted_ckpt`` and the architecture graph
dumps.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GIF training (PyTorch port)")
    p.add_argument("--run_id", type=int, default=0, help="preset id: 0/3/7/8/29")
    p.add_argument("--data", type=str, default=None, help="packed dataset .npz")
    p.add_argument("--flame_resources", type=str, default=None)
    p.add_argument("--out_dir", type=str, default="runs")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--total_iters", type=int, default=3_000_000)
    p.add_argument("--inception_weights", type=str, default=None,
                   help="npz of converted InceptionV3 FID weights, or 'random' for a random-init "
                        "net (relative FID; exercises the eval path without licensed weights)")
    p.add_argument("--fid_every", type=int, default=None, help="override the preset FID cadence")
    p.add_argument("--checkpoint_every", type=int, default=None,
                   help="override the preset checkpoint cadence")
    p.add_argument("--debug", action="store_true", help="tiny synthetic setup for smoke testing")
    p.add_argument("--seed", type=int, default=None,
                   help="RNG / data-stream seed (default: run_id)")
    p.add_argument("--fid_n_samples", type=int, default=10_000)
    p.add_argument("--fid_real_samples", type=int, default=50_000)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--synthetic_images", choices=("noise", "renders"), default="noise",
                   help="no-data image source: 'noise' (uniform frames; throughput work) or "
                        "'renders' (FLAME renders over procedural backgrounds: a learnable target)")
    p.add_argument("--synthetic_n", type=int, default=256, help="synthetic dataset size")
    p.add_argument("--r1_weight", type=float, default=None, help="override the preset R1 gamma")
    p.add_argument("--r1_interval", type=int, default=None,
                   help="override the preset lazy-R1 cadence (reference: every 16)")
    p.add_argument("--d_input_noise", type=float, default=None,
                   help="instance-noise std on all D inputs; 0/off = the reference recipe")
    p.add_argument("--device", type=str, default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    # Check the weights path before any work: a typo must not train for
    # days logging NaN FID.
    if args.inception_weights not in (None, "random") and not os.path.exists(args.inception_weights):
        raise SystemExit(f"--inception_weights {args.inception_weights} does not exist")

    from gif_tpu_torch.data.pipeline import (
        SyntheticFlameDataset,
        SyntheticRenderDataset,
        load_packed_dataset,
    )
    from gif_tpu_torch.device import resolve_device
    from gif_tpu_torch.flame.resources import load_flame_resources, synthetic_flame_resources
    from gif_tpu_torch.train.config import get_config
    from gif_tpu_torch.train.loop import train

    device = resolve_device(args.device)
    if args.debug:
        cfg = get_config(
            args.run_id,
            embedding_vocab_size=64,
            max_size=32,
            init_size=32,
            render_image_size=32,
            batch_size=min(args.batch_size, 8),
            max_channels=32,
            nmlp_for_z_to_w=2,
            compute_dtype="float32",
        )
        res = synthetic_flame_resources(seed=1, n_vertices=503)
        if args.synthetic_images == "renders":
            dataset = SyntheticRenderDataset(res, n=64, size=32, device=device)
        else:
            dataset = SyntheticFlameDataset(n=64, size=32)
    else:
        res = load_flame_resources(args.flame_resources)
        if args.data:
            dataset = load_packed_dataset(args.data)
        elif args.synthetic_images == "renders":
            print("WARNING: no --data given; training on synthetic renders")
            dataset = SyntheticRenderDataset(res, n=args.synthetic_n, size=256, device=device)
        else:
            print("WARNING: no --data given; training on synthetic images")
            dataset = SyntheticFlameDataset(n=args.synthetic_n, size=256)
        cfg = get_config(args.run_id, batch_size=args.batch_size, embedding_vocab_size=len(dataset))

    cfg = dataclasses.replace(
        cfg,
        fid_every=args.fid_every or cfg.fid_every,
        checkpoint_every=args.checkpoint_every or cfg.checkpoint_every,
        r1_weight=cfg.r1_weight if args.r1_weight is None else args.r1_weight,
        r1_interval=cfg.r1_interval if args.r1_interval is None else args.r1_interval,
        d_input_noise_std=cfg.d_input_noise_std if args.d_input_noise is None else args.d_input_noise,
    )

    fid_computer = None
    if args.inception_weights:
        from gif_tpu_torch.eval.fid import FidComputer

        if args.inception_weights == "random":
            from gif_tpu_torch.eval.inception import random_fid_params

            params = random_fid_params()
        else:
            from gif_tpu_torch.tools.convert_params import load_inception_npz

            params = load_inception_npz(args.inception_weights)
        fid_computer = FidComputer(params, stats_dir=os.path.join(args.out_dir, "fid_stats"), device=device)

    train(
        cfg,
        dataset,
        res,
        args.out_dir,
        total_iters=args.total_iters,
        fid_computer=fid_computer,
        seed=args.seed,
        fid_n_samples=args.fid_n_samples,
        fid_real_samples=args.fid_real_samples,
        log_every=args.log_every,
        device=device,
    )


if __name__ == "__main__":
    main()

"""Train GIF with the PyTorch port: ``python -m gif_tpu_torch.train``
(this module; ``__main__`` calls :func:`main`).

The flags and defaults of the JAX package's ``train.py``:

    python -m gif_tpu_torch.train --run_id 0 --data /path/to/dataset.npz
    python -m gif_tpu_torch.train --debug --device cpu --total_iters 3 \\
        --inception_weights random --fid_every 2
    torchrun --nproc_per_node 8 -m gif_tpu_torch.train --multihost --run_id 0

With no ``--data`` a synthetic dataset is used (smoke runs, throughput
work).  FID needs InceptionV3 weights (``--inception_weights``: an npz of
converted weights, or ``random`` for a relative FID); without them training
runs and logs NaN FID.  ``--device`` defaults to ``cuda``.

Data parallelism, one process per GPU (``gif_tpu_torch.parallel``): with
several visible cards and no ``--no_mesh`` the CLI spawns
``choose_data_mesh_size`` ranks itself, joined by a rendezvous on
localhost; under torchrun ``--multihost`` joins from its environment;
``--coordinator host:port --num_processes N --process_id i`` joins
explicitly.  ``--backend`` is ``nccl`` unless the caller asks for ``gloo``
(CPU ranks, or ranks sharing a card).  ``--converted_ckpt`` warm-starts
from converted reference weights (``tools/convert_checkpoint``).
``--deterministic`` makes the steps bit-exact on the card, so a resume
replays the uninterrupted run (off by default: it costs step time; it
needs ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before the process starts).  Rank 0
writes ``generator_run{id}.txt`` / ``discriminator_run{id}.txt`` (and
their ``.html`` twins), the architecture reports, into ``--out_dir``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GIF training (PyTorch port)")
    p.add_argument("--run_id", type=int, default=0, help="preset id: 0/3/7/8/29")
    p.add_argument("--preset", type=str, default=None,
                   help="another architecture's preset in place of --run_id: stylegan3-t-ffhq1024 "
                        "(unconditional, trained on the dataset's images alone)")
    p.add_argument("--data", type=str, default=None, help="packed dataset .npz")
    p.add_argument("--flame_resources", type=str, default=None)
    p.add_argument("--out_dir", type=str, default="runs")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--total_iters", type=int, default=3_000_000)
    p.add_argument("--inception_weights", type=str, default=None,
                   help="npz of InceptionV3 FID weights (gif_tpu_torch.tools.convert_inception "
                        "--torch_weights pt_inception.pth), or 'random' for a random-init "
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
    p.add_argument("--converted_ckpt", type=str, default=None,
                   help="converted reference .model pickle (tools/convert_checkpoint) to warm-start "
                        "from; the reference's fine-tune path (run_id 29)")
    p.add_argument("--no_mesh", action="store_true", help="one process on one device")
    p.add_argument("--multihost", action="store_true",
                   help="join a process group from torchrun's environment")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of rank 0's rendezvous for explicit multi-process runs")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                   help="torch.distributed backend (nccl: one card per rank)")
    p.add_argument("--deterministic", action="store_true",
                   help="bit-exact replay on the card (a resumed run repeats the uninterrupted one); "
                        "needs CUBLAS_WORKSPACE_CONFIG=:4096:8 (or :16:8) in the environment")
    return p.parse_args(argv)


def _preset(args):
    """The run's config before the dataset is known: (run_id preset with
    the CLI's batch, debug overrides)."""
    from gif_tpu_torch.train.config import SG3_TINY_OVERRIDES, get_config

    if args.preset:
        if args.debug:
            return get_config(args.preset, batch_size=min(args.batch_size, 8), **SG3_TINY_OVERRIDES)
        return get_config(args.preset, batch_size=args.batch_size)
    if args.debug:
        return get_config(
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
    return get_config(args.run_id, batch_size=args.batch_size)


def write_graph_dumps(cfg, out_dir: str) -> None:
    """The architecture reports of G and D (``utils/graph.draw``) on the
    meta device: shapes and parameter counts, no arithmetic."""
    import torch

    from gif_tpu_torch.train.state import build_models
    from gif_tpu_torch.utils.graph import draw

    gen, disc = (m.to("meta") for m in build_models(cfg))
    s = cfg.max_size
    cond = torch.zeros((1, s, s, cfg.cond_channels), device="meta")
    draw(gen, os.path.join(out_dir, f"generator_run{cfg.run_id}.txt"), cond,
         input_indices=torch.zeros((1,), dtype=torch.long, device="meta"), step=cfg.max_step)
    draw(disc, os.path.join(out_dir, f"discriminator_run{cfg.run_id}.txt"),
         torch.zeros((1, s, s, 3), device="meta"), cond)


def run(args, group=None):
    """Build the run from ``args`` and train; with a process ``group``
    this rank's share of it."""
    from gif_tpu_torch.data.pipeline import (
        SyntheticFlameDataset,
        SyntheticRenderDataset,
        load_packed_dataset,
    )
    from gif_tpu_torch.device import resolve_device
    from gif_tpu_torch.flame.resources import load_flame_resources, synthetic_flame_resources
    from gif_tpu_torch.parallel.mesh import is_main_process, local_device
    from gif_tpu_torch.train.loop import train

    if group is not None:
        device = local_device(None if args.device == "cuda" else args.device)
    else:
        device = resolve_device(args.device)
    main_rank = is_main_process(group)
    cfg = _preset(args)
    if cfg.architecture != "gif":
        # Unconditional: images alone, no FLAME.
        res = None
        if args.data:
            dataset = load_packed_dataset(args.data)
        else:
            dataset = SyntheticFlameDataset(n=64 if args.debug else args.synthetic_n, size=cfg.max_size)
    elif args.debug:
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
            if main_rank:
                print("WARNING: no --data given; training on synthetic renders")
            dataset = SyntheticRenderDataset(res, n=args.synthetic_n, size=256, device=device)
        else:
            if main_rank:
                print("WARNING: no --data given; training on synthetic images")
            dataset = SyntheticFlameDataset(n=args.synthetic_n, size=256)
        # One identity row per frame: the sampler draws frame indices, bad
        # frames included in the numbering (len(dataset) counts only the
        # good ones; JAX's gather clamps the indices past it, torch raises).
        cfg = dataclasses.replace(cfg, embedding_vocab_size=len(dataset.images))

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

    if main_rank and cfg.architecture == "gif":
        # Like the reference's graph drawings, a failure here costs the
        # report only, never the run.
        try:
            os.makedirs(args.out_dir, exist_ok=True)
            write_graph_dumps(cfg, args.out_dir)
        except Exception as e:
            print(f"graph dump skipped: {e!r}")

    train(
        cfg,
        dataset,
        res,
        args.out_dir,
        total_iters=args.total_iters,
        fid_computer=fid_computer,
        converted_ckpt=args.converted_ckpt,
        seed=args.seed,
        fid_n_samples=args.fid_n_samples,
        fid_real_samples=args.fid_real_samples,
        log_every=args.log_every,
        device=device,
        group=group,
        deterministic=args.deterministic,
    )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned_rank(rank: int, world: int, port: int, argv) -> None:
    """One rank of the CLI's own spawn (module level: spawn pickles it)."""
    import torch.distributed as dist

    from gif_tpu_torch.parallel.mesh import initialize_distributed

    args = parse_args(argv)
    os.environ["LOCAL_RANK"] = str(rank)
    group = initialize_distributed(f"localhost:{port}", world, rank, backend=args.backend)
    try:
        run(args, group)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    args = parse_args(argv)
    # Check the paths before any work: a typo must not train for days
    # logging NaN FID, nor silently skip the warm start.
    if args.inception_weights not in (None, "random") and not os.path.exists(args.inception_weights):
        raise SystemExit(f"--inception_weights {args.inception_weights} does not exist")
    if args.converted_ckpt and not os.path.exists(args.converted_ckpt):
        raise SystemExit(f"--converted_ckpt {args.converted_ckpt} does not exist")

    import torch
    import torch.distributed as dist

    from gif_tpu_torch.parallel.mesh import choose_data_mesh_size, initialize_distributed

    if args.multihost or args.coordinator:
        group = initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                       backend=args.backend)
        try:
            run(args, group)
        finally:
            dist.destroy_process_group()
        return
    n_dev = torch.cuda.device_count() if args.device == "cuda" else 0
    if not args.no_mesh and n_dev > 1:
        cfg = _preset(args)
        # The interpolation loss pairs interpolants within a rank's rows:
        # keep >= 3 a rank.
        min_per_shard = 3 if cfg.apply_texture_space_interpolation_loss else 1
        use = choose_data_mesh_size(cfg.batch_size, n_dev, 1, min_per_shard)
        if use > 1:
            print(f"data-parallel training over {use} ranks ({args.backend})")
            argv = sys.argv[1:] if argv is None else argv
            torch.multiprocessing.spawn(_spawned_rank, args=(use, _free_port(), argv), nprocs=use)
            return
    run(args)

"""Rank bodies of the port's data-parallel tests (tests/test_torch_parallel.py
and the card test in tests/test_torch_kernels.py).

:func:`run_ranks` spawns ``world`` fresh processes joined into one
``torch.distributed`` group over a localhost rendezvous; each runs one of
the module-level rank functions below (spawn pickles them by name) and
writes what it saw to a file the test reads.  Imports torch and the port
only, never JAX: a rank is a process of the port alone.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

RES_SEED, RES_VERTICES = 1, 503


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(fn, world: int, *args, backend: str = "gloo", threads: int = 2) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes of one
    process group; raises when a rank raises."""
    torch.multiprocessing.start_processes(
        _entry, args=(fn, world, free_port(), backend, threads, args), nprocs=world, join=True,
        start_method="spawn",
    )


def _entry(rank, fn, world, port, backend, threads, args):
    from gif_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(threads)
    initialize_distributed(f"localhost:{port}", world, rank, backend=backend)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def _res():
    from gif_tpu_torch.flame.resources import synthetic_flame_resources

    return synthetic_flame_resources(seed=RES_SEED, n_vertices=RES_VERTICES)


def _metrics(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


def step_cases(rank: int, world: int, payload_path: str, out_fmt: str) -> None:
    """One data-parallel train step per case of the payload (run id,
    config overrides, ``fuse_interp``, the converted start state, each
    rank's batch slice and draws), on the CPU: writes {case: (state_dict,
    metrics)} to ``out_fmt.format(rank)``."""
    from gif_tpu_torch.train.config import get_config
    from gif_tpu_torch.train.state import create_train_state, load_train_state
    from gif_tpu_torch.train.step import make_train_step

    res = _res()
    payload = torch.load(payload_path, weights_only=False)
    out = {}
    for case, c in payload.items():
        cfg = get_config(c["run_id"], **c["overrides"])
        state = load_train_state(create_train_state(cfg, device="cpu"), c["state"])
        step = make_train_step(cfg, res, device="cpu", max_tris_per_tile=res.n_faces, fuse_interp=c["fuse"],
                               group=dist.group.WORLD)
        batch = {k: torch.from_numpy(np.asarray(v)) for k, v in c["batches"][rank].items()}
        state, m = step(state, batch, c["draws"][rank])
        out[case] = (state.state_dict(), _metrics(m))
    torch.save(out, out_fmt.format(rank))


class _Calls:
    """Counts the calls of a class's method (wrapped in place)."""

    def __init__(self, owner, name):
        self.owner, self.name, self.n = owner, name, 0
        self.orig = getattr(owner, name)
        calls = self

        def counted(*a, **kw):
            calls.n += 1
            return calls.orig(*a, **kw)

        setattr(owner, name, counted)


def train_runs(rank: int, world: int, out_dir: str, overrides: dict, steps: int) -> None:
    """``train()`` on every rank, CPU, run_id 8 with ``overrides``: run
    ``a`` to ``steps`` with FID on the config's cadence (the random
    InceptionV3 on 8 samples; the Fréchet distance replaced by its
    square-root-free part), then run ``b`` to ``steps // 2`` and resumed
    to ``steps`` without FID.  Writes the final state_dicts, ``used_samples`` and how
    often this rank logged a row and saved a grid to
    ``out_dir/rank{rank}.pt``."""
    from gif_tpu_torch.data.pipeline import FlameDataset, sample_flame_params
    from gif_tpu_torch.eval import fid as tfid
    from gif_tpu_torch.eval.inception import random_fid_params
    from gif_tpu_torch.train import loop
    from gif_tpu_torch.train.config import get_config
    from gif_tpu_torch.utils.viz import VisualizationSaver

    def distance(mu1, sigma1, mu2, sigma2):
        d = mu1 - mu2
        return float(d.dot(d) + np.trace(sigma1) + np.trace(sigma2))

    tfid.frechet_distance = distance
    logged = _Calls(loop.MetricsLogger, "log")
    grids = _Calls(VisualizationSaver, "save_samples")
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8)
    flame = sample_flame_params(rng, 16)
    res = _res()
    group = dist.group.WORLD

    def ds():
        return FlameDataset(images, flame, horizontal_flip=True)

    cfg = get_config(8, **overrides)
    fc = tfid.FidComputer(random_fid_params(0), stats_dir=os.path.join(out_dir, "fid_stats"), batch_size=8,
                          device="cpu")
    kw = dict(log_every=1, device="cpu", group=group, fid_n_samples=8, fid_real_samples=8)
    a = loop.train(cfg, ds(), res, os.path.join(out_dir, "a"), total_iters=steps, fid_computer=fc, **kw)
    cfg_b = dataclasses.replace(cfg, fid_every=10_000)
    loop.train(cfg_b, ds(), res, os.path.join(out_dir, "b"), total_iters=steps // 2, **kw)
    b = loop.train(cfg_b, ds(), res, os.path.join(out_dir, "b"), total_iters=steps, **kw)
    torch.save({
        "a": a.state_dict(), "b": b.state_dict(), "used": (a.used_samples, b.used_samples),
        "logged": logged.n, "grids": grids.n,
    }, os.path.join(out_dir, f"rank{rank}.pt"))


def allgather(rank: int, world: int, counts, max_rows, out_fmt: str) -> None:
    """``allgather_rows`` of rank-tagged rows (``counts[rank]`` rows of
    ``100 * (rank + 1) + row``, float and int arrays aligned) to
    ``out_fmt.format(rank)``."""
    from gif_tpu_torch.parallel import allgather_rows

    rows = 100 * (rank + 1) + np.arange(counts[rank])
    pooled = allgather_rows((rows.astype(np.float32)[:, None].repeat(3, 1), rows.astype(np.int32)),
                            max_rows=max_rows)
    torch.save(pooled, out_fmt.format(rank))


def digest(*modules) -> str:
    """sha1 of every parameter's bytes, in order."""
    h = hashlib.sha1()
    for m in modules:
        for p in m.parameters():
            h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def cuda_steps(rank: int, world: int, out_fmt: str) -> None:
    """Two tiny run_id-8 steps (render in the step, R1 on the second) on
    the card, each rank on its own half of a seeded batch: writes the
    digest of G, D and EMA after each step and the kernel launches."""
    from gif_tpu_torch.ops import activations, blur_cuda
    from gif_tpu_torch.parallel import shard_batch
    from gif_tpu_torch.render import raster_cuda, sampler_cuda
    from gif_tpu_torch.train.config import TINY_OVERRIDES, get_config
    from gif_tpu_torch.train.state import create_train_state, replicate_train_state
    from gif_tpu_torch.train.step import make_train_step

    res = _res()
    cfg = get_config(8, **{**TINY_OVERRIDES, "embedding_vocab_size": 16, "batch_size": 8, "r1_interval": 2,
                           "apply_texture_space_interpolation_loss": False})
    state = replicate_train_state(create_train_state(cfg, seed=rank, device="cuda"), dist.group.WORLD)
    step = make_train_step(cfg, res, max_tris_per_tile=res.n_faces, group=dist.group.WORLD,
                           generator=torch.Generator().manual_seed(rank))
    rng = np.random.default_rng(0)
    flame = np.zeros((8, 236), np.float32)
    flame[:, :100] = rng.standard_normal((8, 100)) * 0.1
    flame[:, 156] = 8.0
    flame[:, 209:212] = 3.0
    batch = {"real_image": rng.uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32), "flame": flame,
             "indices": rng.integers(0, 16, 8).astype(np.int64)}
    counters = (raster_cuda.rasterize_with_attrs, sampler_cuda.grid_sample, activations.fused_leaky_relu,
                activations.fused_leaky_relu_backward, blur_cuda.blur4, blur_cuda.blur4_vjp)
    for fn in counters:
        fn.launches = 0
    digests = []
    for _ in range(2):
        state, m = step(state, shard_batch(batch, "cuda"))
        digests.append(digest(state.generator, state.discriminator, state.g_ema))
    torch.save({"digests": digests, "launches": [fn.launches for fn in counters], "r1": float(m["r1"]),
                "used": state.used_samples}, out_fmt.format(rank))

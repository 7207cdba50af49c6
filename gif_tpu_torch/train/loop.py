"""The training loop: data -> step -> metrics / FID / checkpoints (port of
:mod:`gif_tpu.train.loop`).

As the reference loop runs it: FID on the accumulated FLAME fits every
``fid_every`` steps (and an untrained baseline at step 0), a 10x5 sample
grid with the FID in its filename, checkpoints every ``checkpoint_every``
steps and a final one, and one ``metrics.csv`` row every ``log_every``
steps.  A run resumes from its latest checkpoint and replays exactly the
batches and random draws an uninterrupted run would have seen: batches
are counter-based (``data_iterator(start_step=...)``) and the step's
generator is reseeded from (``seed``, step, rank) before every step.

Data parallel (a process ``group``, one rank per GPU): every rank runs
this loop in lockstep on ``batch_size / world`` rows a step from its own
data stream, seeded (``seed``, rank), with its own draws; the step
all-reduces the gradients.  Rank 0 alone logs, prints, draws the sample
grids and measures FID, on every rank's accumulated fits pooled by
:func:`allgather_rows`; it writes the checkpoints, which every rank
restores.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Optional

import numpy as np
import torch

from gif_tpu_torch.data.pipeline import FlameDataset, data_iterator
from gif_tpu_torch.device import resolve_device, set_deterministic
from gif_tpu_torch.eval.sampling import FlameSampler
from gif_tpu_torch.parallel.collectives import allgather_rows
from gif_tpu_torch.parallel.mesh import process_count, process_index
from gif_tpu_torch.train.checkpoint import CheckpointManager
from gif_tpu_torch.train.config import TrainConfig
from gif_tpu_torch.train.state import create_train_state, replicate_train_state, warm_start_from_converted
from gif_tpu_torch.train.step import make_train_step
from gif_tpu_torch.utils.viz import VisualizationSaver

# Samples of the EMA reconstruction metric on conditionally exact datasets.
RECON_SAMPLES = 64


class MetricsLogger:
    """A CSV file of metric rows.  An existing file's header is read on
    resume; a row that brings a column the header lacks rewrites the file
    under the union of the columns (earlier rows leave the new cells
    empty), so every row parses under ``csv.DictReader``."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self.fields: list = []
        if os.path.exists(path):
            with open(path, newline="") as f:
                self.fields = next(csv.reader(f), [])

    def log(self, step: int, metrics: dict) -> None:
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        new = [k for k in row if k not in self.fields]
        if new:
            rows = []
            if os.path.exists(self.path):
                with open(self.path, newline="") as f:
                    rows = list(csv.DictReader(f))
            self.fields = self.fields + new
            tmp = f"{self.path}.tmp"
            with open(tmp, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self.fields, restval="")
                w.writeheader()
                w.writerows(rows)
            os.replace(tmp, self.path)
        with open(self.path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self.fields, restval="").writerow(row)


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    """The seed of rank ``rank``'s random draws at step ``step``: a hash
    of (1234 + seed, step, rank), 32 bits (a CPU ``torch.Generator`` keeps
    only 32)."""
    return int(np.random.SeedSequence([1234 + seed, step, rank]).generate_state(1)[0])


def train(
    cfg: TrainConfig,
    dataset: FlameDataset,
    res,
    out_dir: str,
    total_iters: int = 3_000_000,
    fid_computer=None,
    resume: bool = True,
    log_every: int = 50,
    fid_n_samples: int = 10_000,
    fid_real_samples: int = 50_000,
    converted_ckpt: Optional[str] = None,
    seed: Optional[int] = None,
    device=None,
    max_tris_per_tile: Optional[int] = None,
    group=None,
    deterministic: bool = False,
):
    """Run training to ``total_iters`` steps; returns the train state.

    A StyleGAN3 config (:class:`~gif_tpu_torch.train.config.StyleGAN3Config`)
    trains its unconditional step on the dataset's images alone (``res``
    unused); it has no sampler, so no FID.

    ``out_dir/{run_id}`` gets ``checkpoint/``, ``sample/{run_id}/`` and
    ``metrics.csv``.  ``seed`` (default ``run_id``, 0 for a named preset)
    seeds the networks, the data stream and the step's draws.  ``fid_computer`` (a
    :class:`gif_tpu_torch.eval.fid.FidComputer`, or None for no FID)
    measures the EMA generator on up to ``fid_n_samples`` accumulated fits
    against the first ``fid_real_samples`` real frames.
    ``max_tris_per_tile`` is the raster's tile capacity in the step and the
    sampler (None: sized from the mesh).  ``device`` is CUDA unless the
    caller passes another.  ``converted_ckpt`` (a pickle of converted
    reference weights, :mod:`gif_tpu_torch.tools.convert_checkpoint`)
    warm-starts a run that has no checkpoint of its own yet.

    With a process ``group`` every rank calls this with the same arguments
    (``fid_computer`` given on every rank or on none; ``device`` its own);
    ``cfg.batch_size`` is the global batch.

    ``deterministic`` turns :func:`gif_tpu_torch.device.set_deterministic`
    on for the steps (and off again after them), so that a run and its
    resume from a checkpoint give the same losses bit for bit on the card,
    as the reference's do on the TPU.  Off by default: it costs step
    time."""
    if cfg.apply_texture_space_interpolation_loss and (
        getattr(dataset, "horizontal_flip", False) or getattr(dataset, "random_crop", False)
    ):
        raise ValueError(
            "flip/crop augmentation invalidates the FLAME labels that the texture-interpolation "
            "loss consumes; disable the augmentation or the loss"
        )
    gif = cfg.architecture == "gif"
    if not gif and fid_computer is not None:
        raise ValueError(f"no FID for {cfg.architecture}: its training has no sampler")
    world, rank = (process_count(group), process_index(group)) if group is not None else (1, 0)
    if cfg.batch_size % world:
        raise ValueError(f"global batch {cfg.batch_size} not divisible by {world} processes")
    local_bs = cfg.batch_size // world
    is_main = rank == 0
    dev = resolve_device(device)
    run_dir = os.path.join(out_dir, str(cfg.run_id))
    ckpt = CheckpointManager(os.path.join(run_dir, "checkpoint"), save_every=cfg.checkpoint_every, group=group)
    logger = MetricsLogger(os.path.join(run_dir, "metrics.csv")) if is_main else None
    viz = VisualizationSaver(run_dir, cfg.run_id) if is_main else None

    if seed is None:
        seed = cfg.run_id if isinstance(cfg.run_id, int) else 0
    state = create_train_state(cfg, seed=seed, device=dev)
    if converted_ckpt is not None and ckpt.latest_step() is None:
        # The reference's fine-tune path; a checkpoint of the run itself
        # takes precedence.
        state = warm_start_from_converted(state, converted_ckpt)
        if is_main:
            print(f"warm-started params from {converted_ckpt}")
    if resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        if is_main:
            print(f"restored checkpoint at step {state.step}")
    if group is not None:
        state = replicate_train_state(state, group)
    step_rng = torch.Generator()
    step_fn = make_train_step(cfg, res, device=dev, max_tris_per_tile=max_tris_per_tile, generator=step_rng,
                              group=group)
    sampler = FlameSampler(
        cfg, res, state.g_ema, batch_size=min(cfg.batch_size, 16), eye_center=False,
        max_tris_per_tile=max_tris_per_tile, device=dev,
    ) if is_main and gif else None

    start = state.step
    fid = float("nan")
    recon = float("nan")
    t_last = time.perf_counter()

    def run_eval(i):
        """FID and the reconstruction error of the EMA generator and the
        sample grid, on rank 0 over every rank's accumulated fits; ``i`` is
        the loop index (artifacts are stamped ``i + 1``; ``-1`` is the
        untrained baseline)."""
        nonlocal fid, recon, t_last
        flame_10k, idx_10k = dataset.get_10k_flame_params()
        if world > 1:
            flame_10k, idx_10k = allgather_rows((flame_10k, idx_10k), max_rows=fid_n_samples, group=group)
        flame_10k = flame_10k[:fid_n_samples]
        idx_10k = idx_10k[: len(flame_10k)]
        if is_main:
            # Streamed: each generated batch stays on the device and only
            # its pool3 activations come back; the uint8 real frames are
            # scaled per chunk inside the Inception sweep.  The other ranks
            # wait in the next step's all-reduce.
            fid = fid_computer.get_fid_streaming(
                sampler.sample_batches_device(flame_10k, idx_10k),
                real_images01=dataset.images[:fid_real_samples],
            )
            if getattr(dataset, "conditionally_exact", False):
                # Every frame is a function of its own conditioning row, so
                # the EMA generator's pixel error against it measures
                # progress.
                k = min(RECON_SAMPLES, len(dataset))
                gt = (dataset.images[:k].astype(np.float32) / 255.0) * 2.0 - 1.0
                out = sampler.sample(
                    np.asarray(dataset.flame_params[:k], np.float32), np.arange(k, dtype=np.int32)
                )[0]
                recon = float(np.mean((out - gt) ** 2))
            if viz.flame_params is None:
                viz.set_flame_params(flame_10k[:50], idx_10k[:50])
            viz.save_samples(i, lambda f, ix: sampler.sample(f, ix)[0], resolution=cfg.max_size, fid=fid)
        # The sweep is not charged to the next window's images/s.
        t_last = time.perf_counter()

    if fid_computer is not None and start == 0:
        # The untrained baseline.  The accumulator is empty before the first
        # batch: seed it with the dataset's own true fits.
        dataset.accumulate_batches_of_flm(np.asarray(dataset.flame_params[:fid_n_samples], np.float32))
        run_eval(-1)

    it = data_iterator(dataset, local_bs, seed=(seed, rank), start_step=start)
    if deterministic:
        set_deterministic(True)
    try:
        for i in range(start, total_iters):
            batch = next(it)
            # The true fits condition FID: augmented labels are crop-zeroed
            # or flip-sentinelled.
            dataset.accumulate_batches_of_flm(batch.get("flame_render", batch["flame"]))
            step_rng.manual_seed(step_seed(seed, i, rank))
            state, metrics = step_fn(state, batch)

            if (i + 1) % log_every == 0 and is_main:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                m["imgs_per_sec"] = cfg.batch_size * log_every / dt
                m["fid"] = fid
                m["ema_recon"] = recon
                logger.log(i + 1, m)
                print(f"[{i + 1}] G {m['g_loss']:.3f} D {m['d_loss']:.3f} fid {fid:.1f} "
                      f"{m['imgs_per_sec']:.1f} img/s", flush=True)

            if (i + 1) % cfg.fid_every == 0 and fid_computer is not None:
                run_eval(i)

            # The Python counter keys the cadence.
            if ckpt.maybe_save(state, step=i + 1):
                t_last = time.perf_counter()
    finally:
        it.close()
        if deterministic:
            set_deterministic(False)
    ckpt.save(state)
    return state

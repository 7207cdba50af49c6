"""Batched sampling from FLAME parameters with the (EMA) generator.

Port of :mod:`gif_tpu.eval.sampling`: eye-centre the camera, render the
conditioning maps on the device, then run the generator — one fixed-size
batch at a time, partial batches padded by repeating the last row.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gif_tpu_torch.device import resolve_device, set_tf32_policy
from gif_tpu_torch.flame.camera import position_to_given_location
from gif_tpu_torch.models.generator import StyledGenerator
from gif_tpu_torch.train.config import TrainConfig
from gif_tpu_torch.train.step import render_condition_maps


def load_generator_params(
    cfg,
    ckpt: str | None = None,
    converted_ckpt: str | None = None,
    converted_params: str | None = None,
    seed: int = 0,
) -> dict:
    """The (EMA) generator's state_dict, on the CPU, from the first source
    given:

    - ``ckpt``: a checkpoint directory of
      :class:`gif_tpu_torch.train.checkpoint.CheckpointManager` (a training
      run's ``checkpoint/``); its latest step's ``g_ema``;
    - ``converted_ckpt``: the trees pickle that the ``convert_checkpoint``
      tools write (``g_ema_params`` + ``buffers``).  Only unpickle files
      this project wrote;
    - ``converted_params``: a state_dict file written by
      :mod:`gif_tpu_torch.tools.convert_params`;
    - else a fresh initialisation seeded with ``seed`` (smoke runs)."""
    if ckpt:
        from gif_tpu_torch.train.checkpoint import CheckpointManager

        return CheckpointManager.read(ckpt)["g_ema"]
    if converted_ckpt:
        import pickle

        from gif_tpu_torch.tools.convert_params import convert_generator_params

        with open(converted_ckpt, "rb") as f:
            trees = pickle.load(f)
        return convert_generator_params(trees["g_ema_params"], trees["buffers"])
    if converted_params:
        return torch.load(converted_params, map_location="cpu", weights_only=True)
    return StyledGenerator.from_config(cfg, seed=seed).state_dict()


class FlameSampler:
    """generator(flame_params_236, indices) -> images, batched.

    ``g_state`` is a generator state_dict, loaded into a fresh
    ``StyledGenerator`` built with ``w_truncation_factor``, or a
    ``StyledGenerator`` on ``device`` to sample with as it is (the train
    loop's EMA generator; it keeps its own truncation factor)."""

    def __init__(
        self,
        cfg: TrainConfig,
        res,
        g_state: dict | StyledGenerator,
        batch_size: int = 16,
        eye_center: bool = True,
        max_tris_per_tile: int | None = None,
        w_truncation_factor: float = 1.0,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_tf32_policy()
        self.cfg = cfg
        self.res = res
        self.batch_size = batch_size
        self.eye_center = eye_center
        self.max_tris_per_tile = max_tris_per_tile
        # Samples whose render dropped candidate triangles (tile overflow).
        self.render_overflows = 0
        if isinstance(g_state, StyledGenerator):
            self.generator = g_state
        else:
            gen = StyledGenerator.from_config(cfg, w_truncation_factor=w_truncation_factor)
            gen.load_state_dict(g_state)
            self.generator = gen.to(self.device).eval()
        self._mean_w = None
        if abs(self.generator.w_truncation_factor - 1.0) > 0.01:
            with torch.inference_mode():
                self._mean_w = self.generator.mean_latent()

    @torch.inference_mode()
    def _run(self, flame: np.ndarray, indices: np.ndarray):
        fl = torch.as_tensor(flame, dtype=torch.float32, device=self.device)
        ix = torch.as_tensor(indices, dtype=torch.long, device=self.device)
        if self.eye_center:
            fl = position_to_given_location(self.res, fl)
        cond, overflow = render_condition_maps(
            self.res, fl, self.cfg, self.max_tris_per_tile, return_overflow=True
        )
        img = self.generator(cond, input_indices=ix, step=self.cfg.max_step, mean_w=self._mean_w)
        return img, cond, overflow

    def _padded_batches(self, flame_params: np.ndarray, indices: np.ndarray):
        """Yield (images, cond, valid rows) on the device, one full batch at
        a time; a short last batch repeats its last row."""
        n = len(flame_params)
        bs = self.batch_size
        for i in range(0, n, bs):
            fl = np.asarray(flame_params[i : i + bs], np.float32)
            ix = np.asarray(indices[i : i + bs], np.int64)
            valid = len(fl)
            pad = bs - valid
            if pad:
                fl = np.concatenate([fl, np.repeat(fl[-1:], pad, 0)])
                ix = np.concatenate([ix, np.repeat(ix[-1:], pad, 0)])
            img, cond, overflow = self._run(fl, ix)
            self.render_overflows += int(overflow[:valid].sum())
            yield img, cond, valid

    def sample_batches(self, flame_params: np.ndarray, indices: np.ndarray):
        """Yield (images [-1,1] (b,S,S,3), cond (b,S,S,C)) numpy batches."""
        for img, cond, valid in self._padded_batches(flame_params, indices):
            yield img[:valid].cpu().numpy(), cond[:valid].cpu().numpy()

    def sample_batches_device(self, flame_params: np.ndarray, indices: np.ndarray):
        """Yield ``(images, n_valid)``: the padded [-1, 1] (bs, S, S, 3)
        image batch left on the device, for a consumer that keeps computing
        there (``FidComputer.get_fid_streaming``); only its first
        ``n_valid`` rows are samples."""
        for img, _, valid in self._padded_batches(flame_params, indices):
            yield img, valid

    def sample(self, flame_params: np.ndarray, indices: np.ndarray):
        """Returns (images [-1,1] (N,S,S,3), cond maps (N,S,S,C)) as numpy."""
        imgs, conds = zip(*self.sample_batches(flame_params, indices))
        return np.concatenate(imgs), np.concatenate(conds)


def random_flame_params(
    rng: np.random.Generator,
    n: int,
    dataset_params: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Random shape/exp/pose with dataset-sourced cam/tex/light when
    available, else a fixed camera scale and ambient light."""
    flame = np.zeros((n, 236), np.float32)
    flame[:, :100] = rng.standard_normal((n, 100)) * 1.0
    flame[:, 100:150] = rng.standard_normal((n, 50)) * 0.7
    flame[:, 150:156] = rng.standard_normal((n, 6)) * 0.05
    if dataset_params is not None:
        rows = rng.integers(0, len(dataset_params), n)
        flame[:, 156:] = dataset_params[rows, 156:]
    else:
        flame[:, 156] = 8.0
        flame[:, 209:212] = 3.0
    return flame

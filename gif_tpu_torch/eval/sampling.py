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


def load_generator_params(cfg, converted_params: str | None = None, seed: int = 0) -> dict:
    """The generator state_dict: from a file written by
    :mod:`gif_tpu_torch.tools.convert_params`, else a fresh seeded
    initialisation (smoke runs)."""
    if converted_params:
        return torch.load(converted_params, map_location="cpu", weights_only=True)
    return StyledGenerator.from_config(cfg, seed=seed).state_dict()


class FlameSampler:
    """generator(flame_params_236, indices) -> images, batched."""

    def __init__(
        self,
        cfg: TrainConfig,
        res,
        g_state: dict,
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
        gen = StyledGenerator.from_config(cfg, w_truncation_factor=w_truncation_factor)
        gen.load_state_dict(g_state)
        self.generator = gen.to(self.device).eval()
        self._mean_w = None
        if abs(w_truncation_factor - 1.0) > 0.01:
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

    def sample_batches(self, flame_params: np.ndarray, indices: np.ndarray):
        """Yield (images [-1,1] (b,S,S,3), cond (b,S,S,C)) numpy batches."""
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
            yield img[:valid].cpu().numpy(), cond[:valid].cpu().numpy()

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

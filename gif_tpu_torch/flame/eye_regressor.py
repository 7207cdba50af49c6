"""MLP camera regressor: FLAME (shape3 + exp3 + pose6) -> orthographic
camera (port of :mod:`gif_tpu.flame.eye_regressor`).

Re-creates the reference ``EyeCenteringByRegression``
(my_utils/eye_centering.py:96-318): a residual MLP (input 12 -> 512 with
batchnorm/ReLU, N skip blocks of 2 layers, -> 3) trained with MSE on
input/output z-scored data against cameras produced by the exact
eye-centering solver; at inference it replaces the slower pinverse solve.
The z-scoring statistics are learned from the data.

The layers follow flax's, so converted flax variables
(:func:`gif_tpu_torch.tools.convert_params.convert_eye_regressor_variables`)
give the same function: :class:`FlaxBatchNorm` normalizes a training batch
by its mean and its *biased* variance ``E[x^2] - E[x]^2`` and updates the
running statistics with momentum 0.99 on the old value (flax's
convention; ``torch.nn.BatchNorm1d`` would keep 0.9 of the old value's
complement and the unbiased variance), and initialization is flax's
``lecun_normal`` for the dense kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from gif_tpu_torch import constants as cnst
from gif_tpu_torch.device import resolve_device
from gif_tpu_torch.flame.camera import solve_eye_camera
from gif_tpu_torch.flame.decoder import flame_decode

# Feature columns: first 3 shape, first 3 expression, full 6 pose
# (reference eye_centering.py:11-13).
FEATURE_IDX = [0, 1, 2, 100, 101, 102, 150, 151, 152, 153, 154, 155]


class FlaxBatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the batch axis of (B, C) inputs: in
    training the batch mean and biased variance (``E[x^2] - E[x]^2``,
    clipped at 0), the running statistics updated as ``momentum * old +
    (1 - momentum) * batch``; in evaluation the running statistics.
    ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias``."""

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if self.training:
            mean = x.mean(0)
            var = torch.clamp((x * x).mean(0) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def _dense(n_in: int, n_out: int, generator: torch.Generator | None) -> nn.Linear:
    """A Linear initialized like flax ``nn.Dense``: ``lecun_normal`` weights
    (a normal of variance 1 / fan_in truncated at two standard deviations)
    and zero bias."""
    lin = nn.Linear(n_in, n_out)
    std = math.sqrt(1.0 / n_in) / 0.87962566103423978  # the truncated normal's std correction
    with torch.no_grad():
        w = torch.empty(n_out, n_in)
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
        lin.weight.copy_(w)
        lin.bias.zero_()
    return lin


class SkipBlock(nn.Module):
    def __init__(self, neurons: int, layers_per_block: int = 2, generator: torch.Generator | None = None):
        super().__init__()
        self.layers_per_block = layers_per_block
        for i in range(layers_per_block):
            setattr(self, f"dense{i}", _dense(neurons, neurons, generator))
            setattr(self, f"bn{i}", FlaxBatchNorm(neurons))

    def forward(self, x):
        h = x
        for i in range(self.layers_per_block):
            h = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"dense{i}")(h)))
        return x + h


class CameraRegressor(nn.Module):
    """stem Dense(neurons) + BatchNorm + ReLU, ``num_skip_blocks`` skip
    blocks, head Dense(3).  Train / eval mode is the module's own
    (``.train()`` / ``.eval()``), flax's ``train`` argument."""

    def __init__(self, neurons: int = 512, num_skip_blocks: int = 2, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.num_skip_blocks = num_skip_blocks
        self.stem = _dense(len(FEATURE_IDX), neurons, gen)
        self.stem_bn = FlaxBatchNorm(neurons)
        for i in range(num_skip_blocks):
            setattr(self, f"skip{i}", SkipBlock(neurons, generator=gen))
        self.head = _dense(neurons, 3, gen)

    def forward(self, x):
        x = torch.relu(self.stem_bn(self.stem(x)))
        for i in range(self.num_skip_blocks):
            x = getattr(self, f"skip{i}")(x)
        return self.head(x)


@dataclasses.dataclass
class EyeCameraRegressor:
    """Train/infer wrapper with learned z-scoring (the model in eval mode)."""

    model: CameraRegressor
    mean_in: np.ndarray
    std_in: np.ndarray
    mean_out: np.ndarray
    std_out: np.ndarray
    val_mse: float = float("nan")  # held-out MSE in camera units (train_regressor)

    def _stat(self, a, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)

    @torch.no_grad()
    def predict(self, feats: torch.Tensor) -> torch.Tensor:
        """Camera from raw (B, 12) feature rows (z-scoring applied here)."""
        feats = torch.as_tensor(feats, dtype=torch.float32, device=next(self.model.parameters()).device)
        x = (feats - self._stat(self.mean_in, feats)) / self._stat(self.std_in, feats)
        out = self.model.eval()(x)
        return out * self._stat(self.std_out, out) + self._stat(self.mean_out, out)

    def get_camera(self, flame_batch: torch.Tensor) -> torch.Tensor:
        return self.predict(torch.as_tensor(flame_batch)[:, FEATURE_IDX])

    def substitute_camera(self, flame_batch: torch.Tensor) -> torch.Tensor:
        flame_batch = torch.as_tensor(flame_batch)
        cam = self.get_camera(flame_batch)
        out = flame_batch.clone()
        out[:, 156:159] = cam.to(out.dtype).to(out.device)
        return out


def generate_training_data(
    res, flame_params: np.ndarray, batch_size: int = 256,
    eye_left: Optional[int] = None, eye_right: Optional[int] = None, device=None,
):
    """(features (N, 12), cameras (N, 3)) as numpy float32: targets from the
    exact solver (the reference trains on the same pinverse-produced
    cameras), decoded on ``device`` (CUDA unless the caller passes another)
    ``batch_size`` rows at a time."""
    cfg = cnst.DEFAULT_FLAME_CONFIG
    eye_left = cfg.eye_left_vertex if eye_left is None else eye_left
    eye_right = cfg.eye_right_vertex if eye_right is None else eye_right
    if eye_left >= res.n_vertices or eye_right >= res.n_vertices:
        raise ValueError(
            f"eye vertex ids ({eye_left}, {eye_right}) out of range for a "
            f"{res.n_vertices}-vertex mesh; pass explicit ids"
        )
    dev = resolve_device(device)
    xs, ys = [], []
    with torch.no_grad():
        for i in range(0, len(flame_params), batch_size):
            fb = torch.as_tensor(np.asarray(flame_params[i : i + batch_size], np.float32), device=dev)
            cam = solve_eye_camera(flame_decode(res, fb[:, 0:100], fb[:, 100:150], fb[:, 150:156]),
                                   eye_left, eye_right)
            xs.append(fb[:, FEATURE_IDX].cpu().numpy())
            ys.append(cam.cpu().numpy())
    return np.concatenate(xs), np.concatenate(ys)


def train_regressor(
    res,
    flame_params: np.ndarray,
    epochs: int = 20,
    batch_size: int = 256,
    lr: float = 1e-4,
    seed: int = 0,
    val_frac: float = 0.1,
    verbose: bool = False,
    eye_left: Optional[int] = None,
    eye_right: Optional[int] = None,
    device=None,
    model: Optional[CameraRegressor] = None,
) -> EyeCameraRegressor:
    """Fit the regressor on solver targets (reference fit_to_data,
    eye_centering.py:186-318; Adam(1e-4, betas (0, 0.99))) on ``device``
    (CUDA unless the caller passes another).  ``model`` is the network to
    start from (default: a fresh one seeded with ``seed``); ``seed`` also
    draws the epochs' permutations."""
    dev = resolve_device(device)
    x, y = generate_training_data(res, flame_params, batch_size, eye_left, eye_right, device=dev)
    n_val = max(1, int(len(x) * val_frac))
    x_tr, y_tr = x[:-n_val], y[:-n_val]

    mean_in, std_in = x_tr.mean(0), x_tr.std(0) + 1e-6
    mean_out, std_out = y_tr.mean(0), y_tr.std(0) + 1e-6
    xn = torch.as_tensor((x_tr - mean_in) / std_in, dtype=torch.float32, device=dev)
    yn = torch.as_tensor((y_tr - mean_out) / std_out, dtype=torch.float32, device=dev)

    model = (CameraRegressor(seed=seed) if model is None else model).to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.0, 0.99), eps=1e-8)
    rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        order = torch.as_tensor(rng.permutation(len(xn)), device=dev)
        losses = []
        for i in range(0, len(xn) - batch_size + 1, batch_size):
            sel = order[i : i + batch_size]
            loss = torch.mean((model(xn[sel]) - yn[sel]) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        if verbose and losses:
            print(f"epoch {epoch}: mse {torch.stack(losses).mean().item():.5f}")

    # Held-out validation on the carved-off tail (normalized like training).
    x_val, y_val = x[-n_val:], y[-n_val:]
    reg = EyeCameraRegressor(
        model=model.eval(),
        mean_in=mean_in.astype(np.float32),
        std_in=std_in.astype(np.float32),
        mean_out=mean_out.astype(np.float32),
        std_out=std_out.astype(np.float32),
    )
    reg.val_mse = float(np.mean((reg.predict(x_val).cpu().numpy() - y_val) ** 2))
    if verbose:
        print(f"val mse (unnormalized cam units): {reg.val_mse:.6f}")
    return reg

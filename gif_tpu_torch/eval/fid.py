"""FID as the reference protocol computes it (port of
:mod:`gif_tpu.eval.fid`).

Activations are InceptionV3 pool3 (2048-d) of images scaled to [0, 1] and
resized to 299; statistics (mu, sigma) per set; the Fréchet distance takes
scipy's matrix square root on the host.  Real-image statistics are cached
per resolution as ``ffhq_{res}X{res}_fid_stats.npz``.  Inception runs in
float32 with TF32 off on the card (:func:`set_tf32_policy`), as the
reference computes it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from gif_tpu_torch.device import resolve_device, set_tf32_policy
from gif_tpu_torch.eval.inception import InceptionV3FID, preprocess_for_fid


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """d^2 = |mu1 - mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)), retrying with
    ``eps`` on the diagonals when the square root is not finite, and
    raising when its diagonal carries an imaginary part above 1e-3."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def activation_statistics(acts: np.ndarray):
    """(mu (D,), sigma (D, D)) of a (N, D) activation matrix."""
    return np.mean(acts, axis=0), np.cov(acts, rowvar=False)


class FidComputer:
    """FID with cached real-image statistics.

    Args:
      params: an ``InceptionV3FID`` state_dict (converted pretrained
        weights for real FID numbers; any weights, such as
        ``random_fid_params``, give a consistent relative metric).
      stats_dir: directory of the per-resolution real-statistics cache.
      batch_size: images per Inception call; a short chunk is padded to it.
      device: CUDA unless the caller passes another.
    """

    def __init__(self, params: dict, stats_dir: Optional[str] = None, batch_size: int = 32, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_tf32_policy()
        self.model = InceptionV3FID()
        self.model.load_state_dict(params)
        self.model = self.model.to(self.device).eval()
        self.batch_size = batch_size
        self.stats_dir = stats_dir

    @torch.inference_mode()
    def _pool3(self, images01: torch.Tensor) -> np.ndarray:
        x = preprocess_for_fid(images01).permute(0, 3, 1, 2)
        return self.model(x).float().cpu().numpy()

    def activations(self, images01: np.ndarray) -> np.ndarray:
        """Pool3 activations of (N, H, W, 3) host images, float in [0, 1]
        or uint8 in [0, 255], in chunks of ``batch_size`` (the last padded
        with zeros).  uint8 chunks (a mem-mapped real-image store) are
        uploaded as they are and scaled on the device, so the set never
        materializes in float32."""
        outs = []
        bs = self.batch_size
        for i in range(0, len(images01), bs):
            chunk = np.asarray(images01[i : i + bs])
            is_u8 = chunk.dtype == np.uint8
            if not is_u8:
                chunk = np.asarray(chunk, np.float32)
            n = len(chunk)
            if n < bs:
                chunk = np.concatenate([chunk, np.zeros((bs - n,) + chunk.shape[1:], chunk.dtype)])
            x = torch.as_tensor(chunk, device=self.device)
            x = x.float() / 255.0 if is_u8 else x
            outs.append(self._pool3(x)[:n])
        return np.concatenate(outs, axis=0)

    def activations_device(self, images_m1p1: torch.Tensor) -> np.ndarray:
        """Pool3 activations of a device-resident (B, H, W, 3) batch in
        [-1, 1]: rescaled and run on the device, only the (B, 2048) result
        is read back.  The numbers of :meth:`activations` on the host copy."""
        x = images_m1p1.to(self.device, torch.float32)
        return self._pool3(torch.clamp((x + 1.0) * 0.5, 0.0, 1.0))

    def statistics(self, images01: np.ndarray):
        return activation_statistics(self.activations(images01))

    def _real_stats_path(self, res: int) -> Optional[str]:
        if self.stats_dir is None:
            return None
        return os.path.join(self.stats_dir, f"ffhq_{res}X{res}_fid_stats.npz")

    def real_statistics(self, real_images01: Optional[np.ndarray], res: int):
        """The cached real statistics, computed and cached on a miss."""
        path = self._real_stats_path(res)
        if path and os.path.exists(path):
            with np.load(path) as data:
                return data["mu"], data["sigma"]
        if real_images01 is None:
            raise ValueError("no cached real stats and no real images given")
        mu, sigma = self.statistics(real_images01)
        if path:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp.npz"
            np.savez(tmp, mu=mu, sigma=sigma)
            os.replace(tmp, path)
        return mu, sigma

    def get_fid(self, generated_m1p1: np.ndarray, real_images01: Optional[np.ndarray] = None) -> float:
        """FID of generated images (range [-1, 1], the generator's output)
        against the cached or given real images."""
        return self.get_fid_streaming([np.asarray(generated_m1p1)], real_images01=real_images01)

    def get_fid_streaming(self, generated_batches_m1p1, real_images01: Optional[np.ndarray] = None) -> float:
        """FID from an iterator of generated [-1, 1] batches: each batch
        goes straight through Inception and only its pool3 activations are
        kept, so host memory stays O(batch).  A batch is a host array, a
        tensor (kept on its device: :meth:`activations_device`) or a
        ``(batch, n_valid)`` tuple whose first ``n_valid`` rows count."""
        acts, res = [], None
        for batch in generated_batches_m1p1:
            n_valid = None
            if isinstance(batch, tuple):
                batch, n_valid = batch
            if isinstance(batch, torch.Tensor):
                act = self.activations_device(batch)
            else:
                act = self.activations(np.clip((np.asarray(batch) + 1.0) / 2.0, 0.0, 1.0))
            res = int(batch.shape[1])
            acts.append(act if n_valid is None else act[:n_valid])
        if not acts:
            raise ValueError("no generated batches")
        mu_g, sig_g = activation_statistics(np.concatenate(acts, axis=0))
        mu_r, sig_r = self.real_statistics(real_images01, res)
        return frechet_distance(mu_r, sig_r, mu_g, sig_g)

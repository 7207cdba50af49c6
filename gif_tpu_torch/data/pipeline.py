"""Array-backed FFHQ + FLAME dataset and a prefetching batch iterator (port
of :mod:`gif_tpu.data.pipeline`).

The train step renders condition maps on the device, so the host pipeline
supplies only (real image, 236-d FLAME parameter vector, identity index).
Storage is memory-mapped npy / npz arrays (images uint8 NHWC), converted
from the reference's LMDBs by :mod:`gif_tpu_torch.data.lmdb_import`; seeded
synthetic datasets stand in when no real data is present.  Batches are
numpy and equal the JAX package's bit for bit for the same seed.

Reference behaviours kept:

- bad DECA fits are skipped (never sampled);
- horizontal flip marks the FLAME label of every sample with the -9999
  sentinel; a random same-pad crop zeroes the label and shifts the image
  (crop first, then flip); the true fit travels as ``flame_render`` with
  per-row ``crop`` / ``flip`` keys, so the step renders the conditions from
  it and gives them the image's pixel transforms;
- a rolling 10k-parameter accumulator feeds the FID conditioning protocol,
  skipping sentinel and crop-zeroed rows.
"""

from __future__ import annotations

import hashlib
import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from gif_tpu_torch import constants as cnst
from gif_tpu_torch.data.augment import FLIPPED_LABEL_SENTINEL, same_padding_crop
from gif_tpu_torch.data.native import assemble_batch
from gif_tpu_torch.device import resolve_device

FID_BUFFER_ROWS = 10_000


class FlameDataset:
    """images: (N, S, S, 3) uint8; flame: (N, 236) float32."""

    def __init__(
        self,
        images: np.ndarray,
        flame_params: np.ndarray,
        bad_images: Optional[np.ndarray] = None,
        horizontal_flip: bool = False,
        random_crop: bool = False,
        crop_max_in_px: int = 10,
    ):
        if len(images) != len(flame_params):
            raise ValueError(f"{len(images)} images for {len(flame_params)} FLAME rows")
        self.images = images
        self.flame_params = np.asarray(flame_params, np.float32)
        self.horizontal_flip = horizontal_flip
        self.random_crop = random_crop
        self.crop_max_in_px = crop_max_in_px
        good = np.ones(len(images), bool)
        if bad_images is not None and len(bad_images):
            good[np.asarray(bad_images, np.int64)] = False
        self.good_indices = np.nonzero(good)[0]
        # FID conditioning accumulator (rolling, capacity 10k rows).
        self._flm_buffer: list[np.ndarray] = []
        self._flm_count = 0

    def __len__(self) -> int:
        return len(self.good_indices)

    @property
    def image_size(self) -> int:
        return self.images.shape[1]

    def sample_batch(self, rng: np.random.Generator, batch_size: int) -> dict:
        """A uniform batch over the good samples as a dict of numpy arrays:
        ``real_image`` (B, S, S, 3) f32 in [-1, 1], ``flame`` (B, 236),
        ``indices`` (B,) int32, and when augmenting ``flame_render``,
        ``crop`` (B, 2) int32 and / or ``flip`` (B,) bool."""
        idx = rng.choice(self.good_indices, size=batch_size, replace=False)
        flip = (rng.random(batch_size) < 0.5) if self.horizontal_flip else None
        # Crop FIRST, then flip (the reference order): the asymmetric edge
        # fills do not commute, so the loader's fused flip serves only
        # batches without a crop.
        native_flip = flip if not self.random_crop else None
        imgs = assemble_batch(self.images, idx, native_flip)
        flame = self.flame_params[idx].copy()
        batch = {"real_image": imgs, "flame": flame, "indices": idx.astype(np.int32)}
        if self.random_crop or flip is not None:
            batch["flame_render"] = flame.copy()
        if self.random_crop:
            crops = rng.integers(
                -self.crop_max_in_px, self.crop_max_in_px, size=(batch_size, 2)
            ).astype(np.int32)
            for b in range(batch_size):
                imgs[b] = same_padding_crop(imgs[b], int(crops[b, 0]), int(crops[b, 1]))
            flame[:] = 0.0
            batch["crop"] = crops
        if flip is not None:
            if native_flip is None:  # the crop ran first
                imgs[flip] = imgs[flip, :, ::-1]
            # Every label is sentinelled whenever flips are on, flipped or
            # not, so a consumer of the label is loudly wrong.
            flame[:] = FLIPPED_LABEL_SENTINEL
            batch["flip"] = flip
        return batch

    # --- FID conditioning accumulator ---

    def accumulate_batches_of_flm(self, flame_batch: np.ndarray) -> None:
        """Append the valid fits of a batch (not flip-sentinelled, not
        crop-zeroed) and drop the oldest chunks beyond 10k rows."""
        flame_batch = np.asarray(flame_batch)
        valid = (flame_batch[:, 0] > -9000) & (np.abs(flame_batch).sum(1) > 0)
        flame_batch = flame_batch[valid]
        if not len(flame_batch):
            return
        self._flm_buffer.append(flame_batch)
        self._flm_count += len(flame_batch)
        while self._flm_count - len(self._flm_buffer[0]) >= FID_BUFFER_ROWS:
            self._flm_count -= len(self._flm_buffer[0])
            self._flm_buffer.pop(0)

    def get_10k_flame_params(self, rng: Optional[np.random.Generator] = None):
        """(params (<= 10k, 236), identity indices) for the FID protocol."""
        if not self._flm_buffer:
            raise RuntimeError("no FLAME parameters accumulated yet")
        params = np.concatenate(self._flm_buffer, axis=0)[:FID_BUFFER_ROWS]
        rng = rng or np.random.default_rng(0)
        indices = rng.integers(0, max(len(self), 1), size=len(params)).astype(np.int32)
        return params, indices


def sample_flame_params(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 236) FLAME vectors with GIF-shaped statistics in the DECA layout
    of ``constants.DECA_IDX`` (shape / exp / pose / cam / tex / lit)."""
    flame = np.zeros((n, 236), np.float32)
    flame[:, :100] = rng.standard_normal((n, 100)) * 0.5  # shape
    flame[:, 100:150] = rng.standard_normal((n, 50)) * 0.3  # exp
    flame[:, 150:156] = rng.standard_normal((n, 6)) * 0.05  # pose
    flame[:, 156] = 8.0 + rng.standard_normal(n) * 0.3  # cam scale
    flame[:, 157:159] = rng.standard_normal((n, 2)) * 0.02
    flame[:, 159:209] = rng.standard_normal((n, 50)) * 0.5  # tex
    flame[:, 209:212] = 3.0  # constant SH band
    flame[:, 212:236] = rng.standard_normal((n, 24)) * 0.2
    return flame


class SyntheticFlameDataset(FlameDataset):
    """Seeded uniform-noise frames with GIF-shaped FLAME rows, for tests and
    throughput work without the licensed FFHQ / DECA files."""

    def __init__(self, n: int = 256, size: int = 256, seed: int = 0):
        rng = np.random.default_rng(seed)
        images = rng.integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)
        flame = sample_flame_params(rng, n)
        bad = rng.choice(n, size=n // 50, replace=False) if n >= 50 else None
        super().__init__(images, flame, bad_images=bad)


class SyntheticRenderDataset(FlameDataset):
    """A learnable synthetic dataset: each frame is the FLAME render of its
    own parameter row over a smooth two-corner gradient background, so the
    target lies inside the conditional generator's reachable set (short
    runs show real adversarial dynamics, unlike uniform noise).

    Renders run on ``device`` (CUDA unless the caller passes another) in
    batches of ``render_batch`` through kernels 1 and 2, and are cached on
    disk keyed by (n, size, seed, noise_std, mesh hash, and the raster
    capacity when one is given): ``cache_dir=""`` forces a rebuild, the
    default is ``~/.cache/gif_tpu_torch/synth``.  ``noise_std`` (0 by
    default: iid noise lies outside the generator's support) adds Gaussian
    noise from a ``torch.Generator`` seeded with ``seed``.
    ``render_overflows`` counts the samples whose render dropped triangles.
    ``conditionally_exact`` (no noise) tells the training loop it may log
    the EMA generator's reconstruction error."""

    def __init__(
        self,
        res,
        n: int = 256,
        size: int = 256,
        seed: int = 0,
        render_batch: int = 16,
        noise_std: float = 0.0,
        cache_dir: str | None = None,
        device=None,
        max_tris_per_tile: int | None = None,
    ):
        from gif_tpu_torch.render.renderer import render_tex_and_normal

        self.conditionally_exact = not noise_std
        rng = np.random.default_rng(seed)
        flame = sample_flame_params(rng, n)
        c0 = rng.uniform(0.1, 0.9, (n, 1, 1, 3)).astype(np.float32)
        c1 = rng.uniform(0.1, 0.9, (n, 1, 1, 3)).astype(np.float32)
        yy = np.linspace(0.0, 1.0, size, dtype=np.float32)[None, :, None, None]
        xx = np.linspace(0.0, 1.0, size, dtype=np.float32)[None, None, :, None]
        bg = c0 + (c1 - c0) * (yy + xx) * 0.5  # (n, S, S, 3) in [0.1, 0.9]

        cache = None
        if cache_dir is None:
            cache_dir = os.path.join(os.path.expanduser("~"), ".cache", "gif_tpu_torch", "synth")
        if cache_dir:
            res_tag = hashlib.sha1(np.ascontiguousarray(res.v_template).tobytes()).hexdigest()[:10]
            cap = "" if max_tris_per_tile is None else f"_cap{max_tris_per_tile}"
            cache = os.path.join(
                cache_dir, f"renders_n{n}_s{size}_seed{seed}_ns{noise_std:g}_{res_tag}{cap}.npz"
            )
        if cache and os.path.exists(cache):
            with np.load(cache) as d:
                self.render_overflows = int(d["overflows"])
                super().__init__(d["images"], d["flame"])
            return

        dev = resolve_device(device)
        noise_rng = torch.Generator().manual_seed(seed)
        ti, tj = cnst.DECA_IDX["tex"]
        li, lj = cnst.DECA_IDX["lit"]
        ci, cj = cnst.DECA_IDX["cam"]
        images = np.empty((n, size, size, 3), np.uint8)
        overflows = 0
        with torch.inference_mode():
            for s in range(0, n, render_batch):
                e = min(s + render_batch, n)
                fp = torch.as_tensor(flame[s:e], device=dev)
                maps = render_tex_and_normal(
                    res, fp[:, 0:100], fp[:, 100:150], fp[:, 150:156], fp[:, ti:tj],
                    fp[:, li:lj].reshape(e - s, 9, 3), fp[:, ci:cj],
                    image_size=size, max_tris_per_tile=max_tris_per_tile,
                )
                fg = torch.clamp(maps.textured, 0.0, 1.0)
                img = torch.where(maps.mask[..., None], fg, torch.as_tensor(bg[s:e], device=dev))
                if noise_std:
                    img = img + torch.randn(img.shape, generator=noise_rng).to(dev) * noise_std
                img = torch.clamp(img, 0.0, 1.0)
                overflows += int(maps.overflow.sum())
                images[s:e] = np.clip(img.cpu().numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8)
        self.render_overflows = overflows
        if cache:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            tmp = f"{cache}.{os.getpid()}.tmp.npz"
            np.savez(tmp, images=images, flame=flame, overflows=overflows)
            os.replace(tmp, cache)
        super().__init__(images, flame)


def load_packed_dataset(path: str, **kwargs) -> FlameDataset:
    """Load an ``.npz`` written by :mod:`gif_tpu_torch.data.lmdb_import`
    (keys: ``flame_params``, optional ``bad_images``, and EITHER an inline
    ``images`` array OR an ``images_path`` naming a separate ``.npy``,
    mem-mapped).  A relocated dataset directory keeps working: a missing
    recorded path falls back to the ``.npy`` of that name beside the npz."""
    data = np.load(path, allow_pickle=False, mmap_mode="r")
    if "images" in data:
        images = data["images"]
    elif "images_path" in data:
        img_path = str(data["images_path"])
        if not os.path.exists(img_path):
            img_path = os.path.join(os.path.dirname(os.path.abspath(path)), os.path.basename(img_path))
        images = np.load(img_path, mmap_mode="r")
    else:
        raise KeyError(f"{path} carries neither an 'images' array nor an 'images_path' reference")
    return FlameDataset(
        images=images,
        flame_params=data["flame_params"],
        bad_images=data["bad_images"] if "bad_images" in data else None,
        **kwargs,
    )


MAX_CONSECUTIVE_FAILURES = 10


def data_iterator(
    dataset: FlameDataset,
    batch_size: int,
    seed=0,
    prefetch: int = 2,
    start_step: int = 0,
) -> Iterator[dict]:
    """Infinite prefetching iterator: a daemon thread keeps ``prefetch``
    batches ready so host assembly overlaps device work.

    Batches are counter-based: batch ``i`` is drawn from a fresh
    ``default_rng([*seed, i, failures])`` stream, so a run resumed at step
    ``s`` (``start_step=s``) sees exactly the batches an uninterrupted run
    saw from step ``s`` on.  ``seed`` is an int or a sequence of ints.  A
    failed batch is drawn again from a stream with the failure count
    folded in; the tenth failure in a row is raised to the consumer.
    Closing the iterator stops the thread."""
    seed_seq = [int(seed)] if np.isscalar(seed) else [int(s) for s in seed]
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def producer():
        failures = 0
        step = start_step
        while not stop.is_set():
            try:
                rng = np.random.default_rng(seed_seq + [step, failures])
                batch = dataset.sample_batch(rng, batch_size)
            except Exception as e:  # noqa: BLE001 - a read error retries the batch
                failures += 1
                if failures >= MAX_CONSECUTIVE_FAILURES:
                    put(e)
                    return
                print(f"data pipeline: batch failed ({e!r}); resampling")
                continue
            step += 1
            failures = 0
            put(batch)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()

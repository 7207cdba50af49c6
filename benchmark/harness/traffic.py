"""The general traffic generator: one reader for every traffic file.

A traffic mix is a JSON file under ``benchmark/traffic/`` whose ``kind``
names the driver that runs it, ``benchmark/harness/<kind>.py``:

- ``train``: a ring of ``ring`` distinct batches of ``batch`` rows made on
  the device before the window, fed to the train step in turn.  Each row:
  a real image drawn uniform in [-1, 1], a FLAME code whose slices are set
  by ``flame`` (``normal`` slices: ``[start, stop, std]``; ``constant``
  slices: ``[start, stop, value]``), an identity uniform over the
  configuration's vocabulary.  Under the interpolation loss each batch
  also carries its draws: the lerp weight, the identity and the pairs.

The same seed gives the same traffic.
"""

from __future__ import annotations

import numpy as np
import torch


def _seed(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, *salt])


def flame_rows(spec: dict, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """(n, 236) FLAME codes drawn on ``device`` as ``spec`` says."""
    flame = torch.zeros((n, 236), dtype=torch.float32, device=device)
    for start, stop, std in spec.get("normal", []):
        flame[:, start:stop] = torch.randn((n, stop - start), generator=gen, device=device) * std
    for start, stop, value in spec.get("constant", []):
        flame[:, start:stop] = value
    return flame


def interp_draws(rng: np.random.Generator, batch: int, vocab: int) -> dict:
    """The interpolation loss's draws for a batch: lerp weight ``t``, one
    identity, ``n_pick`` pair indices of the ``batch - 1`` interpolants."""
    n = batch - 1
    n_pairs = n * (n - 1) // 2
    return {
        "interp_t": float(rng.uniform()),
        "interp_identity": int(rng.integers(0, vocab)),
        "interp_pairs": torch.as_tensor(rng.permutation(n_pairs)[: min(n, n_pairs)]),
    }


def train_ring(spec: dict, seed: int, device, image_size: int, vocab: int, interp: bool,
               rows: slice | None = None) -> list:
    """``spec["ring"]`` batches of ``spec["batch"]`` rows, each ``{"batch":
    {...}, "draws": {...}}``.  ``rows`` takes a slice of every batch (a
    rank's share, or a fault's half batch) after the whole batch is drawn."""
    b = spec["batch"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    rng = _seed(seed, 1)
    ring = []
    for _ in range(spec["ring"]):
        batch = {
            "real_image": torch.rand((b, image_size, image_size, 3), generator=gen, device=device) * 2 - 1,
            "flame": flame_rows(spec["flame"], b, gen, device),
            "indices": torch.as_tensor(rng.integers(0, vocab, b), device=device),
        }
        draws = interp_draws(rng, b, vocab) if interp else {}
        if rows is not None:
            batch = {k: v[rows] for k, v in batch.items()}
            if interp:
                draws = interp_draws(_seed(seed, 2, len(ring)), batch["flame"].shape[0], vocab)
        ring.append({"batch": batch, "draws": draws})
    return ring

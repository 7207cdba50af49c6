"""Benchmark: the full GIF train step (G + D forward-backward + the FLAME
render on the card) at FFHQ-256, batch 16, on one card — the port of the
repository's ``bench.py``, same configuration and protocol:

    python -m gif_tpu_torch.bench [--run_id 8]

Prints ONE JSON line: ``metric``, ``value`` (images/s, the median of 3
chains of 10 steps), ``unit``, ``vs_baseline``, ``spread``, ``chains``,
``flops_per_step`` (PyTorch's FLOP counter; a step of the R1 schedule on
average), ``mfu``
(against the card's data-sheet bf16 peak) and, for run_id != 8,
``render_overflow``.

Baseline derivation (as ``bench.py``'s): the reference publishes no
throughput; its only cost anecdote is ~17 s/iter at batch 16 with the
gradient penalty every iteration (reference train.py:145), so run_id 8
runs R1 every step and ``vs_baseline = imgs_per_sec / (16 / 17)``.

``--tiny --device cpu`` runs the same protocol on the 32 px smoke
configuration and the 503-vertex mesh (a check of the program, not a
measurement).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

METRIC = "ffhq256_train_imgs_per_sec_per_chip"
BASELINE_IMGS_PER_SEC = 16.0 / 17.0  # the reference's 17 s/iter anecdote


def bench_batch(cfg, batch: int, device) -> dict:
    """bench.py's seeded batch: shape x0.1, pose x0.05, camera scale 8, SH
    band 3.0, uniform real images, identities below 1024."""
    rng = np.random.default_rng(0)
    flame = np.zeros((batch, 236), np.float32)
    flame[:, :100] = rng.standard_normal((batch, 100)).astype(np.float32) * 0.1
    flame[:, 150:156] = rng.standard_normal((batch, 6)).astype(np.float32) * 0.05
    flame[:, 156] = 8.0
    flame[:, 209:212] = 3.0
    data = {
        "real_image": rng.uniform(-1, 1, (batch, cfg.max_size, cfg.max_size, 3)).astype(np.float32),
        "flame": flame,
        "indices": rng.integers(0, cfg.embedding_vocab_size, batch),
    }
    return {k: torch.as_tensor(v, device=device) for k, v in data.items()}


def bench_setup(run_id: int = 8, device=None, tiny: bool = False):
    """bench.py's configuration of ``run_id`` on ``device`` (CUDA unless the
    caller passes another): (cfg, train state, train step, its draws'
    generator, the batch).  run_id 8 runs R1 every step (the reference's
    17 s/iter anecdote) and pins the historical raster capacity 512; other
    presets keep their cadence and size the capacity from the mesh.
    ``tiny``: the 32 px smoke configuration, batch 4, the 503-vertex mesh.
    ``gif_tpu_torch.scripts.profile_step`` and ``mfu_report`` time and count
    the same program."""
    from gif_tpu_torch.device import resolve_device
    from gif_tpu_torch.flame.resources import synthetic_flame_resources
    from gif_tpu_torch.train.config import TINY_OVERRIDES, get_config
    from gif_tpu_torch.train.state import create_train_state
    from gif_tpu_torch.train.step import make_train_step

    dev = resolve_device(device)
    batch = 4 if tiny else 16
    kwargs = {"r1_interval": 1} if run_id == 8 else {}
    cfg = get_config(run_id, embedding_vocab_size=16 if tiny else 1024, batch_size=batch, **kwargs,
                     **(TINY_OVERRIDES if tiny else {}))
    res = synthetic_flame_resources(seed=1, n_vertices=503) if tiny else synthetic_flame_resources()
    state = create_train_state(cfg, seed=0, device=dev)
    step_rng = torch.Generator()
    step_fn = make_train_step(cfg, res, device=dev, max_tris_per_tile=512 if run_id == 8 else None,
                              generator=step_rng)
    return cfg, state, step_fn, step_rng, bench_batch(cfg, batch, dev)


def run(run_id: int = 8, device=None, tiny: bool = False, n_iters: int = 10, n_chains: int = 3) -> dict:
    """The bench line of ``run_id`` (a dict; :func:`main` prints it)."""
    from gif_tpu_torch.utils.flops import compiled_flops, device_peak_flops
    from gif_tpu_torch.utils.profiling import StepTimer

    cfg, state, step_fn, step_rng, data = bench_setup(run_id, device, tiny)
    dev, batch = data["flame"].device, cfg.batch_size

    metrics = {}

    def chained(state, i):
        # One draw stream a step, as bench.py folds the step index in.
        step_rng.manual_seed(1 + i)
        state, m = step_fn(state, data)
        metrics.update(m)
        return state

    # Warm-up (kernel builds, Triton JIT, cuDNN's first calls) is the
    # timer's first step; then >= 3 independent chains, each closed by one
    # readback, reported as the median chain and the spread.
    timer = StepTimer(warmup=1, device=dev.type)
    rates = []
    for c in range(n_chains):
        sec = timer.time(lambda s, i: chained(s, c * n_iters + i), state, iters=n_iters)
        timer.warmup = 0
        rates.append(batch / sec)
    imgs_per_sec = float(np.median(rates))
    line = {
        "metric": METRIC if run_id == 8 else f"{METRIC}_run{run_id}",
        "value": round(imgs_per_sec, 3),
        "unit": "imgs/sec",
        "vs_baseline": round(imgs_per_sec / BASELINE_IMGS_PER_SEC, 2),
        "spread": round(max(rates) - min(rates), 3),
        "chains": [round(r, 3) for r in rates],
    }
    # FLOPs a step as PyTorch's counter sees them (forward, backward, R1's
    # double backward), averaged over the R1 schedule the chains ran: one
    # more R1 step and, under lazy R1, one more plain step.
    def flops_at(i):
        state.step = i
        return compiled_flops(chained, state, n_chains * n_iters)

    r = cfg.r1_interval
    flops_step = flops_at(r - 1)
    if r > 1 and flops_step:
        flops_step = (flops_step + (r - 1) * flops_at(r)) / r
    peak = device_peak_flops(dev)
    if flops_step:
        line["flops_per_step"] = float(f"{flops_step:.4g}")
        if peak:
            line["mfu"] = round(flops_step * (imgs_per_sec / batch) / peak, 4)
    if run_id != 8:
        line["render_overflow"] = float(metrics["render_overflow"])
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run_id", type=int, default=8,
                    help="training config preset; 8 (default) is the bench line, 0 is the paper's flagship "
                         "(texture-interpolation loss)")
    ap.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="32 px / 16 channels, 503-vertex mesh (CPU smoke runs)")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.run_id, a.device, a.tiny)))


if __name__ == "__main__":
    main()

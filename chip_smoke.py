#!/usr/bin/env python3
"""Drive the PyTorch port of GIF on one NVIDIA GPU and check it end to end.

Run from the repository root (needs one CUDA card, nvcc and triton):

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. build the CUDA kernels from ``gif_tpu_torch/csrc`` with nvcc and print
   the build seconds and the ptxas resource lines;
2. build the serving stack at full width — run_id 8, 256 px, 512 channels,
   channel multiplier 2, 8-layer mapping, 69158 identities, bf16 convs,
   FLAME-sized synthetic mesh (5023 vertices), batch 8, seeded weights —
   and serve one warm-up batch through it, recording the inputs every
   kernel wrapper receives;
3. hold every kernel to its plain PyTorch version on those inputs (the main
   path's shapes) with the tolerance printed, and time kernel, plain
   version and — where one PyTorch call computes the same function — that
   call;
4. hold the CUDA path to the CPU plain path end to end on a small input
   (tiny generator, 503-vertex mesh);
5. reset every launch counter, serve 52 threaded ``generate()`` requests
   (full batches of 8 and a padded partial batch), read the counters, and
   check the images, the render overflow and that every kernel launched;
6. profile one more batch: device busy share and the kernels that take
   the device time.

Times: ``ms``, ``plain_ms`` and ``library_ms`` are device time per call
(the sum of the CUDA kernels and copies a call runs, from torch.profiler),
so host launch overhead is excluded; ``wall_ms`` is a CUDA-event time per
call over back-to-back calls, which includes it.  Kernels with several
launches per served batch report sums over that batch's launches.

The last lines are one JSON object with a record per kernel, the card's
name and power limit as nvidia-smi reports them, and the result line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM data-sheet peaks (dense): HBM bandwidth and non-tensor f32 rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations one candidate-pixel test of the rasterizer costs
# (csrc/raster.cu inner loop: 2 sub, 4 mul + 2 add, 2 x (3 mul + 1 sub),
# 2 sub, 3 compares, and 3 mul + 2 add for an inside hit).
RASTER_OPS_PER_PAIR = 27
ITERS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def device_ms(fn, iters: int = ITERS) -> float:
    """Device time per call: every CUDA kernel / copy ``fn`` runs, summed
    by torch.profiler over ``iters`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(ms for ms, _ in _device_rows(prof).values()) / iters


def _device_rows(prof) -> dict:
    """{kernel name: (total device ms, count)} of a finished profile."""
    import torch

    rows = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows[e.key] = (us / 1e3, e.count)
    return rows


def wall_ms(fn, iters: int = ITERS) -> float:
    """CUDA-event time per call over back-to-back calls (host gaps included)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def times(kernel_fn, plain_fn, library_fn=None) -> dict:
    return dict(
        ms=device_ms(kernel_fn),
        plain_ms=device_ms(plain_fn, 3),
        library_ms=None if library_fn is None else device_ms(library_fn),
        wall_ms=wall_ms(kernel_fn),
    )


def add_times(tot: dict, t: dict) -> None:
    for k, v in t.items():
        tot[k] = None if v is None else tot.get(k, 0.0) + v


def warm_up_and_capture(server, n: int):
    """Serve one batch of ``n`` requests (on the server's batcher thread,
    so its per-thread CUDA state is warm) with every kernel entry of the
    first batch recorded."""
    from gif_tpu_torch.ops import activations, blur_cuda
    from gif_tpu_torch.render import raster_cuda, sampler_cuda

    batches = []
    targets = [
        (raster_cuda, "rasterize_cuda", "raster"),
        (sampler_cuda, "grid_sample_cuda", "sampler"),
        (activations, "fused_leaky_relu_triton", "flr"),
        (blur_cuda, "blur4_cuda", "blur"),
    ]
    originals = [getattr(mod, name) for mod, name, _ in targets]

    def recorder(orig, key):
        def rec(*args):
            if key == "raster":  # each batch renders first
                batches.append({"raster": [], "sampler": [], "flr": [], "blur": []})
            batches[-1][key].append(args)
            return orig(*args)

        return rec

    for (mod, name, key), orig in zip(targets, originals):
        setattr(mod, name, recorder(orig, key))
    try:
        serve_round(server, range(1000, 1000 + n), {})
    finally:
        for (mod, name, _), orig in zip(targets, originals):
            setattr(mod, name, orig)
    return batches[0]


def serve_round(server, ids, results: dict) -> None:
    """``generate()`` one request per id from concurrent threads."""

    def request(i):
        vocab = server.cfg.embedding_vocab_size
        results[i] = server.generate(None, identity=(i * 7919) % vocab, seed=i)

    threads = [threading.Thread(target=request, args=(i,)) for i in ids]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "request did not finish"


def bbox_pixel_tests(fv, h: int, w: int) -> int:
    """Face-pixel tests these inputs need: for every front-facing face, the
    pixels of its ceil/floor bbox clamped to the image (the kernel itself
    tests every pixel of every tile a face's bbox overlaps)."""
    import torch

    from gif_tpu_torch.render import raster

    xs, ys = fv[..., 0], fv[..., 1]
    nx = torch.clamp(torch.floor(xs.amax(-1)), max=w - 1) - torch.clamp(torch.ceil(xs.amin(-1)), min=0)
    ny = torch.clamp(torch.floor(ys.amax(-1)), max=h - 1) - torch.clamp(torch.ceil(ys.amin(-1)), min=0)
    n = (nx + 1).clamp(min=0).double() * (ny + 1).clamp(min=0).double()
    return int(n[raster._front_facing(fv)].sum().item())


def check_kernels(calls):
    """Kernel vs plain on the recorded inputs; returns the JSON records."""
    import torch
    import torch.nn.functional as F

    from gif_tpu_torch.ops import activations, blur_cuda
    from gif_tpu_torch.render import raster, raster_cuda, sampler_cuda, shading

    records = []

    # --- kernel 1: rasterizer (its wrapper: torch binning + setup + kernel) ---
    (fv, attrs, h, w, tile, cap), = calls["raster"]
    got, got_img = raster_cuda.rasterize_cuda(fv, attrs, h, w, tile, cap)
    want, want_img = raster.rasterize_plain(fv, attrs, h=h, w=w, tile=tile, max_tris_per_tile=cap)
    torch.cuda.synchronize()
    mismatch = (got.tri_id != want.tri_id).float().mean().item()
    same = got.tri_id == want.tri_id
    err = max(
        (got.depth - want.depth)[same].abs().max().item(),
        (got.bary - want.bary)[same].abs().max().item(),
        (got_img - want_img)[same].abs().max().item(),
    )
    overflow_equal = bool(torch.equal(got.tile_overflow, want.tile_overflow))
    verdict = (f"tri_id mismatch fraction {mismatch:.3g} (tol 1e-4), max_abs_err {err:.3g} on "
               f"agreeing pixels (tol 1e-4), overflow equal {overflow_equal}")
    assert mismatch <= 1e-4 and err <= 1e-4 and overflow_equal, f"raster kernel disagrees: {verdict}"
    pairs = bbox_pixel_tests(fv, h, w)
    out_bytes = fv.shape[0] * h * w * (4 + 4 + 12 + 4 * attrs.shape[-1]) + got.tile_overflow.numel()
    t_bytes = (nbytes(fv, attrs) + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = pairs * RASTER_OPS_PER_PAIR / F32_OPS_PER_S * 1e3
    t = times(lambda: raster_cuda.rasterize_cuda(fv, attrs, h, w, tile, cap),
              lambda: raster.rasterize_plain(fv, attrs, h=h, w=w, tile=tile, max_tris_per_tile=cap))
    ids, counts, _ = raster.bin_faces(fv, tile, cap, h, w)
    tab = raster.face_table(fv)
    kernel_only = device_ms(lambda: raster_cuda.launch_kernel(tab, attrs, ids, counts, h, w, tile))
    log(f"kernel raster: {verdict}; ms {t['ms']:.4f} (raster_kernel alone {kernel_only:.4f}; wall "
        f"{t['wall_ms']:.4f}) plain_ms {t['plain_ms']:.4f} bound_ms {max(t_bytes, t_ops):.4f} "
        f"(bytes {t_bytes:.4f}, operations {t_ops:.4f}: {pairs} bbox pixel tests) "
        f"library_ms none; fv {tuple(fv.shape)} attrs {tuple(attrs.shape)} cap {cap} tile {tile}; "
        f"candidates per tile max {int(counts.max())} mean {counts.float().mean().item():.1f}")
    records.append(dict(
        name="raster", route="cuda", source="gif_tpu_torch/csrc/raster.cu",
        replaces="gif_tpu/render/raster_pallas.py:271", max_abs_err=err,
        bound_ms=max(t_bytes, t_ops), bound_by="operations" if t_ops > t_bytes else "bytes",
        kernel_only_ms=kernel_only, tri_id_mismatch=mismatch, **t,
    ))

    # --- kernel 2: albedo sampler ---
    (img, grid), = calls["sampler"]
    got = sampler_cuda.grid_sample_cuda(img, grid)
    want = shading.grid_sample_bilinear(img, grid)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= 1e-6, f"sampler kernel disagrees: max_abs_err {err:.3g} (tol 1e-6)"
    img_nchw = img.permute(0, 3, 1, 2)

    def library():
        return F.grid_sample(img_nchw, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False)

    lib_err = (library().permute(0, 2, 3, 1) - got).abs().max().item()
    bound = nbytes(img, grid, got) / HBM_BYTES_PER_S * 1e3
    t = times(lambda: sampler_cuda.grid_sample_cuda(img, grid),
              lambda: shading.grid_sample_bilinear(img, grid), library)
    log(f"kernel sampler: max_abs_err {err:.3g} (tol 1e-6); ms {t['ms']:.4f} (wall {t['wall_ms']:.4f}) plain_ms {t['plain_ms']:.4f} "
        f"library_ms {t['library_ms']:.4f} (F.grid_sample, max diff {lib_err:.3g}) bound_ms "
        f"{bound:.4f} (bytes); img {tuple(img.shape)} grid {tuple(grid.shape)}")
    records.append(dict(
        name="sampler", route="cuda", source="gif_tpu_torch/csrc/sampler.cu",
        replaces="gif_tpu/render/sampler_pallas.py:43", max_abs_err=err, bound_ms=bound,
        bound_by="bytes", **t,
    ))

    # --- kernel 3: fused bias + lrelu, summed over its launches of a batch ---
    tot, err, bound = {}, 0.0, 0.0
    for x, bias, neg, scale in calls["flr"]:
        got = activations.fused_leaky_relu_triton(x, bias, neg, scale)
        want = activations.fused_leaky_relu_plain(x, bias, neg, scale)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        # One bf16 rounding step of the output: 2^-7 relative.
        assert bool((d <= want.float().abs() * 2.0**-7 + 1e-6).all()), \
            f"flr kernel disagrees at {tuple(x.shape)}"
        err = max(err, d.max().item())
        add_times(tot, times(lambda: activations.fused_leaky_relu_triton(x, bias, neg, scale),
                             lambda: activations.fused_leaky_relu_plain(x, bias, neg, scale)))
        bound += nbytes(x, bias, got) / HBM_BYTES_PER_S * 1e3
    shapes = sorted({tuple(c[0].shape) for c in calls["flr"]})
    log(f"kernel flr: {len(calls['flr'])} launches/batch, max_abs_err {err:.3g} (tol 1 bf16 "
        f"step: 2^-7 relative), ms {tot['ms']:.4f} (wall {tot['wall_ms']:.4f}) plain_ms "
        f"{tot['plain_ms']:.4f} bound_ms {bound:.4f} (bytes) library_ms none; dtype "
        f"{calls['flr'][0][0].dtype}; shapes {shapes}")
    records.append(dict(
        name="fused_bias_lrelu", route="triton", source="gif_tpu_torch/ops/activations.py",
        replaces="gif_tpu/ops/activations.py:41", max_abs_err=err, bound_ms=bound,
        bound_by="bytes", **tot,
    ))

    # --- kernel 4: FIR blur, summed over its launches of a batch ---
    tot, err, bound = {}, 0.0, 0.0
    for x, taps, pads in calls["blur"]:
        got = blur_cuda.blur4_cuda(x, taps, pads)
        want = blur_cuda.blur4_plain(x, taps, pads)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        assert bool((d <= want.float().abs() * 2.0**-7 + 1e-6).all()), \
            f"blur kernel disagrees at {tuple(x.shape)}"
        err = max(err, d.max().item())
        c = x.shape[1]
        k2 = torch.tensor(taps, device=x.device, dtype=x.dtype)
        k2 = (k2[:, None] * k2[None, :]).expand(c, 1, 4, 4).contiguous()
        assert pads[0] == pads[1] == pads[2] == pads[3]
        assert F.conv2d(x, k2, padding=pads[0], groups=c).shape == got.shape
        add_times(tot, times(lambda: blur_cuda.blur4_cuda(x, taps, pads),
                             lambda: blur_cuda.blur4_plain(x, taps, pads),
                             lambda: F.conv2d(x, k2, padding=pads[0], groups=c)))
        bound += nbytes(x, got) / HBM_BYTES_PER_S * 1e3
    shapes = [tuple(c[0].shape) for c in calls["blur"]]
    log(f"kernel blur: {len(calls['blur'])} launches/batch, max_abs_err {err:.3g} (tol 1 bf16 "
        f"step: 2^-7 relative), ms {tot['ms']:.4f} (wall {tot['wall_ms']:.4f}) plain_ms "
        f"{tot['plain_ms']:.4f} library_ms {tot['library_ms']:.4f} (depthwise F.conv2d) bound_ms "
        f"{bound:.4f} (bytes); shapes {shapes}")
    records.append(dict(
        name="fir_blur", route="cuda", source="gif_tpu_torch/csrc/blur.cu",
        replaces="gif_tpu/ops/blur_pallas.py:51", max_abs_err=err, bound_ms=bound,
        bound_by="bytes", **tot,
    ))
    return records


def check_against_cpu_plain():
    """Tiny config: the CUDA path (kernels) against the CPU plain path."""
    import torch

    from gif_tpu_torch.eval.sampling import FlameSampler, load_generator_params, random_flame_params
    from gif_tpu_torch.flame.resources import synthetic_flame_resources
    from gif_tpu_torch.train.config import TINY_OVERRIDES, get_config

    cfg = get_config(8, **{**TINY_OVERRIDES, "embedding_vocab_size": 16})
    res = synthetic_flame_resources(seed=1, n_vertices=503)
    sd = load_generator_params(cfg, seed=0)
    fl = random_flame_params(np.random.default_rng(0), 4)
    idx = np.arange(4)
    samplers = {
        d: FlameSampler(cfg, res, sd, batch_size=4, eye_center=False, device=d)
        for d in ("cuda", "cpu")
    }
    g_img, g_cond = samplers["cuda"].sample(fl, idx)
    c_img, c_cond = samplers["cpu"].sample(fl, idx)
    diff = np.abs(g_cond - c_cond)
    step = 2.0 / 255.0
    flips = float((diff > step * 0.5).mean())
    fg = float((c_cond[..., 3:] > -1).any(-1).mean())
    # The generator on the card, fed the CPU path's conditions.
    gen = samplers["cuda"].generator
    with torch.inference_mode():
        g_on_c = gen(torch.from_numpy(c_cond).cuda(), input_indices=torch.from_numpy(idx).cuda(),
                     step=cfg.max_step).cpu().numpy()
    img_err = float(np.abs(g_on_c - c_img).max())
    log(f"cuda vs cpu plain (tiny G at f32, 503-vertex mesh, 32 px): cond one-step flips "
        f"{flips:.4f} (tol 0.005; max diff {diff.max():.4f}), foreground {fg:.2f}, image "
        f"max_abs_err {img_err:.3g} (tol 1e-3)")
    assert diff.max() <= step * 1.001 and flips < 0.005 and fg > 0.3, "render disagrees"
    assert img_err < 1e-3, "generator on the card disagrees with the CPU plain path"


def profile_batch(sampler):
    """One more batch of 8 under torch.profiler: device busy share and the
    kernels that take the device time."""
    from torch.profiler import ProfilerActivity, profile

    from gif_tpu_torch.eval.sampling import random_flame_params

    fl = random_flame_params(np.random.default_rng(7), 8)
    idx = np.arange(8) * 101 % sampler.cfg.embedding_vocab_size
    sampler.sample(fl, idx)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sampler.sample(fl, idx)
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((ms, n, k) for k, (ms, n) in _device_rows(prof).items()), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"phase profile: batch of 8 {wall:.2f} ms host clock under the profiler, device time "
        f"{busy:.2f} ms ({100 * busy / wall:.1f}% busy), {sum(r[1] for r in rows)} device ops")
    for ms, n, name in rows[:20]:
        log(f"  {ms:8.3f} ms  x{n:<4d} {name[:110]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from gif_tpu_torch import kernels
    from gif_tpu_torch.eval.sampling import load_generator_params
    from gif_tpu_torch.flame.resources import synthetic_flame_resources
    from gif_tpu_torch.ops import activations, blur_cuda
    from gif_tpu_torch.render import raster_cuda, sampler_cuda
    from gif_tpu_torch.serve import GifServer
    from gif_tpu_torch.train.config import get_config

    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # --- phase 1: build ---
    t0 = time.perf_counter()
    _, nvcc_s, build_log = kernels.build()
    log(f"phase build: nvcc {nvcc_s:.2f} s (wall {time.perf_counter() - t0:.2f} s)")
    for src, out in build_log.items():
        for line in out.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")

    # --- phase 2: the full-width serving stack, one recorded warm-up batch ---
    t0 = time.perf_counter()
    cfg = get_config(8)
    res = synthetic_flame_resources()
    g_state = load_generator_params(cfg, seed=0)
    # The synthetic mesh's stand-ins for FLAME's eye vertices (4051, 4597)
    # sit ~0.13 m apart, about twice FLAME's eye distance, so eye-centring
    # draws the head at ~60 px and a 32-px tile sees up to ~2.5k faces,
    # past the mesh-derived default capacity (1280).  This run sets the
    # sampler's capacity to the face count, so no tile can overflow; work
    # still follows each tile's real candidate count.
    server = GifServer(cfg, res, g_state, batch_size=8, max_wait_ms=200.0)
    server.sampler.max_tris_per_tile = res.n_faces
    log(f"phase setup: run_id 8, {cfg.max_size} px, max_channels {cfg.max_channels}, "
        f"vocab {cfg.embedding_vocab_size}, {cfg.compute_dtype}, mesh {res.n_vertices} vertices / "
        f"{res.n_faces} faces, batch 8: {time.perf_counter() - t0:.2f} s")
    counters = {
        "raster": raster_cuda.rasterize_with_attrs,
        "sampler": sampler_cuda.grid_sample,
        "fused_bias_lrelu": activations.fused_leaky_relu,
        "fir_blur": blur_cuda.blur4,
    }
    try:
        t0 = time.perf_counter()
        calls = warm_up_and_capture(server, 8)
        log(f"phase warm-up batch (Triton JIT and first-call setup included): "
            f"{time.perf_counter() - t0:.2f} s; kernel entries per batch: "
            + ", ".join(f"{k} {len(v)}" for k, v in calls.items()))

        # --- phase 3: kernels vs plain versions, timings ---
        t0 = time.perf_counter()
        records = check_kernels(calls)
        del calls
        log(f"phase kernel checks: {time.perf_counter() - t0:.2f} s; card now: "
            + nvidia_smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu"))

        # --- phase 4: CUDA path vs CPU plain path on a small input ---
        check_against_cpu_plain()

        # --- phase 5: serve 52 requests through the counted main path ---
        overflows_before = server.sampler.render_overflows
        n_batches_before = len(server.batch_seconds)
        results = {}
        for fn in counters.values():
            fn.launches = 0
        t_serve = time.perf_counter()
        for r in range(6):
            serve_round(server, range(8 * r, 8 * r + 8), results)
        serve_round(server, range(48, 52), results)  # a padded partial batch
        serve_s = time.perf_counter() - t_serve
        launches = {k: fn.launches for k, fn in counters.items()}

        # --- phase 6: where a batch's device time goes ---
        profile_batch(server.sampler)
    finally:
        server.stop()

    sizes = list(server.batch_sizes)[n_batches_before:]
    secs = list(server.batch_seconds)[n_batches_before:]
    log(f"phase serve: {len(results)} requests in {serve_s:.3f} s; batch sizes {sizes}; "
        f"batch seconds {[round(t, 5) for t in secs]}; launches {launches}")
    assert len(results) == 52 and 8 in sizes and any(s < 8 for s in sizes), sizes
    for i, img in results.items():
        assert img.shape == (cfg.max_size, cfg.max_size, 3) and img.dtype == np.uint8, \
            (i, img.shape, img.dtype)
        assert int(img.max()) > int(img.min()), f"request {i}: constant image"
    overflow = server.sampler.render_overflows - overflows_before
    assert overflow == 0, f"render overflow in {overflow} samples"
    assert all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}"
    full = [t for t, s in zip(secs, sizes) if s == 8]
    log(f"serving latency per batch of 8 (host clock, render + G + readback): median "
        f"{1e3 * float(np.median(full)):.2f} ms, min {1e3 * min(full):.2f} ms, max "
        f"{1e3 * max(full):.2f} ms over {len(full)} batches; {8 / float(np.median(full)):.1f} "
        f"images/s at the median; render overflow 0; on {smi}")

    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"]
    for r in records:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys}, **{k: v for k, v in r.items() if k not in keys}}
        for r in records
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

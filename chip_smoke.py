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
   and serve one warm-up batch through it, every kernel launch held to its
   plain PyTorch version on the spot (on the inputs the wrapper received,
   with the tolerance printed);
3. time each kernel of that batch at its served shapes: kernel, plain
   version and — where one PyTorch call computes the same function — that
   call;
4. hold the CUDA path to the CPU plain path end to end on a small input
   (tiny generator, 503-vertex mesh);
5. reset every launch counter, serve 52 threaded ``generate()`` requests
   (full batches of 8 and a padded partial batch), read the counters, and
   check the images, the render overflow and that every kernel launched;
6. profile one more batch: device busy share and the kernels that take
   the device time;
7. build the run_id-8 train state at the same full width, batch 16, and
   run one warm-up train step (an R1 step) in which every launch of all
   six kernels — raster, sampler, fused bias+lrelu forward (kernel 3) and
   backward (kernel 5), blur (kernel 4) and its VJP — is held to its plain
   version on the spot, then time each kernel at those shapes;
8. reset every launch counter, run 3 counted train steps from step 13
   (R1 fires on the third: (15 + 1) % 16 == 0), read the counters, check
   losses, R1 schedule, parameter / EMA movement, render overflow and that
   all six kernels launched; print step times, images/s and peak memory;
   profile one more step without R1 and one with it; time D's parts of an
   R1 step alone with CUDA events (loss, R1 forward, R1 parameter
   backward) and profile R1's parameter backward;
9. build the run_id-0 train state at the same width (the flagship preset:
   texture-space interpolation loss, fused into one render and one G
   forward over 2B - 1 = 31 rows) and run one warm-up R1 step in which
   every launch of all seven kernels — the six above and the bilinear
   scatter (kernel 6), the texture steal's backward — is held to its plain
   version on the spot, then time each kernel at those shapes;
10. reset every launch counter, run 3 counted run_id-0 steps from step 13
    (R1 on the third), read the counters, check the losses (``interp`` > 0,
    ``g_total = g_loss + interp``), the render overflow, one render, two
    sampler launches (albedo and texture steal) and the scatter in every
    step; print step times, images/s and peak memory; profile one more
    step without R1; time the interpolation penalty alone (forward, and
    with its image gradient);
11. hold R1's parameter gradient through the kernels to the same gradient
    through the plain versions on a narrow discriminator (f32), and the
    bf16 policy's to the f32 one;
12. hold one tiny run_id-8 and one tiny run_id-0 train step on the card to
    the CPU plain path (metrics and the G and D gradients from one state;
    the interpolation draws injected), then one tiny run_id-8 step of each
    branch — path length, direct gradient, embedding regularizer, shuffled
    negatives, instance noise — and one crop + flip step (draws injected;
    the gradients the step hands Adam);
13. the regularized run_id-8 step at the same full width, batch 16: path
    length, embedding regularizer (``EMB_REG``), shuffled-condition
    negatives, instance noise 0.05, crop / flip batches rendered from
    ``flame_render``; one recorded warm-up R1 step (every launch, the
    double backward's included, held to its plain version), 3 counted
    steps from step 13 (R1 on the third) checking losses, ``pl_mean``,
    parameter movement and launches; step times, images/s, peak memory;
    the path-length term alone (CUDA events: forward, parameter backward)
    and a profile of its parameter backward;
14. the fused run_id-0 step with the direct gradient regularizer and the
    adaptive interpolation scale, the same way (``g_total = g_loss + rest +
    interp``, ``interp = 0.25 (g_loss + rest)``), and the direct-gradient
    term alone;
15. the render's gradient at the served shapes (batch 8, 256 px) with
    respect to the texture and light codes and the face attributes,
    through kernels 1, 2 and 6 (counted; every launch held to its plain
    version) against the plain versions on the card, and kernel 6 timed at
    the albedo lookup's shape;
16. the training job through ``gif_tpu_torch.train.loop.train`` at run_id
    8, the same full width, batch 16: a 512-frame
    ``SyntheticRenderDataset`` rendered on the card (kernels 1 and 2,
    counted, overflow 0), the random-weight InceptionV3 FID on 512 samples
    against the 512 frames; every counter 0, then 20 steps with metrics
    every 5, FID at steps 0 and 20, checkpoints at 10 and 20, the first
    step and the first FID batch held launch by launch to the plain
    versions, the steps' and the FID sampling's launches counted apart
    (:class:`LoopProbe`); checks the rows, FIDs, checkpoints, grids, the
    one R1 step and parameter movement; the loop's images/s against phase
    8's bare step, the FID sweep's sampling / Inception / ``sqrtm`` split,
    checkpoint save and restore seconds and bytes; then a copy of the run
    cut back to checkpoint 10 resumed to 20: the same batches (digests),
    the first resumed step's d_loss within 1e-3 and g_loss within 2e-2,
    later steps logged beside a second resume (the card's nondeterminism);
17. the Inception features of 16 frames on the card against the CPU
    (1e-3 of max), and 4 run_id-0 steps through ``train()`` (kernel 6
    launched);
18. data parallelism's production backend: ``initialize_distributed``
    with NCCL, world size 1, in this process, and ``train(group=...)`` at
    run_id 8, the same full width, batch 16, a fresh 512-frame render
    dataset: every counter 0, then 5 steps (R1 on the fifth: r1_interval
    5), a row every step, the random-weight FID on 512 samples at steps 0
    and 5; checks the rows, three mean all-reduces a step (D's gradient,
    G's, the metrics) and kernels 1-5 in the steps; the plain steps'
    images/s beside phase 16's;
19. two data-parallel ranks on the one card, spawned with the gloo
    backend (NCCL refuses two ranks on one device), global batch 16 (8 a
    rank), each through ``train()``: run_id 8 for 5 steps (R1 on the
    fifth, the FID baseline on rank 0, a checkpoint at 5), both ranks
    resumed from it to step 7, then 2 run_id-0 steps; checks the ranks'
    G, D and EMA bit-equal after every step (digests), rows and grids from
    rank 0 only, ``used_samples`` = steps x 16, kernels 1-5 on each rank
    (and 6 under run_id 0; counters 0 just before each run, read just
    after), and the all-reduced D gradient of the first step against the
    mean of the two half-batch D gradients computed here from the same
    state and batches (``DP_GRAD_RTOL`` of its norm; the reduction itself
    bit for bit against the ranks' own gradients); prints the
    all-reduce share of a step and the ranks' combined images/s (a
    correctness configuration: the ranks time-slice one card).
20. the generation path: every figure script of ``gif_tpu_torch.scripts``
    once at ``--tiny`` (FLAME-sized mesh, 32 px) on the card and on the
    CPU, held together end to end (conditions, the card's G on the CPU's
    conditions, landmarks, stolen textures); then at run_id 0's full width
    (256 px, 512 channels, 69158 identities, bf16 convs) from a trees
    pickle written from a seeded port train state, every counter 0 just
    before: ``generate_random_samples`` (64 samples, batch 16; its first
    batch held launch by launch to the plain versions),
    ``role_of_different_parameters`` (2 pairs), ``generate_gif`` (4
    keyframes x 8 steps), ``animate_teaser`` (8 steps a sweep), ``teaser``
    (1 identity with ``--steal_textures``, every launch held) and
    ``landmark_overlay`` (8 samples, ``--reinferred`` the same fits, so the
    error reads 0); checks the files, finite images, render overflow 0,
    kernels 1-4 launched and 5-6 not; prints generate_random_samples'
    images/s; then the library calls: a style-mixed G forward against the
    plain kernels, ``get_visibility`` / ``get_visibility_z`` (batch 8, 256
    px) equal to the plain rasterizer's, ``FlameRenderer`` with
    ``constant_albedo`` (one raster launch, no sampler launch, maps equal
    to the plain render).
21. the resampling modes, the bench and the new tools: the run_id-8 R1
    step at full width (batch 16) under each resampling mode
    (``GIF_TPU_TORCH_RESAMPLE`` legacy / even / phase) from
    one seeded state and batch — G's bf16 images against the same G in f32,
    the recorded warm-up R1 step (every launch held to its plain version)
    against legacy's losses, 3 counted steps (counters 0 just before, read
    just after; ``phase`` launches kernel 4 fewer times), step times with
    the modes in turns; ``python -m gif_tpu_torch.bench`` for run_id 8 and
    0 in their own processes (the JSON line echoed); ``profile_step``
    (run_id 8 and 0), ``mfu_report`` at the bench's images/s and
    ``blur_hw_check``; the eye-camera regressor on the FLAME-sized mesh
    (solver targets and training on the card, rows/s, held-out MSE below
    the mean's); the deterministic resume in its own process with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (``train(deterministic=True)``: 10
    steps, checkpoint at 5, resumed: every resumed step's d_loss and
    g_loss and the final weights bit-equal; kernel 6's fixed-order
    accumulate and ``index_add_`` bit-equal across two calls; the flag's
    cost on bare steps); ``python -m gif_tpu_torch.serve --ckpt`` on that
    run's checkpoint against a ``FlameSampler`` from it; and both
    converters on fabricated inputs at the real sizes, timed.  Phase 16's
    resume check stays as it was for the default, non-deterministic mode.
22. the study and analysis scripts (:func:`study_scripts`): four of them
    at ``--tiny`` on the card and the CPU under phase 20's bars, then at
    run_id 0's full width with counted launches — ``mturk_stimuli`` in
    both modes, ``voca_animation`` frames and grid,
    ``compute_fid_for_models`` (512 samples, sigmas 0 and 1: sigma 0 reads
    0 within the host ``sqrtm``'s rounding, below sigma 1),
    ``show_training_data``; a 10-step run_id-8 run of the training CLI in
    a counted child process and ``recon_trend`` on its checkpoints;
    ``raster_sensitivity`` (40 deterministic steps, each arm a counted
    child: kernel 1 only in the ``cuda`` arm, kernels 1-5 and 4's VJP
    there, the first step held launch by launch; the ratio at most 1.5)
    and one batch rasterized bit-equal under both backends; the host-only scripts on
    what these wrote.  Prints each script's host seconds and images/s.
23. the port at full width against the JAX package's goldens
    (:func:`full_width_goldens`, ``tests/golden/torch_full_width.npz``):
    weights rebuilt from the name-keyed seeding rule, every counter 0, then
    FLAME decode, the condition render, G (run_id 8 and 0 in f32, run_id 8
    under bf16), D's scores and parameter gradient, ``FlameSampler.sample``,
    the texture steal with ``sample_at_points`` and their image gradients,
    and six R1 train steps on 4 rows — run_id 8 and fused run_id 0 in f32,
    the bench's own step (run_id 8, bf16) and fused run_id 0 under bf16,
    run_id 8 with every branch and fused run_id 0 with the direct gradient
    in f32 —, every output held to its golden at its bar (a bf16 output's
    widened to ``BF16_K`` times ``gif_tpu``'s own bf16-vs-f32 distance),
    TF32 off; all seven kernels launched, the scatter in each run_id-0
    step; then each step again: one line per output with its max abs
    error, relative L2, bar, ``gif_tpu``'s bf16-vs-f32 distance for a bf16
    case, and the spread between the two identical calls on the card with
    its share of the bar.
24. StyleGAN3-T's filtered leaky ReLU (:func:`filtered_lrelu_phase`,
    ``csrc/filtered_lrelu.cu``): the wrapper ``filtered_lrelu`` against
    ``filtered_lrelu_plain``, forward and backward (dx and the bias
    gradient), at the first layer of the 1024 px schedule of each (up,
    down) and dtype, batch 4, in the layer's dtype, at the card tests'
    bars; then the ``stylegan3-t-ffhq1024`` preset at batch 4 through
    ``make_train_step``: a warm-up (R1) step, both launch counters 0 just
    before a plain step and read just after (28 forward launches, 14
    backward), that step's launches recorded by shape and replayed behind
    a device spin beside their bound (``benchmark/harness/flops_sg3.py``
    ``launch_counts``: max(bytes / 3.35 TB/s, f32 ops / 67 TFLOP/s)).
    ``python3 chip_smoke.py --filtered-lrelu`` builds the kernels and runs
    this phase alone.

Times: ``ms``, ``plain_ms`` and ``library_ms`` are device time per call
from CUDA events around 20 calls (plain versions: 3) queued behind a
device-side spin (:func:`queued_ms`), so host launch overhead is excluded
except where a call waits on the device (the plain rasterizer and
scatter); kernel 1's ``ms`` is its whole call (clear, bin, rank, cover,
large walks, resolve: it never waits on the host), with each step's share
(``clear_ms`` ... ``resolve_ms``: :func:`step_times`), as kernel 6's
(``clear_ms``, ``bin_ms``, ``accumulate_ms``); ``wall_ms`` is a CUDA-event
time per call over back-to-back calls, which includes host overhead.  Every number of a kernel
record is a sum over its launches of one R1 train step (batch 16), each
distinct input timed once: run_id 8's at the top (the scatter's: run_id
0's), run_id 0's under ``run_id0``; the forward kernels also carry the same
numbers for one served batch of 8 under ``serve``.  A profile's busy share
is the union of its device events' intervals over the host clock.

The last lines are one JSON object with a record per kernel (``launches``:
the counted run_id-8 train steps'; ``serve.launches``: the counted served
requests'; ``run_id0.launches``: the counted run_id-0 steps';
``run_id8_reg``, ``run_id0_direct`` and ``render_grad``: phases 13-15's
counted launches; ``loop``: phases 16-17's, the ``train()`` run's and its
split; ``data_parallel``: phase 18's steps' and each phase-19 rank's
per run; ``generation``: phase 20's six full-width scripts';
``phase21``: the counted launches of each resampling mode's 3 steps and
of its recorded warm-up step, the deterministic run's and its resume's
(kernel 6 also its fixed-order timing); ``scripts22``: phase 22's
launches in all and by script (training children by arm); ``goldens23``:
phase 23's launches; kernel 6's
``albedo``: its numbers at the albedo
lookup's gradient; phase 24's two filtered-leaky-ReLU records, their
launches those of one batch-4 plain step), the card's name and power
limit as nvidia-smi reports them, and the result line.
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
SPIN_CYCLES = 20_000_000  # ~10 ms at the H100's 1.98 GHz SM clock


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


def _device_events(prof) -> list:
    """The kernels, copies and memsets of a finished profile: its device
    events without the user-annotation ranges (``Optimizer.step#...``) the
    profiler also lays on the device timeline, which span kernels that
    have events of their own."""
    import torch

    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def _busy_ms(events) -> float:
    """Length of the union of the events' intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted((ev.time_range.start, ev.time_range.end) for ev in events):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def log_profile(prof, wall: float, what: str) -> None:
    """Device busy share and the kernels that take the device time."""
    events = _device_events(prof)
    rows = {}
    for e in events:
        ms, n = rows.get(e.name, (0.0, 0))
        rows[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy, total = _busy_ms(events), sum(ms for ms, _ in rows.values())
    streams = len({getattr(e, "device_resource_id", 0) for e in events})
    log(f"{what}: {wall:.2f} ms host clock under the profiler, device busy {busy:.2f} ms "
        f"({100 * busy / wall:.1f}%: the union of the device events' intervals; their durations "
        f"sum to {total:.2f} ms on {streams} stream(s)), {len(events)} device ops")
    for ms, n, name in sorted(((ms, n, k) for k, (ms, n) in rows.items()), reverse=True)[:20]:
        log(f"  {ms:8.3f} ms  x{n:<4d} {name[:110]}")
    # Kernel 4 runs as several template instances (csrc/blur.cu); their sum.
    blur = [(ms, n) for k, (ms, n) in rows.items() if "blur4_" in k]
    if blur:
        log(f"  {sum(ms for ms, _ in blur):8.3f} ms  x{sum(n for _, n in blur):<4d} all blur4_* rows (kernel 4)")


def queued_ms(fn, iters: int = ITERS) -> float:
    """Device time per call of ``fn``: ``iters`` calls between two CUDA
    events, queued behind a 10 ms device-side spin so that the host's
    launch overhead opens no gaps between them (the kernels' own
    back-to-back gaps stay in).  Where ``fn`` waits on the device, host
    time between its launches is in too.  Every kernel, library and plain
    time is taken so: on the H100, torch.profiler's device events have read
    up to ~40% low in some profiles that held every event, and none at all
    in others.
    """
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
        ms=queued_ms(kernel_fn),
        plain_ms=queued_ms(plain_fn, 3),
        library_ms=None if library_fn is None else queued_ms(library_fn),
        wall_ms=wall_ms(kernel_fn),
    )


def add_times(tot: dict, t: dict) -> None:
    for k, v in t.items():
        tot[k] = None if v is None else tot.get(k, 0.0) + v


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


def _agree(got, want, what: str) -> float:
    """max |got - want|; raises past one bf16 rounding step (2^-7 relative)."""
    d = (got.float() - want.float()).abs()
    assert bool((d <= want.float().abs() * 2.0**-7 + 1e-6).all()), f"{what} disagrees at {tuple(got.shape)}"
    return d.max().item()


KERNELS = {
    "raster": dict(name="raster", route="cuda", source="gif_tpu_torch/csrc/raster.cu",
                   replaces="gif_tpu/render/raster_pallas.py:271"),
    "sampler": dict(name="sampler", route="cuda", source="gif_tpu_torch/csrc/sampler.cu",
                    replaces="gif_tpu/render/sampler_pallas.py:43"),
    "flr": dict(name="fused_bias_lrelu", route="triton", source="gif_tpu_torch/ops/activations.py",
                replaces="gif_tpu/ops/activations.py:41"),
    "flr_bwd": dict(name="fused_bias_lrelu_bwd", route="triton", source="gif_tpu_torch/ops/activations.py",
                    replaces="gif_tpu/ops/activations.py:48"),
    "blur": dict(name="fir_blur", route="cuda", source="gif_tpu_torch/csrc/blur.cu",
                 replaces="gif_tpu/ops/blur_pallas.py:51"),
    "blur_vjp": dict(name="fir_blur_vjp", route="cuda", source="gif_tpu_torch/csrc/blur.cu",
                     replaces="gif_tpu/ops/blur_pallas.py:241"),
    "scatter": dict(name="bilinear_scatter", route="cuda", source="gif_tpu_torch/csrc/scatter.cu",
                    replaces="gif_tpu/render/sampler_pallas.py:129"),
}
RUN8_KERNELS = [k for k in KERNELS if k != "scatter"]  # run_id 8 has no interpolation loss
TOLERANCE = {
    "raster": "tol 0: depth, tri_id, bary, overflow and attributes equal",
    "sampler": "tol 1e-6",
    "flr": "tol 1 bf16 step: 2^-7 relative",
    "flr_bwd": "tol 1 bf16 step: 2^-7 relative",
    "blur": "tol 1 bf16 step: 2^-7 relative",
    "blur_vjp": "tol 1 bf16 step: 2^-7 relative",
    "scatter": "tol max|got - plain| <= 1e-5 max|plain| + 1e-7: atomics add in no fixed order",
}


def _dtype(t) -> str:
    return str(t.dtype).split(".")[-1]


def _signature(kind: str, args) -> tuple:
    """What a launch's cost depends on besides its data: shapes, dtype,
    taps, pads, and for kernels 3-5 the map's memory format."""
    from gif_tpu_torch.ops import layout

    if kind == "raster":
        return (tuple(args[0].shape),) + tuple(args[2:6])
    if kind in ("sampler", "scatter"):
        return tuple(args[0].shape), tuple(args[1].shape)
    fmt = "channels_last" if layout.is_channels_last(args[0]) else "nchw"
    if kind in ("flr", "flr_bwd"):
        return tuple(args[0].shape), _dtype(args[0]), fmt
    return tuple(args[0].shape), _dtype(args[0]), tuple(args[1]), tuple(args[2]), fmt


def _label(kind: str, sig: tuple) -> tuple:
    """A signature without its taps, for the logs."""
    if kind in ("blur", "blur_vjp"):
        return sig[0], sig[1], sig[3], sig[4]
    if kind == "raster":
        return sig[0], f"cap {sig[4]}"
    return sig if kind in ("flr", "flr_bwd") else sig[:2]


def check_raster(args, out) -> dict:
    import torch

    from gif_tpu_torch.render import raster

    fv, attrs, h, w, tile, cap = args
    got, got_img = out
    want, want_img = raster.rasterize_plain(fv, attrs, h=h, w=w, tile=tile, max_tris_per_tile=cap)
    unequal = [name for name, a, b in zip(("depth", "tri_id", "bary", "tile_overflow", "attributes"),
                                          (*got, got_img), (*want, want_img)) if not torch.equal(a, b)]
    assert not unequal, f"raster kernel differs from rasterize_plain at fv {tuple(fv.shape)} in {unequal}"
    return {"max_abs_err": 0.0}


def check_sampler(args, out) -> dict:
    from gif_tpu_torch.render import shading

    err = (out - shading.grid_sample_bilinear(*args)).abs().max().item()
    assert err <= 1e-6, f"sampler kernel disagrees at {tuple(args[1].shape)}: max_abs_err {err:.3g} (tol 1e-6)"
    return {"max_abs_err": err}


def check_scatter(args, out) -> dict:
    from gif_tpu_torch.render import sampling_ops

    want = sampling_ops.scatter_bilinear_plain(*args)
    err, bar = (out - want).abs().max().item(), 1e-5 * want.abs().max().item() + 1e-7
    assert err <= bar, f"scatter kernel disagrees at {tuple(args[0].shape)}: max_abs_err {err:.3g} (tol {bar:.3g})"
    return {"max_abs_err": err}


def check_flr(args, out) -> dict:
    from gif_tpu_torch.ops import activations

    return {"max_abs_err": _agree(out, activations.fused_leaky_relu_plain(*args), "flr kernel")}


def check_flr_bwd(args, out) -> dict:
    from gif_tpu_torch.ops import activations

    return {"max_abs_err": _agree(out, activations.fused_leaky_relu_backward_plain(*args), "flr bwd kernel")}


def check_blur(args, out) -> dict:
    from gif_tpu_torch.ops import blur_cuda

    x, taps, pads, _ = args
    return {"max_abs_err": _agree(out, blur_cuda.blur4_plain(x, taps, pads), "blur kernel")}


class LaunchRecorder:
    """While active, every launch of the seven kernels is held to its plain
    version on the spot, on the inputs the wrapper received (the checks
    launch nothing), and noted by its signature.  A raster launch opens a
    new round: each served batch and each train step renders first.
    ``rounds[i][kind][signature]`` is ``{"n": launches, "args": the first
    such launch's inputs}``; ``stats[kind]`` holds the largest errors."""

    def __enter__(self):
        import torch

        from gif_tpu_torch.ops import activations, blur_cuda
        from gif_tpu_torch.render import raster_cuda, sampler_cuda, scatter_cuda

        self.rounds = []
        self.stats = {k: {} for k in KERNELS}
        self.saved = []
        # The incoming gradients of blur VJPs that Blur4Function.backward
        # must copy to the memory format of the map it differentiates
        # first (cuDNN hands some back in the other one): (shape, stride,
        # dtype, that format is channels-last) -> count.
        self.vjp_copies = {}
        orig_bwd = blur_cuda.Blur4Function.__dict__["backward"]

        def backward(ctx, g):
            fmt = torch.channels_last if ctx.channels_last else torch.contiguous_format
            if g.is_cuda and not g.is_contiguous(memory_format=fmt):
                key = (tuple(g.shape), tuple(g.stride()), g.dtype, ctx.channels_last)
                self.vjp_copies[key] = self.vjp_copies.get(key, 0) + 1
            return orig_bwd.__func__(ctx, g)

        self.saved.append((blur_cuda.Blur4Function, "backward", orig_bwd))
        blur_cuda.Blur4Function.backward = staticmethod(backward)

        def blur_kind(args):
            return "blur_vjp" if args[3] is blur_cuda.blur4_vjp else "blur"

        for mod, name, kind_of, check in (
            (raster_cuda, "rasterize_cuda", lambda a: "raster", check_raster),
            (sampler_cuda, "grid_sample_cuda", lambda a: "sampler", check_sampler),
            (activations, "fused_leaky_relu_triton", lambda a: "flr", check_flr),
            (activations, "fused_leaky_relu_backward_triton", lambda a: "flr_bwd", check_flr_bwd),
            (blur_cuda, "_launch", blur_kind, check_blur),
            (scatter_cuda, "scatter_bilinear_cuda", lambda a: "scatter", check_scatter),
        ):
            orig = getattr(mod, name)
            self.saved.append((mod, name, orig))
            setattr(mod, name, self._recording(orig, kind_of, check))
        return self

    def _recording(self, orig, kind_of, check):
        def launch(*args):
            out = orig(*args)
            kind = kind_of(args)
            if kind == "raster":
                self.rounds.append({k: {} for k in KERNELS})
            for k, v in check(args, out).items():
                self.stats[kind][k] = max(self.stats[kind].get(k, 0.0), v)
            rec = self.rounds[-1][kind].setdefault(_signature(kind, args), {"n": 0, "args": args})
            rec["n"] += 1
            return out

        return launch

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)


def step_times(launch, steps, what: str, whole_ms: float) -> dict:
    """``<step>_ms`` for each step of a kernel whose call runs ``steps`` in
    order, one bit each: the queued time of the call cut after the step
    less the call cut before it.  Every cut starts with the first step (a
    clear), so repeating it leaves the same state: a step timed alone on
    the state of an earlier repeat would not (a bin step appends)."""
    out, prev = {}, 0.0
    for i, step in enumerate(steps):
        cut = queued_ms(lambda m=(1 << (i + 1)) - 1: launch(m))
        out[f"{step}_ms"], prev = cut - prev, cut
    log(f"{what} (queued CUDA events; each step the increment it adds to the call cut after it): "
        + ", ".join(f"{step} {out[f'{step}_ms']:.4f} ms" for step in steps) + f"; whole call {whole_ms:.4f} ms")
    return out


def time_raster(fv, attrs, h, w, tile, cap):
    """(times, bytes ms, operations ms, info) of kernel 1 on these inputs:
    its whole call (``ms``: clear the keys, bin, rank, cover, the large
    walks, resolve, all queued on the stream) and each of those steps
    (:func:`step_times`); the call is first run under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
    host-device synchronization."""
    import torch

    from gif_tpu_torch.render import raster, raster_cuda

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        raster_cuda.rasterize_cuda(fv, attrs, h, w, tile, cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t = times(lambda: raster_cuda.rasterize_cuda(fv, attrs, h, w, tile, cap),
              lambda: raster.rasterize_plain(fv, attrs, h=h, w=w, tile=tile, max_tris_per_tile=cap))
    fv_c, attrs_c = raster_cuda.kernel_inputs(fv, attrs, h, w, tile)
    bufs = raster_cuda.raster_buffers(fv_c, attrs_c.shape[-1], h, w, tile)
    raster_cuda.launch_kernel(fv_c, attrs_c, bufs, cap, h, w, tile)
    large_walks = int(bufs["wide"][0])
    t.update(step_times(lambda m: raster_cuda.launch_kernel(fv_c, attrs_c, bufs, cap, h, w, tile, m),
                        raster_cuda.STEPS, f"kernel raster steps at fv {tuple(fv.shape)}, cap {cap}", t["ms"]))
    pairs = bbox_pixel_tests(fv, h, w)
    out_bytes = fv.shape[0] * h * w * (4 + 4 + 12 + 4 * attrs.shape[-1]) + bufs["overflow"].numel()
    counts = raster.bin_faces(fv, tile, cap, h, w)[1].float()
    info = {"bbox_pixel_tests": pairs, "candidates_per_tile_max": int(counts.max()),
            "candidates_per_tile_mean": counts.mean().item(), "large_walks": large_walks}
    return (t, (nbytes(fv, attrs) + out_bytes) / HBM_BYTES_PER_S * 1e3,
            pairs * RASTER_OPS_PER_PAIR / F32_OPS_PER_S * 1e3, info)


def time_sampler(img, grid):
    import torch.nn.functional as F

    from gif_tpu_torch.render import sampler_cuda, shading

    img_nchw = img.permute(0, 3, 1, 2)

    def library():
        return F.grid_sample(img_nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=False)

    got = sampler_cuda.grid_sample_cuda(img, grid)
    lib_diff = (library().permute(0, 2, 3, 1) - got).abs().max().item()
    t = times(lambda: sampler_cuda.grid_sample_cuda(img, grid),
              lambda: shading.grid_sample_bilinear(img, grid), library)
    # Per call site (the albedo lookup, the texture steal), by grid shape.
    at = "x".join(map(str, grid.shape))
    return t, nbytes(img, grid, got) / HBM_BYTES_PER_S * 1e3, 0.0, {
        "library_max_diff": lib_diff, f"ms_at_grid_{at}": t["ms"], f"library_ms_at_grid_{at}": t["library_ms"],
        f"ms_over_library_at_grid_{at}": t["ms"] / t["library_ms"]}


def time_flr(x, bias, neg, scale):
    from gif_tpu_torch.ops import activations

    t = times(lambda: activations.fused_leaky_relu_triton(x, bias, neg, scale),
              lambda: activations.fused_leaky_relu_plain(x, bias, neg, scale))
    return t, (2 * nbytes(x) + nbytes(bias)) / HBM_BYTES_PER_S * 1e3, 0.0, {}


def time_flr_bwd(x, bias, g, neg, scale):
    from gif_tpu_torch.ops import activations

    t = times(lambda: activations.fused_leaky_relu_backward_triton(x, bias, g, neg, scale),
              lambda: activations.fused_leaky_relu_backward_plain(x, bias, g, neg, scale))
    # Read x and g, write dx (x's dtype).
    return t, (2 * nbytes(x) + nbytes(g, bias)) / HBM_BYTES_PER_S * 1e3, 0.0, {}


def time_blur(x, taps, pads, _counter):
    """Kernel 4 forward; the library is a depthwise ``F.conv2d`` with the
    same (correlation) taps."""
    import torch
    import torch.nn.functional as F

    from gif_tpu_torch.ops import blur_cuda

    assert pads[0] == pads[1] == pads[2] == pads[3], pads
    c = x.shape[1]
    k1 = torch.tensor(taps, device=x.device, dtype=x.dtype)
    k2 = (k1[:, None] * k1[None, :]).expand(c, 1, 4, 4).contiguous()
    got = blur_cuda.blur4_cuda(x, taps, pads)
    lib_diff = (F.conv2d(x, k2, padding=pads[0], groups=c).float() - got.float()).abs().max().item()
    t = times(lambda: blur_cuda.blur4_cuda(x, taps, pads),
              lambda: blur_cuda.blur4_plain(x, taps, pads),
              lambda: F.conv2d(x, k2, padding=pads[0], groups=c))
    return t, nbytes(x, got) / HBM_BYTES_PER_S * 1e3, 0.0, {"library_max_diff": lib_diff, "_map": got.shape[-1]}


def time_blur_vjp(g, taps, pads, _counter):
    """Kernel 4's VJP launch on gradient ``g``; the library computes the
    same input gradient as the autograd backward of the depthwise
    ``F.conv2d`` this launch is the VJP of (taps reversed, pads 3 - p)."""
    import torch
    import torch.nn.functional as F

    from gif_tpu_torch.ops import blur_cuda

    nb, c, ho, wo = g.shape
    fpads = tuple(3 - p for p in pads)
    assert fpads[0] == fpads[1] == fpads[2] == fpads[3], fpads
    xin = torch.zeros((nb, c, ho - 2 * fpads[0] + 3, wo - 2 * fpads[0] + 3), dtype=g.dtype,
                      device=g.device, requires_grad=True)
    k1 = torch.tensor(taps[::-1], device=g.device, dtype=g.dtype)
    k2 = (k1[:, None] * k1[None, :]).expand(c, 1, 4, 4).contiguous()
    y = F.conv2d(xin, k2, padding=fpads[0], groups=c)

    def library():
        return torch.autograd.grad(y, xin, g, retain_graph=True)[0]

    got = blur_cuda.blur4_cuda(g, taps, pads)
    lib_diff = (library().float() - got.float()).abs().max().item()
    t = times(lambda: blur_cuda.blur4_cuda(g, taps, pads),
              lambda: blur_cuda.blur4_plain(g, taps, pads), library)
    return t, (nbytes(g) + nbytes(got)) / HBM_BYTES_PER_S * 1e3, 0.0, {"library_max_diff": lib_diff,
                                                                    "_map": got.shape[-1]}


def time_scatter(g, pts, h, w):
    """Kernel 6; the library is the image gradient of ``F.grid_sample`` at
    the same points: one ``aten::grid_sampler_2d_backward`` with only the
    input mask set, on NCHW inputs prepared outside the timed call."""
    import torch

    from gif_tpu_torch.render import sampling_ops, scatter_cuda

    b, p, c = g.shape
    g_nchw = g.permute(0, 2, 1)[..., None].contiguous()  # (B, C, P, 1)
    img_nchw = torch.zeros((b, c, h, w), device=g.device)
    grid = pts[:, :, None, :].contiguous()

    def library():
        return torch.ops.aten.grid_sampler_2d_backward(g_nchw, img_nchw, grid, 0, 0, False, [True, False])[0]

    got = scatter_cuda.scatter_bilinear_cuda(g, pts, h, w)
    lib_diff = (library().permute(0, 2, 3, 1) - got).abs().max().item()
    t = times(lambda: scatter_cuda.scatter_bilinear_cuda(g, pts, h, w),
              lambda: sampling_ops.scatter_bilinear_plain(g, pts, h, w), library)
    g_c, pts_c, bufs = scatter_cuda.scatter_buffers(g, pts, h, w)
    t.update(step_times(lambda m: scatter_cuda.launch_kernel(g_c, pts_c, bufs, m), scatter_cuda.STEPS,
                        f"kernel bilinear_scatter steps at g {tuple(g.shape)}", t["ms"]))
    # The points' footprint: distinct texels their valid taps hit, per point.
    ids, _, ok = sampling_ops.tap_data(h, w, pts)
    footprint = sum(torch.unique(ids[i][ok[i]]).numel() for i in range(b)) / (b * p)
    geo = scatter_cuda.scatter_launch_geometry(b, h, w, c, torch.cuda.get_device_properties(g.device).multi_processor_count)
    log(f"kernel bilinear_scatter at g {tuple(g.shape)}: {footprint:.4f} distinct texels hit per point "
        f"({4 * footprint:.2f} per point's 4 taps at most); windows {geo}")
    return t, nbytes(g, pts, got) / HBM_BYTES_PER_S * 1e3, 0.0, {"library_max_diff": lib_diff,
                                                                "texels_per_point": footprint}


TIMERS = {"raster": time_raster, "sampler": time_sampler, "flr": time_flr, "flr_bwd": time_flr_bwd,
          "blur": time_blur, "blur_vjp": time_blur_vjp, "scatter": time_scatter}


def time_round(groups: dict, stats: dict, per: str) -> dict:
    """Every kernel of one recorded round, timed once per distinct
    signature and scaled by its launch count, with its bound; returns
    {kind: record fields} and logs one line per kernel."""
    out = {}
    for kind, sigs in groups.items():
        if not sigs:
            continue
        tot, t_bytes, t_ops, info, by_map = {}, 0.0, 0.0, {}, {}
        for rec in sigs.values():
            t, b, o, extra = TIMERS[kind](*rec["args"])
            n = rec["n"]
            add_times(tot, {k: None if v is None else n * v for k, v in t.items()})
            t_bytes, t_ops = t_bytes + n * b, t_ops + n * o
            if "_map" in extra:  # kernel 4: launches, ms and bound by output map width
                m = by_map.setdefault(extra.pop("_map"), {"launches": 0, "ms": 0.0, "bound_ms": 0.0})
                m["launches"] += n
                m["ms"] += n * t["ms"]
                m["bound_ms"] += n * b
            for k, v in extra.items():
                info[k] = max(info.get(k, v), v)
        if by_map:
            info["share_of_bound_by_map"] = {
                w: {**m, "share": m["bound_ms"] / m["ms"]} for w, m in sorted(by_map.items())}
        n = sum(r["n"] for r in sigs.values())
        bound_by = "operations" if t_ops > t_bytes else "bytes"
        out[kind] = dict(max_abs_err=stats[kind]["max_abs_err"], bound_ms=max(t_bytes, t_ops),
                         bound_by=bound_by, per=per, launches_per=n, **tot,
                         **{k: v for k, v in stats[kind].items() if k != "max_abs_err"}, **info)
        extras = {k: v for k, v in out[kind].items() if k not in (
            "max_abs_err", "bound_ms", "bound_by", "per", "launches_per", "ms", "plain_ms",
            "library_ms", "wall_ms")}
        lib = "none" if tot["library_ms"] is None else f"{tot['library_ms']:.4f}"
        log(f"kernel {KERNELS[kind]['name']} ({per}): {n} launches, {len(sigs)} distinct inputs; "
            f"max_abs_err {stats[kind]['max_abs_err']:.3g} ({TOLERANCE[kind]}); ms {tot['ms']:.4f} (wall "
            f"{tot['wall_ms']:.4f}) plain_ms {tot['plain_ms']:.4f} library_ms {lib} bound_ms "
            f"{max(t_bytes, t_ops):.4f} ({bound_by}: bytes {t_bytes:.4f}, operations {t_ops:.4f}); "
            f"{extras}; inputs {sorted((_label(kind, sig), r['n']) for sig, r in sigs.items())}")
    return out


def time_vjp_copies(copies: dict, what: str) -> dict:
    """Device time of the gradient copies Blur4Function.backward made in
    front of kernel 4's VJP launches of one recorded step, each into the
    memory format of the map it differentiates: each (shape, stride,
    dtype, format) timed once on a tensor of that layout, times its
    count."""
    import torch

    total_ms, n, layouts = 0.0, 0, {}
    for (shape, stride, dtype, cl), k in copies.items():
        src = torch.empty_strided(shape, stride, dtype=dtype, device="cuda").normal_()
        fmt = torch.channels_last if cl else torch.contiguous_format
        total_ms += k * queued_ms(lambda: src.contiguous(memory_format=fmt))
        n += k
        layout = "channels_last" if src.is_contiguous(memory_format=torch.channels_last) else "other"
        key = f"{layout} to {'channels_last' if cl else 'contiguous'}"
        layouts[key] = layouts.get(key, 0) + k
    log(f"blur VJP gradient copies ({what}): {n} of the step's VJP launches got a gradient in another format "
        f"than their map {layouts}; the copies take {total_ms:.4f} ms of device time (queued CUDA events, "
        f"{len(copies)} distinct layouts)")
    return {"g_copies_per_step": n, "g_copy_ms_per_step": total_ms, "g_copy_layouts": layouts}


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
    log_profile(prof, wall, "phase profile: batch of 8")


TRAIN_BATCH = 16


def train_batch(cfg, n: int, device, seed: int = 0) -> dict:
    """bench.py's seeded batch (bench.py:50-62): shape x0.1, pose x0.05,
    camera scale 8, SH band 3.0, uniform real images; identities drawn
    over the whole vocabulary."""
    import torch

    rng = np.random.default_rng(seed)
    s = cfg.max_size
    flame = np.zeros((n, 236), np.float32)
    flame[:, :100] = rng.standard_normal((n, 100)).astype(np.float32) * 0.1
    flame[:, 150:156] = rng.standard_normal((n, 6)).astype(np.float32) * 0.05
    flame[:, 156] = 8.0
    flame[:, 209:212] = 3.0
    batch = {
        "real_image": rng.uniform(-1, 1, (n, s, s, 3)).astype(np.float32),
        "flame": flame,
        "indices": rng.integers(0, cfg.embedding_vocab_size, n),
    }
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _param_snapshot(module):
    return [p.detach().clone() for p in module.parameters()]


def _moved(before, module) -> float:
    return sum((a - p.detach()).abs().mean().item() for a, p in zip(before, module.parameters()))


def run_train_steps(step, state, batch, counters, n_steps: int = 3):
    """The counted main path: every counter set to 0 just before, read just
    after.  Returns (per-step [(step index, seconds, metrics, launches)],
    launches, peak bytes, moved)."""
    import torch

    before = {k: _param_snapshot(getattr(state, k)) for k in ("generator", "discriminator", "g_ema")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    steps = []
    for _ in range(n_steps):
        i = state.step
        prev = {k: fn.launches for k, fn in counters.items()}
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps.append((i, dt, {k: v.item() for k, v in m.items()},
                      {k: fn.launches - prev[k] for k, fn in counters.items()}))
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    moved = {k: _moved(v, getattr(state, k)) for k, v in before.items()}
    return steps, launches, peak, moved


def profile_train_step(step, state, batch, r1: bool, what: str = "one step"):
    """One more train step (with or without R1, by setting ``state.step``)
    under torch.profiler: device busy share and the kernels that take the
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state.step = 15 if r1 else 16  # r1_interval 16: (15 + 1) % 16 == 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    assert (m["r1"].item() > 0) == r1
    log_profile(prof, wall, f"phase train profile: {what} (batch {TRAIN_BATCH}, {'with' if r1 else 'no'} R1)")


def event_ms(fn, iters: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``iters`` synchronized calls
    after one warm-up call."""
    import torch

    out = []
    for _ in range(iters + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return float(np.median(out[1:]))


def time_r1_parts(state, batch, cfg, res) -> None:
    """Where an R1 step's extra time goes, at the train shapes: CUDA-event
    times of D's loss forward + parameter backward (every step runs it),
    of R1's own forward (D(real) and its input gradient, graph kept) and
    of R1's parameter backward (the double backward) alone; then a profile
    of the last, naming the ops that launched its slowest kernels."""
    import torch

    from gif_tpu_torch.device import second_order_safe
    from gif_tpu_torch.train import losses
    from gif_tpu_torch.train.step import render_condition_maps

    disc = state.discriminator
    params = list(disc.parameters())
    real = batch["real_image"]
    with torch.no_grad():
        cond = render_condition_maps(res, batch["flame"], cfg, res.n_faces)
        fake = state.generator(cond, input_indices=batch["indices"], step=cfg.max_step)

    def d_loss_grads():
        torch.autograd.grad(losses.d_ns_loss(disc(real, cond), disc(fake, cond)), params)

    def r1_forward():
        return losses.r1_penalty(disc, real, cond, cfg.r1_weight)

    t_d, t_fwd = event_ms(d_loss_grads), event_ms(r1_forward)
    r1 = r1_forward()

    def r1_backward():
        with second_order_safe(real.device):
            torch.autograd.grad(r1, params, retain_graph=True, materialize_grads=True)

    t_bwd = event_ms(r1_backward)
    log(f"phase r1 parts (full-width D, batch {TRAIN_BATCH}, CUDA events, median of 3): D loss "
        f"forward + parameter backward {t_d:.2f} ms; R1 forward (D(real) + input gradient, graph "
        f"kept) {t_fwd:.2f} ms; R1 parameter backward (double backward) {t_bwd:.2f} ms")
    profile_by_op(r1_backward, "phase r1 profile: R1's parameter backward alone")
    del r1


def profile_by_op(fn, what: str) -> None:
    """One call of ``fn`` under torch.profiler: device busy share, the
    kernels that take the device time, and the ops that launched the
    slowest of them (with their input shapes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    log_profile(prof, wall, what)
    by_op = {}
    for e in prof.events():
        for k in getattr(e, "kernels", []):
            key = (e.name, str(e.input_shapes)[:150], k.name[:60])
            ms, n = by_op.get(key, (0.0, 0))
            by_op[key] = (ms + k.duration / 1e3, n + 1)
    for (op, shapes, kernel), (ms, n) in sorted(by_op.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"  {ms:8.3f} ms  x{n:<3d} {op} {shapes} -> {kernel}")


class plain_kernels:
    """Route the kernel launchers of kernels 3-5 to their plain versions on
    CUDA tensors (the autograd Functions around them stay)."""

    def __enter__(self):
        from gif_tpu_torch.ops import activations, blur_cuda

        self.saved = [(activations, "fused_leaky_relu_triton"),
                      (activations, "fused_leaky_relu_backward_triton"),
                      (blur_cuda, "blur4_cuda")]
        self.saved = [(m, n, getattr(m, n)) for m, n in self.saved]
        activations.fused_leaky_relu_triton = activations.fused_leaky_relu_plain
        activations.fused_leaky_relu_backward_triton = activations.fused_leaky_relu_backward_plain
        blur_cuda.blur4_cuda = blur_cuda.blur4_plain
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def r1_param_grads(disc, real, cond):
    import torch

    from gif_tpu_torch.device import second_order_safe
    from gif_tpu_torch.train import losses

    r1 = losses.r1_penalty(disc, real, cond, 5.0)
    with second_order_safe(real.device):
        return torch.autograd.grad(r1, list(disc.parameters()), materialize_grads=True)


def check_r1_narrow(counters):
    """R1's parameter gradient (grad-of-grad through kernels 3-5) on a
    narrow discriminator — max_channels 64, 64 px, batch 4, f32 — through
    the kernels and through the plain versions, both on the card; then the
    bf16 policy's against f32."""
    import torch

    from gif_tpu_torch.models.discriminator import Discriminator

    rng = np.random.default_rng(3)
    real = torch.as_tensor(rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32), device="cuda")
    cond = torch.as_tensor(rng.uniform(-1, 1, (4, 64, 64, 6)).astype(np.float32), device="cuda")
    d32 = Discriminator(size=64, max_channels=64, generator=torch.Generator().manual_seed(3)).cuda()
    prev = {k: fn.launches for k, fn in counters.items()}
    got = r1_param_grads(d32, real, cond)
    torch.cuda.synchronize()
    used = {k: fn.launches - prev[k] for k, fn in counters.items()}
    # D runs channels-last: its launches are the channels-last variants'.
    assert all(used[k + "_cl"] > 0 for k in ("fused_bias_lrelu", "fused_bias_lrelu_bwd", "fir_blur", "fir_blur_vjp")), used
    with plain_kernels():
        want = r1_param_grads(d32, real, cond)
    err = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item() for a, b in zip(got, want))
    log(f"phase r1 check (D max_channels 64, 64 px, batch 4, f32): R1 parameter gradient through the "
        f"kernels vs the plain versions, max |diff| / max |plain| per tensor {err:.3g} (tol 1e-4: "
        f"cuDNN's weight-gradient algorithms may sum in another order); launches {used}")
    assert err <= 1e-4, err
    d16 = Discriminator(size=64, max_channels=64, dtype=torch.bfloat16).cuda()
    d16.load_state_dict(d32.state_dict())
    g16 = r1_param_grads(d16, real, cond)
    # The act_bias gradients of R1 are ~1e-7, mostly bf16 rounding: the
    # weights' directions and the whole gradient's error are what can show
    # a fault (a wrong double backward reads cosine ~0.1).
    cos = min(
        (torch.dot(a.flatten().double(), b.flatten().double()) / a.double().norm() / b.double().norm()).item()
        for a, b in zip(g16, want) if b.ndim >= 2
    )
    fa, fb = (torch.cat([t.flatten().double() for t in g]) for g in (g16, want))
    rel = ((fa - fb).norm() / fb.norm()).item()
    log(f"  bf16 policy vs f32: min cosine of the weights' R1 gradients {cos:.4f} (tol >= 0.98), whole "
        f"R1 gradient relative L2 error {rel:.4f} (tol 0.1)")
    assert cos >= 0.98 and rel <= 0.1, (cos, rel)


def check_train_against_cpu_plain(run_id: int):
    """Tiny config: one train step (R1 on) on the card against the CPU plain
    path, from one seeded state; gradients from the same conditions.  Under
    the interpolation loss (run_id 0) both take the same injected draws,
    and G's gradient adds the penalty of interpolants rendered once on the
    CPU."""
    import torch

    from gif_tpu_torch.flame.resources import synthetic_flame_resources
    from gif_tpu_torch.train import losses as L
    from gif_tpu_torch.train.config import TINY_OVERRIDES, get_config
    from gif_tpu_torch.train.state import create_train_state
    from gif_tpu_torch.train.step import (
        d_loss_and_grads,
        g_loss_and_grads,
        make_train_step,
        render_condition_maps,
        render_flame_maps,
    )

    cfg = get_config(run_id, **{**TINY_OVERRIDES, "embedding_vocab_size": 16, "batch_size": 4, "r1_interval": 2})
    res = synthetic_flame_resources(seed=1, n_vertices=503)
    interp = cfg.apply_texture_space_interpolation_loss
    draws = {"interp_t": 0.375, "interp_identity": 5, "interp_pairs": np.array([2, 0, 1])}
    devs = ("cuda", "cpu")
    states = {d: create_train_state(cfg, seed=0, device=d) for d in devs}
    for a, b in zip(states["cuda"].generator.state_dict().values(), states["cpu"].generator.state_dict().values()):
        assert torch.equal(a.cpu(), b)
    batches = {d: train_batch(cfg, 4, d, seed=1) for d in devs}
    with torch.no_grad():
        conds = {d: render_condition_maps(res, batches[d]["flame"], cfg, res.n_faces) for d in devs}
        if interp:
            flm = L.interpolate_flame_batch(batches["cpu"]["flame"], draws["interp_t"])
            maps = render_flame_maps(res, L.interp_render_flame(flm), cfg.render_image_size, res.n_faces)
            icond = L.interp_condition_channels(
                maps.textured, maps.normal, rendered_flame_as_condition=cfg.rendered_flame_as_condition,
                normal_maps_as_cond=cfg.normal_maps_as_cond)
    diff = (conds["cuda"].cpu() - conds["cpu"]).abs()
    step8 = 2.0 / 255.0
    flips = (diff > step8 * 0.5).float().mean().item()
    assert diff.max().item() <= step8 * 1.001 and flips < 0.005, "render disagrees"
    grads, mets = {}, {}
    for d in devs:
        st, b = states[d], batches[d]
        cond = conds["cpu"].to(d)
        g_in, idx, interp_fn = cond, b["indices"], None
        if interp:
            g_in = torch.cat([cond, icond.to(d)])
            idx = torch.cat([idx, torch.full((3,), draws["interp_identity"], device=d)])
        fake_live = st.generator(g_in, input_indices=idx, step=cfg.max_step)
        _, _, dg = d_loss_and_grads(st.discriminator, b["real_image"], cond, fake_live[:4].detach(), cfg, True)
        if interp:
            frm = torch.as_tensor(res.face_region_mask, device=d)

            def interp_fn():
                return L.interp_penalty_from_images(res, fake_live[4:], flm.to(d), draws["interp_pairs"], frm)
        _, _, _, gg, _ = g_loss_and_grads(st.generator, st.discriminator, fake_live, cond, interp_fn)
        grads[d] = [t.cpu() for t in (*dg, *gg)]
        st.step = 1  # (1 + 1) % 2 == 0: R1 fires
        _, m = make_train_step(cfg, res, device=d, max_tris_per_tile=res.n_faces)(st, b, draws)
        mets[d] = {k: v.item() for k, v in m.items()}
    g_err = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                for a, b in zip(grads["cuda"], grads["cpu"]))
    keys = ("d_loss", "g_loss", "r1", "g_total") + (("interp",) if interp else ())
    m_err = max(abs(mets["cuda"][k] - mets["cpu"][k]) / max(abs(mets["cpu"][k]), 1e-12) for k in keys)
    log(f"cuda vs cpu plain (tiny run_id-{run_id} train step, 503-vertex mesh, 32 px, batch 4, R1 on"
        f"{', injected interpolation draws' if interp else ''}): cond one-step flips {flips:.4f} (tol 0.005); "
        f"D and G gradients from the same conditions, max |diff| / max |cpu| per tensor {g_err:.3g} (tol "
        f"1e-3); step metrics max relative diff {m_err:.3g} (tol 1e-2, conditions rendered on each device); "
        f"cuda {mets['cuda']} cpu {mets['cpu']}")
    assert g_err <= 1e-3 and m_err <= 1e-2 and mets["cuda"]["r1"] > 0
    assert not interp or mets["cuda"]["interp"] > 0


def train_run_id0(res, counters: dict, smi: str):
    """The run_id-0 train step at full width (the paper's flagship preset:
    the texture-space interpolation loss, fused into one render and one G
    forward over 2B - 1 rows).  One recorded warm-up R1 step holds every
    launch of all seven kernels to its plain version and times them at
    these shapes; then 3 counted steps from step 13 (R1 on the third) and a
    profile of one more step without R1.  Returns (kernel record fields,
    counted launches)."""
    import torch

    from gif_tpu_torch.train.config import get_config
    from gif_tpu_torch.train.state import create_train_state
    from gif_tpu_torch.train.step import make_train_step

    t0 = time.perf_counter()
    cfg = get_config(0, batch_size=TRAIN_BATCH)
    state = create_train_state(cfg, seed=0)
    step = make_train_step(cfg, res, max_tris_per_tile=res.n_faces, generator=torch.Generator().manual_seed(0))
    batch = train_batch(cfg, TRAIN_BATCH, "cuda")
    n_texels = len(res.texture_x_coords)
    log(f"phase run_id-0 setup: {cfg.max_size} px, max_channels {cfg.max_channels}, {cfg.compute_dtype}, batch "
        f"{TRAIN_BATCH} (+{TRAIN_BATCH - 1} interpolants in the fused G forward), r1_interval {cfg.r1_interval}, "
        f"adaptive_interp_loss {cfg.adaptive_interp_loss}, {n_texels} valid texels: {time.perf_counter() - t0:.2f} s")
    state.step = cfg.r1_interval - 1
    t0 = time.perf_counter()
    with LaunchRecorder() as rec:
        state, m0 = step(state, batch)
        m0 = {k: v.item() for k, v in m0.items()}
    log(f"phase run_id-0 warm-up (R1) step incl. the on-the-spot checks of every kernel launch: "
        f"{time.perf_counter() - t0:.2f} s; metrics {m0}")
    assert m0["r1"] > 0 and m0["interp"] > 0 and len(rec.rounds) == 1, (m0, len(rec.rounds))
    assert all(rec.rounds[0][k] for k in KERNELS), {k: len(v) for k, v in rec.rounds[0].items()}
    steal = ((TRAIN_BATCH - 1, cfg.max_size, cfg.max_size, 3), (TRAIN_BATCH - 1, n_texels, 1, 2))
    assert steal in rec.rounds[0]["sampler"], list(rec.rounds[0]["sampler"])
    t0 = time.perf_counter()
    parts = time_round(rec.rounds[0], rec.stats, f"run_id-0 R1 train step, batch {TRAIN_BATCH}")
    parts["blur_vjp"].update(time_vjp_copies(rec.vjp_copies, f"run_id-0 R1 step, batch {TRAIN_BATCH}"))
    del rec
    log(f"phase run_id-0 kernel timings: {time.perf_counter() - t0:.2f} s; card now: "
        + nvidia_smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu"))

    state.step = 13
    steps, launches, peak, moved = run_train_steps(step, state, batch, counters)
    for i, dt, m, n in steps:
        log(f"  run_id-0 step {i}: {1e3 * dt:.2f} ms host clock (synchronized), metrics {m}, launches {n}")
    for i, dt, m, n in steps:
        assert all(np.isfinite(v) for v in m.values()), (i, m)
        assert (m["r1"] > 0) == ((i + 1) % cfg.r1_interval == 0), (i, m)
        assert m["render_overflow"] == 0.0 and m["interp"] > 0, (i, m)
        assert abs(m["g_total"] - (m["g_loss"] + m["interp"])) <= 1e-6 * abs(m["g_total"]), (i, m)
        # One fused render, the albedo lookup and the texture steal's
        # sampling, and the steal's backward.
        assert n["raster"] == 1 and n["sampler"] == 2 and n["bilinear_scatter"] >= 1, (i, n)
    assert all(moved[k] > 0 for k in moved) and moved["g_ema"] < moved["generator"], moved
    assert all(n > 0 for n in launches.values()), f"a kernel never launched in the run_id-0 steps: {launches}"
    t_plain = float(np.median([dt for i, dt, _, _ in steps if (i + 1) % cfg.r1_interval != 0]))
    t_r1 = next(dt for i, dt, _, _ in steps if (i + 1) % cfg.r1_interval == 0)
    log(f"phase run_id-0 train: {len(steps)} counted steps at batch {TRAIN_BATCH}: without R1 median "
        f"{1e3 * t_plain:.2f} ms ({TRAIN_BATCH / t_plain:.1f} images/s), with R1 {1e3 * t_r1:.2f} ms "
        f"({TRAIN_BATCH / t_r1:.1f} images/s); over the r1_interval {cfg.r1_interval} schedule "
        f"{TRAIN_BATCH * cfg.r1_interval / ((cfg.r1_interval - 1) * t_plain + t_r1):.1f} images/s; "
        f"peak memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); parameter movement "
        f"{moved}; render overflow 0; launches {launches}; on {smi}")
    profile_train_step(step, state, batch, r1=False, what="one run_id-0 step")
    time_interp_penalty(res, cfg, batch)
    return parts, launches


def time_interp_penalty(res, cfg, batch) -> None:
    """CUDA-event time of the interpolation penalty alone at the run_id-0
    shapes — decode, texture steal and pairwise penalty of 15 images and
    their image gradient (kernel 2 forward, kernel 6 backward) — the part
    of a step that run_id 8 does not have besides G's extra rows."""
    import torch

    from gif_tpu_torch.train import losses as L

    n = TRAIN_BATCH - 1
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.uniform(-1, 1, (n, cfg.max_size, cfg.max_size, 3)).astype(np.float32),
                             device="cuda").requires_grad_(True)
    flm = L.interpolate_flame_batch(batch["flame"], 0.5)
    frm = torch.as_tensor(res.face_region_mask, device="cuda")
    pairs = np.arange(n)  # n of the n (n - 1) / 2 pairs

    def forward():
        return L.interp_penalty_from_images(res, images, flm, pairs, frm)

    t_fwd = event_ms(forward)
    t_all = event_ms(lambda: torch.autograd.grad(forward(), images))
    log(f"phase interp penalty alone ({n} images of {cfg.max_size} px, {len(res.texture_x_coords)} texels, "
        f"CUDA events, median of 3): forward {t_fwd:.3f} ms, forward + image gradient {t_all:.3f} ms")


# The regularized run_id-8 phase's embedding regularizer weight (no preset
# sets one; the L2 norm of the 8-layer mapping net is ~1.5e6, so this makes
# the term ~150, a large share of G's loss, and its gradient visible).
EMB_REG = 1e-4
# The data pipeline's crop range (gif_tpu/data/pipeline.py crop_max_in_px).
CROP_MAX_PX = 10


def augment_batch(batch: dict, seed: int = 0) -> dict:
    """The pipeline's augmentation on a train batch: crops uniform in
    [-10, 10] px, flips with p = 0.5, the true fit as ``flame_render`` and
    the label's flipped rows set to the sentinel."""
    import torch

    from gif_tpu_torch.data.augment import FLIPPED_LABEL_SENTINEL

    n, dev = batch["flame"].shape[0], batch["flame"].device
    rng = np.random.default_rng(seed + 100)
    flip = torch.as_tensor(rng.uniform(size=n) < 0.5, device=dev)
    label = batch["flame"].clone()
    label[flip] = FLIPPED_LABEL_SENTINEL
    return {**batch, "flame": label, "flame_render": batch["flame"], "flip": flip,
            "crop": torch.as_tensor(rng.integers(-CROP_MAX_PX, CROP_MAX_PX + 1, (n, 2)), device=dev)}


def record_warmup(step, state, batch, kernels, what: str):
    """One warm-up R1 step under LaunchRecorder: every launch held to its
    plain version on the spot (the double backward's included).  Returns
    (state, metrics, {kind: launches}, {kind: max_abs_err})."""
    state.step = 15  # r1_interval 16: (15 + 1) % 16 == 0
    t0 = time.perf_counter()
    with LaunchRecorder() as rec:
        state, m = step(state, batch)
        m = {k: v.item() for k, v in m.items()}
    n = {k: sum(r["n"] for r in rec.rounds[0][k].values()) for k in KERNELS}
    errs = {k: v["max_abs_err"] for k, v in rec.stats.items() if v}
    log(f"phase {what} warm-up (R1) step incl. the on-the-spot checks of every kernel launch: "
        f"{time.perf_counter() - t0:.2f} s; metrics {m}; launches held to their plain versions {n}; "
        f"max_abs_err {errs}")
    assert m["r1"] > 0 and len(rec.rounds) == 1, (m, len(rec.rounds))
    assert all(n[k] > 0 for k in kernels), n
    return state, m, n, errs


def log_train_steps(steps, cfg, peak, moved, launches, what: str, smi: str) -> None:
    """Step times without and with R1, images/s over the r1_interval
    schedule and peak memory of counted steps."""
    t_plain = float(np.median([dt for i, dt, _, _ in steps if (i + 1) % cfg.r1_interval != 0]))
    t_r1 = next(dt for i, dt, _, _ in steps if (i + 1) % cfg.r1_interval == 0)
    log(f"phase {what}: {len(steps)} counted steps at batch {TRAIN_BATCH}: without R1 median "
        f"{1e3 * t_plain:.2f} ms ({TRAIN_BATCH / t_plain:.1f} images/s), with R1 {1e3 * t_r1:.2f} ms "
        f"({TRAIN_BATCH / t_r1:.1f} images/s); over the r1_interval {cfg.r1_interval} schedule "
        f"{TRAIN_BATCH * cfg.r1_interval / ((cfg.r1_interval - 1) * t_plain + t_r1):.1f} images/s; "
        f"peak memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated) of "
        f"{torch_total_gib():.1f} GiB; parameter movement {moved}; launches {launches}; on {smi}")


def torch_total_gib() -> float:
    import torch

    return torch.cuda.get_device_properties(0).total_memory / 2**30


def time_reg_term(name: str, forward, params) -> None:
    """CUDA-event times of a G regularizer term alone — its forward (with
    its own create_graph backward) and its parameter backward (the double
    backward) — and a profile of that backward naming its slowest kernels."""
    import torch

    t_fwd = event_ms(forward)
    loss = forward()

    def backward():
        torch.autograd.grad(loss, params, retain_graph=True, materialize_grads=True)

    t_bwd = event_ms(backward)
    log(f"phase {name} term alone (full-width G, batch {TRAIN_BATCH}, CUDA events, median of 3): forward "
        f"(G forward and its create_graph backward) {t_fwd:.2f} ms; parameter backward (double backward) "
        f"{t_bwd:.2f} ms")
    profile_by_op(backward, f"phase {name} profile: the term's parameter backward alone")
    del loss


def train_regularized(res, counters: dict, smi: str):
    """Phase 13: the run_id-8 step at full width with every branch of the
    D phase and G's path-length and embedding regularizers: shuffled
    negatives, instance noise, crop / flip batches rendered from
    ``flame_render``.  One recorded warm-up R1 step; 3 counted steps from
    step 13 (R1 on the third); the path-length term timed alone.  Returns
    (counted launches, warm-up launches, max_abs_err by kernel)."""
    import torch

    from gif_tpu_torch.train import losses as L
    from gif_tpu_torch.train.config import get_config
    from gif_tpu_torch.train.state import create_train_state
    from gif_tpu_torch.train.step import make_train_step, render_condition_maps

    t0 = time.perf_counter()
    cfg = get_config(8, batch_size=TRAIN_BATCH, gen_reg_type="path_len_reg", embedding_reg_weight=EMB_REG,
                     shfld_cond_as_neg_smpl=True, d_input_noise_std=0.05)
    state = create_train_state(cfg, seed=0)
    step = make_train_step(cfg, res, max_tris_per_tile=res.n_faces, generator=torch.Generator().manual_seed(0))
    batch = augment_batch(train_batch(cfg, TRAIN_BATCH, "cuda"))
    log(f"phase regularized run_id-8 setup: {cfg.max_size} px, max_channels {cfg.max_channels}, "
        f"{cfg.compute_dtype}, batch {TRAIN_BATCH} (D's fakes 2 x {TRAIN_BATCH} rows), gen_reg_type "
        f"{cfg.gen_reg_type}, embedding_reg_weight {cfg.embedding_reg_weight}, shfld_cond_as_neg_smpl "
        f"{cfg.shfld_cond_as_neg_smpl}, d_input_noise_std {cfg.d_input_noise_std}, crops in "
        f"[-{CROP_MAX_PX}, {CROP_MAX_PX}] px, {int(batch['flip'].sum())} of {TRAIN_BATCH} flipped: "
        f"{time.perf_counter() - t0:.2f} s")
    state, _, warm, errs = record_warmup(step, state, batch, RUN8_KERNELS, "regularized run_id-8")

    state.step = 13
    pl0 = state.pl_mean.item()
    steps, launches, peak, moved = run_train_steps(step, state, batch, counters)
    for i, dt, m, n in steps:
        log(f"  regularized run_id-8 step {i}: {1e3 * dt:.2f} ms host clock (synchronized), metrics {m}, "
            f"launches {n}")
    for i, dt, m, _ in steps:
        assert all(np.isfinite(v) for v in m.values()), (i, m)
        assert (m["r1"] > 0) == ((i + 1) % cfg.r1_interval == 0), (i, m)
        assert m["render_overflow"] == 0.0 and m["g_total"] > m["g_loss"], (i, m)
    pl1 = state.pl_mean.item()
    log(f"  pl_mean {pl0:.6g} -> {pl1:.6g} over the counted steps")
    assert np.isfinite(pl1) and pl1 != pl0, (pl0, pl1)
    assert all(moved[k] > 0 for k in moved) and moved["g_ema"] < moved["generator"], moved
    assert all(launches[KERNELS[k]["name"]] > 0 for k in RUN8_KERNELS), \
        f"a kernel never launched in the regularized steps: {launches}"
    log_train_steps(steps, cfg, peak, moved, launches, "regularized run_id-8 train", smi)

    gen = state.generator
    with torch.no_grad():
        cond = render_condition_maps(res, batch["flame_render"], cfg, res.n_faces)
    rng = torch.Generator().manual_seed(1)
    z = torch.randn((TRAIN_BATCH, 512), generator=rng).cuda()
    noise = torch.randn((TRAIN_BATCH, cfg.max_size, cfg.max_size, 3), generator=rng).cuda()

    def ppl():
        return L.path_length_penalty(lambda zz: gen(cond, z=zz, step=cfg.max_step), z, state.pl_mean,
                                     noise=noise)[0]

    time_reg_term("path-length", ppl, list(gen.parameters()))
    del state, step, batch
    return launches, warm, errs


def train_run_id0_direct(res, counters: dict, smi: str):
    """Phase 14: the fused run_id-0 step with the direct gradient
    regularizer and the adaptive interpolation scale at full width: one
    recorded warm-up R1 step, 3 counted steps from step 13 checking
    ``g_total = g_loss + rest + interp`` with ``interp = 0.25 (g_loss +
    rest)``, and the direct-gradient term timed alone.  Returns (counted
    launches, warm-up launches, max_abs_err by kernel)."""
    import torch

    from gif_tpu_torch.train import losses as L
    from gif_tpu_torch.train.config import get_config
    from gif_tpu_torch.train.state import create_train_state
    from gif_tpu_torch.train.step import make_train_step, render_condition_maps

    t0 = time.perf_counter()
    cfg = get_config(0, batch_size=TRAIN_BATCH, gen_reg_type="direct_grad_reg", adaptive_interp_loss=True)
    state = create_train_state(cfg, seed=0)
    step = make_train_step(cfg, res, max_tris_per_tile=res.n_faces, generator=torch.Generator().manual_seed(0))
    batch = train_batch(cfg, TRAIN_BATCH, "cuda")
    log(f"phase direct-grad run_id-0 setup: fused interpolation loss over {2 * TRAIN_BATCH - 1} G rows, "
        f"gen_reg_type {cfg.gen_reg_type}, adaptive_interp_loss {cfg.adaptive_interp_loss}: "
        f"{time.perf_counter() - t0:.2f} s")
    state, _, warm, errs = record_warmup(step, state, batch, list(KERNELS), "direct-grad run_id-0")

    state.step = 13
    steps, launches, peak, moved = run_train_steps(step, state, batch, counters)
    for i, dt, m, n in steps:
        rest = m["g_total"] - m["g_loss"] - m["interp"]
        log(f"  direct-grad run_id-0 step {i}: {1e3 * dt:.2f} ms host clock (synchronized), metrics {m}, "
            f"rest = g_total - g_loss - interp = {rest:.6g}, launches {n}")
        assert all(np.isfinite(v) for v in m.values()), (i, m)
        assert (m["r1"] > 0) == ((i + 1) % cfg.r1_interval == 0), (i, m)
        assert m["render_overflow"] == 0.0 and m["interp"] > 0 and rest >= -1e-6 * m["g_total"], (i, m)
        # interp = 0.25 (g_loss + rest) with g_total = g_loss + rest + interp.
        assert abs(m["interp"] - 0.25 * (m["g_loss"] + rest)) <= 1e-5 * m["g_total"], (i, m)
        assert n["raster"] == 1 and n["sampler"] == 2 and n["bilinear_scatter"] >= 1, (i, n)
    assert all(moved[k] > 0 for k in moved) and moved["g_ema"] < moved["generator"], moved
    assert all(n > 0 for n in launches.values()), f"a kernel never launched in the direct-grad steps: {launches}"
    log_train_steps(steps, cfg, peak, moved, launches, "direct-grad run_id-0 train", smi)

    gen = state.generator
    with torch.no_grad():
        cond = render_condition_maps(res, batch["flame"], cfg, res.n_faces)

    def direct():
        return 8e-8 * L.direct_grad_penalty(
            lambda c: gen(c, input_indices=batch["indices"], step=cfg.max_step), cond)

    time_reg_term("direct-grad", direct, list(gen.parameters()))
    del state, step, batch
    return launches, warm, errs


class plain_render:
    """Route kernels 1, 2 and 6's launchers to their plain versions on CUDA
    tensors (the autograd Functions around them stay)."""

    def __enter__(self):
        from gif_tpu_torch.render import raster, raster_cuda, sampler_cuda, sampling_ops, scatter_cuda, shading

        self.saved = [(m, n, getattr(m, n)) for m, n in (
            (raster_cuda, "rasterize_cuda"), (sampler_cuda, "grid_sample_cuda"),
            (scatter_cuda, "scatter_bilinear_cuda"))]
        raster_cuda.rasterize_cuda = lambda fv, a, h, w, tile, cap: raster.rasterize_plain(
            fv, a, h=h, w=w, tile=tile, max_tris_per_tile=cap)
        sampler_cuda.grid_sample_cuda = shading.grid_sample_bilinear
        scatter_cuda.scatter_bilinear_cuda = sampling_ops.scatter_bilinear_plain
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def render_grads(res, flame, weights):
    """Gradients of ``sum(textured * w_t) + sum(normal * w_n)`` of one
    render of ``flame`` with respect to the texture code, the light code
    and the (B, F, 3, 5) face attributes (normals and UVs) the renderer
    hands the rasterizer."""
    import torch

    from gif_tpu_torch import constants as cnst
    from gif_tpu_torch.render import renderer

    captured = {}
    orig = renderer.rasterize_with_attrs

    def capture(fv, attrs, *args):
        captured["attrs"] = attrs.detach().requires_grad_(True)
        return orig(fv, captured["attrs"], *args)

    (t0, t1), (l0, l1), (c0, c1) = (cnst.DECA_IDX[k] for k in ("tex", "lit", "cam"))
    tex = flame[:, t0:t1].clone().requires_grad_(True)
    lit = flame[:, l0:l1].reshape(-1, 9, 3).clone().requires_grad_(True)
    renderer.rasterize_with_attrs = capture
    try:
        maps = renderer.render_tex_and_normal(res, flame[:, :100], flame[:, 100:150], flame[:, 150:156], tex, lit,
                                              flame[:, c0:c1], image_size=256, max_tris_per_tile=res.n_faces)
    finally:
        renderer.rasterize_with_attrs = orig
    loss = (maps.textured * weights[0]).sum() + (maps.normal * weights[1]).sum()
    return torch.autograd.grad(loss, (tex, lit, captured["attrs"]))


def check_render_gradient(res, counters: dict):
    """Phase 15: the render's gradient on the card at the served shapes
    (batch 8, 256 px) through kernels 1, 2 and 6 (counted, every launch held
    to its plain version on the spot) against the same gradient through the
    plain versions, both on the card; then kernel 6 timed at the albedo
    lookup's shape.  Returns (launches, kernel 6's record fields)."""
    import torch

    rng = np.random.default_rng(11)
    n = 8
    flame = np.zeros((n, 236), np.float32)
    flame[:, :100] = rng.standard_normal((n, 100)) * 0.5
    flame[:, 100:150] = rng.standard_normal((n, 50)) * 0.5
    flame[:, 150:156] = rng.standard_normal((n, 6)) * 0.05
    flame[:, 156] = 8.0
    flame[:, 159:209] = rng.standard_normal((n, 50))
    flame[:, 209:212] = 3.0
    flame[:, 212:236] = rng.standard_normal((n, 24)) * 0.2
    flame = torch.as_tensor(flame, device="cuda")
    weights = [torch.as_tensor(rng.standard_normal((n, 256, 256, 3)).astype(np.float32), device="cuda")
               for _ in range(2)]
    render_grads(res, flame, weights)  # warm-up
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    with LaunchRecorder() as rec:
        got = render_grads(res, flame, weights)
        torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    with plain_render():
        want = render_grads(res, flame, weights)
    errs = {}
    for name, g, w in zip(("texcode", "lightcode", "face_attrs"), got, want):
        errs[name] = ((g - w).abs().max() / w.abs().max()).item()
    log(f"phase render gradient (batch {n}, 256 px, through kernels 1, 2 and 6 vs their plain versions, both "
        f"on the card): max |diff| / max |plain| {errs} (tol 1e-4: atomic sums in another order); "
        f"launches {launches}; held on the spot: max_abs_err "
        f"{ {k: v['max_abs_err'] for k, v in rec.stats.items() if v} }")
    assert all(np.isfinite(v) and v <= 1e-4 for v in errs.values()), errs
    assert all(w.abs().max().item() > 0 for w in want)
    assert launches["raster"] == 1 and launches["sampler"] == 1 and launches["bilinear_scatter"] == 1, launches
    albedo = time_round({"scatter": rec.rounds[0]["scatter"]}, rec.stats, f"albedo lookup gradient, batch {n}")
    return launches, albedo["scatter"]


# The training job of phase 16: steps, cadences, dataset and FID sizes.
LOOP_STEPS = 20
LOOP_DATASET = 512
FID_KERNELS = ["raster", "sampler", "flr", "blur"]  # the FID sweep's sampling: G forward only


class LoopProbe:
    """For the ``train()`` calls inside it, wraps the loop's collaborators
    and notes what they did, launching nothing of its own:

    - each train step: its launches (counter deltas), its metric tensors,
      a digest of its batch (every key; the real images sampled on a
      16-px lattice) and, with ``record``, the first step under
      :class:`LaunchRecorder` (every launch held to its plain version);
    - the FID sweep's sampling (``FlameSampler._run`` while
      ``sample_batches_device`` is iterated): synchronized host-clock
      seconds and launches; with ``record`` its first batch recorded too;
    - the Inception passes (generated batches on the device, real images
      from the host) and the Fréchet distance (its host ``sqrtm``):
      synchronized host-clock seconds, and every FID value;
    - checkpoint saves and restores: seconds and bytes."""

    def __init__(self, counters: dict, record: bool):
        self.counters, self.record = counters, record
        self.step_launches = {k: 0 for k in counters}
        self.fid_launches = {k: 0 for k in counters}
        self.metrics, self.digests, self.before, self.state = [], {}, None, None
        self.reduces = []  # the step's mean all-reduce calls (data parallel), per step
        self.recorded, self.checked, self.errs = {}, {}, {}
        self.in_fid = False
        self.spans = {"fid_sampling_s": [], "inception_s": [], "real_inception_s": [], "frechet_s": []}
        self.fids, self.n_generated, self.n_real, self.saves, self.restores = [], 0, 0, [], []

    def _counts(self) -> dict:
        return {k: fn.launches for k, fn in self.counters.items()}

    def _add(self, into: dict, before: dict) -> None:
        for k, v in self._counts().items():
            into[k] += v - before[k]

    def _recorded(self, what: str, fn):
        """``fn()`` under LaunchRecorder the first time ``what`` runs."""
        if not self.record or what in self.recorded:
            return fn()
        with LaunchRecorder() as rec:
            out = fn()
        self.recorded[what] = {k: sum(r["n"] for r in rec.rounds[0][k].values()) for k in KERNELS}
        for k, st in rec.stats.items():
            if st:
                self.errs[k] = max(self.errs.get(k, 0.0), st["max_abs_err"])
                self.checked[k] = self.checked.get(k, 0) + self.recorded[what][k]
        return out

    def __enter__(self):
        import hashlib

        import torch

        from gif_tpu_torch.eval import fid as fid_mod
        from gif_tpu_torch.eval.sampling import FlameSampler
        from gif_tpu_torch.parallel import collectives
        from gif_tpu_torch.train import checkpoint, loop

        probe = self
        self.saved = []

        def patch(owner, name, make):
            orig = getattr(owner, name)
            self.saved.append((owner, name, owner.__dict__[name] if isinstance(owner, type) else orig))
            setattr(owner, name, make(orig))

        def digest(batch: dict) -> str:
            h = hashlib.sha1()
            for k in sorted(batch):
                v = batch[k][:, ::16, ::16] if k == "real_image" else batch[k]
                h.update(k.encode())
                h.update(np.ascontiguousarray(v).tobytes())
            return h.hexdigest()

        def make_train_step(orig):
            def make(*a, **kw):
                step = orig(*a, **kw)

                def counted(state, batch):
                    if probe.before is None:
                        probe.state = state
                        probe.before = {k: _param_snapshot(getattr(state, k))
                                        for k in ("generator", "discriminator", "g_ema")}
                    i, c0, r0 = state.step, probe._counts(), collectives.mean_all_reduce.calls
                    probe.digests[i] = digest(batch)
                    state, m = probe._recorded("step", lambda: step(state, batch))
                    probe._add(probe.step_launches, c0)
                    probe.reduces.append(collectives.mean_all_reduce.calls - r0)
                    probe.metrics.append((i, m))
                    return state, m

                return counted
            return make

        def sample_batches_device(orig):
            def gen(sampler, *a):
                probe.in_fid = True
                try:
                    yield from orig(sampler, *a)
                finally:
                    probe.in_fid = False
            return gen

        def timed(key, n_attr=None, sync=True):
            def wrap(orig):
                def call(*a):
                    if sync:
                        torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = orig(*a)
                    if sync:
                        torch.cuda.synchronize()
                    probe.spans[key].append(time.perf_counter() - t0)
                    if n_attr:
                        setattr(probe, n_attr, getattr(probe, n_attr) + len(a[1]))
                    return out
                return call
            return wrap

        def run(orig):
            def call(sampler, fl, ix):
                if not probe.in_fid:
                    return orig(sampler, fl, ix)
                torch.cuda.synchronize()
                c0, t0 = probe._counts(), time.perf_counter()
                out = probe._recorded("fid_sampling", lambda: orig(sampler, fl, ix))
                torch.cuda.synchronize()
                probe.spans["fid_sampling_s"].append(time.perf_counter() - t0)
                probe._add(probe.fid_launches, c0)
                return out
            return call

        def frechet(orig):
            def call(*a):
                t0 = time.perf_counter()
                value = orig(*a)
                probe.spans["frechet_s"].append(time.perf_counter() - t0)
                probe.fids.append(value)
                return value
            return call

        def save(orig):
            def call(mgr, state):
                torch.cuda.synchronize()
                existed, t0 = os.path.exists(mgr.path(state.step)), time.perf_counter()
                orig(mgr, state)
                if not existed:
                    probe.saves.append((state.step, time.perf_counter() - t0, os.path.getsize(mgr.path(state.step))))
            return call

        def restore(orig):
            def call(mgr, state, step=None):
                t0 = time.perf_counter()
                out = orig(mgr, state, step)
                torch.cuda.synchronize()
                probe.restores.append((state.step, time.perf_counter() - t0, os.path.getsize(mgr.path(state.step))))
                return out
            return call

        patch(loop, "make_train_step", make_train_step)
        patch(FlameSampler, "sample_batches_device", sample_batches_device)
        patch(FlameSampler, "_run", run)
        patch(fid_mod.FidComputer, "activations_device", timed("inception_s", "n_generated"))
        patch(fid_mod.FidComputer, "activations", timed("real_inception_s", "n_real"))
        patch(fid_mod, "frechet_distance", frechet)
        patch(checkpoint.CheckpointManager, "save", save)
        patch(checkpoint.CheckpointManager, "restore", restore)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self.saved):
            setattr(owner, name, orig)

    def r1_steps(self) -> list:
        return [i for i, m in self.metrics if m["r1"].item() > 0]

    def moved(self) -> dict:
        return {k: _moved(v, getattr(self.state, k)) for k, v in self.before.items()}


def _csv_rows(path: str) -> list:
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _truncate_run(run: str, keep_step: int) -> None:
    """A run directory as a crash after step ``keep_step``'s checkpoint
    leaves it: later checkpoints, metric rows and grids removed."""
    import csv

    from gif_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(os.path.join(run, "checkpoint"))
    for step in mgr.all_steps():
        if step > keep_step:
            os.remove(mgr.path(step))
    rows = _csv_rows(os.path.join(run, "metrics.csv"))
    with open(os.path.join(run, "metrics.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(r for r in rows if int(r["step"]) <= keep_step)
    grids = os.path.join(run, "sample", os.path.basename(run))
    for g in os.listdir(grids) if os.path.isdir(grids) else []:  # a run without FID draws no grids
        if int(g[:6]) > keep_step:
            os.remove(os.path.join(grids, g))


def train_loop(res, counters: dict, smi: str, bare_plain_s: float):
    """Phases 16-17: the training job through ``train()`` at run_id 8, full
    width (256 px, 512 channels, bf16 convs, batch 16, r1_interval 16) on a
    512-frame ``SyntheticRenderDataset`` rendered on the card, with the
    random-weight InceptionV3 FID on 512 samples against the 512 frames:
    20 counted steps (FID at 0 and 20, checkpoints at 10 and 20, metrics
    every 5; the first step and the first FID batch held launch by launch
    to the plain versions), a resume from checkpoint 10 replaying the same
    batches, the Inception features on the card against the CPU, and 4
    steps of run_id 0 through ``train()``.  Returns ({kind: loop record
    fields}, {kind: max_abs_err})."""
    import shutil
    import tempfile

    import torch

    from gif_tpu_torch.data.pipeline import FlameDataset, SyntheticRenderDataset
    from gif_tpu_torch.eval.fid import FidComputer
    from gif_tpu_torch.eval.inception import random_fid_params
    from gif_tpu_torch.train import loop
    from gif_tpu_torch.train.checkpoint import CheckpointManager
    from gif_tpu_torch.train.config import get_config
    from gif_tpu_torch.train.step import make_train_step

    def counts() -> dict:
        return {k: fn.launches for k, fn in counters.items()}

    def zero() -> None:
        for fn in counters.values():
            fn.launches = 0

    cfg = get_config(8, batch_size=TRAIN_BATCH, fid_every=LOOP_STEPS, checkpoint_every=LOOP_STEPS // 2)
    sweep_batches = LOOP_DATASET // TRAIN_BATCH  # the FID sampler's batch is min(batch, 16)
    with tempfile.TemporaryDirectory(prefix="gif_loop_") as tmp:
        # --- phase 16: the data and FID set-up ---
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds = SyntheticRenderDataset(res, n=LOOP_DATASET, size=cfg.max_size, seed=0,
                                    cache_dir=os.path.join(tmp, "synth"), max_tris_per_tile=res.n_faces)
        render_s, render_launches = time.perf_counter() - t0, counts()
        log(f"phase loop data: SyntheticRenderDataset of {LOOP_DATASET} frames at {cfg.max_size} px rendered on the card in "
            f"{render_s:.3f} s (batches of 16, host readback included), render overflow in "
            f"{ds.render_overflows} samples, launches {render_launches}")
        assert ds.render_overflows == 0 and render_launches["raster"] > 0 and render_launches["sampler"] > 0
        t0 = time.perf_counter()
        fid_computer = FidComputer(random_fid_params(0), stats_dir=os.path.join(tmp, "fid_stats"))
        log(f"phase loop FID set-up: random-weight InceptionV3 on the card in {time.perf_counter() - t0:.2f} s")
        run_kw = dict(total_iters=LOOP_STEPS, fid_computer=fid_computer, log_every=5,
                      fid_n_samples=LOOP_DATASET, fid_real_samples=LOOP_DATASET, max_tris_per_tile=res.n_faces)

        # --- the counted run: every counter 0 just before train(), read just after ---
        zero()
        t0 = time.perf_counter()
        with LoopProbe(counters, record=True) as a:
            state = loop.train(cfg, ds, res, os.path.join(tmp, "a"), **run_kw)
            torch.cuda.synchronize()
        run_s, launches = time.perf_counter() - t0, counts()
        run = os.path.join(tmp, "a", "8")
        rows = _csv_rows(os.path.join(run, "metrics.csv"))
        grids = sorted(os.listdir(os.path.join(run, "sample", "8")))
        ckpts = CheckpointManager(os.path.join(run, "checkpoint")).all_steps()
        moved, r1 = a.moved(), a.r1_steps()
        log(f"phase loop run: {LOOP_STEPS} steps through train() in {run_s:.2f} s host clock (both FID sweeps, "
            f"checkpoints, the recorded first step and FID batch included); metrics.csv rows {rows}; grids "
            f"{grids}; checkpoints {ckpts}; R1 on steps {r1}; FIDs {a.fids}; parameter movement {moved}; "
            f"launches: train() {launches}, steps {a.step_launches}, FID sampling {a.fid_launches}; held to the "
            f"plain versions on the spot (first step, first FID batch) {a.recorded}, max_abs_err {a.errs}")
        assert [r["step"] for r in rows] == ["5", "10", "15", "20"], rows
        for r in rows:
            assert all(np.isfinite(float(r[k])) for k in ("d_loss", "g_loss", "g_total", "imgs_per_sec", "fid",
                                                          "ema_recon")), r
            assert float(r["render_overflow"]) == 0.0, r
        assert len(a.fids) == 2 and all(np.isfinite(f) for f in a.fids), a.fids
        assert float(rows[0]["fid"]) == a.fids[0]
        assert [g[:6] for g in grids] == ["000000", f"{LOOP_STEPS:06d}"], grids
        assert ckpts == [LOOP_STEPS // 2, LOOP_STEPS], ckpts
        assert r1 == [cfg.r1_interval - 1], r1
        assert all(v > 0 for v in moved.values()) and moved["g_ema"] < moved["generator"], moved
        assert all(a.step_launches[KERNELS[k]["name"]] > 0 for k in RUN8_KERNELS), a.step_launches
        assert all(a.fid_launches[KERNELS[k]["name"]] > 0 for k in FID_KERNELS), a.fid_launches
        assert all(a.recorded["step"][k] > 0 for k in RUN8_KERNELS), a.recorded
        assert all(a.recorded["fid_sampling"][k] > 0 for k in FID_KERNELS), a.recorded
        assert a.n_generated == 2 * LOOP_DATASET and a.n_real == LOOP_DATASET, (a.n_generated, a.n_real)

        # Timings: the loop's images/s over the plain 5-step windows (rows 10
        # and 15: no R1, no sweep, no checkpoint inside) against the bare
        # step's over the same windows (the run's state, a batch already on
        # the card, one synchronize at each window's end), and phase 8's.
        loop_ips = [float(r["imgs_per_sec"]) for r in rows[1:3]]
        bare_step = make_train_step(cfg, res, max_tris_per_tile=res.n_faces)
        batch = train_batch(cfg, TRAIN_BATCH, "cuda")
        state.step = LOOP_STEPS  # no R1 in steps 20-30
        state, _ = bare_step(state, batch)
        bare_ips = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                state, m = bare_step(state, batch)
            float(m["d_loss"])
            bare_ips.append(5 * TRAIN_BATCH / (time.perf_counter() - t0))
        del state, bare_step, batch
        sp = a.spans
        log(f"phase loop timings: images/s {loop_ips} over steps 6-10 and 11-15 (loop host clock) against the "
            f"bare step's {bare_ips} over 5-step windows of the same state (loop overhead "
            f"{[round(100 * (b / l - 1), 2) for l, b in zip(loop_ips, bare_ips)]} %: the loop's step time over the bare step's, less 1) and "
            f"phase 8's synchronized single steps {TRAIN_BATCH / bare_plain_s:.2f} images/s; first window (step 1 "
            f"recorded) {float(rows[0]['imgs_per_sec']):.2f}, R1 window {float(rows[3]['imgs_per_sec']):.2f} "
            f"images/s; on {smi}")
        sweeps = [dict(sampling_s=sum(sp["fid_sampling_s"][sweep_batches * j: sweep_batches * (j + 1)]),
                       inception_s=sum(sp["inception_s"][sweep_batches * j: sweep_batches * (j + 1)]),
                       frechet_s=sp["frechet_s"][j]) for j in range(2)]
        log(f"phase loop FID sweeps ({LOOP_DATASET} samples each, sampler batch 16; synchronized host-clock "
            f"spans): {sweeps}; real statistics of {a.n_real} frames (uint8 from the host, once, cached) "
            f"{sum(sp['real_inception_s']):.3f} s; sampling per batch median "
            f"{1e3 * float(np.median(sp['fid_sampling_s'])):.2f} ms, Inception per batch median "
            f"{1e3 * float(np.median(sp['inception_s'])):.2f} ms")
        log(f"phase loop checkpoints: saves (step, s, bytes) {a.saves}; on {smi}")

        # --- the resume: checkpoint 10 only, the same batches from step 10 on ---
        del a.state, a.before
        torch.cuda.empty_cache()
        shutil.copytree(os.path.join(tmp, "a"), os.path.join(tmp, "b"))
        _truncate_run(os.path.join(tmp, "b", "8"), LOOP_STEPS // 2)
        ds_b = FlameDataset(ds.images, ds.flame_params)  # a fresh accumulator, as in a new process
        ds_b.conditionally_exact = True
        zero()
        with LoopProbe(counters, record=False) as b:
            loop.train(cfg, ds_b, res, os.path.join(tmp, "b"), **run_kw)
            torch.cuda.synchronize()
        launches_b = counts()
        rows_b = _csv_rows(os.path.join(tmp, "b", "8", "metrics.csv"))
        log(f"phase loop resume from step {LOOP_STEPS // 2}: restores (step, s, bytes) {b.restores}; rows "
            f"{rows_b}; FID at step {LOOP_STEPS} {b.fids} (on the {len(b.metrics) * TRAIN_BATCH} fits "
            f"accumulated since the resume); launches {launches_b}")
        assert sorted(b.digests) == list(range(LOOP_STEPS // 2, LOOP_STEPS)), sorted(b.digests)
        assert all(b.digests[i] == a.digests[i] for i in b.digests), "the resumed run saw other batches"
        assert [r["step"] for r in rows_b] == ["5", "10", "15", "20"], rows_b
        # A control: a second resume from the same checkpoint (no FID).  Two
        # resumed runs differ only by the card's nondeterminism (cuDNN's
        # weight gradients), which the GAN's Adam steps (beta1 0) amplify.
        shutil.copytree(os.path.join(tmp, "a"), os.path.join(tmp, "c"))
        _truncate_run(os.path.join(tmp, "c", "8"), LOOP_STEPS // 2)
        ds_c = FlameDataset(ds.images, ds.flame_params)
        with LoopProbe(counters, record=False) as c:
            loop.train(cfg, ds_c, res, os.path.join(tmp, "c"), **{**run_kw, "fid_computer": None})
            torch.cuda.synchronize()

        def losses(probe) -> dict:
            return {i: (m["d_loss"].item(), m["g_loss"].item()) for i, m in probe.metrics}

        def rel(x: float, y: float) -> float:
            return abs(x - y) / abs(y)

        la, lb, lc = losses(a), losses(b), losses(c)
        resumed = {i: [rel(lb[i][j], la[i][j]) for j in (0, 1)] for i in lb}
        control = {i: [rel(lc[i][j], lb[i][j]) for j in (0, 1)] for i in lb}
        rows_rel = {f"{ra['step']}/{k}": rel(float(rb[k]), float(ra[k]))
                    for ra, rb in zip(rows[2:], rows_b[2:]) for k in ("d_loss", "g_loss")}
        first = LOOP_STEPS // 2
        log(f"phase loop resume: per-step (d_loss, g_loss) relative to the uninterrupted run {resumed}; a second "
            f"resume against the first (the card's nondeterminism alone) {control}; rows 15 and 20 {rows_rel} "
            f"(tol: the first resumed step's d_loss 1e-3 and g_loss 2e-2, ~10x the largest first-step spread "
            f"of resumed and control runs on the H100, 7.7e-5 and 1.8e-3; later steps are not held: the "
            f"control diverges as far)")
        assert resumed[first][0] <= 1e-3 and resumed[first][1] <= 2e-2, resumed[first]
        assert all(np.isfinite(v) for v in rows_rel.values()), rows_rel
        del c.state, c.before
        assert len(b.restores) == 1 and b.restores[0][0] == LOOP_STEPS // 2, b.restores
        del b.state, b.before

        # --- phase 17: Inception on the card against the CPU; run_id 0 through train() ---
        imgs = ds.images[:16]
        act_gpu = fid_computer.activations(imgs)
        act_cpu = FidComputer(random_fid_params(0), batch_size=16, device="cpu").activations(imgs)
        fid_err = float(np.abs(act_gpu - act_cpu).max() / np.abs(act_cpu).max())
        log(f"phase loop FID card vs CPU: pool3 of 16 frames, max |cuda - cpu| / max |cpu| {fid_err:.3g} (tol "
            f"1e-3: f32 convs, TF32 off, summed in another order)")
        assert fid_err <= 1e-3, fid_err

        cfg0 = get_config(0, batch_size=TRAIN_BATCH, checkpoint_every=1000)
        zero()
        t0 = time.perf_counter()
        loop.train(cfg0, ds, res, os.path.join(tmp, "r0"), total_iters=4, log_every=2,
                   max_tris_per_tile=res.n_faces)
        torch.cuda.synchronize()
        launches0 = counts()
        rows0 = _csv_rows(os.path.join(tmp, "r0", "0", "metrics.csv"))
        log(f"phase loop run_id 0: 4 steps through train() in {time.perf_counter() - t0:.2f} s host clock (final "
            f"checkpoint included); rows {rows0}; launches {launches0}")
        assert [r["step"] for r in rows0] == ["2", "4"], rows0
        assert all(float(r["interp"]) > 0 and np.isfinite(float(r["g_total"])) for r in rows0), rows0
        assert all(n > 0 for n in launches0.values()), launches0
        torch.cuda.empty_cache()

    out = {}
    for kind, meta in KERNELS.items():
        name = meta["name"]
        out[kind] = {"launches": launches[name], "step_launches": a.step_launches[name],
                     "fid_sampling_launches": a.fid_launches[name], "dataset_render_launches": render_launches[name],
                     "resume_launches": launches_b[name], "run_id0_launches": launches0[name],
                     "checked_launches": a.checked.get(kind, 0)}
    return out, a.errs, loop_ips


# The data-parallel phases 18-19: steps and cadences.  run_id 8 at full
# width, global batch 16; R1 on the last of DP_STEPS steps.
DP_STEPS = 5
DP_RESUME_STEPS = 2
DP_RUN0_STEPS = 2
DP_WORLD = 2
# The all-reduced D gradient against the mean of the half-batch gradients
# computed apart, relative to its norm.  D's bf16 backward is not
# deterministic on the card: one half-batch gradient computed twice in one
# process differed by 0.96-1.2% of its norm on the H100, so the bar is
# ~2.5x that spread (a fault of the reduction — a sum, one rank's half,
# no division — reads 30% or more); the reduction itself is held bit for
# bit against the ranks' own gradients.
DP_GRAD_RTOL = 3e-2


def kernel_counters() -> dict:
    """Every kernel wrapper by its counter name (each counts its launches;
    kernels 3-5 on NCHW maps, the generator's, and apart on channels-last
    ones, the discriminator's)."""
    from gif_tpu_torch.ops import activations, blur_cuda
    from gif_tpu_torch.render import raster_cuda, sampler_cuda, scatter_cuda

    return {
        "raster": raster_cuda.rasterize_with_attrs,
        "sampler": sampler_cuda.grid_sample,
        "fused_bias_lrelu": activations.fused_leaky_relu,
        "fused_bias_lrelu_bwd": activations.fused_leaky_relu_backward,
        "fir_blur": blur_cuda.blur4,
        "fir_blur_vjp": blur_cuda.blur4_vjp,
        "bilinear_scatter": scatter_cuda.scatter_bilinear,
        "fused_bias_lrelu_cl": activations.fused_leaky_relu_cl,
        "fused_bias_lrelu_bwd_cl": activations.fused_leaky_relu_backward_cl,
        "fir_blur_cl": blur_cuda.blur4_cl,
        "fir_blur_vjp_cl": blur_cuda.blur4_vjp_cl,
    }


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def param_digest(state) -> str:
    """sha1 of the bytes of every parameter of G, D and the EMA, in order."""
    import hashlib

    h = hashlib.sha1()
    for m in (state.generator, state.discriminator, state.g_ema):
        for p in m.parameters():
            h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_config(run_id: int, **kw):
    from gif_tpu_torch.train.config import get_config

    return get_config(run_id, batch_size=TRAIN_BATCH, r1_interval=DP_STEPS, **kw)


def train_nccl(res, counters: dict, smi: str, loop_ips: list) -> dict:
    """Phase 18: ``train()`` over a process group of one rank on the NCCL
    backend (the production backend) — run_id 8 at full width, batch 16, a
    512-frame ``SyntheticRenderDataset``, 5 steps with R1 on the fifth, a
    metrics row every step, the random-weight InceptionV3 FID on 512
    samples at steps 0 and 5; every counter 0 just before, read just
    after.  Checks the rows, the FIDs, three mean all-reduces a step (D's
    gradient, G's, the metrics) and kernels 1-5 in the steps; prints the
    plain steps' images/s beside phase 16's.  Returns {kind: launches}."""
    import tempfile

    import torch
    import torch.distributed as dist

    from gif_tpu_torch.data.pipeline import SyntheticRenderDataset
    from gif_tpu_torch.eval.fid import FidComputer
    from gif_tpu_torch.eval.inception import random_fid_params
    from gif_tpu_torch.parallel import initialize_distributed, process_count
    from gif_tpu_torch.train import loop

    group = initialize_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl")
    try:
        log(f"phase nccl setup: backend {dist.get_backend(group)}, world {process_count(group)}, rank "
            f"{dist.get_rank(group)}, card {torch.cuda.current_device()}")
        cfg = dp_config(8, fid_every=DP_STEPS, checkpoint_every=1000)
        with tempfile.TemporaryDirectory(prefix="gif_nccl_") as tmp:
            ds = SyntheticRenderDataset(res, n=LOOP_DATASET, size=cfg.max_size, seed=0,
                                        cache_dir=os.path.join(tmp, "synth"), max_tris_per_tile=res.n_faces)
            fid_computer = FidComputer(random_fid_params(0), stats_dir=os.path.join(tmp, "fid_stats"))
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            with LoopProbe(counters, record=False) as a:
                loop.train(cfg, ds, res, os.path.join(tmp, "run"), total_iters=DP_STEPS, fid_computer=fid_computer,
                           log_every=1, fid_n_samples=LOOP_DATASET, fid_real_samples=LOOP_DATASET,
                           max_tris_per_tile=res.n_faces, group=group)
                torch.cuda.synchronize()
            run_s, launches = time.perf_counter() - t0, {k: fn.launches for k, fn in counters.items()}
            rows = _csv_rows(os.path.join(tmp, "run", "8", "metrics.csv"))
            grids = sorted(os.listdir(os.path.join(tmp, "run", "8", "sample", "8")))
            del a.state, a.before
    finally:
        dist.destroy_process_group()
    ips = [float(r["imgs_per_sec"]) for r in rows]
    log(f"phase nccl run: {DP_STEPS} steps through train(group=<nccl, world 1>) in {run_s:.2f} s host clock (both "
        f"FID sweeps included); rows {rows}; grids {grids}; FIDs {a.fids}; mean all-reduce calls per step "
        f"{a.reduces}; launches: train() {launches}, steps {a.step_launches}, FID sampling {a.fid_launches}")
    assert [r["step"] for r in rows] == [str(i) for i in range(1, DP_STEPS + 1)], rows
    for r in rows:
        assert all(np.isfinite(float(r[k])) for k in ("d_loss", "g_loss", "g_total", "imgs_per_sec", "fid")), r
        assert float(r["render_overflow"]) == 0.0, r
    assert [float(r["r1"]) > 0 for r in rows] == [False] * (DP_STEPS - 1) + [True], rows
    assert len(a.fids) == 2 and all(np.isfinite(f) for f in a.fids), a.fids
    assert [g[:6] for g in grids] == ["000000", f"{DP_STEPS:06d}"], grids
    assert a.reduces == [3] * DP_STEPS, a.reduces
    assert all(a.step_launches[KERNELS[k]["name"]] > 0 for k in RUN8_KERNELS), a.step_launches
    plain = ips[1:DP_STEPS - 1]
    log(f"phase nccl timings: images/s of the plain steps 2-{DP_STEPS - 1} {plain} (median "
        f"{float(np.median(plain)):.2f}) against phase 16's single-process 5-step windows {loop_ips} (median "
        f"{float(np.median(loop_ips)):.2f}): {100 * (float(np.median(plain)) / float(np.median(loop_ips)) - 1):+.2f} %; "
        f"step 1 {ips[0]:.2f}, the R1 step {ips[-1]:.2f} images/s; on {smi}")
    return {kind: a.step_launches[meta["name"]] for kind, meta in KERNELS.items()}


class _FirstAdamCall(Exception):
    """Raised by the wrapped Adam call to stop a step once D's gradient is
    in hand (nothing of the state has changed yet)."""

    def __init__(self, grads):
        self.grads = grads


def dp_rank(rank: int, world: int, port: int, tmp: str) -> None:
    """Phase 19, one rank (spawned): joins the gloo group, then through
    ``train()`` run_id 8 at full width (global batch 16, 8 a rank) for
    ``DP_STEPS`` steps with R1 on the last, the random-weight FID baseline
    at step 0 (rank 0 sweeps), a checkpoint at ``DP_STEPS``; a resume of
    both ranks from it to ``DP_STEPS + DP_RESUME_STEPS``; then
    ``DP_RUN0_STEPS`` steps of run_id 0.  Writes to ``tmp/rank{rank}.pt``:
    the parameter digest after every step, each run's kernel launches
    (counters 0 just before each, read just after) and ``used_samples``,
    how often it logged a row or saved a grid, synchronized host-clock
    spans of each step and of each gradient all-reduce, and its first
    step's batch and the all-reduced D gradient that step handed Adam."""
    import torch
    import torch.distributed as dist

    from gif_tpu_torch.data.pipeline import SyntheticRenderDataset
    from gif_tpu_torch.eval.fid import FidComputer
    from gif_tpu_torch.eval.inception import random_fid_params
    from gif_tpu_torch.flame.resources import synthetic_flame_resources
    from gif_tpu_torch.parallel import initialize_distributed
    from gif_tpu_torch.train import loop
    from gif_tpu_torch.train import step as step_mod
    from gif_tpu_torch.utils.viz import VisualizationSaver

    group = initialize_distributed(f"localhost:{port}", world, rank, backend="gloo")
    try:
        counters = kernel_counters()
        res = synthetic_flame_resources()
        cfg = dp_config(8, fid_every=1000, checkpoint_every=DP_STEPS)
        ds = SyntheticRenderDataset(res, n=LOOP_DATASET, size=cfg.max_size, seed=0,
                                    cache_dir=os.path.join(tmp, "synth"), max_tris_per_tile=res.n_faces)
        fid_computer = FidComputer(random_fid_params(0), stats_dir=os.path.join(tmp, "fid_stats"))
        out = {"digests": [], "step_s": [], "reduce_s": [], "logged": 0, "grids": 0, "used": [], "launches": []}
        saved = []

        def patch(owner, name, make):
            orig = getattr(owner, name)
            saved.append((owner, name, orig))
            setattr(owner, name, make(orig))

        def counted(key):
            def make(orig):
                def call(*a, **kw):
                    out[key] += 1
                    return orig(*a, **kw)
                return call
            return make

        def timed_reduce(orig):
            def call(tensors, group=None):
                if "local_d_grad" not in out:  # the first call: D's gradient, this rank's own
                    out["local_d_grad"] = [t.detach().cpu() for t in tensors]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                orig(tensors, group)
                torch.cuda.synchronize()
                out["reduce_s"].append(time.perf_counter() - t0)
            return call

        def adam(orig):
            def call(opt, params, grads):
                if "d_grad" not in out:
                    out["d_grad"] = [g.detach().cpu() for g in grads]
                return orig(opt, params, grads)
            return call

        def make_train_step(orig):
            def make(*a, **kw):
                step = orig(*a, **kw)

                def wrapped(state, batch):
                    if "batch" not in out:
                        out["batch"] = {k: np.asarray(v).copy() for k, v in batch.items()}
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, m = step(state, batch)
                    torch.cuda.synchronize()
                    out["step_s"].append(time.perf_counter() - t0)
                    out["digests"].append(param_digest(state))
                    return state, m
                return wrapped
            return make

        patch(loop, "make_train_step", make_train_step)
        patch(step_mod, "mean_all_reduce", timed_reduce)
        patch(step_mod, "_adam_step", adam)
        patch(loop.MetricsLogger, "log", counted("logged"))
        patch(VisualizationSaver, "save_samples", counted("grids"))
        kw = dict(log_every=1, max_tris_per_tile=res.n_faces, group=group)
        runs = (
            (cfg, "run", DP_STEPS, dict(fid_computer=fid_computer, fid_n_samples=LOOP_DATASET,
                                        fid_real_samples=LOOP_DATASET)),
            (cfg, "run", DP_STEPS + DP_RESUME_STEPS, {}),
            (dp_config(0, checkpoint_every=1000), "run0", DP_RUN0_STEPS, {}),
        )
        try:
            for c, name, total, extra in runs:
                for fn in counters.values():
                    fn.launches = 0
                state = loop.train(c, ds, res, os.path.join(tmp, name), total_iters=total, **kw, **extra)
                torch.cuda.synchronize()
                out["launches"].append({k: fn.launches for k, fn in counters.items()})
                out["used"].append(state.used_samples)
                del state
        finally:
            for owner, name, orig in reversed(saved):
                setattr(owner, name, orig)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def train_two_ranks(res, smi: str) -> dict:
    """Phase 19: two data-parallel ranks on the one card, spawned with the
    gloo backend (NCCL refuses two ranks on one device), each running
    :func:`dp_rank`; a rank that raises fails the phase.  Checks: the
    ranks' G, D and EMA bit-equal after every step; rows and grids from
    rank 0 only; ``used_samples`` = steps x 16; kernels 1-5 launched on
    each rank in both run_id-8 runs and kernel 6 too in run_id 0; the
    all-reduced D gradient of the first step against the mean of the two
    half-batch D gradients computed here from the same fresh state and the
    ranks' batches (run_id 8 draws nothing in that step), within
    ``DP_GRAD_RTOL`` of the gradient's norm beside the card's own spread
    (each half computed twice), and the all-reduced gradient bit-equal to
    the mean of the ranks' own.  Prints the all-reduce share
    of the ranks' steps (synchronized host-clock spans) and their combined
    images/s — a correctness configuration: two ranks time-slice one card
    and gloo stages every CUDA tensor through the host.  Returns {kind:
    {"rank_launches": ..., "rank_run_id0_launches": ...}}."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from gif_tpu_torch.data.pipeline import SyntheticRenderDataset
    from gif_tpu_torch.train import step as step_mod
    from gif_tpu_torch.train.state import create_train_state
    from gif_tpu_torch.train.step import make_train_step

    torch.cuda.empty_cache()
    cfg = dp_config(8, fid_every=1000, checkpoint_every=DP_STEPS)
    with tempfile.TemporaryDirectory(prefix="gif_dp2_") as tmp:
        # Rendered once here; the ranks load it from the cache.
        SyntheticRenderDataset(res, n=LOOP_DATASET, size=cfg.max_size, seed=0, cache_dir=os.path.join(tmp, "synth"),
                               max_tris_per_tile=res.n_faces)
        log(f"phase two ranks: spawning {DP_WORLD} ranks, backend gloo (explicit: NCCL refuses two ranks on one "
            f"card), one card")
        t0 = time.perf_counter()
        mp.start_processes(dp_rank, args=(DP_WORLD, free_port(), tmp), nprocs=DP_WORLD, join=True,
                           start_method="spawn")
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(DP_WORLD)]
        rows = _csv_rows(os.path.join(tmp, "run", "8", "metrics.csv"))
        grids = sorted(os.listdir(os.path.join(tmp, "run", "8", "sample", "8")))
        ckpts = sorted(os.listdir(os.path.join(tmp, "run", "8", "checkpoint")))
    r0, r1 = ranks
    n8 = DP_STEPS + DP_RESUME_STEPS
    log(f"phase two ranks: {wall:.2f} s wall (spawn, set-up, the FID baseline on rank 0, {n8} + {DP_RUN0_STEPS} "
        f"steps); rows {rows}; grids {grids}; checkpoints {ckpts}; rank 0 logged {r0['logged']} rows and saved "
        f"{r0['grids']} grids, rank 1 {r1['logged']} and {r1['grids']}; used_samples {r0['used']} / {r1['used']}; "
        f"digests equal after every step: {r0['digests'] == r1['digests']} ({len(r0['digests'])} steps); "
        f"launches rank 0 {r0['launches']}, rank 1 {r1['launches']}")
    assert r0["digests"] == r1["digests"] and len(r0["digests"]) == n8 + DP_RUN0_STEPS, (r0["digests"], r1["digests"])
    assert len(set(r0["digests"])) == len(r0["digests"]), "a step left the parameters unchanged"
    assert (r0["logged"], r0["grids"]) == (n8 + DP_RUN0_STEPS, 1) and (r1["logged"], r1["grids"]) == (0, 0)
    assert [r["step"] for r in rows] == [str(i) for i in range(1, n8 + 1)], rows
    assert [g[:6] for g in grids] == ["000000"] and f"{DP_STEPS:09d}.pt" in ckpts, (grids, ckpts)
    assert [float(r["r1"]) > 0 for r in rows][:DP_STEPS] == [False] * (DP_STEPS - 1) + [True], rows
    for r in (r0, r1):
        assert r["used"] == [TRAIN_BATCH * DP_STEPS, TRAIN_BATCH * n8, TRAIN_BATCH * DP_RUN0_STEPS], r["used"]
        for launches in r["launches"][:2]:
            assert all(launches[KERNELS[k]["name"]] > 0 for k in RUN8_KERNELS), launches
        assert all(n > 0 for n in r["launches"][2].values()), r["launches"][2]

    # The all-reduced D gradient against the mean of the two half-batch
    # gradients: the fresh state train() builds (seed = run_id), each
    # rank's first batch, the step stopped at D's Adam call.
    state = create_train_state(cfg, seed=cfg.run_id)
    step = make_train_step(cfg, res, max_tris_per_tile=res.n_faces)
    orig = step_mod._adam_step

    def stop(opt, params, grads):
        raise _FirstAdamCall([g.detach().cpu() for g in grads])

    def flat(grads):
        return torch.cat([g.reshape(-1) for g in grads])

    def rel(a, b) -> float:
        return float((a - b).norm() / b.norm())

    # Each half twice: the second is a control, the card's own spread
    # between two computations of one gradient.
    halves = [[], []]
    step_mod._adam_step = stop
    try:
        for rep in range(2):
            for r in ranks:
                try:
                    step(state, r["batch"])
                except _FirstAdamCall as c:
                    halves[rep].append(flat(c.grads))
    finally:
        step_mod._adam_step = orig
    assert [len(h) for h in halves] == [DP_WORLD, DP_WORLD] and state.step == 0
    want = (halves[0][0] + halves[0][1]) / 2
    got0, got1 = flat(r0["d_grad"]), flat(r1["d_grad"])
    local = [flat(r["local_d_grad"]) for r in ranks]
    reduced_exact = torch.equal(got0, (local[0] + local[1]) / 2)
    control = [rel(halves[1][i], halves[0][i]) for i in range(DP_WORLD)]
    local_vs_parent = [rel(local[i], halves[0][i]) for i in range(DP_WORLD)]
    log(f"phase two ranks D gradient ({want.numel()} values): all-reduced on rank 0 == rank 1: "
        f"{torch.equal(got0, got1)}; == (local 0 + local 1) / 2 bit for bit: {reduced_exact}; all-reduced vs the "
        f"mean of the half-batch gradients computed here |diff| / |mean| {rel(got0, want):.3g} (max |diff| "
        f"{float((got0 - want).abs().max()):.3g} of max |mean| {float(want.abs().max()):.3g}); each rank's local "
        f"gradient vs the same half computed here {local_vs_parent}; the same half computed twice here {control} "
        f"(tol {DP_GRAD_RTOL} on the all-reduced gradient vs the mean)")
    assert torch.equal(got0, got1) and reduced_exact
    assert rel(got0, want) <= DP_GRAD_RTOL, (rel(got0, want), DP_GRAD_RTOL)

    # Timings of the run_id-8 steps after the first (whose call pays
    # set-up): each rank's synchronized step spans and, inside them, its
    # three all-reduces a step (D's gradient, G's, the metrics).
    step_ms, reduce_ms, shares, ips = [], [], [], []
    for r in ranks:
        assert len(r["reduce_s"]) == 3 * len(r["step_s"]), (len(r["reduce_s"]), len(r["step_s"]))
        steps, reds = r["step_s"][1:n8], r["reduce_s"][3:3 * n8]
        step_ms.append(1e3 * float(np.median(steps)))
        reduce_ms.append([1e3 * float(np.median(reds[j::3])) for j in range(3)])
        shares.append(100 * sum(reds) / sum(steps))
        ips.append(TRAIN_BATCH / float(np.median(steps)))
    log(f"phase two ranks timings (a correctness configuration, not scaling: two ranks time-slice one card and "
        f"gloo stages each gradient through the host): steps 2-{n8} median {step_ms} ms per rank, combined "
        f"{ips} images/s (global batch {TRAIN_BATCH} a step); all-reduce medians (D gradient, G gradient, "
        f"metrics) {reduce_ms} ms; all-reduce share of the step time {shares} % (synchronized host-clock "
        f"spans); rank 1's first all-reduce, spent waiting for rank 0's FID baseline sweep (the rank-0 eval "
        f"wait), {r1['reduce_s'][0]:.2f} s against rank 0's {r0['reduce_s'][0]:.3f} s; on {smi}")
    return {kind: {"rank_launches": [r["launches"][0][meta["name"]] for r in ranks],
                   "rank_resume_launches": [r["launches"][1][meta["name"]] for r in ranks],
                   "rank_run_id0_launches": [r["launches"][2][meta["name"]] for r in ranks]}
            for kind, meta in KERNELS.items()}


def check_branches_against_cpu_plain():
    """Phase 12, continued: one tiny run_id-8 step of each new branch (and
    one crop + flip step) on the card against the CPU plain path, from one
    seeded state, draws injected: the metrics, ``pl_mean`` and the D and G
    gradients the step hands Adam (recorded by wrapping the step's Adam
    call).  Conditions are given (rendered once on the CPU) except in the
    crop + flip step, which renders them on each device."""
    import torch

    import gif_tpu_torch.train.step as step_mod
    from gif_tpu_torch.flame.resources import synthetic_flame_resources
    from gif_tpu_torch.train.config import TINY_OVERRIDES, get_config
    from gif_tpu_torch.train.state import create_train_state

    res = synthetic_flame_resources(seed=1, n_vertices=503)
    b, s = 4, TINY_OVERRIDES["max_size"]
    rng = np.random.default_rng(12)
    draws = {"shuffle_shift": 3, "noise_real": rng.standard_normal((b, s, s, 3)).astype(np.float32),
             "noise_fake": rng.standard_normal((2 * b, s, s, 3)).astype(np.float32),
             "noise_g": rng.standard_normal((1, b, s, s, 3)).astype(np.float32),
             "pl_z": rng.standard_normal((1, b, 512)).astype(np.float32),
             "pl_noise": rng.standard_normal((1, b, s, s, 3)).astype(np.float32)}
    cases = {
        "path_len_reg": dict(gen_reg_type="path_len_reg"),
        "direct_grad_reg": dict(gen_reg_type="direct_grad_reg"),
        "embedding_reg": dict(embedding_reg_weight=0.01),
        "shuffled_negatives": dict(shfld_cond_as_neg_smpl=True),
        "instance_noise": dict(d_input_noise_std=0.1),
        "crop_flip": dict(render_in_step=True),
    }
    for name, flags in cases.items():
        cfg = get_config(8, **{**TINY_OVERRIDES, "embedding_vocab_size": 16, "batch_size": b, "r1_interval": 2,
                               "render_in_step": False, **flags})
        case_draws = dict(draws, noise_fake=draws["noise_fake"][: 2 * b if cfg.shfld_cond_as_neg_smpl else b])
        base = train_batch(cfg, b, "cpu", seed=1)
        if cfg.render_in_step:
            base = augment_batch(base, seed=1)
        else:
            with torch.no_grad():
                base["cond"] = step_mod.render_condition_maps(res, base["flame"], cfg, res.n_faces)
        grads, mets, pl = {}, {}, {}
        for d in ("cuda", "cpu"):
            state = create_train_state(cfg, seed=0, device=d)
            state.step = 1  # (1 + 1) % 2 == 0: R1 fires
            recorded = []
            orig = step_mod._adam_step

            def adam_step(opt, params, g, orig=orig, recorded=recorded):
                recorded.append([t.detach().cpu() for t in g])
                orig(opt, params, g)

            step_mod._adam_step = adam_step
            try:
                step = step_mod.make_train_step(cfg, res, device=d, max_tris_per_tile=res.n_faces)
                _, m = step(state, {k: v.to(d) for k, v in base.items()}, case_draws)
            finally:
                step_mod._adam_step = orig
            grads[d] = [t for g in recorded for t in g]
            mets[d] = {k: v.item() for k, v in m.items()}
            pl[d] = state.pl_mean.item()
        g_err = max(((a - c).abs().max() / c.abs().max().clamp(min=1e-30)).item()
                    for a, c in zip(grads["cuda"], grads["cpu"]))
        m_err = max(abs(mets["cuda"][k] - mets["cpu"][k]) / max(abs(mets["cpu"][k]), 1e-12)
                    for k in ("d_loss", "g_loss", "r1", "g_total"))
        pl_err = abs(pl["cuda"] - pl["cpu"]) / max(abs(pl["cpu"]), 1e-12)
        bar = 1e-2 if cfg.render_in_step else 1e-3
        log(f"cuda vs cpu plain (tiny run_id-8 step, {name}, R1 on, draws injected): D and G gradients max "
            f"|diff| / max |cpu| per tensor {g_err:.3g}, metrics max relative diff {m_err:.3g}, pl_mean "
            f"{pl_err:.3g} (tol {bar:g}{': conditions rendered on each device' if cfg.render_in_step else ''}); "
            f"cuda {mets['cuda']}")
        assert len(grads["cuda"]) == len(grads["cpu"]) > 0 and mets["cuda"]["r1"] > 0
        assert g_err <= bar and m_err <= bar and pl_err <= bar, (name, g_err, m_err, pl_err)


# --- Phase 20: the generation path (the paper's figure scripts) -------------
GEN_SCRIPTS = ("generate_random_samples", "role_of_different_parameters", "generate_gif", "animate_teaser",
               "teaser", "landmark_overlay")
GEN_FULL_ARGS = {  # full width: the scripts' shares of the phase
    "generate_random_samples": ["--n", "64", "--batch", "16"],
    "role_of_different_parameters": ["--n_pairs", "2"],
    "generate_gif": ["--n_keyframes", "4", "--steps", "8"],
    "animate_teaser": ["--steps", "8"],
    "teaser": ["--n_identities", "1", "--steal_textures"],
    "landmark_overlay": ["--n", "8"],
}
GEN_TINY_ARGS = {  # one batch each (the teaser's 15 rows: two of 8)
    "generate_random_samples": ["--n", "4", "--batch", "4"],
    "role_of_different_parameters": ["--n_pairs", "1"],
    "generate_gif": ["--n_keyframes", "2", "--steps", "3"],
    "animate_teaser": ["--steps", "2"],
    "teaser": ["--n_identities", "1", "--steal_textures"],
    "landmark_overlay": ["--n", "3"],
}
GEN_KERNELS = ["raster", "sampler", "flr", "blur"]  # the generation path: G and the render forward only


class ScriptProbe:
    """While active, every ``FlameSampler`` the scripts build gets the
    raster capacity ``capacity`` (None: the script's own), and the probe
    keeps each sampler, each ``sample`` call's (sampler, indices, images,
    conditions), the start time of each batch and the end of each call,
    and the landmark projections of ``landmark_overlay``.  With
    ``record_first`` the first batch of the first sampler runs under a
    :class:`LaunchRecorder` (every launch held to its plain version).

    It also sees what the study scripts render outside a sampler: the
    display renders of ``renderer.render_tex_and_normal`` (given
    ``capacity`` too) and the condition maps of
    ``step.render_condition_maps``, counting their overflowed samples, and
    it keeps the statistics every Fréchet distance gets (with
    ``skip_sqrtm`` it returns NaN instead of taking the host square
    root)."""

    def __init__(self, capacity=None, record_first: bool = False, skip_sqrtm: bool = False):
        self.capacity, self.record_first, self.skip_sqrtm = capacity, record_first, skip_sqrtm
        self.samplers, self.samples, self.batch_starts, self.sample_ends = [], [], [], []
        self.landmarks, self.recorders, self.stats, self.conds = [], [], [], []
        self.display_overflows, self.cond_overflows = 0, 0

    def __enter__(self):
        import torch

        from gif_tpu_torch.eval import fid, sampling
        from gif_tpu_torch.render import renderer
        from gif_tpu_torch.scripts import landmark_overlay
        from gif_tpu_torch.train import step

        cls = sampling.FlameSampler
        self.saved = [(cls, n, cls.__dict__[n]) for n in ("__init__", "sample", "_run")]
        for owner, name in ((landmark_overlay, "project_landmarks"), (renderer, "render_tex_and_normal"),
                            (step, "render_condition_maps"), (fid, "frechet_distance")):
            self.saved.append((owner, name, getattr(owner, name)))
        init, sample, run, project, render, conditions, frechet = (f for _, _, f in self.saved)
        probe = self

        def init_(sampler, *a, **kw):
            init(sampler, *a, **kw)
            if probe.capacity is not None:
                sampler.max_tris_per_tile = probe.capacity
            probe.samplers.append(sampler)

        def sample_(sampler, flame, indices):
            images, conds = sample(sampler, flame, indices)
            probe.sample_ends.append(time.perf_counter())
            probe.samples.append((sampler, np.array(indices), images, conds))
            return images, conds

        def run_(sampler, flame, indices):
            probe.batch_starts.append(time.perf_counter())
            if probe.record_first and not probe.recorders:
                with LaunchRecorder() as rec:
                    out = run(sampler, flame, indices)
                    torch.cuda.synchronize()
                probe.recorders.append(rec)
                return out
            return run(sampler, flame, indices)

        def project_(*a, **kw):
            # The helper defaults to the card: callers name the device.
            assert len(a) == 4 or "device" in kw, "project_landmarks called without a device"
            pts = project(*a, **kw)
            probe.landmarks.append(pts)
            return pts

        def render_(*a, **kw):
            if probe.capacity is not None:
                kw["max_tris_per_tile"] = probe.capacity
            maps = render(*a, **kw)
            probe.display_overflows += int(maps.overflow.sum())
            return maps

        def conditions_(res, flame, cfg, max_tris_per_tile=None, return_overflow=False):
            cond, overflow = conditions(res, flame, cfg, max_tris_per_tile, return_overflow=True)
            probe.cond_overflows += int(overflow.sum())
            probe.conds.append(cond.float().cpu().numpy())
            return (cond, overflow) if return_overflow else cond

        def frechet_(*a):
            probe.stats.append([np.asarray(x, np.float64) for x in a])
            return float("nan") if probe.skip_sqrtm else frechet(*a)

        cls.__init__, cls.sample, cls._run = init_, sample_, run_
        landmark_overlay.project_landmarks = project_
        renderer.render_tex_and_normal = render_
        step.render_condition_maps = conditions_
        fid.frechet_distance = frechet_
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)

    @property
    def render_overflows(self) -> int:
        return sum(s.render_overflows for s in self.samplers) + self.display_overflows + self.cond_overflows


def write_trees(cfg, path: str, device=None) -> None:
    """The trees pickle (``g_params``, ``g_ema_params``, ``d_params``,
    ``buffers``) of a fresh seeded port train state of ``cfg``: what
    ``--converted_ckpt`` loads."""
    import pickle

    from gif_tpu_torch.tools.convert_params import train_state_trees
    from gif_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg, seed=0, device=device)
    with open(path, "wb") as f:
        pickle.dump(train_state_trees(state), f)


def run_script(name: str, args: list) -> None:
    import importlib

    importlib.import_module(f"gif_tpu_torch.scripts.{name}").main(args)


def check_generation_against_cpu_plain(tmp: str, names=GEN_SCRIPTS, tiny_args=GEN_TINY_ARGS) -> None:
    """Phase 20's first part (and phase 22's, for the study scripts): every
    script of ``names`` once at ``--tiny`` (one batch each, the FLAME-sized
    synthetic mesh, run_id 0's tiny G at f32) on the card and on the CPU,
    from one trees pickle: the conditions of every ``FlameSampler.sample``
    call within one 8-bit step on < 0.5% of values, the card's G fed the
    CPU's conditions within 1e-3 of the CPU images, the landmark
    projections within 1e-3 px, the stolen textures within 1e-2 on all but
    0.1% of texels (a visibility flip moves a texel by the whole value);
    the statistics ``compute_fid_for_models`` hands the Fréchet distance
    within 1e-3 of their largest magnitude (its host square root is
    skipped: the same scipy call on either device), and
    ``show_training_data``'s grids within one level on < 0.5% of values."""
    import torch

    from gif_tpu_torch.train.config import TINY_OVERRIDES, get_config

    trees = os.path.join(tmp, "tiny_trees.pkl")
    write_trees(get_config(0, **TINY_OVERRIDES, embedding_vocab_size=16), trees, device="cpu")
    step = 2.0 / 255.0
    for name in names:
        runs = {}
        for d in ("cuda", "cpu"):
            out = os.path.join(tmp, f"tiny_{name}_{d}")
            extra = {"generate_gif": ["--out", out + ".gif"], "compute_fid_for_models": ["--out", out + ".json"]}
            model = [] if name == "show_training_data" else ["--vocab", "16", "--converted_ckpt", trees]
            with ScriptProbe(skip_sqrtm=True) as probe:
                run_script(name, ["--tiny", "--flame_resources", "synthetic", *model, "--device", d, *tiny_args[name],
                                  *extra.get(name, ["--out_dir", out])])
            runs[d] = probe
        flips, img_err = 0.0, 0.0
        assert len(runs["cuda"].samples) == len(runs["cpu"].samples), name
        for (sampler, idx, g_img, g_cond), (_, _, c_img, c_cond) in zip(runs["cuda"].samples, runs["cpu"].samples):
            diff = np.abs(g_cond - c_cond)
            assert diff.max() <= step * 1.001, (name, diff.max())
            flips = max(flips, float((diff > step * 0.5).mean()))
            with torch.inference_mode():
                g_on_c = sampler.generator(torch.from_numpy(c_cond).cuda(), input_indices=torch.from_numpy(idx).cuda(),
                                           step=sampler.cfg.max_step).cpu().numpy()
            img_err = max(img_err, float(np.abs(g_on_c - c_img).max()))
            assert np.isfinite(g_img).all()
        lmk_err = max([float(np.abs(a - b).max()) for a, b in zip(runs["cuda"].landmarks, runs["cpu"].landmarks)]
                      or [0.0])
        more = ""
        if name == "teaser":
            from PIL import Image

            t = [np.stack([np.asarray(Image.open(os.path.join(tmp, f"tiny_teaser_{d}", "identity_0",
                                                             f"texture_{i}.png"))) for i in range(15)])
                 for d in ("cuda", "cpu")]
            off = float((np.abs(t[0].astype(int) - t[1].astype(int)) > 2.55).any(-1).mean())
            more = f", stolen textures: texels off by > 1e-2 {off:.5f} (tol 0.001)"
            assert off <= 1e-3, off
        if name == "compute_fid_for_models":
            (got,), (want,) = runs["cuda"].stats, runs["cpu"].stats
            scale = max(float(np.abs(w).max()) for w in want)
            stat_err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
            more = f", Fréchet statistics max |diff| {stat_err:.3g} (tol 1e-3 x {scale:.3g})"
            assert stat_err <= 1e-3 * scale, (stat_err, scale)
        if name == "show_training_data":
            # The conditions each device rendered, then the grids written
            # (a value on a level's edge may truncate to either side).
            assert len(runs["cuda"].conds) == len(runs["cpu"].conds) > 0
            for g_cond, c_cond in zip(runs["cuda"].conds, runs["cpu"].conds):
                diff = np.abs(g_cond - c_cond)
                assert diff.max() <= step * 1.001, (name, diff.max())
                flips = max(flips, float((diff > step * 0.5).mean()))
            levels = _png_diff(os.path.join(tmp, f"tiny_{name}_cuda", "batch_0.png"),
                               os.path.join(tmp, f"tiny_{name}_cpu", "batch_0.png"))
            more = f", grid PNG max level diff {levels.max()} (tol 1)"
            assert levels.max() <= 1, levels.max()
        else:
            assert runs["cuda"].samples or runs["cuda"].stats, name
        log(f"cuda vs cpu plain ({name} --tiny, FLAME-sized mesh, 32 px): {len(runs['cuda'].samples)} sample "
            f"call(s), cond one-step flips {flips:.4f} (tol 0.005), card G on the CPU conditions max_abs_err "
            f"{img_err:.3g} (tol 1e-3), landmarks max |diff| {lmk_err:.3g} px (tol 1e-3){more}")
        assert flips < 0.005 and img_err < 1e-3 and lmk_err < 1e-3, name


def _png_diff(a: str, b: str) -> np.ndarray:
    """|a - b| of two PNGs' pixel levels."""
    from PIL import Image

    with Image.open(a) as x, Image.open(b) as y:
        return np.abs(np.asarray(x).astype(int) - np.asarray(y).astype(int))


def generation_path(counters: dict, smi: str):
    """Phase 20: the paper's figure scripts on the card at run_id 0's
    full width (256 px, 512 channels, 69158 identities, bf16 convs), the
    FLAME-sized synthetic mesh, from a trees pickle written from a seeded
    port train state; then the generation library calls.  Returns
    (launches by counter name, the recorded launches' largest errors by
    kernel)."""
    import tempfile

    import torch

    from gif_tpu_torch.eval.sampling import FlameSampler, load_generator_params, random_flame_params
    from gif_tpu_torch.flame.camera import position_to_given_location
    from gif_tpu_torch.flame.resources import synthetic_flame_resources
    from gif_tpu_torch.models.generator import StyledGenerator
    from gif_tpu_torch import constants as cnst
    from gif_tpu_torch.flame.camera import batch_orth_proj
    from gif_tpu_torch.flame.decoder import flame_decode
    from gif_tpu_torch.render import FlameRenderer, get_visibility, get_visibility_z
    from gif_tpu_torch.train.config import get_config

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gif_gen_") as tmp:
        check_generation_against_cpu_plain(tmp)

        t0 = time.perf_counter()
        cfg = get_config(0)
        trees = os.path.join(tmp, "trees.pkl")
        write_trees(cfg, trees)
        res = synthetic_flame_resources()
        log(f"phase generation setup: run_id 0, {cfg.max_size} px, max_channels {cfg.max_channels}, vocab "
            f"{cfg.embedding_vocab_size}, {cfg.compute_dtype}, mesh {res.n_vertices} vertices / {res.n_faces} "
            f"faces, trees pickle {os.path.getsize(trees)} bytes from a seeded port train state: "
            f"{time.perf_counter() - t0:.2f} s")
        # The landmark overlay's --reinferred fits: its own eye-centred draws,
        # so the re-inference error must read 0.
        fl = random_flame_params(np.random.default_rng(0), 8)
        fits = position_to_given_location(res, torch.as_tensor(fl, device="cuda")).cpu().numpy()
        np.save(os.path.join(tmp, "fits.npy"), fits)
        common = ["--run_id", "0", "--flame_resources", "synthetic", "--converted_ckpt", trees, "--device", "cuda"]
        extra = {"generate_gif": ["--out", os.path.join(tmp, "full_generate_gif.gif")],
                 "landmark_overlay": ["--reinferred", os.path.join(tmp, "fits.npy")]}
        errs, secs, probes = {}, {}, {}
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        for name in GEN_SCRIPTS:
            out = ["--out_dir", os.path.join(tmp, f"full_{name}")] if name != "generate_gif" else []
            t0 = time.perf_counter()
            # The synthetic mesh's eye-centred heads overflow the mesh-derived
            # capacity (phase 2), so the samplers bin up to the face count.
            with ScriptProbe(capacity=res.n_faces, record_first=name == "generate_random_samples") as probe:
                if name == "teaser":
                    with LaunchRecorder() as rec:
                        run_script(name, [*common, *GEN_FULL_ARGS[name], *out, *extra.get(name, [])])
                        torch.cuda.synchronize()
                    probe.recorders.append(rec)
                else:
                    run_script(name, [*common, *GEN_FULL_ARGS[name], *out, *extra.get(name, [])])
            secs[name] = time.perf_counter() - t0
            probes[name] = probe
            for rec in probe.recorders:
                for kind, st in rec.stats.items():
                    if st:
                        errs[kind] = max(errs.get(kind, 0.0), st["max_abs_err"])
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}

        # Checks: files, finite images, no overflow, the recorded launches.
        for path in ("full_generate_random_samples/images/img_63.png", "full_generate_random_samples/params.npy",
                     "full_role_of_different_parameters/pair_1/norm_5.png", "full_generate_gif.gif",
                     "full_animate_teaser/teaser_animation.gif", "full_teaser/identity_0/rows.txt",
                     "full_teaser/identity_0/texture_12.png", "full_landmark_overlay/lmk_face_7.png"):
            assert os.path.getsize(os.path.join(tmp, path)) > 0, path
        n_images = {name: sum(len(s[2]) for s in p.samples) for name, p in probes.items()}
        for name, p in probes.items():
            for _, _, images, conds in p.samples:
                assert images.shape[1:] == (cfg.max_size, cfg.max_size, 3) and np.isfinite(images).all(), name
                assert np.isfinite(conds).all() and images.max() > images.min(), name
            assert p.render_overflows == 0, (name, p.render_overflows)
        first = probes["generate_random_samples"].recorders[0]
        steal = probes["teaser"].recorders[0]
        assert len(first.rounds) == 1 and all(first.rounds[0][k] for k in GEN_KERNELS), \
            {k: len(v) for k, v in first.rounds[0].items()}
        # The steal's launch: kernel 2 on the (B, texels, 1, 2) point grid.
        assert len(steal.rounds) == 2 and any(sig[1][1:] == (len(res.texture_x_coords), 1, 2)
                                              for sig in steal.rounds[-1]["sampler"]), steal.rounds[-1]["sampler"]
        lmk = probes["landmark_overlay"].landmarks
        assert len(lmk) == 2 and np.array_equal(lmk[0], lmk[1]), "re-inference error is not 0"
        assert all(launches[KERNELS[k]["name"]] > 0 for k in GEN_KERNELS), launches
        assert all(launches[KERNELS[k]["name"]] == 0 for k in ("flr_bwd", "blur_vjp", "scatter")), launches

        # images/s of generate_random_samples over its batches after the
        # recorded first one (host clock: render + G + readback).
        g = probes["generate_random_samples"]
        t_batches = g.sample_ends[-1] - g.batch_starts[1]
        ips = 16 * (len(g.batch_starts) - 1) / t_batches
        log(f"phase generation: six scripts at full width in {sum(secs.values()):.2f} s host clock "
            f"({', '.join(f'{k} {v:.2f} s / {n_images[k]} images' for k, v in secs.items())}); launches {launches}; "
            f"render overflow 0; recorded launches (generate_random_samples' first batch, the teaser with its "
            f"steal) max_abs_err {errs}; landmark re-inference error 0")
        log(f"generation images/s (generate_random_samples, batch 16, batches 2-{len(g.batch_starts)}, host clock: "
            f"render + G + readback): {ips:.2f}; on {smi}")

        # Library calls on the card.
        t0 = time.perf_counter()
        gen = StyledGenerator.from_config(cfg)
        gen.load_state_dict(load_generator_params(cfg, converted_ckpt=trees))
        gen = gen.cuda().eval()
        rng = np.random.default_rng(20)
        cond = torch.as_tensor(rng.uniform(-1, 1, (4, 256, 256, cfg.cond_channels)).astype(np.float32), device="cuda")
        zs = [torch.as_tensor(rng.standard_normal((4, 512)).astype(np.float32), device="cuda") for _ in range(2)]
        with torch.inference_mode():
            mixed = gen(cond, z=zs, step=cfg.max_step, inject_index=[cfg.max_step // 2])
            single = gen(cond, z=zs[0], step=cfg.max_step)
            with plain_kernels():
                want = gen(cond, z=zs, step=cfg.max_step, inject_index=[cfg.max_step // 2])
        mix_err = (mixed - want).abs().max().item()
        mix_bar = want.abs().max().item() * 2.0**-7
        assert mix_err <= mix_bar and (mixed - single).abs().max().item() > 1e-3, (mix_err, mix_bar)

        flame = torch.as_tensor(random_flame_params(np.random.default_rng(21), 8), device="cuda")
        trans = batch_orth_proj(flame_decode(res, flame[:, :100], flame[:, 100:150], flame[:, 150:156]),
                                flame[:, 156:159])
        ndc = torch.cat([trans[:, :, :1], -trans[:, :, 1:]], dim=2)
        before = counters["raster"].launches
        vis = {fn.__name__: fn(ndc, res.faces, 256, 256) for fn in (get_visibility, get_visibility_z)}
        torch.cuda.synchronize()
        assert counters["raster"].launches == before + 2
        with plain_render():
            vis_plain = {fn.__name__: fn(ndc, res.faces, 256, 256) for fn in (get_visibility, get_visibility_z)}
        for k in vis:
            assert torch.equal(vis[k], vis_plain[k]), k
            assert bool((vis[k] > 0).any()) and bool((vis[k] == 0).any()), k

        before = counters["raster"].launches, counters["sampler"].launches
        (tex0, tex1), (lit0, lit1) = cnst.DECA_IDX["tex"], cnst.DECA_IDX["lit"]
        fr = FlameRenderer(res, image_size=256)
        params = (flame[:, :100], flame[:, 100:150], flame[:, 150:156], flame[:, lit0:lit1].reshape(8, 9, 3),
                  flame[:, tex0:tex1])
        normal, textured = fr.get_rendered_mesh(params, flame[:, 156:159], constant_albedo=0.6)
        torch.cuda.synchronize()
        assert (counters["raster"].launches, counters["sampler"].launches) == (before[0] + 1, before[1])
        with plain_render():
            want_n, want_t = fr.get_rendered_mesh(params, flame[:, 156:159], constant_albedo=0.6)
        # The vertex normals are index_add_ sums whose atomics add in no
        # fixed order: a floored value may move by one 8-bit step.
        fr_flips = max(float(((a - b).abs() > 0).float().mean()) for a, b in ((normal, want_n), (textured, want_t)))
        fr_err = max((a - b).abs().max().item() for a, b in ((normal, want_n), (textured, want_t)))
        assert fr_err <= 1.001 / 255.0 and fr_flips < 1e-3 and bool((textured > 0).any()), (fr_err, fr_flips)
        log(f"phase generation library calls ({time.perf_counter() - t0:.2f} s): style-mixed G (two z, inject_index "
            f"[{cfg.max_step // 2}], batch 4, {cfg.compute_dtype}) vs the plain kernels max_abs_err {mix_err:.3g} (tol 1 bf16 step of the max: "
            f"{mix_bar:.3g}); get_visibility / get_visibility_z (batch 8, 256 px, kernel 1) equal to the plain "
            f"rasterizer's, visible share {[round(float(v.mean()), 4) for v in vis.values()]}; FlameRenderer "
            f"constant_albedo 0.6 (batch 8): one raster launch, no sampler launch, maps against the plain render: "
            f"max diff {fr_err:.3g} on {fr_flips:.2g} of values (tol one 8-bit step on < 0.001)")
    log(f"phase generation: {time.perf_counter() - t_phase:.2f} s in all (the tiny CUDA-vs-CPU check included)")
    return launches, errs


# --- Phase 21: resampling modes, the bench and measurement scripts, the eye
# regressor, the deterministic resume, serving a checkpoint, the converters ---

RESAMPLE_MODES = ("legacy", "even", "phase")
# What the modes may differ by, on one set of weights and one batch: G's
# bf16 images are held to the same G in f32 (legacy), each mode's largest
# difference at most RESAMPLE_IMAGE_FACTOR times legacy's own (``phase``
# folds the FIR into bf16 weights: other roundings, not more of them);
# the warm-up step's d_loss and g_loss within 5e-2 of legacy's, R1 (D
# alone, a squared gradient norm) within 0.25.
RESAMPLE_IMAGE_FACTOR, RESAMPLE_LOSS_RTOL, RESAMPLE_R1_RTOL = 2.0, 5e-2, 0.25
# The deterministic resume: DET_STEPS steps, a checkpoint half-way, R1 in
# the resumed half (r1_interval 8: step 7), on a DET_DATASET-frame render
# dataset.
DET_STEPS, DET_DATASET, DET_R1_INTERVAL = 10, 128, 8
EYE_ROWS, EYE_EPOCHS = 16384, 5


def resample_modes(res, counters: dict, smi: str):
    """Phase 21, first part: the run_id-8 R1 step at full width (batch 16)
    under each resampling mode, from the same seeded state and batch: G's
    images of four condition maps before the step against the same G in
    f32, and the recorded warm-up R1 step's losses against ``legacy``'s,
    every launch of that step held to its plain version; then 3 counted
    steps (13-15, R1 on the third) with every counter 0 just before and
    read just after; then step times with the modes in turns on one state
    (the mode is read at every call).  Returns ({mode: launches}, {mode:
    recorded warm-up launches}, {kind: max_abs_err})."""
    import torch

    from gif_tpu_torch.models.generator import StyledGenerator
    from gif_tpu_torch.train.config import get_config
    from gif_tpu_torch.train.state import create_train_state
    from gif_tpu_torch.train.step import make_train_step

    cfg = get_config(8, batch_size=TRAIN_BATCH)
    batch = train_batch(cfg, TRAIN_BATCH, "cuda")
    rng = np.random.default_rng(21)
    cond = torch.as_tensor(rng.uniform(-1, 1, (4, cfg.max_size, cfg.max_size, cfg.cond_channels)).astype(np.float32),
                           device="cuda")
    idx = torch.as_tensor([3, 1000, 20000, 69000], device="cuda")
    saved = os.environ.get("GIF_TPU_TORCH_RESAMPLE")
    out, launches, warm, errs = {}, {}, {}, {}
    try:
        for mode in RESAMPLE_MODES:
            os.environ["GIF_TPU_TORCH_RESAMPLE"] = mode
            state = create_train_state(cfg, seed=0)
            step = make_train_step(cfg, res, max_tris_per_tile=res.n_faces, generator=torch.Generator().manual_seed(0))
            with torch.inference_mode():
                images = state.generator(cond, input_indices=idx, step=cfg.max_step).float()
                if mode == "legacy":
                    g32 = StyledGenerator.from_config(get_config(8, compute_dtype="float32")).cuda().eval()
                    g32.load_state_dict(state.generator.state_dict())
                    exact = g32(cond, input_indices=idx, step=cfg.max_step).float()
                    del g32
            state, m0, warm[mode], e = record_warmup(step, state, batch, RUN8_KERNELS, f"resample {mode}")
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)
            state.step = 13
            steps, launches[mode], peak, moved = run_train_steps(step, state, batch, counters)
            for i, dt, m, _ in steps:
                assert all(np.isfinite(v) for v in m.values()) and (m["r1"] > 0) == (i == 15), (mode, i, m)
            assert all(v > 0 for v in moved.values()), (mode, moved)
            # D's launches count apart, on the channels-last counters (the
            # phase mode's G launches no kernel 4).
            ran = [launches[mode][KERNELS[k]["name"]] + launches[mode].get(KERNELS[k]["name"] + "_cl", 0)
                   for k in RUN8_KERNELS]
            assert all(n > 0 for n in ran), (mode, launches[mode])
            out[mode] = ((images - exact).abs().max().item(), m0)
            log(f"phase resample {mode}: counted steps 13-15 at batch {TRAIN_BATCH}, peak memory "
                f"{peak / 2**30:.2f} GiB; launches {launches[mode]}")
            if mode != RESAMPLE_MODES[-1]:
                del state, step, steps
                torch.cuda.empty_cache()

        # Step times in turns, on the last mode's state: plain steps
        # (legacy, even, phase, phase, even, legacy) twice, R1 steps once.
        times_ms = {m: {"plain": [], "r1": []} for m in RESAMPLE_MODES}
        order = RESAMPLE_MODES + RESAMPLE_MODES[::-1]
        for kind, i, rounds in (("plain", 16, 2), ("r1", 15, 1)):
            for mode in order * rounds:
                os.environ["GIF_TPU_TORCH_RESAMPLE"] = mode
                state.step = i
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                times_ms[mode][kind].append(1e3 * (time.perf_counter() - t0))
                assert (m["r1"].item() > 0) == (kind == "r1")
        del state, step
        torch.cuda.empty_cache()
    finally:
        if saved is None:
            os.environ.pop("GIF_TPU_TORCH_RESAMPLE", None)
        else:
            os.environ["GIF_TPU_TORCH_RESAMPLE"] = saved
    ref_err, ref_m = out["legacy"]
    log(f"phase resample legacy (bf16) vs the same G in f32: G images (4 x 256 px) max |diff| {ref_err:.4g}")
    for mode in ("even", "phase"):
        img_err, m = out[mode]
        rel = {k: abs(m[k] - ref_m[k]) / abs(ref_m[k]) for k in ("d_loss", "g_loss", "r1")}
        log(f"phase resample {mode} (bf16) vs the same G in f32 (legacy): G images max |diff| {img_err:.4g} (tol "
            f"{RESAMPLE_IMAGE_FACTOR} x legacy's {ref_err:.4g}); its warm-up R1 step against legacy's, relative "
            f"{rel} (tol d_loss / g_loss {RESAMPLE_LOSS_RTOL}, r1 {RESAMPLE_R1_RTOL})")
        assert img_err <= RESAMPLE_IMAGE_FACTOR * ref_err, (mode, img_err, ref_err)
        assert rel["d_loss"] <= RESAMPLE_LOSS_RTOL and rel["g_loss"] <= RESAMPLE_LOSS_RTOL, (mode, rel)
        assert rel["r1"] <= RESAMPLE_R1_RTOL, (mode, rel)
    blur = {mode: (launches[mode]["fir_blur"], launches[mode]["fir_blur_vjp"]) for mode in RESAMPLE_MODES}
    assert blur["phase"][0] < blur["legacy"][0] and blur["phase"][1] < blur["legacy"][1], blur
    assert blur["even"] == blur["legacy"], blur
    med = {m: {k: round(float(np.median(v)), 2) for k, v in t.items()} for m, t in times_ms.items()}
    log(f"phase resample step times in turns (host clock, synchronized; ms): {times_ms}; medians {med}; kernel-4 "
        f"launches (forward, VJP) in 3 counted steps {blur}; on {smi}")
    return launches, warm, errs


def run_module(args: list, timeout: int = 600, env=None) -> str:
    """``python -m <args>`` from the repository root in a child process;
    its standard output (raises with its errors when it fails)."""
    p = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                       env=env)
    assert p.returncode == 0, f"{args} exited {p.returncode}:\n{p.stdout[-3000:]}\n{p.stderr[-6000:]}"
    return p.stdout


def bench_lines() -> dict:
    """Phase 21: ``python -m gif_tpu_torch.bench`` for run_id 8 and 0, each
    in its own process, echoing its JSON line."""
    lines = {}
    for run_id in (8, 0):
        t0 = time.perf_counter()
        line = json.loads(run_module(["gif_tpu_torch.bench", "--run_id", str(run_id)]).strip().splitlines()[-1])
        log(f"phase bench run_id {run_id} ({time.perf_counter() - t0:.1f} s, its own process): {json.dumps(line)}")
        keys = ["metric", "value", "unit", "vs_baseline", "spread", "chains", "flops_per_step", "mfu"]
        assert list(line)[:len(keys)] == keys and line["value"] > 0 and len(line["chains"]) == 3, line
        assert run_id == 8 or line["render_overflow"] == 0.0, line
        lines[run_id] = line
    return lines


def measurement_scripts(tmp: str, bench: dict, smi: str) -> dict:
    """Phase 21: ``profile_step`` (run_id 8 and 0), ``mfu_report`` at the
    bench's images/s, and ``blur_hw_check``, in this process."""
    import gc

    import torch

    from gif_tpu_torch.scripts import blur_hw_check, mfu_report, profile_step

    out = {}
    for run_id in (8, 0):
        t0 = time.perf_counter()
        prof = profile_step.main(["--run_id", str(run_id), "--out_dir", os.path.join(tmp, f"profile_{run_id}")])
        log(f"phase profile_step run_id {run_id} ({time.perf_counter() - t0:.1f} s): {prof['wall_ms_per_step']:.2f} ms "
            f"a step host clock, device busy {prof['busy_ms_per_step']:.2f} ms ({100 * prof['busy_share']:.1f}%), "
            f"{prof['device_ops_per_step']:.0f} device ops a step; top ops (ms a step) "
            f"{[(n[:60], round(ms, 3)) for n, ms in prof['top_ops'][:8]]}")
        assert prof["device_ops_per_step"] > 0 and prof["busy_share"] > 0, prof
        prof.pop("top_ops")
        out[f"profile_{run_id}"] = prof
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mfu = mfu_report.main(["--run_id", str(run_id), "--imgs_per_sec", str(bench[run_id]["value"])])
        log(f"phase mfu_report run_id {run_id} ({time.perf_counter() - t0:.1f} s): {mfu}")
        assert mfu["step_flops"] > mfu["g_forward_flops"] > 0 and mfu["peak_flops_bf16"], mfu
        out[f"mfu_{run_id}"] = mfu
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows = blur_hw_check.main(["--iters", "20"])
    log(f"phase blur_hw_check ({time.perf_counter() - t0:.1f} s): {rows}; on {smi}")
    # bf16 in and out: one bf16 step of the largest value apart at most.
    assert all(r["rel_err"] <= 2.0**-7 and r["grad_rel_err"] <= 2.0**-6 for r in rows), rows
    out["blur_hw_check"] = rows
    return out


def eye_regressor_phase(res, smi: str) -> dict:
    """Phase 21: the eye-camera regressor on the FLAME-sized synthetic mesh:
    EYE_ROWS rows of solver targets generated on the card (shape 0-2,
    expression 0-2 and the pose varied: the regressor's features), then
    ``train_regressor`` for EYE_EPOCHS epochs on the card; rows/s of both
    and the held-out MSE against predicting the training mean."""
    import torch

    from gif_tpu_torch.flame.eye_regressor import generate_training_data, train_regressor

    rng = np.random.default_rng(22)
    flame = np.zeros((EYE_ROWS, 236), np.float32)
    flame[:, :3] = rng.standard_normal((EYE_ROWS, 3)) * 0.3
    flame[:, 100:103] = rng.standard_normal((EYE_ROWS, 3)) * 0.2
    flame[:, 150:156] = rng.standard_normal((EYE_ROWS, 6)) * 0.05
    generate_training_data(res, flame[:256], device="cuda")  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, y = generate_training_data(res, flame, batch_size=1024, device="cuda")
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    reg = train_regressor(res, flame, epochs=EYE_EPOCHS, batch_size=256, lr=1e-3, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0 - gen_s  # train_regressor generates its data again first
    n_val = max(1, int(EYE_ROWS * 0.1))
    base = float(np.mean((y[-n_val:] - y[:-n_val].mean(0)) ** 2))
    n_steps = EYE_EPOCHS * ((EYE_ROWS - n_val) // 256)
    out = {"rows": EYE_ROWS, "data_rows_per_s": EYE_ROWS / gen_s, "train_rows_per_s": n_steps * 256 / train_s,
           "val_mse": reg.val_mse, "mean_baseline_mse": base}
    log(f"phase eye regressor (mesh {res.n_vertices} vertices, FLAME's eye vertex ids): solver targets "
        f"{out['data_rows_per_s']:.0f} rows/s ({EYE_ROWS} rows, batch 1024), training {EYE_EPOCHS} epochs "
        f"({n_steps} Adam steps of 256) {out['train_rows_per_s']:.0f} rows/s; held-out MSE {reg.val_mse:.6g} "
        f"against the predict-the-mean {base:.6g}; on {smi}")
    assert np.isfinite(reg.val_mse) and reg.val_mse < base, out
    return out


def deterministic_child(tmp: str) -> None:
    """Phase 21's deterministic run, in its own process started with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (cuBLAS reads it once): phase 16's
    resume with ``train(deterministic=True)`` — DET_STEPS steps at run_id 8,
    full width, batch 16, checkpoint half-way, then the run cut back to it
    and resumed — every step's d_loss and g_loss, and the final weights,
    bit-equal; two identical kernel-6 calls and ``index_add_`` calls
    bit-equal under the flag; and the cost of the flag on bare steps
    (run_id 8 plain and R1, run_id 0 plain; off / on / on / off).  Writes
    ``tmp/det.json``."""
    import shutil

    import torch

    from gif_tpu_torch import kernels
    from gif_tpu_torch.data.pipeline import FlameDataset, SyntheticRenderDataset
    from gif_tpu_torch.device import set_deterministic
    from gif_tpu_torch.flame.resources import synthetic_flame_resources
    from gif_tpu_torch.render import sampling_ops, scatter_cuda
    from gif_tpu_torch.train import loop
    from gif_tpu_torch.train.config import get_config
    from gif_tpu_torch.train.state import create_train_state
    from gif_tpu_torch.train.step import make_train_step

    kernels.build()
    res = synthetic_flame_resources()
    counters = kernel_counters()
    cfg = get_config(8, batch_size=TRAIN_BATCH, fid_every=10**9, checkpoint_every=DET_STEPS // 2,
                     r1_interval=DET_R1_INTERVAL)
    ds = SyntheticRenderDataset(res, n=DET_DATASET, size=cfg.max_size, seed=0, cache_dir=os.path.join(tmp, "synth"),
                                max_tris_per_tile=res.n_faces)
    run_kw = dict(total_iters=DET_STEPS, log_every=DET_STEPS // 2, max_tris_per_tile=res.n_faces, deterministic=True)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with LoopProbe(counters, record=False) as a:
        loop.train(cfg, ds, res, os.path.join(tmp, "a"), **run_kw)
        torch.cuda.synchronize()
    run_s, launches = time.perf_counter() - t0, {k: fn.launches for k, fn in counters.items()}
    digest_a = param_digest(a.state)
    shutil.copytree(os.path.join(tmp, "a"), os.path.join(tmp, "b"))
    _truncate_run(os.path.join(tmp, "b", "8"), DET_STEPS // 2)
    for fn in counters.values():
        fn.launches = 0
    with LoopProbe(counters, record=False) as b:
        loop.train(cfg, FlameDataset(ds.images, ds.flame_params), res, os.path.join(tmp, "b"), **run_kw)
        torch.cuda.synchronize()
    launches_b = {k: fn.launches for k, fn in counters.items()}
    la = {i: (m["d_loss"].item(), m["g_loss"].item()) for i, m in a.metrics}
    lb = {i: (m["d_loss"].item(), m["g_loss"].item()) for i, m in b.metrics}
    r1 = [i for i, m in b.metrics if m["r1"].item() > 0]
    result = {"run_s": run_s, "launches": launches, "resume_launches": launches_b, "losses": la, "resumed": lb,
              "r1_steps": r1, "digest_equal": param_digest(b.state) == digest_a,
              "batches_equal": all(b.digests[i] == a.digests[i] for i in b.digests),
              "flag_off_after": not torch.are_deterministic_algorithms_enabled(),
              "ckpt": os.path.join(tmp, "b", "8", "checkpoint")}
    del a, b
    torch.cuda.empty_cache()

    # Kernel 6 (the fixed-order accumulate) and index_add_ twice on the same
    # inputs under the flag, at the run_id-0 steal's and the vertex
    # normals' shapes.
    rng = np.random.default_rng(23)
    g = torch.as_tensor(rng.standard_normal((15, 20000, 3)).astype(np.float32), device="cuda")
    pts = torch.as_tensor(rng.uniform(-0.5, 0.5, (15, 20000, 2)).astype(np.float32), device="cuda")
    rows = torch.as_tensor(rng.integers(0, 5023, 16 * 30000), device="cuda")
    src = torch.as_tensor(rng.standard_normal((16 * 30000, 3)).astype(np.float32), device="cuda")

    def index_add():
        return torch.zeros((5023, 3), device="cuda").index_add_(0, rows, src)

    pair = {}
    for det in (False, True):
        set_deterministic(det)
        pair[det] = dict(
            scatter=[scatter_cuda.scatter_bilinear(g, pts, 256, 256) for _ in range(2)],
            index_add=[index_add() for _ in range(2)],
            scatter_ms=queued_ms(lambda: scatter_cuda.scatter_bilinear(g, pts, 256, 256)),
            index_add_ms=queued_ms(index_add),
        )
    set_deterministic(False)
    plain = sampling_ops.scatter_bilinear_plain(g, pts, 256, 256)
    result["kernel6"] = {
        "fixed_equal": bool(torch.equal(*pair[True]["scatter"])),
        "default_equal": bool(torch.equal(*pair[False]["scatter"])),
        "fixed_err": (pair[True]["scatter"][0] - plain).abs().max().item(),
        "bar": 1e-5 * plain.abs().max().item() + 1e-7,
        "fixed_ms": pair[True]["scatter_ms"], "default_ms": pair[False]["scatter_ms"],
        "index_add_equal": bool(torch.equal(*pair[True]["index_add"])),
        "index_add_default_equal": bool(torch.equal(*pair[False]["index_add"])),
        "index_add_ms": pair[True]["index_add_ms"], "index_add_default_ms": pair[False]["index_add_ms"],
    }
    del pair, plain

    # The flag's cost on bare steps, in turns within this process.
    cost = {}
    for run_id in (8, 0):
        cfg_s = get_config(run_id, batch_size=TRAIN_BATCH)
        state = create_train_state(cfg_s, seed=0)
        step = make_train_step(cfg_s, res, max_tris_per_tile=res.n_faces, generator=torch.Generator().manual_seed(0))
        batch = train_batch(cfg_s, TRAIN_BATCH, "cuda")
        times_s = {False: {"plain": [], "r1": []}, True: {"plain": [], "r1": []}}
        for det in (False, True, True, False):
            set_deterministic(det)
            kinds = (("plain", 16), ("plain", 16), ("plain", 16)) + ((("r1", 15),) if run_id == 8 else ())
            for _, i in dict(kinds).items():  # warm-up after the switch, each kind of step
                state.step = i
                state, _ = step(state, batch)
            for kind, i in kinds:
                state.step = i
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                times_s[det][kind].append(time.perf_counter() - t0)
        set_deterministic(False)
        cost[run_id] = {("on" if det else "off"): {k: 1e3 * float(np.median(v)) for k, v in d.items() if v}
                        for det, d in times_s.items()}
        del state, step, batch
        torch.cuda.empty_cache()
    result["cost_ms"] = cost
    with open(os.path.join(tmp, "det.json"), "w") as f:
        json.dump(result, f)


def deterministic_resume(tmp: str, smi: str) -> dict:
    """Phase 21: :func:`deterministic_child` in its own process; checks its
    results here."""
    t0 = time.perf_counter()
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--deterministic-child", tmp], cwd=ROOT,
                       capture_output=True, text=True, timeout=900, env=env)
    assert p.returncode == 0, f"deterministic child exited {p.returncode}:\n{p.stdout[-3000:]}\n{p.stderr[-6000:]}"
    with open(os.path.join(tmp, "det.json")) as f:
        r = json.load(f)
    k6 = r["kernel6"]
    log(f"phase deterministic resume ({time.perf_counter() - t0:.1f} s, its own process, "
        f"CUBLAS_WORKSPACE_CONFIG=:4096:8, train(deterministic=True)): {DET_STEPS} steps at run_id 8, batch "
        f"{TRAIN_BATCH}, R1 on {r['r1_steps']}, in {r['run_s']:.2f} s; per-step (d_loss, g_loss) "
        f"{r['losses']}; resumed from step {DET_STEPS // 2}: {r['resumed']}; final weights equal "
        f"{r['digest_equal']}; batches equal {r['batches_equal']}; launches {r['launches']}, resume "
        f"{r['resume_launches']}")
    log(f"phase deterministic kernel 6 (15 x 20000 points into 256 x 256 x 3): two calls under the flag equal "
        f"{k6['fixed_equal']} (default accumulate: {k6['default_equal']}), fixed-order vs plain max_abs_err "
        f"{k6['fixed_err']:.3g} (bar {k6['bar']:.3g}), {k6['fixed_ms']:.4f} ms fixed-order vs {k6['default_ms']:.4f} "
        f"ms default; index_add_ (480000 rows into 5023 x 3) under the flag equal {k6['index_add_equal']} "
        f"(default: {k6['index_add_default_equal']}), {k6['index_add_ms']:.4f} vs {k6['index_add_default_ms']:.4f} "
        f"ms; the flag's cost on bare steps (ms, median, off / on in turns) {r['cost_ms']}; on {smi}")
    resumed = {int(i): v for i, v in r["resumed"].items()}
    first = {int(i): v for i, v in r["losses"].items()}
    assert sorted(resumed) == list(range(DET_STEPS // 2, DET_STEPS)), sorted(resumed)
    assert all(resumed[i] == first[i] for i in resumed), "a resumed step's losses differ from the run's"
    assert r["digest_equal"] and r["batches_equal"] and r["flag_off_after"], r
    assert DET_R1_INTERVAL - 1 in r["r1_steps"], r["r1_steps"]
    assert k6["fixed_equal"] and k6["index_add_equal"] and k6["fixed_err"] <= k6["bar"], k6
    assert all(r["launches"][KERNELS[k]["name"]] > 0 for k in RUN8_KERNELS), r["launches"]
    return r


def serve_checkpoint(ckpt: str, res, smi: str) -> None:
    """Phase 21: ``python -m gif_tpu_torch.serve --ckpt`` (its
    ``build_server``) on the deterministic run's checkpoint (run_id 8, full
    width): 8 threaded requests, their images against a ``FlameSampler``
    built from the same checkpoint on the same rows."""
    from gif_tpu_torch.eval.sampling import FlameSampler, load_generator_params, random_flame_params
    from gif_tpu_torch.serve import build_server

    server, _ = build_server(["--run_id", "8", "--ckpt", ckpt, "--flame_resources", "synthetic", "--batch_size", "8"])
    server.sampler.max_tris_per_tile = res.n_faces
    try:
        flames = random_flame_params(np.random.default_rng(24), 8)
        ids = [(i * 7919) % server.cfg.embedding_vocab_size for i in range(8)]
        got = {}

        def request(i):
            got[i] = server.generate(flames[i], identity=ids[i])

        threads = [threading.Thread(target=request, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive(), "request did not finish"
        sizes = list(server.batch_sizes)
    finally:
        server.stop()
    sampler = FlameSampler(server.cfg, res, load_generator_params(server.cfg, ckpt=ckpt), batch_size=8,
                           max_tris_per_tile=res.n_faces)
    want = ((np.clip(sampler.sample(flames, np.asarray(ids))[0], -1, 1) + 1) * 127.5).astype(np.uint8)
    diff = np.abs(np.stack([got[i] for i in range(8)]).astype(int) - want.astype(int))
    log(f"phase serve --ckpt (run_id 8, full width, the deterministic run's checkpoint): 8 requests in batches "
        f"{sizes}; served images against a FlameSampler from the same checkpoint: max |diff| {diff.max()} "
        f"(uint8) on {float((diff > 0).mean()):.2g} of values (tol one level on < 0.001: a request batch may "
        f"differ in rows); on {smi}")
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (diff.max(), (diff > 0).mean())


def fabricate_flame_inputs(d: str, seed: int = 0) -> tuple:
    """The FLAME 2020 artifact set at its real sizes, seeded: generic model
    (5023 vertices, 9976 faces, 400 shape + expression dirs, 36 pose
    columns), a 512 px texture space with 50 dirs, landmark embedding,
    texture precompute, a template OBJ with seams and a face mask."""
    import pickle

    from PIL import Image

    rng = np.random.default_rng(seed)
    n_v, n_f, n_t = 5023, 9976, 20000
    faces = rng.integers(0, n_v, (n_f, 3))
    model = {"v_template": rng.standard_normal((n_v, 3)), "shapedirs": rng.standard_normal((n_v, 3, 400)),
             "posedirs": rng.standard_normal((n_v, 3, 36)), "J_regressor": rng.uniform(0, 1e-3, (5, n_v)),
             "weights": rng.uniform(0, 1, (n_v, 5)), "f": faces.astype(np.uint32)}
    paths = [os.path.join(d, n) for n in ("generic_model.pkl", "FLAME_texture.npz", "landmark_embedding.npy",
                                          "texture_data_256.npy", "head_template_mesh.obj", "mask.png")]
    with open(paths[0], "wb") as f:
        pickle.dump(model, f)
    np.savez(paths[1], mean=rng.uniform(0, 255, 512 * 512 * 3).astype(np.float32),
             tex_dir=rng.standard_normal((512 * 512 * 3, 50)).astype(np.float32))
    np.save(paths[2], {"static_lmk_faces_idx": rng.integers(0, n_f, 51),
                       "static_lmk_bary_coords": rng.dirichlet(np.ones(3), 51),
                       "dynamic_lmk_faces_idx": rng.integers(0, n_f, (79, 17)),
                       "dynamic_lmk_bary_coords": rng.dirichlet(np.ones(3), (79, 17))}, allow_pickle=True)
    np.save(paths[3], {"x_coords": rng.integers(0, 256, n_t), "y_coords": rng.integers(0, 256, n_t),
                       "valid_pixel_ids": rng.integers(0, 256 * 256, n_t),
                       "valid_pixel_3d_faces": rng.integers(0, n_v, (n_t, 3)),
                       "valid_pixel_b_coords": rng.dirichlet(np.ones(3), n_t)}, allow_pickle=True)
    n_vt = n_v + 200
    with open(paths[4], "w") as f:
        f.writelines(f"v {a:.6f} {b:.6f} {c:.6f}\n" for a, b, c in rng.standard_normal((n_v, 3)))
        f.writelines(f"vt {a:.6f} {b:.6f}\n" for a, b in rng.uniform(0, 1, (n_vt, 2)))
        f.writelines("f " + " ".join(f"{a + 1}/{b + 1}" for a, b in zip(fa, fu)) + "\n"
                     for fa, fu in zip(faces, rng.integers(0, n_vt, (n_f, 3))))
    mask = np.zeros((256, 256, 3), np.uint8)
    mask[64:192, 80:176] = 255
    Image.fromarray(mask).save(paths[5])
    return tuple(paths)


def converters(tmp: str) -> dict:
    """Phase 21: both converters on fabricated inputs at the real sizes,
    timed; the FLAME npz loads as resources of FLAME's shapes, and the
    Inception npz loads back to the state_dict it came from."""
    import torch

    from gif_tpu_torch.eval.inception import random_fid_params
    from gif_tpu_torch.flame.resources import load_flame_resources
    from gif_tpu_torch.tools import convert_flame, convert_inception
    from gif_tpu_torch.tools.convert_params import load_inception_npz

    t0 = time.perf_counter()
    *inputs, mask = fabricate_flame_inputs(tmp)
    fab_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    convert_flame.convert(*inputs, os.path.join(tmp, "flame.npz"), face_mask_file=mask)
    flame_s = time.perf_counter() - t0
    r = load_flame_resources(os.path.join(tmp, "flame.npz"))
    assert r.v_template.shape == (5023, 3) and r.shapedirs.shape == (5023, 3, 100) and r.n_faces == 9976
    assert r.tex_dirs.shape == (256, 256, 3, 50) and r.face_region_mask.shape == (256, 256)
    sd = random_fid_params(0)
    torch.save(sd, os.path.join(tmp, "pt_inception.pth"))
    t0 = time.perf_counter()
    convert_inception.convert(os.path.join(tmp, "pt_inception.pth"), os.path.join(tmp, "inception.npz"))
    inc_s = time.perf_counter() - t0
    back = load_inception_npz(os.path.join(tmp, "inception.npz"))
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    out = {"flame_s": flame_s, "flame_npz_bytes": os.path.getsize(os.path.join(tmp, "flame.npz")),
           "inception_s": inc_s, "inception_npz_bytes": os.path.getsize(os.path.join(tmp, "inception.npz")),
           "inception_params": int(sum(v.numel() for v in sd.values()))}
    log(f"phase converters (host; inputs fabricated in {fab_s:.1f} s): convert_flame on the FLAME 2020 sizes "
        f"(5023 vertices, 400 dirs, 50 texture dirs at 512 px) {flame_s:.2f} s -> {out['flame_npz_bytes']} bytes; "
        f"convert_inception ({out['inception_params']} values) {inc_s:.2f} s -> {out['inception_npz_bytes']} bytes, "
        f"loaded back equal")
    return out


def phase_21(res, counters: dict, smi: str):
    """Phase 21 in order; returns ({kind: record fields} for the kernels
    line, {kind: max_abs_err of the recorded launches})."""
    import tempfile

    t_phase = time.perf_counter()
    launches, warm, errs = resample_modes(res, counters, smi)
    with tempfile.TemporaryDirectory(prefix="gif_phase21_") as tmp:
        bench = bench_lines()
        measurement_scripts(tmp, bench, smi)
        eye_regressor_phase(res, smi)
        det = deterministic_resume(tmp, smi)
        serve_checkpoint(det["ckpt"], res, smi)
        converters(tmp)
    log(f"phase 21: {time.perf_counter() - t_phase:.2f} s in all")
    out = {}
    for kind, meta in KERNELS.items():
        name = meta["name"]
        out[kind] = {"resample_launches": {m: launches[m][name] for m in RESAMPLE_MODES},
                     "resample_warmup_launches": {m: warm[m][kind] for m in RESAMPLE_MODES},
                     "deterministic_launches": det["launches"][name],
                     "deterministic_resume_launches": det["resume_launches"][name]}
    out["scatter"]["deterministic_fixed_order"] = {k: det["kernel6"][k] for k in ("fixed_ms", "default_ms",
                                                                                  "fixed_err", "fixed_equal")}
    return out, errs


# --- Phase 22: the study and analysis scripts --------------------------------
STUDY_TINY_ARGS = {  # one batch each, card against CPU
    "mturk_stimuli": ["association", "--n", "4"],
    "voca_animation": ["frames", "--run_id", "0", "--identities", "1", "--n_frames", "4"],
    "compute_fid_for_models": ["--n_samples", "16", "--sigmas", "1.0"],
    "show_training_data": ["--batch", "4", "--n_batches", "1"],
}
# The recon_trend run (run_id 8 through the CLI: a render dataset,
# checkpoints, the random-weight FID once, as its untrained baseline) and
# raster_sensitivity's arms.
RECON_STEPS, RECON_DATASET, RECON_CKPT_EVERY = 10, 128, 5
RSENS_ITERS, RSENS_LOG_EVERY, RSENS_MAX_RATIO = 40, 2, 1.5  # the bar tests/test_aux.py holds the TPU artifact to


def counted_train_child(counts_path: str, argv: list) -> None:
    """``python -m gif_tpu_torch.train <argv>`` in this process (phase 22's
    children): every counter 0 just before, read just after, the run
    under a :class:`LoopProbe` whose first step (and first FID batch) is
    held launch by launch to the plain versions unless the rasterizer is
    forced to its plain version (``GIF_TPU_TORCH_RASTER=plain``: kernel 1
    never launches there, and a round starts at a raster launch).  Writes
    the launches, the steps' metrics and the recorded errors to
    ``counts_path``."""
    import torch

    from gif_tpu_torch import kernels
    from gif_tpu_torch.train import cli

    kernels.build()
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with LoopProbe(counters, record=os.environ.get("GIF_TPU_TORCH_RASTER") != "plain") as probe:
        cli.main(argv)
        torch.cuda.synchronize()
    out = {"seconds": time.perf_counter() - t0, "launches": {k: fn.launches for k, fn in counters.items()},
           "step_launches": probe.step_launches, "recorded": probe.recorded, "checked": probe.checked,
           "errs": probe.errs, "metrics": [(i, {k: v.item() for k, v in m.items()}) for i, m in probe.metrics],
           "fids": probe.fids}
    with open(counts_path, "w") as f:
        json.dump(out, f)


def counted_train_command(counts_path: str, argv: list) -> list:
    return [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--counted-train", counts_path, *argv]


def check_train_child(c: dict, what: str, steps: int, kinds) -> None:
    """A counted child's run: every step's metrics finite with no render
    overflow, the kernels ``kinds`` launched in its steps, the recorded
    first step's launches held to their plain versions."""
    assert len(c["metrics"]) == steps, (what, len(c["metrics"]))
    for i, m in c["metrics"]:
        assert all(np.isfinite(v) for v in m.values()) and m["render_overflow"] == 0.0, (what, i, m)
    assert all(c["step_launches"][KERNELS[k]["name"]] > 0 for k in kinds), (what, c["step_launches"])
    if c["recorded"]:
        assert all(c["recorded"]["step"][k] > 0 for k in kinds), (what, c["recorded"])


def rasterizer_backends_bit_equal(res) -> tuple:
    """One training batch's raster (256 px, capacity = face count) through
    ``rasterize_with_attrs`` under backend ``cuda`` and ``plain`` on the
    card: depth, face ids, barycentrics, overflow and the interpolated
    attributes bit-equal; then ``render_tex_and_normal`` under both: the
    depth and mask equal (the shaded maps carry the vertex normals'
    ``index_add_`` order).  Returns (kernel-1 launches, batch)."""
    import torch

    from gif_tpu_torch.data.pipeline import sample_flame_params
    from gif_tpu_torch.flame.camera import batch_orth_proj
    from gif_tpu_torch.flame.decoder import flame_decode
    from gif_tpu_torch.flame.mesh import face_vertices, vertex_normals
    from gif_tpu_torch.render.raster import to_pixel_space
    from gif_tpu_torch.render.raster_cuda import rasterize_with_attrs
    from gif_tpu_torch.render.renderer import render_tex_and_normal

    f = torch.as_tensor(sample_flame_params(np.random.default_rng(22), TRAIN_BATCH), device="cuda")
    b, dev = len(f), f.device
    with torch.inference_mode():
        trans = batch_orth_proj(flame_decode(res, f[:, :100], f[:, 100:150], f[:, 150:156]), f[:, 156:159])
        trans = torch.cat([trans[:, :, :1], -trans[:, :, 1:]], dim=2)
        faces = res.tensor("faces", dev, torch.long)
        fv = face_vertices(to_pixel_space(trans, 256, 256), faces)
        attrs = torch.cat([face_vertices(vertex_normals(trans, faces), faces),
                           res.tensor("uv_coords", dev, torch.float32)[faces].expand(b, -1, -1, -1)], dim=-1)
        before = rasterize_with_attrs.launches
        outs = {bk: rasterize_with_attrs(fv, attrs, 256, 256, 32, res.n_faces, bk) for bk in ("cuda", "plain")}
        torch.cuda.synchronize()
        launched = rasterize_with_attrs.launches - before
        (rc, ic), (rp, ip) = outs["cuda"], outs["plain"]
        unequal = [n for n, x, y in zip(("depth", "tri_id", "bary", "tile_overflow", "attributes"), (*rc, ic), (*rp, ip))
                   if not torch.equal(x, y)]
        codes = (f[:, 0:100], f[:, 100:150], f[:, 150:156], f[:, 159:209], f[:, 209:236], f[:, 156:159])
        maps = {bk: render_tex_and_normal(res, *codes, max_tris_per_tile=res.n_faces, raster_backend=bk)
                for bk in ("cuda", "plain")}
    assert launched == 1 and not unequal, (launched, unequal)
    assert torch.equal(maps["cuda"].depth, maps["plain"].depth) and torch.equal(maps["cuda"].mask, maps["plain"].mask)
    assert not bool(rc.tile_overflow.any()) and bool(maps["cuda"].mask.any())
    return launched, b


def _images_live(paths) -> None:
    """Each PNG exists, and its pixels are not all one value."""
    from PIL import Image

    for p in paths:
        with Image.open(p) as im:
            a = np.asarray(im)
        assert a.size and int(a.max()) > int(a.min()), p


def study_scripts(counters: dict, smi: str):
    """Phase 22: the study and analysis scripts.  At ``--tiny`` on the card
    and the CPU (:func:`check_generation_against_cpu_plain`); then at run_id
    0's full width (256 px, 512 channels, 69158 identities, bf16 convs) on
    the FLAME-sized synthetic mesh from a trees pickle of a seeded port
    train state, raster capacity = face count, every counter 0 just before
    each script and read just after: ``mturk_stimuli`` in both modes (16
    stimuli; the first batch held launch by launch to the plain versions),
    ``voca_animation`` frames (2 identities x 60 frames) and grid,
    ``compute_fid_for_models`` (512 samples, sigmas 0 and 1, random
    Inception), ``show_training_data`` (2 batches of 8); a 10-step run_id-8
    run of ``python -m gif_tpu_torch.train`` (128 synthetic renders,
    checkpoints every 5, the random FID once) in a counted child and
    ``recon_trend`` on it; ``raster_sensitivity`` (40 deterministic steps,
    a row every 2, ``--max_ratio 1.5``) with each arm in a counted child; one batch's
    raster bit-equal under both backends; ``make_image_grid``,
    ``plot_fid`` and ``mturk_results csv`` on what these wrote.  Returns
    ({script: launches}, the recorded launches' largest errors by kernel,
    the raster_sensitivity result)."""
    import tempfile

    import torch

    from gif_tpu_torch.flame.resources import synthetic_flame_resources
    from gif_tpu_torch.scripts import raster_sensitivity
    from gif_tpu_torch.train.config import get_config

    t_phase = time.perf_counter()
    launches, secs, probes, n_images, errs = {}, {}, {}, {}, {}

    def take_errs(stats: dict) -> None:
        """A recorder's stats ({kind: {} or {"max_abs_err": e}}) or a
        child's errors ({kind: e})."""
        for kind, st in stats.items():
            if st != {}:
                errs[kind] = max(errs.get(kind, 0.0), st["max_abs_err"] if isinstance(st, dict) else st)

    def counted(key: str, args: list, **probe_kw):
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with ScriptProbe(**probe_kw) as probe:
            run_script(key.split(":")[0], args)
            torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t0
        launches[key] = {k: fn.launches for k, fn in counters.items()}
        probes[key] = probe
        for rec in probe.recorders:
            take_errs(rec.stats)
        return probe

    def release() -> None:
        # The training children need the card's memory that this process's
        # caching allocator holds.
        import gc

        gc.collect()
        torch.cuda.empty_cache()

    def child(key: str, argv: list) -> dict:
        release()
        path = os.path.join(tmp, f"{key}.counts.json")
        t0 = time.perf_counter()
        p = subprocess.run(counted_train_command(path, argv), cwd=ROOT, capture_output=True, text=True)
        assert p.returncode == 0, f"{key} exited {p.returncode}:\n{p.stdout[-3000:]}\n{p.stderr[-6000:]}"
        with open(path) as f:
            c = json.load(f)
        secs[key], launches[key] = time.perf_counter() - t0, c["launches"]
        take_errs(c["errs"])
        return c

    with tempfile.TemporaryDirectory(prefix="gif_study_") as tmp:
        check_generation_against_cpu_plain(tmp, STUDY_TINY_ARGS, STUDY_TINY_ARGS)
        t_tiny = time.perf_counter() - t_phase

        t0 = time.perf_counter()
        cfg = get_config(0)
        res = synthetic_flame_resources()
        trees = os.path.join(tmp, "trees.pkl")
        write_trees(cfg, trees)
        log(f"phase study setup: run_id 0, {cfg.max_size} px, max_channels {cfg.max_channels}, vocab "
            f"{cfg.embedding_vocab_size}, {cfg.compute_dtype}, trees pickle {os.path.getsize(trees)} bytes: "
            f"{time.perf_counter() - t0:.2f} s")
        common = ["--run_id", "0", "--flame_resources", "synthetic", "--converted_ckpt", trees, "--device", "cuda"]
        cap = dict(capacity=res.n_faces)
        first = counted("mturk_stimuli:association", ["association", *common, "--n", "16", "--out_dir",
                                                      os.path.join(tmp, "study")], record_first=True, **cap)
        counted("mturk_stimuli:comparison", ["comparison", *common, "--n", "16", "--converted_ckpt_b", trees,
                                             "--out_dir", os.path.join(tmp, "study_ab")], **cap)
        voca = os.path.join(tmp, "voca")
        counted("voca_animation:frames", ["frames", *common, "--identities", "0", "1", "--n_frames", "60",
                                          "--out_dir", voca], **cap)
        counted("voca_animation:grid", ["grid", "--out_dir", voca])
        counted("compute_fid_for_models", [*common, "--n_samples", "512", "--sigmas", "0.0", "1.0", "--out",
                                           os.path.join(tmp, "fid.json")], **cap)
        counted("show_training_data", ["--run_id", "0", "--flame_resources", "synthetic", "--device", "cuda",
                                       "--batch", "8", "--n_batches", "2", "--out_dir", os.path.join(tmp, "data_viz")],
                **cap)

        recon = os.path.join(tmp, "recon")
        train_c = child("recon_train", ["--run_id", "8", "--synthetic_images", "renders", "--synthetic_n",
                                        str(RECON_DATASET), "--total_iters", str(RECON_STEPS), "--checkpoint_every",
                                        str(RECON_CKPT_EVERY), "--log_every", str(RECON_CKPT_EVERY),
                                        "--inception_weights", "random", "--fid_every", "1000", "--fid_n_samples",
                                        "64", "--fid_real_samples", str(RECON_DATASET), "--out_dir", recon,
                                        "--no_mesh"])
        check_train_child(train_c, "recon_train", RECON_STEPS, RUN8_KERNELS)
        counted("recon_trend", ["--out_dir", recon, "--run_id", "8", "--synthetic_n", str(RECON_DATASET),
                                "--device", "cuda"], **cap)

        rsens = os.path.join(tmp, "rsens")
        arms = {}
        orig_command = raster_sensitivity.train_command

        def arm_command(args, out, seed):
            cmd = orig_command(args, out, seed)
            assert cmd[1:3] == ["-m", "gif_tpu_torch.train"], cmd
            return counted_train_command(out + ".counts.json", cmd[3:])

        raster_sensitivity.train_command = arm_command
        release()
        t0 = time.perf_counter()
        try:
            rs = raster_sensitivity.main(["--iters", str(RSENS_ITERS), "--log_every", str(RSENS_LOG_EVERY),
                                          "--max_ratio", str(RSENS_MAX_RATIO), "--out_dir", rsens,
                                          "--device", "cuda"])
        finally:
            raster_sensitivity.train_command = orig_command
        secs["raster_sensitivity"] = time.perf_counter() - t0
        for arm in ("plain", "cuda", "plain_reseed"):
            with open(os.path.join(rsens, arm + ".counts.json")) as f:
                arms[arm] = json.load(f)
            launches[f"raster_sensitivity:{arm}"] = arms[arm]["launches"]
            take_errs(arms[arm]["errs"])
            check_train_child(arms[arm], arm, RSENS_ITERS, [k for k in RUN8_KERNELS if arm == "cuda" or k != "raster"])
            assert (arms[arm]["launches"]["raster"] > 0) == (arm == "cuda"), (arm, arms[arm]["launches"])
        assert arms["cuda"]["recorded"] and arms["cuda"]["checked"], arms["cuda"]["recorded"]
        assert rs["rows"] == RSENS_ITERS // RSENS_LOG_EVERY and rs["ratio"] <= RSENS_MAX_RATIO, rs

        t0 = time.perf_counter()
        launched, n_bit = rasterizer_backends_bit_equal(res)
        bit_s = time.perf_counter() - t0

        # The host-only scripts on what the runs wrote.
        t0 = time.perf_counter()
        run_script("make_image_grid", ["--pattern", os.path.join(tmp, "study", "faces", "s_*.png"), "--n_row", "4",
                                       "--n_col", "4", "--out", os.path.join(tmp, "stitched.png")])
        import importlib.util

        # plot_fid draws its curve where matplotlib is installed, and prints
        # the best checkpoint either way.
        has_plot = importlib.util.find_spec("matplotlib") is not None
        run_script("plot_fid", ["--run_dir", os.path.join(recon, "8"), "--out", os.path.join(tmp, "fid_curve.png")])
        for study, d in (("association", "study"), ("comparison", "study_ab")):
            run_script("mturk_results", ["csv", "--study", study, "--stimulus_dir", os.path.join(tmp, d),
                                         "--out", os.path.join(tmp, f"batch_{study}.csv")])
        host_s = time.perf_counter() - t0

        # Checks: the files each script advertises, live images, no overflow.
        pngs = [os.path.join(tmp, p) for p in (
            "study/faces/s_15.png", "study/renders/s_15.png", "study_ab/model_a/s_15.png", "study_ab/model_b/s_15.png",
            "voca/selected_ids_1/59.png", "voca/selected_ids_1/mesh_textured_59.png",
            "voca/selected_ids_0/mesh_normal_0.png", "data_viz/batch_1.png", "stitched.png")]
        pngs += [os.path.join(tmp, "fid_curve.png")] if has_plot else []
        _images_live(pngs)
        for p in ("study/key.json", "voca/voca_selected_ids.gif", "batch_association.csv", "batch_comparison.csv",
                  "batch_comparison.csv.key.json", "recon/8/recon_trend.json", "rsens/raster_sensitivity.json"):
            assert os.path.getsize(os.path.join(tmp, p)) > 0, p
        with open(os.path.join(tmp, "batch_comparison.csv")) as f:
            assert len(f.read().splitlines()) == 17
        for key, probe in probes.items():
            assert probe.render_overflows == 0, (key, probe.render_overflows)
            for _, _, images, conds in probe.samples:
                assert np.isfinite(images).all() and np.isfinite(conds).all() and images.max() > images.min(), key
        rec = first.recorders[0]
        assert len(rec.rounds) == 1 and all(rec.rounds[0][k] for k in GEN_KERNELS), rec.rounds
        for key in ("mturk_stimuli:association", "mturk_stimuli:comparison", "voca_animation:frames",
                    "compute_fid_for_models", "recon_trend"):
            n = launches[key]
            assert all(n[KERNELS[k]["name"]] > 0 for k in GEN_KERNELS), (key, n)
            assert all(n[KERNELS[k]["name"]] == 0 for k in ("flr_bwd", "blur_vjp", "scatter")), (key, n)
        assert launches["show_training_data"]["raster"] > 0 and launches["show_training_data"]["sampler"] > 0
        assert sum(launches["voca_animation:grid"].values()) == 0

        with open(os.path.join(tmp, "fid.json")) as f:
            fid = json.load(f)["fid"]
        # sigma 0 repeats the reference's own generations: its distance is the
        # host sqrtm's rounding of 0, against the traces it cancels.
        (mu_r, sig_r, _, sig_0), _ = probes["compute_fid_for_models"].stats
        zero_tol = 1e-3 * float(np.trace(sig_r) + np.trace(sig_0))
        assert abs(fid["0.0"]) <= zero_tol and fid["0.0"] < fid["1.0"], (fid, zero_tol)
        with open(os.path.join(tmp, "recon", "8", "recon_trend.json")) as f:
            trend = json.load(f)
        assert [r["step"] for r in trend] == [0, RECON_CKPT_EVERY, RECON_STEPS], trend
        assert all(np.isfinite(r[k]) for r in trend for k in ("ema_recon", "live_recon")), trend
        assert len(train_c["fids"]) == 1 and np.isfinite(train_c["fids"][0]), train_c["fids"]

        n_images = {
            "mturk_stimuli:association": 16, "mturk_stimuli:comparison": 32,
            "voca_animation:frames": 2 * 60, "compute_fid_for_models": 3 * 512, "show_training_data": 2 * 8,
            "recon_trend": 3 * 2 * 64, "recon_train": RECON_STEPS * TRAIN_BATCH,
            "raster_sensitivity": 3 * RSENS_ITERS * TRAIN_BATCH,
        }
        arm_ips = {arm: float(np.median([m["imgs_per_sec"] for _, m in _csv_metrics(rsens, arm)]))
                   for arm in arms}
        log(f"phase study: tiny card-vs-CPU checks {t_tiny:.2f} s; scripts at full width, host clock (s / images / "
            f"images/s): " + "; ".join(f"{k} {secs[k]:.2f} / {n_images.get(k, 0)} / "
                                       f"{n_images.get(k, 0) / secs[k]:.2f}" for k in secs)
            + f"; host-only scripts {host_s:.2f} s (the FID curve {'drawn' if has_plot else 'not drawn: no matplotlib'})"
            f"; on {smi}")
        log(f"phase study launches: {launches}; recorded launches (mturk's first batch, each train child's first step "
            f"and FID batch) max_abs_err {errs}; render overflow 0")
        log(f"phase study FID vs corruption (shape, 512 samples, random Inception): {fid} (sigma 0 within "
            f"{zero_tol:.3g} of 0); recon trend {trend}; recon run FID (random Inception, untrained) "
            f"{train_c['fids'][0]:.4f}; on {smi}")
        log(f"phase study raster_sensitivity (run_id 8, full width, batch {TRAIN_BATCH}, {RSENS_ITERS} steps, a row "
            f"every {RSENS_LOG_EVERY}): {json.dumps(rs)}; arms' median images/s (metrics.csv) {arm_ips}; one "
            f"batch of {n_bit} rasterized bit-equal under cuda and plain ({launched} kernel-1 launch, {bit_s:.2f} s); "
            f"on {smi}")
    log(f"phase 22: {time.perf_counter() - t_phase:.2f} s in all")
    return launches, errs, rs


# --- Phase 23: the port at full width against the JAX package's goldens ------

GOLDEN_PATH = os.path.join(ROOT, "tests", "golden", "torch_full_width.npz")


def full_width_goldens(res, counters: dict, smi: str) -> dict:
    """Phase 23: every full-width parity case of
    :mod:`gif_tpu_torch.tools.full_width_goldens` on the card through the
    kernels — FLAME decode, the condition render (kernels 1, 2), G in f32
    for run_id 8 and 0 and under bf16 (3, 4), D's scores and parameter
    gradient (3, 4, 5 and 4's VJP), ``FlameSampler.sample``, the texture
    steal and ``sample_at_points`` with their image gradients (2, 6), and
    six R1 train steps (all seven): run_id 8 and fused run_id 0 in f32; the
    bench's own step (run_id 8 under the bf16 policy) and fused run_id 0
    under bf16; run_id 8 with every branch (path length, embedding
    regularizer, negatives, instance noise, crop / flip) and fused run_id 0
    with the direct gradient, in f32 — from weights the name-keyed rule
    rebuilds, TF32 off, each output held to the golden ``gif_tpu`` made on
    the CPU (``tests/golden/torch_full_width.npz``) at the case's bar (a
    bf16 case's widened to ``BF16_K`` times ``gif_tpu``'s own bf16-vs-f32
    distance, printed beside it); the G and D cases take the golden's
    condition maps, the steps its interpolation draws and shuffle shift.
    Every counter 0 just before the cases and read just after: all seven
    kernels must launch, the scatter in every run_id-0 step.  Then each step
    runs again and its outputs' spread between the two identical calls (the
    card's nondeterminism) is printed beside each output's error and bar.
    Returns the launches by counter name."""
    import torch

    from gif_tpu_torch.device import set_tf32_policy
    from gif_tpu_torch.tools import full_width_goldens as fw

    t_phase = time.perf_counter()
    set_tf32_policy()
    golden = fw.Golden(GOLDEN_PATH)
    cond = golden.whole("render", "cond")
    n_texels = len(res.texture_x_coords)
    failed, secs, outs, checks, case_launches = [], {}, {}, {}, {}
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    for case in fw.CASES + fw.STEP_CASES:
        t0 = time.perf_counter()
        before = {k: fn.launches for k, fn in counters.items()}
        inp = fw.inputs(case, n_texels)
        if case in fw.STEP_CASES:
            out = fw.port_step_outputs(case, res, "cuda", inp, golden.draws(case))
        else:
            out = fw.port_outputs(case, res, "cuda", inp, cond)
        torch.cuda.synchronize()
        secs[case] = time.perf_counter() - t0
        case_launches[case] = {k: fn.launches - before[k] for k, fn in counters.items()}
        outs[case] = out
        assert sorted(out) == golden.outputs(case), (case, sorted(out), golden.outputs(case))
        for out_name in golden.outputs(case):
            checks[case, out_name] = golden.check(case, out_name, out[out_name])
            if not checks[case, out_name][2]:
                failed.append(f"{case}/{out_name}")
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}

    # The card's own spread: each step again, identical inputs and state.
    spread = {}
    for case in fw.STEP_CASES:
        again = fw.port_step_outputs(case, res, "cuda", fw.inputs(case), golden.draws(case))
        spread[case] = fw.distances(again, outs[case])
    for case in fw.CASES + fw.STEP_CASES:
        for out_name in golden.outputs(case):
            bar = fw.BARS[(case, out_name)]
            a, r, ok, worst = checks[case, out_name]
            what = "flips" if bar.kind in ("levels", "flips") else "rel L2"
            line = (f"phase goldens {case}/{out_name}: max abs err {a:.4g}, {what} {r:.4g}"
                    + (f" (worst tensor {worst})" if worst else "") + f"; bar {bar.text()}")
            dist = golden.bf16_dist(case, out_name)
            if dist is not None:
                line += f", widened to {fw.BF16_K:g} x gif_tpu's bf16-vs-f32 " + fw.distance_text(dist)
                if bar.kind == "rel_l2":
                    floor = fw.bf16_floor(dist)
                    line += (f"; the worst tensor's limit {fw.bf16_limit(bar.rel_l2, dist[0][worst], floor):.3g} "
                             f"(its own d {dist[0][worst]:.3g}, the floor {floor:.3g})")
                if out_name == "metrics":
                    want = golden.entries[f"{case}/metrics/samples"].astype(np.float64)
                    err = np.abs(outs[case]["metrics"] - want)
                    rel = np.divide(err, np.abs(want), out=err.copy(), where=want != 0)
                    line += "; per metric error / limit: " + ", ".join(
                        f"{k} {e:.3g} / {lim:.3g}" for k, e, lim in
                        zip(fw.step_metrics(case), rel, fw.bf16_limit(bar.rtol, dist[0])))
            if case in spread:
                share = fw.spread_limit_share(bar, spread[case][out_name], dist)
                line += (f"; two identical calls on the card: {fw.distance_text(spread[case][out_name])}, "
                         f"{share:.3g} of the bar" + (" -- THE CARD'S SPREAD IS PAST THE BAR" if share > 1 else ""))
            log(line + ("" if ok else " -- PAST THE BAR"))
    log(f"phase goldens: {len(fw.CASES) + len(fw.STEP_CASES)} cases at full width (256 px, 512 channels, 69158 "
        f"identities, mesh {res.n_vertices} vertices / {res.n_faces} faces) in {time.perf_counter() - t_phase:.2f} s "
        "(the steps' second calls included); seconds by case " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
        + f"; launches {launches}; launches by step case "
        + "; ".join(f"{c}: {case_launches[c]}" for c in fw.STEP_CASES) + f"; on {smi}")
    assert not failed, f"past the golden's bar: {failed}"
    assert all(n > 0 for n in launches.values()), f"a kernel never launched in phase 23: {launches}"
    for case in fw.STEP_CASES:
        need = [k for k in counters if k != "bilinear_scatter" or fw.step_config(case).run_id == 0]
        assert all(case_launches[case][k] > 0 for k in need), f"{case}: a kernel never launched: {case_launches[case]}"
    return launches


def _csv_metrics(rsens: str, arm: str) -> list:
    """The (step, row) pairs of an arm's metrics.csv, as floats."""
    return [(int(r["step"]), {k: float(v) for k, v in r.items()})
            for r in _csv_rows(os.path.join(rsens, arm, "8", "metrics.csv"))]


# Phase 24: StyleGAN3-T's filtered leaky ReLU at batch 4 (one card's share
# of the published batch).  Bars: the card tests' (tests/test_torch_kernels.py).
SG3_PRESET = "stylegan3-t-ffhq1024"
SG3_BATCH = 4
SG3_LAUNCHES = {"forward": 28, "backward": 14}  # a plain step: G's and D's G forwards, G's backward
SG3_KERNELS = {
    "forward": dict(name="filtered_lrelu", route="cuda", source="gif_tpu_torch/csrc/filtered_lrelu.cu",
                    replaces="none: gif_tpu has no alias-free generator"),
    "backward": dict(name="filtered_lrelu_backward", route="cuda", source="gif_tpu_torch/csrc/filtered_lrelu.cu",
                     replaces="none: gif_tpu has no alias-free generator"),
}


def check_filtered_lrelu_layer(spec) -> tuple:
    """The wrapper against the plain version at one layer of the schedule,
    batch :data:`SG3_BATCH`, in the layer's dtype: (max |y - plain|, max
    |dx - plain|); raises past the card tests' bars."""
    import torch
    from gif_tpu_torch.ops import filtered_lrelu as fl

    g = torch.Generator(device="cuda").manual_seed(spec["out_size"] * 1000 + spec["out_channels"])
    size = spec["in_size"] + spec["kernel"] - 1
    bf16 = spec["low_precision"]
    x = torch.randn((SG3_BATCH, spec["out_channels"], size, size), generator=g, device="cuda")
    x = x.to(torch.bfloat16 if bf16 else torch.float32)
    b = torch.randn(spec["out_channels"], generator=g, device="cuda") * 0.2
    fu = torch.from_numpy(spec["up_filter"]).cuda()
    fd = torch.from_numpy(spec["down_filter"]).cuda()
    args = (spec["up"], spec["down"], spec["padding"], 2**0.5, 0.2, 256.0)
    outs = []
    for fn in (fl.filtered_lrelu, fl.filtered_lrelu_plain):
        before = (fl.filtered_lrelu.launches, fl.filtered_lrelu_backward.launches)
        xi, bi = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
        y = fn(xi, fu, fd, bi, *args)
        dy = torch.randn(y.shape, generator=torch.Generator(device="cuda").manual_seed(7), device="cuda")
        y.backward(dy.to(y.dtype))
        n = (fl.filtered_lrelu.launches - before[0], fl.filtered_lrelu_backward.launches - before[1])
        outs.append((y.detach().float(), xi.grad.float(), bi.grad.float(), n))
    torch.cuda.synchronize()
    (y, dx, db, n), (yp, dxp, dbp, n_plain) = outs
    assert n == (1, 1) and n_plain == (0, 0), (spec["name"], n, n_plain)
    scale = yp.abs().max().item()
    y_err = ((y - yp).abs() - (2**-7 if bf16 else 0.0) * yp.abs()).max().item()
    dx_rel = (torch.linalg.vector_norm(dx - dxp) / torch.linalg.vector_norm(dxp)).item()
    db_share = ((db - dbp).abs() / (1e-5 * dxp.abs().sum((0, 2, 3)))).max().item()
    log(f"  {spec['name']} (up {spec['up']}, down {spec['down']}, {'bf16' if bf16 else 'f32'}, "
        f"{tuple(x.shape)}): y {y_err / scale:.3g} of max (bar 1e-5), dx {dx_rel:.3g} by norm (bar "
        f"{2**-8 if bf16 else 1e-5:.3g}), db {db_share:.3g} of its bar")
    assert y_err <= 1e-5 * scale and dx_rel <= (2**-8 if bf16 else 1e-5) and db_share <= 1.0, spec["name"]
    return (y - yp).abs().max().item(), (dx - dxp).abs().max().item()


def filtered_lrelu_phase(smi: str) -> list:
    """Phase 24 (module docstring): the layer checks, the counted batch-4
    step and its launches replayed.  Returns the two kernel records."""
    import torch
    from benchmark.harness import flops_sg3
    from benchmark.harness.train_uncond import record_flrelu, replay_flrelu
    from gif_tpu_torch.device import set_tf32_policy
    from gif_tpu_torch.models.stylegan3 import synthesis_schedule
    from gif_tpu_torch.ops import filtered_lrelu as fl
    from gif_tpu_torch.train.config import get_config
    from gif_tpu_torch.train.state import create_train_state
    from gif_tpu_torch.train.step import make_train_step

    set_tf32_policy()
    t0 = time.perf_counter()
    firsts = {}
    for spec in synthesis_schedule(1024)[1:]:
        if not spec["torgb"]:
            firsts.setdefault((spec["up"], spec["down"], spec["low_precision"]), spec)
    errs = [check_filtered_lrelu_layer(spec) for spec in firsts.values()]
    log(f"phase filtered leaky ReLU checks: {len(firsts)} layers at batch {SG3_BATCH}: "
        f"{time.perf_counter() - t0:.2f} s")

    cfg = get_config(SG3_PRESET, batch_size=SG3_BATCH)
    state = create_train_state(cfg, seed=0)
    step = make_train_step(cfg, None, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"real_image": torch.rand((SG3_BATCH, cfg.max_size, cfg.max_size, 3), generator=gen,
                                      device="cuda") * 2 - 1}

    def draws():
        return {k: torch.randn((SG3_BATCH, 512), generator=gen, device="cuda") for k in ("z_g", "z_d")}

    t0 = time.perf_counter()
    state, m = step(state, batch, draws())  # step 0: the R1 step
    torch.cuda.synchronize()
    log(f"phase sg3 warm-up (R1) step: {time.perf_counter() - t0:.2f} s; metrics "
        f"{ {k: v.item() for k, v in m.items()} }")
    fl.filtered_lrelu.launches = fl.filtered_lrelu_backward.launches = 0
    launches = record_flrelu(lambda: (step(state, batch, draws()), torch.cuda.synchronize()))
    counted = {"forward": fl.filtered_lrelu.launches, "backward": fl.filtered_lrelu_backward.launches}
    assert counted == SG3_LAUNCHES, counted
    records = []
    for i, (kind, meta) in enumerate(SG3_KERNELS.items()):
        mine = {k: v for k, v in launches.items() if k[0] == kind}
        assert sum(c for c, _ in mine.values()) == counted[kind], (kind, mine.keys())
        t = replay_flrelu(mine)
        bytes_s = ops_s = 0.0
        for (_, shape, dtype, up, down, padding), (count, (fu, fd, *_)) in mine.items():
            y0, y1, x0, x1 = fl._pads(padding)
            out_hw = (fl.output_size(shape[2], up, down, y0, y1, fu.numel(), fd.numel()),
                      fl.output_size(shape[3], up, down, x0, x1, fu.numel(), fd.numel()))
            ops, nb = flops_sg3.launch_counts(kind, shape, out_hw, up, down, torch.empty((), dtype=dtype).element_size())
            bytes_s += count * nb / flops_sg3.HBM_BYTES_PER_S
            ops_s += count * ops / flops_sg3.PEAK_F32_FLOPS
        records.append({**meta, "launches": counted[kind], "max_abs_err": max(e[i] for e in errs),
                        "ms": 1e3 * t["measured_s"], "plain_ms": None, "bound_ms": 1e3 * t["bound_s"],
                        "bound_by": "f32 ops" if ops_s > bytes_s else "bytes", "library_ms": None,
                        "share_of_bound": t["bound_s"] / t["measured_s"]})
        log(f"phase sg3 {meta['name']}: {counted[kind]} launches in one plain batch-{SG3_BATCH} step "
            f"({len(mine)} shapes), {1e3 * t['measured_s']:.3f} ms replayed, bound {1e3 * t['bound_s']:.3f} "
            f"ms ({100 * t['bound_s'] / t['measured_s']:.1f}%); on {smi}")
    del state, step, batch
    torch.cuda.empty_cache()
    return records


def filtered_lrelu_only() -> int:
    """``--filtered-lrelu``: phase 1's build, then phase 24 alone."""
    import torch
    from gif_tpu_torch import kernels

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    _, nvcc_s, _ = kernels.build()
    log(f"phase build: nvcc {nvcc_s:.2f} s")
    print(json.dumps({"kernels": filtered_lrelu_phase(smi)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from gif_tpu_torch import kernels
    from gif_tpu_torch.eval.sampling import load_generator_params
    from gif_tpu_torch.flame.resources import synthetic_flame_resources
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
    counters = kernel_counters()
    serve_kernels = [KERNELS[k]["name"] for k in ("raster", "sampler", "flr", "blur")]
    try:
        t0 = time.perf_counter()
        with LaunchRecorder() as served:
            serve_round(server, range(1000, 1008), {})
        log(f"phase warm-up batch (Triton JIT, first-call setup and the on-the-spot kernel checks "
            f"included): {time.perf_counter() - t0:.2f} s; kernel launches in the first batch: "
            + ", ".join(f"{k} {sum(r['n'] for r in v.values())}" for k, v in served.rounds[0].items()))

        # --- phase 3: kernel timings at the served shapes ---
        t0 = time.perf_counter()
        serve_parts = time_round(served.rounds[0], served.stats, "served batch of 8")
        del served
        log(f"phase kernel timings: {time.perf_counter() - t0:.2f} s; card now: "
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
    assert all(launches[k] > 0 for k in serve_kernels), f"a kernel never launched: {launches}"
    full = [t for t, s in zip(secs, sizes) if s == 8]
    log(f"serving latency per batch of 8 (host clock, render + G + readback): median "
        f"{1e3 * float(np.median(full)):.2f} ms, min {1e3 * min(full):.2f} ms, max "
        f"{1e3 * max(full):.2f} ms over {len(full)} batches; {8 / float(np.median(full)):.1f} "
        f"images/s at the median; render overflow 0; on {smi}")
    serve_launches = launches
    del server, results

    # --- phase 7: the full-width train step, one recorded warm-up (R1) step ---
    from gif_tpu_torch.train.state import create_train_state
    from gif_tpu_torch.train.step import make_train_step

    t0 = time.perf_counter()
    cfg = get_config(8, batch_size=TRAIN_BATCH)
    state = create_train_state(cfg, seed=0)
    step = make_train_step(cfg, res, max_tris_per_tile=res.n_faces)
    batch = train_batch(cfg, TRAIN_BATCH, "cuda")
    log(f"phase train setup: run_id 8, {cfg.max_size} px, max_channels {cfg.max_channels}, vocab "
        f"{cfg.embedding_vocab_size}, {cfg.compute_dtype}, batch {TRAIN_BATCH}, r1_interval "
        f"{cfg.r1_interval}, n_critic {cfg.n_critic}, G {sum(p.numel() for p in state.generator.parameters())} "
        f"/ D {sum(p.numel() for p in state.discriminator.parameters())} parameters: "
        f"{time.perf_counter() - t0:.2f} s")
    # Warm up on an R1 step, so every kernel specialization is built before
    # anything is timed; the counted steps then start from step 13.
    state.step = cfg.r1_interval - 1
    t0 = time.perf_counter()
    with LaunchRecorder() as trained:
        state, m0 = step(state, batch)
        m0 = {k: v.item() for k, v in m0.items()}
    log(f"phase train warm-up (R1) step incl. Triton JIT and the on-the-spot checks of every kernel "
        f"launch: {time.perf_counter() - t0:.2f} s; metrics {m0}")
    assert m0["r1"] > 0 and len(trained.rounds) == 1
    assert all(trained.rounds[0][k] for k in RUN8_KERNELS), {k: len(v) for k, v in trained.rounds[0].items()}
    t0 = time.perf_counter()
    train_parts = time_round(trained.rounds[0], trained.stats, f"R1 train step, batch {TRAIN_BATCH}")
    train_parts["blur_vjp"].update(time_vjp_copies(trained.vjp_copies, f"run_id-8 R1 step, batch {TRAIN_BATCH}"))
    del trained
    log(f"phase train kernel timings: {time.perf_counter() - t0:.2f} s; card now: "
        + nvidia_smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu"))

    # --- phase 8: three counted train steps (13, 14, 15: R1 on the last) ---
    state.step = 13
    steps, launches, peak, moved = run_train_steps(step, state, batch, counters)
    for i, dt, m, n in steps:
        log(f"  train step {i}: {1e3 * dt:.2f} ms host clock (synchronized), metrics {m}, launches {n}")
    r1_steps = [(i, dt) for i, dt, m, _ in steps if (i + 1) % cfg.r1_interval == 0]
    plain_steps = [dt for i, dt, m, _ in steps if (i + 1) % cfg.r1_interval != 0]
    assert len(r1_steps) == 1, r1_steps
    for i, dt, m, _ in steps:
        assert all(np.isfinite(v) for v in m.values()), (i, m)
        assert (m["r1"] > 0) == ((i + 1) % cfg.r1_interval == 0), (i, m)
        assert m["render_overflow"] == 0.0, (i, m)
    assert all(moved[k] > 0 for k in moved) and moved["g_ema"] < moved["generator"], moved
    assert all(launches[KERNELS[k]["name"]] > 0 for k in RUN8_KERNELS), \
        f"a kernel never launched in the train steps: {launches}"
    t_plain = float(np.median(plain_steps))
    bare_plain_s = t_plain
    t_r1 = r1_steps[0][1]
    log(f"phase train: {len(steps)} counted steps at batch {TRAIN_BATCH}: without R1 median "
        f"{1e3 * t_plain:.2f} ms ({TRAIN_BATCH / t_plain:.1f} images/s), with R1 {1e3 * t_r1:.2f} ms "
        f"({TRAIN_BATCH / t_r1:.1f} images/s); over the r1_interval {cfg.r1_interval} schedule "
        f"{TRAIN_BATCH * cfg.r1_interval / ((cfg.r1_interval - 1) * t_plain + t_r1):.1f} images/s; "
        f"peak memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); parameter movement "
        f"(sum of mean |delta|) {moved}; render overflow 0; launches {launches}; on {smi}")
    profile_train_step(step, state, batch, r1=False)
    profile_train_step(step, state, batch, r1=True)
    time_r1_parts(state, batch, cfg, res)
    del state, step, batch

    # --- phases 9-10: the run_id-0 train step (interpolation loss) ---
    train0_parts, launches0 = train_run_id0(res, counters, smi)

    # --- phase 11: R1's grad-of-grad through the kernels vs the plain versions ---
    check_r1_narrow(counters)

    # --- phase 12: tiny train steps on the card vs the CPU plain path ---
    check_train_against_cpu_plain(8)
    check_train_against_cpu_plain(0)
    check_branches_against_cpu_plain()

    # --- phase 13: the regularized run_id-8 step (every D branch, path length) ---
    launches_reg, warm_reg, errs_reg = train_regularized(res, counters, smi)

    # --- phase 14: the fused run_id-0 step with the direct gradient regularizer ---
    launches_dg, warm_dg, errs_dg = train_run_id0_direct(res, counters, smi)

    # --- phase 15: the render's gradient on the card ---
    launches_rg, albedo = check_render_gradient(res, counters)

    # --- phases 16-17: the training job through train(), resume, FID, run_id 0 ---
    loop_parts, errs_loop, loop_ips = train_loop(res, counters, smi, bare_plain_s)

    # --- phase 18: train() over an NCCL process group of one rank ---
    nccl_parts = train_nccl(res, counters, smi, loop_ips)

    # --- phase 19: two data-parallel ranks (gloo) on the one card ---
    dp_parts = train_two_ranks(res, smi)

    # --- phase 20: the generation path (the figure scripts) ---
    gen_launches, errs_gen = generation_path(counters, smi)

    # --- phase 21: resampling modes, bench + measurement scripts, eye regressor,
    # the deterministic resume, serve --ckpt, the converters ---
    slice_parts, errs_slice = phase_21(res, counters, smi)

    # --- phase 22: the study and analysis scripts, raster_sensitivity ---
    study_launches, errs_study, _ = study_scripts(counters, smi)

    # --- phase 23: the port at full width against gif_tpu's goldens ---
    golden_launches = full_width_goldens(res, counters, smi)

    # --- phase 24: StyleGAN3-T's filtered leaky ReLU ---
    sg3_records = filtered_lrelu_phase(smi)

    # One record per kernel: launches from the counted run_id-8 train steps
    # and the other numbers at its shapes (one R1 step's launches); the
    # forward kernels carry their served-path numbers under "serve", every
    # kernel its run_id-0 numbers under "run_id0" (the scatter, which only
    # run_id 0 runs, also at the top); max_abs_err is the largest of all.
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"]
    records = []
    for kind, meta in KERNELS.items():
        run0 = {"launches": launches0[meta["name"]], **train0_parts[kind]}
        if kind in train_parts:
            r = {**meta, "launches": launches[meta["name"]], **train_parts[kind]}
        else:
            r = {**meta, **run0}
        if kind in serve_parts:
            r["serve"] = {"launches": serve_launches[meta["name"]], **serve_parts[kind]}
            r["max_abs_err"] = max(r["max_abs_err"], serve_parts[kind]["max_abs_err"])
        r["run_id0"] = run0
        # The paths of phases 13-15: counted launches (and the recorded
        # warm-up step's, every one held to the plain version).
        r["run_id8_reg"] = {"launches": launches_reg[meta["name"]], "warmup_launches": warm_reg[kind]}
        r["run_id0_direct"] = {"launches": launches_dg[meta["name"]], "warmup_launches": warm_dg[kind]}
        r["render_grad"] = {"launches": launches_rg[meta["name"]]}
        r["loop"] = loop_parts[kind]
        r["data_parallel"] = {"nccl_launches": nccl_parts[kind], **dp_parts[kind]}
        r["generation"] = {"launches": gen_launches[meta["name"]]}
        r["phase21"] = slice_parts[kind]
        by_script = {key: n[meta["name"]] for key, n in study_launches.items()}
        r["scripts22"] = {"launches": sum(by_script.values()), "by_script": by_script}
        r["goldens23"] = {"launches": golden_launches[meta["name"]]}
        if kind == "scatter":
            r["albedo"] = albedo
        r["max_abs_err"] = max(r["max_abs_err"], run0["max_abs_err"], errs_reg.get(kind, 0.0),
                               errs_dg.get(kind, 0.0), errs_loop.get(kind, 0.0), errs_gen.get(kind, 0.0),
                               errs_slice.get(kind, 0.0), errs_study.get(kind, 0.0),
                               albedo["max_abs_err"] if kind == "scatter" else 0.0)
        records.append({**{k: r[k] for k in keys}, **{k: v for k, v in r.items() if k not in keys}})
    records += sg3_records
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--deterministic-child"]:  # phase 21's child process
        deterministic_child(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--counted-train"]:  # phase 22's training children
        counted_train_child(sys.argv[2], sys.argv[3:])
        sys.exit(0)
    if sys.argv[1:2] == ["--filtered-lrelu"]:  # phase 24 alone
        sys.exit(filtered_lrelu_only())
    sys.exit(main())

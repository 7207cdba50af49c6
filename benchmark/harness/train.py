"""The training driver: one run of a training cell.

Set-up builds one object, the program's train step with its models and
optimizer state, from weights the benchmark draws on the device from the
seed, and drives it through its first three steps on the ring's first
three batches.  The state's step counter starts at ``r1_interval - 1``, so
the first step is an R1 step and the three warm every shape the window
runs (the R1 step and the plain one).  The same object then runs the
window: whole R1 cycles of ``r1_interval`` steps, fed from the ring in
turn, until ``seconds`` have passed; each cycle ends in a synchronize.

After the window closes and the peak memory is read, a traced run adds a
profiled cycle (the traced slice) and a replay of kernel 4's launches of
one step.  Then the program's state is freed and the reference follows
the first three steps from the same weights and batches.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import os
import time

import torch

from ..reference import resources as ref_resources
from ..reference.ops import lower_precision
from ..reference.train import ReferenceTrainer, build_models
from . import compare, flops, traffic
from .weights import module_shapes, seeded_weights

FIRST_STEPS = 3


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class StepTimes:
    """CUDA-event spans around each step call (host clock on the CPU)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.spans = []  # (start, end, is_r1)

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, start, is_r1: bool):
        self.spans.append((start, self.start(), is_r1))

    def ms(self, r1: bool) -> list:
        out = []
        for s, e, is_r1 in self.spans:
            if is_r1 == r1:
                out.append(s.elapsed_time(e) if self.cuda else 1e3 * (e - s))
        return out


def resources(cfg: dict):
    """The mesh the configuration names, made by the benchmark's own copy
    of the synthetic FLAME generator: (reference's, program's)."""
    import dataclasses

    from gif_tpu_torch.flame.resources import FlameResources

    mesh = cfg["mesh"]
    ref = ref_resources.synthetic_flame_resources(seed=mesh["seed"], n_vertices=mesh["n_vertices"])
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    return ref, FlameResources(**fields)


def train_config(cfg: dict, overrides: dict | None = None) -> dict:
    out = dict(cfg["train_config"])
    out.update(overrides or {})
    return out


def program_state(tcfg: dict, g_weights: dict, d_weights: dict, device):
    """The program's train state, its models built on the meta device and
    given the benchmark's weights (copies: the state trains in place)."""
    from gif_tpu_torch.models.discriminator import Discriminator
    from gif_tpu_torch.models.generator import StyledGenerator
    from gif_tpu_torch.train.config import TrainConfig
    from gif_tpu_torch.train.state import TrainState, make_optimizers

    pcfg = TrainConfig(**tcfg)
    with torch.device("meta"):
        gen = StyledGenerator.from_config(pcfg)
        disc = Discriminator.from_config(pcfg)
    gen.load_state_dict({k: v.clone() for k, v in g_weights.items()}, strict=True, assign=True)
    disc.load_state_dict({k: v.clone() for k, v in d_weights.items()}, strict=True, assign=True)
    g_ema = copy.deepcopy(gen).requires_grad_(False)
    g_ema.embedding = gen.embedding
    g_opt, d_opt = make_optimizers(pcfg, gen.parameters(), disc.parameters())
    state = TrainState(step=0, generator=gen, discriminator=disc, g_ema=g_ema, g_opt=g_opt, d_opt=d_opt,
                       pl_mean=torch.zeros((), device=device), used_samples=0)
    return pcfg, state


def _cpu(named) -> dict:
    return {k: v.detach().float().cpu().clone() for k, v in named}


def _first_moments(opt, module) -> dict:
    """The gradient Adam got on its first step, from its state: with
    beta1 = 0 the first moment is the gradient itself."""
    b1 = opt.param_groups[0]["betas"][0]
    out = {}
    for k, p in module.named_parameters():
        m = opt.state.get(p, {}).get("exp_avg")  # none where the optimizer never stepped
        out[k] = (torch.zeros_like(p) if m is None else m / (1.0 - b1)).detach().float().cpu()
    return out


def replay_blur4(launches: dict) -> dict | None:
    """Kernel 4's launches of one step, replayed at their shapes with CUDA
    events around 20 calls queued behind a device spin (``chip_smoke.py``'s
    ``queued_ms``); the bound of each is its bytes (every input read once,
    every output written once) over the HBM bandwidth."""
    from gif_tpu_torch.ops import blur_cuda

    if not launches:
        return None
    bound = measured = 0.0
    for (shape, dtype, taps, pads), count in launches.items():
        x = torch.randn(shape, device="cuda").to(dtype)
        n, c, h, w = shape
        ho, wo = h + pads[0] + pads[1] - 3, w + pads[2] + pads[3] - 3
        nbytes = (x.numel() + n * c * ho * wo) * x.element_size()
        blur_cuda.blur4_cuda(x, taps, pads)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(20):
            blur_cuda.blur4_cuda(x, taps, pads)
        end.record()
        torch.cuda.synchronize()
        measured += count * start.elapsed_time(end) / 20 / 1e3
        bound += count * nbytes / flops.HBM_BYTES_PER_S
    return {"bound_s": bound, "measured_s": measured, "launches": sum(launches.values())}


def record_blur4(fn):
    """Run ``fn()`` with kernel 4's launches recorded by shape."""
    from gif_tpu_torch.ops import blur_cuda

    launches, orig = {}, blur_cuda.blur4_cuda

    def recorder(x, taps, pads):
        key = (tuple(x.shape), x.dtype, tuple(taps), tuple(pads))
        launches[key] = launches.get(key, 0) + 1
        return orig(x, taps, pads)

    blur_cuda.blur4_cuda = recorder
    try:
        fn()
    finally:
        blur_cuda.blur4_cuda = orig
    return launches


@contextlib.contextmanager
def profiled(tmpdir: str, got: dict):
    """Profile the block (CPU and CUDA activity) inside the window range,
    closed by a synchronize; on exit the reduced trace is in ``got``
    under ``slice``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .trace import WINDOW_RANGE, device_slice, load_events

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_RANGE):
            yield
            torch.cuda.synchronize()
    path = os.path.join(tmpdir, f"benchmark_trace_{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        got["slice"] = device_slice(load_events(path))
    finally:
        if os.path.exists(path):
            os.remove(path)


def reference_steps(tcfg: dict, ref_res, first: list, seed: int, device, lower: bool = False) -> dict:
    """The reference's first three steps from the run's weights: losses,
    the first step's gradients, and the change of G, D and the EMA."""
    gen_m, disc_m = build_models(tcfg)
    g0, d0 = seeded_weights(module_shapes(gen_m), module_shapes(disc_m), seed, device)
    init_g = {k: v.detach().float().cpu().clone() for k, v in g0.items()}
    init_d = {k: v.detach().float().cpu().clone() for k, v in d0.items()}
    trainer = ReferenceTrainer(tcfg, ref_res, g0, d0, device)
    losses, grads = [], None
    ctx = lower_precision if lower else contextlib.nullcontext
    with ctx():
        for i, entry in enumerate(first):
            m, dg, gg = trainer.step(entry["batch"], entry["draws"], tcfg["r1_interval"] - 1 + i)
            losses.append(m)
            if grads is None:
                dn = [k for k, _ in trainer.disc.named_parameters()]
                gn = [k for k, _ in trainer.gen.named_parameters()]
                grads = {"d": {k: g.float().cpu() for k, g in zip(dn, dg)},
                         "g": {k: g.float().cpu() for k, g in zip(gn, gg)}}
    g_after = _cpu(trainer.gen.named_parameters())
    d_after = _cpu(trainer.disc.named_parameters())
    ema = {k: e.float().cpu() for (k, _), e in zip(trainer.gen.named_parameters(), trainer.ema)}
    change = {"g": {k: g_after[k] - init_g[k] for k in g_after},
              "d": {k: d_after[k] - init_d[k] for k in d_after},
              "ema": {k: ema[k] - init_g[k] for k in ema}}
    return {"losses": losses, "grads": grads, "change": change, "init_g": init_g, "init_d": init_d}


def run(cell, seed: int, seconds: float, traced: bool, t_start: float, device="cuda",
        overrides: dict | None = None, mesh: dict | None = None, tmpdir: str | None = None,
        keep: bool = False) -> dict:
    """One run of training cell ``cell``: returns the run's numbers (the
    line's ``metrics`` are filled in by :mod:`benchmark.run` from them).
    ``overrides`` and ``mesh`` change the configuration's train settings
    and mesh (the CPU tests' small sizes); ``keep`` returns the program's
    and the reference's readings too (the calibration reads them).  A cell
    that asks for more than one GPU is refused: this driver uses one."""
    from .registry import Refused

    if int(cell.workload["chips"]) != 1:
        raise Refused(f"cell {cell.name} asks for {cell.workload['chips']} GPUs; the train driver runs on one")
    from gif_tpu_torch.train.step import make_train_step

    device = torch.device(device)
    marks = {"start": time.perf_counter() - t_start}
    tcfg = train_config(cell.config, overrides)
    ref_res, prog_res = resources({"mesh": dict(cell.config["mesh"], **(mesh or {}))})
    marks["mesh"] = time.perf_counter() - t_start
    gen_m, disc_m = build_models(tcfg)
    g_w, d_w = seeded_weights(module_shapes(gen_m), module_shapes(disc_m), seed, device)
    pcfg, state = program_state(tcfg, g_w, d_w, device)
    marks["state"] = time.perf_counter() - t_start
    del g_w, d_w
    interp = tcfg["apply_texture_space_interpolation_loss"]
    spec = cell.traffic
    ring = traffic.train_ring(spec, seed, device, tcfg["max_size"], tcfg["embedding_vocab_size"], interp)
    step_fn = make_train_step(pcfg, prog_res, device=device, max_tris_per_tile=None,
                              generator=torch.Generator().manual_seed(int(seed) % 2**63))
    r1_every = tcfg["r1_interval"]
    state.step = r1_every - 1
    at = [0]

    def one(times=None):
        entry = ring[at[0] % len(ring)]
        at[0] += 1
        is_r1 = (state.step + 1) % r1_every == 0
        t = times.start() if times else None
        _, m = step_fn(state, entry["batch"], entry["draws"])
        if times:
            times.stop(t, is_r1)
        return m

    marks["ring"] = time.perf_counter() - t_start
    # The first three steps: the window's own call and feed.
    prog = {"losses": []}
    for i in range(FIRST_STEPS):
        m = one()
        marks[f"step{i + 1}"] = time.perf_counter() - t_start
        prog["losses"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            prog["grads"] = {"g": _first_moments(state.g_opt, state.generator),
                             "d": _first_moments(state.d_opt, state.discriminator)}
    after = {"g": _cpu(state.generator.named_parameters()), "d": _cpu(state.discriminator.named_parameters()),
             "ema": _cpu(state.g_ema.named_parameters())}
    sync(device)
    setup_s = time.perf_counter() - t_start

    # The window: whole R1 cycles until ``seconds`` have passed.
    times = StepTimes(device)
    steps = 0
    t0 = time.perf_counter()
    cycles = []
    while True:
        for _ in range(r1_every):
            one(times)
        sync(device)
        steps += r1_every
        cycles.append(time.perf_counter() - t0)
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    rows = spec["batch"]
    out = {
        "end_to_end": {"train_images_per_s": steps * rows / window_s, "setup_s": setup_s},
        "setup_s": setup_s, "window_s": window_s, "steps": steps, "images": steps * rows,
        "attempted": steps, "failed": 0, "devices": 1,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0,
        "spans": {"train.plain_step": times.ms(False), "train.r1_step": times.ms(True)},
        "flops": flops.train_step(tcfg, rows),
        "first_losses": prog["losses"], "setup_marks": marks, "cycle_ends": cycles,
    }
    if traced and device.type == "cuda":
        out["blur4"] = replay_blur4(record_blur4(lambda: (one(), torch.cuda.synchronize())))
        got = {}
        with profiled(tmpdir or os.environ.get("TMPDIR", "/tmp"), got):
            for _ in range(r1_every):
                one()
        out["slice"] = got["slice"]
        out["slice_steps"] = r1_every

    # Free the program's state, then follow its first steps with the reference.
    first = ring[:FIRST_STEPS]
    del state, step_fn, ring
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_steps(tcfg, ref_res, first, seed, device)
    prog["change"] = {"g": {k: after["g"][k] - ref["init_g"][k] for k in after["g"]},
                      "d": {k: after["d"][k] - ref["init_d"][k] for k in after["d"]},
                      "ema": {k: after["ema"][k] - ref["init_g"][k] for k in after["ema"]}}
    numbers = compare.train_numbers(prog, ref)
    out["correct"], out["checks"] = compare.checks(numbers, cell.limits)
    out["reference_s"] = time.perf_counter() - t_ref
    if keep:
        out["program"], out["reference"], out["first"], out["ref_res"] = prog, ref, first, ref_res
        out["train_config"] = tcfg
    return out

"""The unconditional training driver (traffic ``kind`` ``train_uncond``): one
run of a StyleGAN3 training cell.

Set-up builds the program's train step (``make_train_step`` of a
``StyleGAN3Config``) with its models and optimizer state, from weights the
benchmark draws on the device from the seed (:func:`seeded_weights`), and
drives it through its first three steps on the ring's first three
batches; the state's counter starts at 0, so the first step is an R1 step
(NVlabs' ``batch_idx % r1_interval == 0``) and the three warm every shape
the window runs.  The window runs whole R1 cycles (any ``r1_interval``
consecutive steps hold one R1 step), fed from the ring in turn, until
``seconds`` have passed, each cycle closed by a synchronize.

Compared (:mod:`.compare`), after the first three steps: the first step's
D and G losses; its gradients as the Adam steps got them, G's and D's of
its main phase (both from the initial weights, the fakes from the updated
G); and the change of G, D and the EMA.  R1's value is reported and not
compared: NVlabs' order takes it after D's first Adam step, whose
sign-like update moves every element whose gradient is round-off by the
whole learning rate, and the R1 of the moved D read up to 0.097 off
between the program and the reference, as far as the float8 control's
(from 0.009, PERF.md).  Its gradient is held by its scale instead:
``r1_grad_ratio`` is ``|‖g‖ / ‖r‖ - 1|`` of the whole gradient D's R1
Adam step gets on the first step (1 where the program takes no R1 step),
which sees R1's weight and a missing R1 phase.

A traced run then records one step's filtered-leaky-ReLU launches by shape
and replays them behind a device spin (``filtered_lrelu``: their bound and
CUDA-event time), and profiles one cycle (the traced slice).  Then the
program's state is freed and the reference (:mod:`..reference.train_uncond`,
in the configuration's precision) follows the first three steps from the
same weights and batches; :mod:`.compare`'s numbers against the cell's
limits decide ``correct``.

The ring: ``ring`` batches of ``batch`` rows made on the device from the
seed, each real images uniform in [-1, 1] (B, S, S, 3) and its draws
``z_g``, ``z_d`` standard normal (B, 512).
"""

from __future__ import annotations

import contextlib
import copy
import gc
import os
import re
import time

import torch

from ..reference.train_uncond import ReferenceUncondTrainer, build_models
from . import compare, flops_sg3
from .train import FIRST_STEPS, StepTimes, _cpu, _first_moments, profiled, sync, train_config
from .weights import leaf_distribution, module_shapes

Z_DIM = 512
BUFFERS = re.compile(r"\.(freqs|phases|transform|magnitude_ema)$")
STYLE_BIAS = re.compile(r"^synthesis\.L\d+_\d+_\d+\.affine\.bias$")
# The Fourier input's affine as NVlabs initializes it (weight 0, bias (1,
# 0, 0, 0)): every w starts at the identity transform.  Drawn like the
# other leaves, the rotation part (r_c, r_s) of some rows comes near 0,
# where the input divides by its norm: the gradient there, and through it
# the mapping net's, swings with round-off, and the float32 program read
# the mapping biases' change up to 0.43 off the float32 reference (PERF.md).
INPUT_AFFINE = {"synthesis.input.affine.weight": 0.0, "synthesis.input.affine.bias": (1.0, 0.0, 0.0, 0.0)}


def uncond_ring(spec: dict, seed: int, device, size: int) -> list:
    """``spec["ring"]`` batches of ``spec["batch"]`` rows, each ``{"batch":
    {"real_image"}, "draws": {"z_g", "z_d"}}``."""
    b = spec["batch"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    ring = []
    for _ in range(spec["ring"]):
        real = torch.rand((b, size, size, 3), generator=gen, device=device) * 2 - 1
        draws = {k: torch.randn((b, Z_DIM), generator=gen, device=device) for k in ("z_g", "z_d")}
        ring.append({"batch": {"real_image": real}, "draws": draws})
    return ring


def _leaf(name: str) -> tuple[float, float]:
    """(mean, std) of a parameter: :func:`.weights.leaf_distribution`'s rule,
    with the synthesis layers' style biases at 1 + N(0, 0.1) as the
    modulation biases are (NVlabs initializes them at 1)."""
    if STYLE_BIAS.match(name):
        return 1.0, 0.1
    return leaf_distribution(name)


def seeded_weights(gen_shapes: dict, disc_shapes: dict, seed: int, device) -> tuple[dict, dict]:
    """(G's state, D's state) for ``seed``: every parameter of G and then of
    D from one standard-normal draw on ``device``, sliced leaf by leaf in
    name order and scaled by :func:`_leaf` (the input's affine then set to
    :data:`INPUT_AFFINE`); G's buffers as NVlabs makes
    them: the Fourier frequencies and phases drawn from the seed (its
    rule, on a CPU generator), the transform the identity, the magnitude
    EMAs 1."""
    params = {k: s for k, s in {**{f"g.{k}": v for k, v in gen_shapes.items()},
                                **{f"d.{k}": v for k, v in disc_shapes.items()}}.items()
              if not BUFFERS.search(k)}
    total = sum(int(torch.Size(s).numel()) for s in params.values())
    flat = torch.randn(total, generator=torch.Generator(device=device).manual_seed(int(seed) % 2**63),
                       device=device, dtype=torch.float32)
    out, at = {"g": {}, "d": {}}, 0
    for key in sorted(params):
        net, name = key.split(".", 1)
        shape = torch.Size(params[key])
        mean, std = _leaf(name)
        leaf = flat[at:at + shape.numel()].view(shape) * std
        out[net][name] = leaf + mean if mean else leaf
        if net == "g" and name in INPUT_AFFINE:
            out[net][name] = torch.tensor(INPUT_AFFINE[name], device=device).expand(shape).clone()
        at += shape.numel()
    cpu = torch.Generator().manual_seed(int(seed) % 2**63)
    for name, shape in sorted(gen_shapes.items()):
        if name.endswith(".freqs"):
            c = shape[0]
            freqs = torch.randn([c, 2], generator=cpu)
            radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
            out["g"][name] = freqs / (radii * radii.square().exp().pow(0.25))  # scaled by the bandwidth below
            out["g"][name[: -len("freqs")] + "phases"] = torch.rand([c], generator=cpu) - 0.5
        elif name.endswith(".transform"):
            out["g"][name] = torch.eye(3)
        elif name.endswith(".magnitude_ema"):
            out["g"][name] = torch.ones([])
    return out["g"], out["d"]


def _weights(tcfg: dict, seed: int, device) -> tuple[dict, dict]:
    gen_m, disc_m = build_models(tcfg)
    g, d = seeded_weights(module_shapes(gen_m), module_shapes(disc_m), seed, device)
    g["synthesis.input.freqs"] = g["synthesis.input.freqs"] * gen_m.synthesis.input.bandwidth
    return {k: v.to(device) for k, v in g.items()}, d


def program_state(tcfg: dict, g_weights: dict, d_weights: dict, device):
    """The program's train state, its models built on the meta device and
    given the benchmark's weights (copies: the state trains in place)."""
    from gif_tpu_torch.models.discriminator import Discriminator
    from gif_tpu_torch.models.stylegan3 import StyleGAN3Generator
    from gif_tpu_torch.train.config import StyleGAN3Config
    from gif_tpu_torch.train.state import TrainState, make_optimizers

    pcfg = StyleGAN3Config(**tcfg)
    with torch.device("meta"):
        gen = StyleGAN3Generator.from_config(pcfg)
        disc = Discriminator.from_config(pcfg)
    gen.load_state_dict({k: v.clone() for k, v in g_weights.items()}, strict=True, assign=True)
    disc.load_state_dict({k: v.clone() for k, v in d_weights.items()}, strict=True, assign=True)
    gen = gen.to(device)  # the filters, computed on the CPU
    g_ema = copy.deepcopy(gen).requires_grad_(False)
    g_opt, d_opt = make_optimizers(pcfg, gen.parameters(), disc.parameters())
    state = TrainState(step=0, generator=gen, discriminator=disc, g_ema=g_ema, g_opt=g_opt, d_opt=d_opt,
                       pl_mean=torch.zeros((), device=device), used_samples=0)
    return pcfg, state


def record_flrelu(fn) -> dict:
    """Run ``fn()`` with the filtered leaky ReLU's forward and backward
    launches recorded: {(kind, shape, dtype, up, down, padding): [count,
    (fu, fd, bias, gain, slope, clamp)]}."""
    from gif_tpu_torch.ops import filtered_lrelu as fl

    launches, orig = {}, (fl.filtered_lrelu_cuda, fl.filtered_lrelu_backward_cuda)

    def note(kind, x, fu, fd, b, up, down, padding, rest):
        key = (kind, tuple(x.shape), x.dtype, up, down, tuple(padding) if not isinstance(padding, int) else padding)
        launches.setdefault(key, [0, (fu, fd, b) + rest])[0] += 1

    def fwd(x, fu, fd, b, up, down, padding, gain, slope, clamp):
        note("forward", x, fu, fd, b, up, down, padding, (gain, slope, clamp))
        return orig[0](x, fu, fd, b, up, down, padding, gain, slope, clamp)

    def bwd(x, dy, fu, fd, b, up, down, padding, gain, slope, clamp):
        note("backward", x, fu, fd, b, up, down, padding, (gain, slope, clamp))
        return orig[1](x, dy, fu, fd, b, up, down, padding, gain, slope, clamp)

    fl.filtered_lrelu_cuda, fl.filtered_lrelu_backward_cuda = fwd, bwd
    try:
        fn()
    finally:
        fl.filtered_lrelu_cuda, fl.filtered_lrelu_backward_cuda = orig
    return launches


def replay_flrelu(launches: dict, reps: int = 20) -> dict | None:
    """The recorded launches replayed at their shapes, ``reps`` calls each
    queued behind a device spin and timed by CUDA events; each one's bound
    is max(bytes / HBM bandwidth, operations / float32 peak)
    (:func:`.flops_sg3.launch_counts`)."""
    from gif_tpu_torch.ops import filtered_lrelu as fl

    if not launches:
        return None
    bound = measured = 0.0
    for (kind, shape, dtype, up, down, padding), (count, (fu, fd, b, gain, slope, clamp)) in launches.items():
        x = torch.randn(shape, device="cuda").to(dtype)
        y = fl.filtered_lrelu_cuda(x, fu, fd, b, up, down, padding, gain, slope, clamp)
        if kind == "forward":
            def call():
                fl.filtered_lrelu_cuda(x, fu, fd, b, up, down, padding, gain, slope, clamp)
        else:
            dy = torch.randn_like(y)

            def call():
                fl.filtered_lrelu_backward_cuda(x, dy, fu, fd, b, up, down, padding, gain, slope, clamp)
        call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        torch.cuda.synchronize()
        ops, nbytes = flops_sg3.launch_counts(kind, shape, tuple(y.shape[2:]), up, down, x.element_size())
        measured += count * start.elapsed_time(end) / reps / 1e3
        bound += count * max(nbytes / flops_sg3.HBM_BYTES_PER_S, ops / flops_sg3.PEAK_F32_FLOPS)
        del x, y
    return {"bound_s": bound, "measured_s": measured, "launches": sum(c for c, _ in launches.values())}


def compared_losses(losses: list) -> list:
    """The losses :mod:`.compare` reads: all but R1's (the module
    docstring says why)."""
    return [{k: v for k, v in m.items() if k != "r1"} for m in losses]


def reference_steps(tcfg: dict, first: list, seed: int, device, precision: str = "config") -> dict:
    """The reference's first three steps from the run's weights: losses,
    the first step's gradients (G's, and D's of its main phase), and the
    change of G, D and the EMA."""
    g0, d0 = _weights(tcfg, seed, device)
    init_g = {k: v.detach().float().cpu().clone() for k, v in g0.items()}
    init_d = {k: v.detach().float().cpu().clone() for k, v in d0.items()}
    trainer = ReferenceUncondTrainer(tcfg, g0, d0, device, precision)
    losses, grads, r1_grad = [], None, {}
    dn = [k for k, _ in trainer.disc.named_parameters()]
    gn = [k for k, _ in trainer.gen.named_parameters()]
    for i, entry in enumerate(first):
        m, dg, gg, rg = trainer.step(entry["batch"], entry["draws"], i)
        losses.append(m)
        if grads is None:
            grads = {"d": {k: g.float().cpu() for k, g in zip(dn, dg)},
                     "g": {k: g.float().cpu() for k, g in zip(gn, gg)}}
            r1_grad = {k: g.float().cpu() for k, g in zip(dn, rg)} if rg is not None else {}
    g_after = _cpu(trainer.gen.named_parameters())
    d_after = _cpu(trainer.disc.named_parameters())
    ema = {k: e.float().cpu() for (k, _), e in zip(trainer.gen.named_parameters(), trainer.ema)}
    change = {"g": {k: g_after[k] - init_g[k] for k in g_after},
              "d": {k: d_after[k] - init_d[k] for k in d_after},
              "ema": {k: ema[k] - init_g[k] for k in ema}}
    return {"losses": losses, "grads": grads, "r1_grad": r1_grad, "change": change, "init_g": init_g,
            "init_d": init_d}


def r1_grad_ratio(prog: dict, ref: dict) -> float:
    """``|‖g‖ / ‖r‖ - 1|`` of D's whole R1 gradient on the first step, the
    program's (``{}`` where it took no R1 step) against the reference's."""
    if not prog:
        return 1.0
    return compare.tree_ratio(prog, ref, list(ref))


def numbers(prog: dict, ref: dict) -> dict:
    """The numbers that decide ``correct`` (``{name: (value, where)}``):
    :func:`.compare.train_numbers` on every loss but R1's, and
    ``r1_grad_ratio``."""
    out = compare.train_numbers(dict(prog, losses=compared_losses(prog["losses"])),
                                dict(ref, losses=compared_losses(ref["losses"])))
    out["r1_grad_ratio"] = (r1_grad_ratio(prog["r1_grad"], ref["r1_grad"]), "d")
    return out


def run(cell, seed: int, seconds: float, traced: bool, t_start: float, device="cuda",
        overrides: dict | None = None, tmpdir: str | None = None, keep: bool = False) -> dict:
    """One run of the unconditional training cell ``cell``: returns the
    run's numbers (:mod:`benchmark.run` fills the line's metrics from
    them).  ``overrides`` change the configuration's train settings (the CPU
    tests' small sizes); ``keep`` returns the program's and the reference's
    readings too (the calibration reads them).  A cell that asks for more
    than one GPU is refused: this driver uses one."""
    from .registry import Refused

    if int(cell.workload["chips"]) != 1:
        raise Refused(f"cell {cell.name} asks for {cell.workload['chips']} GPUs; the train driver runs on one")
    from gif_tpu_torch.train.step import make_train_step

    device = torch.device(device)
    marks = {"start": time.perf_counter() - t_start}
    tcfg = train_config(cell.config, overrides)
    g_w, d_w = _weights(tcfg, seed, device)
    pcfg, state = program_state(tcfg, g_w, d_w, device)
    marks["state"] = time.perf_counter() - t_start
    del g_w, d_w
    spec = cell.traffic
    ring = uncond_ring(spec, seed, device, tcfg["max_size"])
    step_fn = make_train_step(pcfg, None, device=device, generator=torch.Generator().manual_seed(int(seed) % 2**63))
    r1_every = tcfg["r1_interval"]
    at = [0]

    def one(times=None):
        entry = ring[at[0] % len(ring)]
        at[0] += 1
        is_r1 = state.step % r1_every == 0
        t = times.start() if times else None
        _, m = step_fn(state, entry["batch"], entry["draws"])
        if times:
            times.stop(t, is_r1)
        return m

    marks["ring"] = time.perf_counter() - t_start
    prog = {"losses": []}
    d_steps = []

    def d_step(opt, args, kwargs):  # the gradients D's Adam steps get: main phase, then R1
        d_steps.append({k: p.grad.detach().float().cpu().clone() for k, p in state.discriminator.named_parameters()})

    hook = state.d_opt.register_step_pre_hook(d_step)
    for i in range(FIRST_STEPS):
        m = one()
        marks[f"step{i + 1}"] = time.perf_counter() - t_start
        prog["losses"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            hook.remove()
            prog["grads"] = {"g": _first_moments(state.g_opt, state.generator), "d": d_steps[0]}
            prog["r1_grad"] = d_steps[1] if len(d_steps) > 1 else {}
    after = {"g": _cpu(state.generator.named_parameters()), "d": _cpu(state.discriminator.named_parameters()),
             "ema": _cpu(state.g_ema.named_parameters())}
    sync(device)
    setup_s = time.perf_counter() - t_start

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
    cuda = device.type == "cuda"
    out = {
        "end_to_end": {"train_images_per_s": steps * rows / window_s, "setup_s": setup_s},
        "setup_s": setup_s, "window_s": window_s, "steps": steps, "images": steps * rows,
        "attempted": steps, "failed": 0, "devices": 1,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if cuda else 0,
        "spans": {"train.plain_step": times.ms(False), "train.r1_step": times.ms(True)},
        "flops": flops_sg3.train_step(tcfg, rows),
        "first_losses": prog["losses"], "setup_marks": marks, "cycle_ends": cycles,
    }
    if traced and cuda:
        out["filtered_lrelu"] = replay_flrelu(record_flrelu(lambda: (one(), torch.cuda.synchronize())))
        got = {}
        with profiled(tmpdir or os.environ.get("TMPDIR", "/tmp"), got):
            for _ in range(r1_every):
                one()
        out["slice"] = got["slice"]
        out["slice_steps"] = r1_every

    first = ring[:FIRST_STEPS]
    del state, step_fn, ring
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_steps(tcfg, first, seed, device)
    prog["change"] = {"g": {k: after["g"][k] - ref["init_g"][k] for k in after["g"]},
                      "d": {k: after["d"][k] - ref["init_d"][k] for k in after["d"]},
                      "ema": {k: after["ema"][k] - ref["init_g"][k] for k in after["ema"]}}
    out["correct"], out["checks"] = compare.checks(numbers(prog, ref), cell.limits)
    out["reference_s"] = time.perf_counter() - t_ref
    if keep:
        out["program"], out["reference"], out["first"], out["train_config"] = prog, ref, first, tcfg
    return out


def calibrate(cell, seed: int) -> dict:
    """One seed's readings for the cell's limits: the sound run's numbers;
    the control's (the reference one precision below the configuration's,
    float8 where it states bfloat16, in the program's place); and, for
    the record, the float32 reference's."""
    out = run(cell, seed, 0.0, False, time.perf_counter(), keep=True)
    ref = out["reference"]
    row = {"seed": seed, "sound": {k: v["value"] for k, v in out["checks"].items()},
           "sound_where": {k: v["where"] for k, v in out["checks"].items()}}
    for name in ("float8", "float32"):
        other = reference_steps(out["train_config"], out["first"], seed, "cuda", name)
        n = numbers(other, ref)
        row[name] = {k: v[0] for k, v in n.items()}
        row[name + "_where"] = {k: v[1] for k, v in n.items()}
        row[name + "_losses"] = other["losses"]
    row.update(losses=out["first_losses"], reference_losses=ref["losses"],
               memory_peak_bytes=out["memory_peak_bytes"], setup_s=out["setup_s"],
               reference_s=out["reference_s"])
    return row


if __name__ == "__main__":
    import argparse
    import json

    from . import env, registry

    ap = argparse.ArgumentParser(description="calibration readings of an unconditional training cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    a = ap.parse_args()
    env.pin_caches()
    env.require_cards(1)
    for s in a.seeds.split(","):
        print(json.dumps(calibrate(registry.cell(a.workload), int(s))), flush=True)
        with contextlib.suppress(Exception):
            torch.cuda.empty_cache()

"""The StyleGAN3-T cell from its new files alone: the registry finds its
configuration, traffic mix, limits, driver (``train_uncond``) and metric
readers, and the driver runs a tiny version of the cell on the CPU to
lines that pass ``lastline.check``.  A CPU run has no device memory or
trace, so the traced line's device numbers (peak memory, the slice, the
kernel replay) are set by hand; the card test runs the cell whole.  A
run whose train step is broken underneath (:data:`FAULTS`) comes out not
correct."""

import dataclasses
import time

import pytest

from benchmark import run
from benchmark.harness import lastline, registry, train_uncond
from benchmark.harness.trace import DeviceSlice

CELL = "sg3t-ffhq1024-train-b4"
TINY = dict(max_size=32, init_size=32, render_image_size=32, channel_base=1024, max_channels=32,
            compute_dtype="float32", r1_interval=2)


FAULTS = ("half_batch", "lr_x1.25", "ema_decay_0.999", "r1_gamma_x2", "r1_missing")


def faulty_make_train_step(fault: str, real):
    """``make_train_step`` whose step carries ``fault``: half the batch's
    rows; both learning rates 1.25x; the EMA decay 0.999; R1's weight 2x;
    no R1 phase in the first steps (the step sees its counter one ahead)."""
    def make(cfg, *a, **k):
        if fault == "ema_decay_0.999":
            return real(dataclasses.replace(cfg, ema_decay=0.999), *a, **k)
        if fault == "r1_gamma_x2":
            return real(dataclasses.replace(cfg, r1_weight=2 * cfg.r1_weight), *a, **k)
        step = real(cfg, *a, **k)

        def broken(state, batch, draws):
            if fault == "half_batch":
                b = batch["real_image"].shape[0] // 2
                return step(state, {k: v[:b] for k, v in batch.items()}, {k: v[:b] for k, v in draws.items()})
            if fault == "lr_x1.25":
                for opt in (state.g_opt, state.d_opt):
                    for group in opt.param_groups:
                        group.setdefault("benchmark_base_lr", group["lr"])
                        group["lr"] = 1.25 * group["benchmark_base_lr"]
                return step(state, batch, draws)
            state.step += 1
            try:
                return step(state, batch, draws)
            finally:
                state.step -= 1
        return broken
    return make


def test_the_cell_is_found_from_its_files():
    from gif_tpu_torch.train.config import StyleGAN3Config, get_config

    cell = registry.cell(CELL)
    assert registry.driver(cell.traffic["kind"]) is train_uncond
    assert cell.traffic["batch"] == 4 and cell.traffic["ring"] == 16
    assert set(cell.limits) == {"loss_gap", "grad_gap", "grad_diff", "change_gap", "change_ratio", "r1_grad_ratio"}
    assert [m["name"] for m in cell.end_to_end] == ["train_images_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "train.step_mfu", "train.cycle_images_per_s_median", "train.plain_step_ms", "train.r1_step_ms",
        "sg3.filtered_lrelu_ms_per_step", "sg3.filtered_lrelu_roofline"]
    # The file holds the preset at published widths, with the batch cut to
    # one card's share.
    tc = cell.config["train_config"]
    assert StyleGAN3Config(**tc) == get_config("stylegan3-t-ffhq1024", batch_size=4)
    assert (tc["max_size"], tc["channel_base"], tc["max_channels"], tc["nmlp_for_z_to_w"]) == (1024, 32768, 512, 2)


def test_a_tiny_run_prints_lines_that_pass_the_check():
    cell = registry.cell(CELL)
    cell.traffic = dict(cell.traffic, ring=3)
    numbers = train_uncond.run(cell, 2**32 + 9, 0.2, False, time.perf_counter(), device="cpu", overrides=TINY)
    numbers["memory_peak_bytes"] = 1
    assert numbers["correct"] and numbers["steps"] >= 2
    for traced in (False, True):
        if traced:
            numbers["slice"] = DeviceSlice(0.0, 2000.0, [(0.0, 800.0, "void (anonymous namespace)::flrelu_forward"
                                                                     "<float, 2, 2>(float const*)")])
            numbers["slice_steps"] = 2
            numbers["filtered_lrelu"] = {"bound_s": 1.0, "measured_s": 4.0, "launches": 3}
        line = run.result_line(cell, numbers, traced, "cpu")
        names = [m["name"] for m in cell.metrics(traced)]
        lastline.check(line, names, {m["name"]: m["unit"] for m in cell.metrics(traced)}, traced, 1)
    assert line["metrics"]["sg3.filtered_lrelu_ms_per_step"]["value"] == 0.4
    assert line["metrics"]["sg3.filtered_lrelu_roofline"]["value"] == 25.0


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_step_is_caught(monkeypatch, fault):
    import gif_tpu_torch.train.step as step_mod

    monkeypatch.setattr(step_mod, "make_train_step", faulty_make_train_step(fault, step_mod.make_train_step))
    cell = registry.cell(CELL)
    cell.traffic = dict(cell.traffic, ring=3)
    numbers = train_uncond.run(cell, 2**32 + 11, 0.0, False, time.perf_counter(), device="cpu", overrides=TINY)
    assert not numbers["correct"], numbers["checks"]

"""``train.step_mfu``: the whole step's share of the card's dense bf16 peak
(989.4 TFLOP/s, data sheet, at 700 W): the benchmark's analytic FLOPs of a
step of the R1 schedule on average times the window's steps per second."""

from benchmark.harness.flops import PEAK_BF16_FLOPS


def read(ctx):
    if ctx.get("flops") is None or not ctx.get("steps"):
        return None
    return 100.0 * ctx.flops["mean"] * ctx.steps / ctx.window_s / PEAK_BF16_FLOPS

"""``train.optim_ms_per_step``: the device time per step, in the traced
cycle, of the program's ``train.d_adam``, ``train.g_adam`` and
``train.ema`` spans (CUDA events at their entry and exit): the two Adam
steps and the EMA update."""

from benchmark.harness import phases


def read(ctx):
    return phases.device_ms_per_step(phases.program_spans(), phases.GROUPS["optim"])

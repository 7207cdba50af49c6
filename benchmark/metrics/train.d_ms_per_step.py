"""``train.d_ms_per_step``: the device time per step, in the traced cycle,
of the program's ``train.d_grads`` span (CUDA events at its entry and
exit): the negatives, the instance noise, D's forwards and loss, R1 on
R1 steps and D's gradient."""

from benchmark.harness import phases


def read(ctx):
    return phases.device_ms_per_step(phases.program_spans(), phases.GROUPS["d"])

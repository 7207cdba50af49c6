"""``train.g_idle_ms_per_step``: device idle per step in the traced slice
while the host is inside the program's ``train.g_forward`` or
``train.g_grads`` span: the slice's idle gaps cut by the host intervals of
those spans, on the trace's own clock."""

from benchmark.harness import phases


def read(ctx):
    return phases.idle_ms_per_step(ctx.get("slice"), "g")

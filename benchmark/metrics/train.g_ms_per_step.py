"""``train.g_ms_per_step``: the device time per step, in the traced cycle,
of the program's ``train.g_forward`` and ``train.g_grads`` spans (CUDA
events at their entry and exit): G's forward, and G's loss through the
updated D, its regularizers, the interpolation penalty and its backward."""

from benchmark.harness import phases


def read(ctx):
    return phases.device_ms_per_step(phases.program_spans(), phases.GROUPS["g"])

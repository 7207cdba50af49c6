"""``sg3.filtered_lrelu_ms_per_step``: device time per step, in the traced
slice, of the filtered leaky ReLU's kernels (the program's
``csrc/filtered_lrelu.cu``, forward and backward), by their kernel names."""

import re

KERNELS = re.compile(r"\bflrelu_(forward|backward)\b")


def read(ctx):
    sl = ctx.get("slice")
    if sl is None:
        return None
    t = sl.time_of(lambda name: KERNELS.search(name) is not None)
    return 1e3 * t / ctx.slice_steps if t > 0 else None

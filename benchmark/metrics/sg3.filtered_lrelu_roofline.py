"""``sg3.filtered_lrelu_roofline``: the filtered leaky ReLU's (the
program's ``csrc/filtered_lrelu.cu``, forward and backward) share of its
roofline over one step's launches: per launch the larger of its bytes over
3.35 TB/s and its operations over the float32 peak
(``benchmark/harness/flops_sg3.py``), summed, over the launches'
CUDA-event time, replayed at their shapes behind a device spin."""


def read(ctx):
    f = ctx.get("filtered_lrelu")
    if not f or f["measured_s"] <= 0:
        return None
    return 100.0 * f["bound_s"] / f["measured_s"]

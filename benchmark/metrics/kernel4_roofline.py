"""``kernel4_roofline``: kernel 4's (``csrc/blur.cu``, forward and VJP) share
of its roofline over one step's launches: the bytes of each launch (each
input read once, each output written once) over 3.35 TB/s, summed, over
the launches' CUDA-event time, replayed at their shapes behind a device
spin."""


def read(ctx):
    b = ctx.get("blur4")
    if not b or b["measured_s"] <= 0:
        return None
    return 100.0 * b["bound_s"] / b["measured_s"]

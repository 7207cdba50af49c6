"""``render.ms_per_step``: device time per step, in the traced slice, of
the render's kernels (the program's ``csrc/raster.cu``, ``sampler.cu`` and
``scatter.cu``: kernels 1, 2 and 6), by their kernel names."""

import re

KERNELS = re.compile(r"\b(raster_bin|raster_ranks|raster_cover|raster_cover_wide|raster_resolve|"
                     r"sampler_kernel|scatter_bin|scatter_accumulate|scatter_accumulate_fixed)\b")


def read(ctx):
    sl = ctx.get("slice")
    if sl is None:
        return None
    t = sl.time_of(lambda name: KERNELS.search(name) is not None)
    return 1e3 * t / ctx.slice_steps if t > 0 else None

"""``train.cycle_images_per_s_median``: the median over the window's R1
cycles of each cycle's images per second (host clock, each cycle closed
by a synchronize).  A steadier reading beside ``train_images_per_s``: a
stall of a few cycles moves the window's rate, not this median."""

import statistics


def read(ctx):
    ends = ctx.get("cycle_ends")
    if not ends:
        return None
    per_cycle = ctx.images / len(ends)
    return statistics.median(per_cycle / (b - a) for a, b in zip([0.0] + ends[:-1], ends))

"""``train.cuda_mallocs_per_step``: the caching allocator's ``cudaMalloc``
calls (its ``segment.all.allocated`` count) across each of the traced
cycle's ``train.step`` spans, the program's own counter, mean per step."""

from benchmark.harness import phases


def read(ctx):
    return phases.mallocs_per_step(phases.program_spans())

"""``train.r1_step_ms``: the mean of CUDA-event spans around each R1 step
call of the window."""


def read(ctx):
    spans = (ctx.get("spans") or {}).get("train.r1_step")
    return sum(spans) / len(spans) if spans else None

"""``train.plain_step_ms``: the mean of CUDA-event spans around each step
call of the window that runs no R1."""


def read(ctx):
    spans = (ctx.get("spans") or {}).get("train.plain_step")
    return sum(spans) / len(spans) if spans else None

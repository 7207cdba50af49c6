"""The train step's phases, read from the program's own spans
(``gif_tpu_torch.utils.profiling.span``, recorded while the traced cycle
runs under the profiler).

Two readings, each a mean per step over the traced cycle's ``train.step``
spans:

- device time: the CUDA-event time of a group of phase spans, from the
  program's in-memory records (:func:`program_spans`);
- device idle by host phase: each idle gap of the traced slice (the
  window less the union of its device events) cut by the host intervals
  of the phase spans, which the slice holds as ``user_annotation`` host
  ops on the clock of its device events.  Idle under no phase span is
  the remainder: the caller's loop between steps, and the step's own few
  lines outside its phases.

A program without the spans (a CPU run, an untraced line, a version
before them) gives None.
"""

from __future__ import annotations

STEP = "train.step"
GROUPS = {
    "render": ("train.render",),
    "g": ("train.g_forward", "train.g_grads"),
    "d": ("train.d_grads",),
    "optim": ("train.d_adam", "train.g_adam", "train.ema"),
}


def program_spans() -> list:
    """The program's recorded spans; [] where it records none."""
    from gif_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return list(read()) if read is not None else []


def device_ms_per_step(spans: list, names) -> float | None:
    """The summed device time (ms) of the spans named in ``names`` over the
    number of ``train.step`` spans; None without steps or device times."""
    steps = [s for s in spans if s.name == STEP]
    picked = [s.device_ms for s in spans if s.name in names]
    if not steps or not picked or any(t is None for t in picked):
        return None
    return sum(picked) / len(steps)


def mallocs_per_step(spans: list) -> float | None:
    """The allocator's ``cudaMalloc`` calls per ``train.step`` span."""
    counts = [s.counters.get("cuda_mallocs") for s in spans if s.name == STEP]
    if not counts or any(c is None for c in counts):
        return None
    return sum(counts) / len(counts)


def _idle(sl) -> list:
    """The idle gaps of the slice: sorted disjoint (start, end) pairs."""
    gaps, prev = [], sl.start_us
    for s, e in sl.busy_intervals() + [(sl.end_us, sl.end_us)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    return gaps


def _overlap(a: list, b: list) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_us_by_phase(sl) -> dict | None:
    """Microseconds of device idle in the slice under each group's phase
    spans, under none (``remainder``), and the number of steps; None
    where the slice holds no ``train.step`` span.  An instant under two
    phase spans (which the program never nests) counts for the earlier."""
    if sl is None:
        return None
    group_of = {name: g for g, names in GROUPS.items() for name in names}
    steps = sum(1 for _, _, name in sl.host_ops if name == STEP)
    if not steps:
        return None
    phases, end = [], sl.start_us
    for s, e, name in sorted((s, e, n) for s, e, n in sl.host_ops if n in group_of):
        s, e = max(s, end, sl.start_us), min(e, sl.end_us)
        if e > s:
            phases.append((s, e, group_of[name]))
            end = e
    gaps = _idle(sl)
    out = {g: _overlap(gaps, [(s, e) for s, e, gg in phases if gg == g]) for g in GROUPS}
    out["remainder"] = sum(e - s for s, e in gaps) - sum(out.values())
    out["steps"] = steps
    return out


def idle_ms_per_step(sl, group: str) -> float | None:
    got = idle_us_by_phase(sl)
    return None if got is None else got[group] / 1e3 / got["steps"]

"""The numbers that decide ``correct`` in a training cell.

The program's first three steps (the window's own call and feed) are
followed by the reference.  Compared, each by its worst case:

- ``loss_gap``: the gap of each loss the first step reports (D's, G's, R1,
  the interpolation penalty), relative as :func:`loss_gap` says;
- ``grad_gap``: per leaf, the gap between the norms of the program's and
  the reference's first gradient, as Adam got it (the program's from its
  optimizer's state after one step: with beta1 = 0 the first moment is
  the gradient), over the larger of the reference leaf's norm and the
  median leaf's;
- ``change_gap``: the same of the parameters' change after the three
  steps, G's, D's and the EMA's, leaving out the leaves whose reference
  gradient is under a thousandth of the median leaf's (they move under
  Adam by round-off alone);
- ``grad_diff``: per leaf, the norm of the difference between the
  program's and the reference's first gradient, over the same
  denominator as ``grad_gap``.  The norms alone cannot see a step that
  takes half the batch (PERF.md): with random weights the rows' gradients
  share most of their direction, so the mean over half of them has about
  the norm of the mean over all, but not their direction;
- ``change_ratio``: per tree (G, D, the EMA), over the leaves
  ``change_gap`` keeps, ``|‖Δp‖ / ‖Δr‖ - 1|`` of the whole tree's change
  after the three steps.  Adam moves every element by about the learning
  rate, so this is the learning rate's and the EMA decay's own scale:
  round-off that flips a few elements of one small leaf (what
  ``change_gap`` reads) averages out over a tree, and a rate or a decay
  off by some tens of percent does not.
"""

from __future__ import annotations

import statistics

import torch

SMALL_GRADIENT = 1e-3


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def worst_diff(prog: dict, ref: dict) -> tuple[float, str]:
    """(worst gap, its leaf): ``‖p - r‖ / max(‖r‖, median ‖r‖)``."""
    rn = _norms(ref)
    dn = _norms({k: prog[k].double() - ref[k].double() for k in ref})
    med = statistics.median(rn.values())
    worst, leaf = 0.0, ""
    for k in rn:
        gap = dn[k] / max(rn[k], med, 1e-30)
        if not gap <= worst:
            worst, leaf = gap, k
    return worst, leaf


def worst_leaf(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """(worst gap, its leaf): ``|‖p‖ - ‖r‖| / max(‖r‖, median ‖r‖)`` over
    the leaves in ``keep`` (all when None)."""
    pn, rn = _norms(prog), _norms(ref)
    names = [k for k in rn if keep is None or k in keep]
    med = statistics.median(rn[k] for k in names)
    worst, leaf = 0.0, ""
    for k in names:
        gap = abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30)
        if not gap <= worst:  # NaN wins
            worst, leaf = gap, k
    return worst, leaf


def moved_leaves(ref_grads: dict) -> set:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    rn = _norms(ref_grads)
    med = statistics.median(rn.values())
    return {k for k, v in rn.items() if v >= SMALL_GRADIENT * med}


def tree_ratio(prog: dict, ref: dict, keep) -> float:
    """``|‖p‖ / ‖r‖ - 1|`` of the leaves in ``keep``, taken as one vector."""
    p = sum(float(torch.sum(prog[k].double() ** 2)) for k in keep)
    r = sum(float(torch.sum(ref[k].double() ** 2)) for k in keep)
    return abs((p / max(r, 1e-300)) ** 0.5 - 1.0)


def loss_gap(prog: list, ref: list, steps: int = 1) -> tuple[float, str]:
    """Worst gap of a reported loss over the first ``steps`` steps: D's and
    G's losses and the interpolation penalty against the larger of the
    reference's value and the median of those values (a loss near 0 is
    held to the scale of the others); R1, a positive sum of squares,
    against its own value where the reference's is not 0.  The cells
    compare the first step's: the later steps' losses swing with the
    round-off of Adam's first updates (PERF.md)."""
    keys = ("d_loss", "g_loss", "interp")
    ref, prog = ref[:steps], prog[:steps]
    scale = statistics.median(abs(r[k]) for r in ref for k in keys if k in r)
    worst, what = 0.0, ""
    for i, (p, r) in enumerate(zip(prog, ref)):
        for k in keys + ("r1",):
            if k not in r or (k == "r1" and r[k] == 0.0):
                continue
            den = abs(r[k]) if k == "r1" else max(abs(r[k]), scale)
            gap = abs(p[k] - r[k]) / max(den, 1e-30)
            if not gap <= worst:
                worst, what = gap, f"step {i + 1} {k}"
    return worst, what


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` each hold ``losses`` (three dicts), ``grads``
    (``{"g": {leaf: tensor}, "d": {...}}`` of the first step) and
    ``change`` (``{"g": ..., "d": ..., "ema": ...}`` after three steps);
    ``ref`` holds the gradients the leaf rule reads.  Returns ``{name:
    (value, where)}``."""
    out = {"loss_gap": loss_gap(prog["losses"], ref["losses"])}
    grad = [worst_leaf(prog["grads"][n], ref["grads"][n]) + (n,) for n in ("g", "d")]
    g = max(grad, key=lambda t: (t[0] != t[0], t[0]))
    out["grad_gap"] = (g[0], f"{g[2]} {g[1]}")
    diff = [worst_diff(prog["grads"][n], ref["grads"][n]) + (n,) for n in ("g", "d")]
    g = max(diff, key=lambda t: (t[0] != t[0], t[0]))
    out["grad_diff"] = (g[0], f"{g[2]} {g[1]}")
    keep = {"g": moved_leaves(ref["grads"]["g"]), "d": moved_leaves(ref["grads"]["d"])}
    keep["ema"] = keep["g"]
    change = [worst_leaf(prog["change"][n], ref["change"][n], keep[n]) + (n,) for n in ("g", "d", "ema")]
    c = max(change, key=lambda t: (t[0] != t[0], t[0]))
    out["change_gap"] = (c[0], f"{c[2]} {c[1]}")
    ratio = [(tree_ratio(prog["change"][n], ref["change"][n], keep[n]), n) for n in ("g", "d", "ema")]
    out["change_ratio"] = max(ratio, key=lambda t: (t[0] != t[0], t[0]))
    return out


def checks(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, ``{name: {"value", "limit", "where"}}``): correct when
    every number is finite and at most its limit."""
    out, ok = {}, True
    for name, (value, where) in numbers.items():
        limit = limits[name]
        passed = value == value and value <= limit
        ok = ok and passed
        out[name] = {"value": value, "limit": limit, "where": where}
    return ok, out

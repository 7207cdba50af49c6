"""Architecture reports: parameter counts by module path and a table of
the module hierarchy (port of :mod:`gif_tpu.utils.graph`).

The reference drew a call graph of its modules at train start; here
:func:`draw` runs one forward with hooks on every module down to a depth
and tabulates each call — module path, class, output shapes, parameters —
into a text report and an HTML twin, and :func:`param_summary` counts the
parameters by top-level module path (the port's module names follow the
flax tree, so the counts equal the JAX package's for the same config).
"""

from __future__ import annotations

import html
import os

import torch


def param_summary(module: torch.nn.Module, max_depth: int = 2) -> dict:
    """Parameter counts aggregated by the first ``max_depth`` parts of
    each parameter's path (joined by ``/``), plus ``TOTAL``."""
    counts: dict = {}
    total = 0
    for name, p in module.named_parameters():
        key = "/".join(name.split(".")[:max_depth])
        counts[key] = counts.get(key, 0) + p.numel()
        total += p.numel()
    counts["TOTAL"] = total
    return counts


def _shapes(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(tuple(x.shape))
    if isinstance(x, (list, tuple)):
        return "[" + ", ".join(_shapes(v) for v in x) + "]"
    if isinstance(x, dict):
        return "{" + ", ".join(f"{k}: {_shapes(v)}" for k, v in x.items()) + "}"
    return type(x).__name__


def draw(module: torch.nn.Module, out_path: str, *args, depth: int = 3, **kwargs) -> str:
    """Write a text table (``out_path``) and an HTML twin (same name,
    ``.html``) of ``module``'s calls during one forward on the example
    inputs ``*args`` / ``**kwargs`` (a batch of 1 does), down to
    ``depth`` levels below the module: path, class, output shapes, the
    parameters the module holds (its children's included).  Returns
    ``out_path``."""
    rows = []
    hooks = []
    for name, sub in module.named_modules():
        level = 0 if not name else name.count(".") + 1
        if level > depth:
            continue

        def enter(mod, _inputs, name=name):
            # A row per call, in call order (callers before their callees);
            # its output shapes are filled in when the call returns.
            open_rows.append(len(rows))
            rows.append([name or "(root)", type(mod).__name__, "", sum(p.numel() for p in mod.parameters())])

        def leave(_mod, _inputs, output):
            rows[open_rows.pop()][2] = _shapes(output)

        hooks += [sub.register_forward_pre_hook(enter), sub.register_forward_hook(leave)]
    open_rows = []
    try:
        with torch.no_grad():
            module(*args, **kwargs)
    finally:
        for h in hooks:
            h.remove()
    head = ("path", "module", "outputs", "params")
    widths = [max(len(str(r[i])) for r in rows + [list(head)]) for i in range(4)]
    lines = [f"{type(module).__name__}: {sum(p.numel() for p in module.parameters()):,} parameters", ""]
    for r in [head] + rows:
        lines.append("  ".join(str(v).ljust(w) for v, w in zip(r, widths)).rstrip())
    table = "\n".join(lines) + "\n"
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(table)
    with open(os.path.splitext(out_path)[0] + ".html", "w") as f:
        f.write("<html><body><pre style='font-family:monospace'>" + html.escape(table) + "</pre></body></html>")
    return out_path

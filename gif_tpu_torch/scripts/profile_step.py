"""Profile the bench train step op by op on the card (port of
``scripts/profile_step.py``).

Records a ``torch.profiler`` trace of a few steps of the bench
configuration (``gif_tpu_torch.bench.bench_setup``: run_id 8 with R1 every
step, or run_id 0 with its own cadence) after one warm-up step, writes it
as a Chrome trace, and prints the per-step device time, the device's busy
share (the union of the kernels', copies' and memsets' intervals over the
synchronized host-clock window) and the top device ops.

    python -m gif_tpu_torch.scripts.profile_step [--run_id 8] [--out_dir DIR]
    python -m gif_tpu_torch.scripts.profile_step --parse_only DIR [--n_steps 3]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time

# Chrome-trace categories of device work (torch.profiler's export).
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def run(out_dir: str, n_steps: int = 3, run_id: int = 8, device=None, tiny: bool = False) -> float:
    """Warm up, then trace ``n_steps`` steps into ``out_dir/trace.json``;
    returns the window's synchronized host-clock milliseconds."""
    import torch

    from gif_tpu_torch.bench import bench_setup
    from gif_tpu_torch.utils.profiling import force_ready, trace

    cfg, state, step_fn, step_rng, data = bench_setup(run_id, device, tiny)
    dev = data["flame"].device
    step_rng.manual_seed(1)
    state, m = step_fn(state, data)  # warm-up: builds, JIT, cuDNN's first calls
    force_ready(m)
    with trace(out_dir, device=dev.type):
        t0 = time.perf_counter()
        for i in range(n_steps):
            step_rng.manual_seed(2 + i)
            state, m = step_fn(state, data)
        force_ready(m)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    with open(os.path.join(out_dir, "window.json"), "w") as f:
        json.dump({"wall_ms": wall_ms, "n_steps": n_steps, "run_id": run_id}, f)
    return wall_ms


def parse(out_dir: str, n_steps: int | None = None, top: int = 40) -> dict:
    """Per-step device time and busy share of ``out_dir``'s trace, and its
    top device ops by time; printed, and returned as a dict."""
    with open(os.path.join(out_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    with open(os.path.join(out_dir, "window.json")) as f:
        window = json.load(f)
    n_steps = n_steps or window["n_steps"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and "dur" in e]
    by_op, by_cat = collections.Counter(), collections.Counter()
    busy, end = 0.0, float("-inf")
    for e in sorted(dev, key=lambda e: e["ts"]):
        by_op[e["name"]] += e["dur"] / 1e3 / n_steps
        by_cat[e["cat"]] += e["dur"] / 1e3 / n_steps
        s, t = e["ts"], e["ts"] + e["dur"]
        if t > end:
            busy += t - max(s, end)
            end = t
    busy_ms = busy / 1e3
    out = {"n_steps": n_steps, "wall_ms_per_step": window["wall_ms"] / n_steps,
           "device_ms_per_step": sum(by_cat.values()), "busy_ms_per_step": busy_ms / n_steps,
           "busy_share": busy_ms / window["wall_ms"] if window["wall_ms"] else float("nan"),
           "device_ops_per_step": len(dev) / n_steps,
           "top_ops": [(name, ms) for name, ms in by_op.most_common(top)]}
    print(f"\n=== per step: {out['wall_ms_per_step']:.2f} ms host clock, device busy "
          f"{out['busy_ms_per_step']:.2f} ms ({100 * out['busy_share']:.1f}%: the union of the device ops' "
          f"intervals), {out['device_ms_per_step']:.2f} ms summed over {out['device_ops_per_step']:.0f} device ops ===")
    print("\n--- by category ---")
    for cat, ms in by_cat.most_common():
        print(f"{ms:9.3f} ms  {cat}")
    print(f"\n--- top {top} device ops ---")
    for name, ms in out["top_ops"]:
        print(f"{ms:9.3f} ms  {name[:140]}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run_id", type=int, default=8)
    ap.add_argument("--out_dir", default="runs/profile_step")
    ap.add_argument("--n_steps", type=int, default=3)
    ap.add_argument("--parse_only", default=None, metavar="DIR", help="parse an earlier trace directory")
    ap.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="32 px / 16 channels, 503-vertex mesh (CPU smoke runs)")
    a = ap.parse_args(argv)
    if a.parse_only:
        return parse(a.parse_only, a.n_steps)
    run(a.out_dir, a.n_steps, a.run_id, a.device, a.tiny)
    return parse(a.out_dir, a.n_steps)


if __name__ == "__main__":
    main()

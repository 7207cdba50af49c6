"""Renderer-numerics sensitivity: does the rasterizer backend move training?

Runs the training CLI (``python -m gif_tpu_torch.train``) three times: with
the plain rasterizer and with kernel 1 from one seed, and with the plain
rasterizer from the next seed (the control).  Each arm sets
``GIF_TPU_TORCH_RASTER`` for its child process
(:func:`gif_tpu_torch.render.raster_cuda.raster_backend`).  The claim it
tests: the divergence between the backends lies at or below seed-level
noise.  Every arm trains with ``--deterministic``, as a TPU step is by
construction: otherwise the card's nondeterminism (atomics in cuDNN's and
``index_add_``'s backward) drives two runs from one seed as far apart as
two seeds within a few dozen steps, and the comparison measures that
instead of the rasterizer.  Kernel 1 equals the plain rasterizer bit for
bit, so on the card the two seed-s arms should agree exactly.  Kernel 1
has no CPU mode: under ``--device cpu`` the kernel arm takes the default
route (the plain rasterizer on CPU tensors), and its divergence is 0.

  python -m gif_tpu_torch.scripts.raster_sensitivity --iters 300 --out_dir rsens
  python -m gif_tpu_torch.scripts.raster_sensitivity --iters 2 --log_every 1 --debug --device cpu

A completed arm (as many logged rows as ``--iters // --log_every``) is
reused.  Writes ``raster_sensitivity.json`` into ``--out_dir``:
``divergence`` (mean |plain - cuda| over the logged d and g losses),
``noise_floor`` (mean |plain(seed) - plain(seed + 1)|), ``iters``,
``rows`` and ``ratio`` = divergence / noise_floor.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def read_losses(path: str) -> list:
    """(d_loss, g_loss) of every row of a ``metrics.csv``."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return [(float(r["d_loss"]), float(r["g_loss"])) for r in rows]


def mean_abs_diff(a, b) -> float:
    """Mean |a - b| over the d and g losses of the rows both have."""
    n = min(len(a), len(b))
    if n == 0:
        raise SystemExit("no logged rows — lower --log_every or raise --iters")
    return sum(abs(x[0] - y[0]) + abs(x[1] - y[1]) for x, y in zip(a[:n], b[:n])) / (2 * n)


def train_command(args, out: str, seed: int) -> list:
    """The training CLI's command line for one arm."""
    cmd = [
        sys.executable, "-m", "gif_tpu_torch.train",
        "--run_id", str(args.run_id),
        "--total_iters", str(args.iters),
        "--out_dir", out,
        "--seed", str(seed),
        "--log_every", str(args.log_every),
        "--no_mesh",
        "--device", args.device,
        "--deterministic",
    ]
    if args.debug:
        cmd.append("--debug")
    return cmd


def run_arm(tag: str, backend: str, seed: int, args) -> str:
    """Train one arm in a child process (unless a completed one is there);
    its ``metrics.csv``."""
    out = os.path.join(args.out_dir, tag)
    metrics = os.path.join(out, str(args.run_id), "metrics.csv")
    if os.path.exists(metrics) and len(read_losses(metrics)) >= args.iters // args.log_every:
        print(f"[{tag}] complete, skipping")
        return metrics
    if os.path.exists(out):
        # A partial arm restarts clean: metrics.csv appends, and repeated
        # early rows would misalign the row-wise comparison.
        shutil.rmtree(out)
    print(f"[{tag}] backend={backend} seed={seed}")
    # cuBLAS reads its workspace setting once, when the child creates its
    # handle: the deterministic mode needs it set before the start.
    env = dict(os.environ, GIF_TPU_TORCH_RASTER=backend, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    rc = subprocess.run(train_command(args, out, seed), env=env, cwd=_REPO).returncode
    if rc != 0:
        raise SystemExit(f"arm {tag} exited with {rc}")
    return metrics


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--run_id", type=int, default=8)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--out_dir", default="raster_sensitivity")
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--max_ratio", type=float, default=None, help="fail if divergence/noise_floor exceeds this")
    p.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from gif_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    # The arms run from the repository root: their paths must not depend
    # on this process's working directory.
    args.device, args.out_dir = str(device), os.path.abspath(args.out_dir)
    os.makedirs(args.out_dir, exist_ok=True)
    kernel = "cuda" if device.type == "cuda" else "auto"
    a = read_losses(run_arm("plain", "plain", args.seed, args))
    b = read_losses(run_arm("cuda", kernel, args.seed, args))
    c = read_losses(run_arm("plain_reseed", "plain", args.seed + 1, args))

    result = {
        "divergence": mean_abs_diff(a, b),
        "noise_floor": mean_abs_diff(a, c),
        "iters": args.iters,
        "rows": min(len(a), len(b), len(c)),
    }
    result["ratio"] = result["divergence"] / result["noise_floor"] if result["noise_floor"] > 0 else float("inf")
    out = os.path.join(args.out_dir, "raster_sensitivity.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    if args.max_ratio is not None and result["ratio"] > args.max_ratio:
        raise SystemExit(
            f"raster-backend divergence {result['divergence']:.4f} exceeds "
            f"{args.max_ratio}x the seed noise floor {result['noise_floor']:.4f}"
        )
    return result


if __name__ == "__main__":
    main()

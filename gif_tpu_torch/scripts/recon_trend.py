"""EMA and live-G reconstruction trend over a training run's checkpoints.

For the fresh state (step 0) and every saved checkpoint step of
``<out_dir>/<run_id>/checkpoint``, restore the state and compute the
generator's pixel reconstruction MSE (in [-1, 1]) against the ground truth
of the first ``--k`` rows of the conditionally exact synthetic render
dataset: the offline form of the loop's ``ema_recon`` column, for runs
recorded without it.  A falling EMA curve shows that training improves the
model, independently of the FID harness.  Writes
``<out_dir>/<run_id>/recon_trend.json``:

  python -m gif_tpu_torch.scripts.recon_trend --out_dir runs/longitudinal_r05 \
      --run_id 8 --synthetic_n 8192
"""

from __future__ import annotations

import argparse
import json
import os

from gif_tpu_torch.scripts.generate_random_samples import TINY_HELP


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--run_id", type=int, default=8)
    ap.add_argument("--synthetic_n", type=int, default=8192)
    ap.add_argument("--k", type=int, default=64, help="probe rows")
    ap.add_argument("--seed", type=int, default=None, help="state-init seed (default: run_id, the CLI's)")
    ap.add_argument("--tiny", action="store_true", help=TINY_HELP)
    ap.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from gif_tpu_torch.data.pipeline import SyntheticRenderDataset
    from gif_tpu_torch.device import resolve_device
    from gif_tpu_torch.eval.sampling import FlameSampler
    from gif_tpu_torch.flame.resources import load_flame_resources
    from gif_tpu_torch.train.checkpoint import CheckpointManager
    from gif_tpu_torch.train.config import TINY_OVERRIDES, get_config
    from gif_tpu_torch.train.state import create_train_state

    device = resolve_device(args.device)
    tiny = TINY_OVERRIDES if args.tiny else {}
    res = load_flame_resources(None)
    ds = SyntheticRenderDataset(res, n=args.synthetic_n, size=tiny.get("max_size", 256), device=device)
    cfg = get_config(args.run_id, batch_size=16, embedding_vocab_size=len(ds), **tiny)
    seed = cfg.run_id if args.seed is None else args.seed
    state = create_train_state(cfg, seed=seed, device=device)

    run_dir = os.path.join(args.out_dir, str(cfg.run_id))
    mgr = CheckpointManager(os.path.join(run_dir, "checkpoint"))
    steps = mgr.all_steps()

    k = min(args.k, len(ds))
    gt = (ds.images[:k].astype(np.float32) / 255.0) * 2.0 - 1.0
    flame = np.asarray(ds.flame_params[:k], np.float32)
    idx = np.arange(k, dtype=np.int32)

    def mse(generator) -> float:
        s = FlameSampler(cfg, res, generator, batch_size=16, eye_center=False, device=device)
        return float(np.mean((s.sample(flame, idx)[0] - gt) ** 2))

    rows = [{"step": 0, "ema_recon": mse(state.g_ema), "live_recon": mse(state.generator)}]
    for s in steps:
        mgr.restore(state, step=s)
        rows.append({"step": s, "ema_recon": mse(state.g_ema), "live_recon": mse(state.generator)})

    print(f"{'step':>6}  {'ema_recon':>10}  {'live_recon':>10}")
    for r in rows:
        print(f"{r['step']:>6}  {r['ema_recon']:>10.5f}  {r['live_recon']:>10.5f}")
    out = os.path.join(run_dir, "recon_trend.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()

"""MFU / FLOP accounting report (port of ``scripts/mfu_report.py``).

Prints, for the bench train step (``gif_tpu_torch.bench.bench_setup``:
run_id 8 with R1 every step, or another preset) and a bare generator
forward at the same configuration:

- the FLOPs PyTorch's counter sees in one call
  (``gif_tpu_torch.utils.flops.compiled_flops``: matmuls and convolutions,
  forward, backward and R1's double backward — the number the bench's
  ``mfu`` key uses);
- the analytic conv count of the generator forward
  (``analytic_generator_forward_flops``) as the cross-check;
- MFU at a measured images/s (``--imgs_per_sec``, from the bench's line)
  against the card's data-sheet bf16 peak.

    python -m gif_tpu_torch.scripts.mfu_report [--run_id 8] [--imgs_per_sec 100.0]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run_id", type=int, default=8)
    ap.add_argument("--imgs_per_sec", type=float, default=None)
    ap.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="32 px / 16 channels, 503-vertex mesh (CPU smoke runs)")
    a = ap.parse_args(argv)

    import torch

    from gif_tpu_torch.bench import bench_setup
    from gif_tpu_torch.utils.flops import analytic_generator_forward_flops, compiled_flops, device_peak_flops

    cfg, state, step_fn, step_rng, data = bench_setup(a.run_id, a.device, a.tiny)
    dev, batch = data["flame"].device, cfg.batch_size
    step_rng.manual_seed(1)
    step_flops = compiled_flops(step_fn, state, data)

    # A bare generator forward, as inside the step (random condition maps).
    cond = torch.zeros((batch, cfg.max_size, cfg.max_size, cfg.cond_channels), device=dev)
    with torch.no_grad():
        g_flops = compiled_flops(state.generator, cond, input_indices=data["indices"], step=cfg.max_step)
    g_analytic = analytic_generator_forward_flops(cfg, batch)

    peak = device_peak_flops(dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = {"device": name, "peak_flops_bf16": peak, "run_id": cfg.run_id, "batch": batch,
           "step_flops": step_flops, "g_forward_flops": g_flops, "g_forward_analytic": g_analytic,
           "g_counted_over_analytic": g_flops / g_analytic if g_flops else None,
           "step_over_g_forward": step_flops / g_flops if step_flops and g_flops else None}
    peak_s = f"{peak / 1e12:.1f} TFLOP/s (data sheet)" if peak else "unknown"
    print(f"device: {name}  peak (bf16, dense): {peak_s}")
    print(f"run_id {cfg.run_id} train step, batch {batch} (counted): "
          f"{step_flops / 1e12 if step_flops else float('nan'):.4f} TFLOP")
    print(f"generator fwd (counted):  {g_flops / 1e12 if g_flops else float('nan'):.4f} TFLOP")
    print(f"generator fwd (analytic): {g_analytic / 1e12:.4f} TFLOP")
    if out["g_counted_over_analytic"]:
        print(f"cross-check counted/analytic: {out['g_counted_over_analytic']:.3f}x")
    if out["step_over_g_forward"]:
        print(f"step/g_fwd ratio: {out['step_over_g_forward']:.2f}x")
    if a.imgs_per_sec and step_flops and peak:
        out["mfu"] = step_flops * (a.imgs_per_sec / batch) / peak
        print(f"MFU @ {a.imgs_per_sec} imgs/s: {100 * out['mfu']:.2f}%")
    if step_flops is None:
        raise SystemExit("the FLOP counter saw no dense product in the step")
    return out


if __name__ == "__main__":
    main()

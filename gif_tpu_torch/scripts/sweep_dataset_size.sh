#!/bin/bash
# Sweep the synthetic dataset size of a run_id-8 run, everything else
# identical: with few images D memorizes the set within a few hundred
# steps (d_loss collapsing, g_loss spiking) and the EMA generator's FID
# worsens; more images should delay it.
#
#   bash gif_tpu_torch/scripts/sweep_dataset_size.sh
#
# Extra arguments go to the trainer (e.g. --device cpu).
set -u
cd "$(dirname "$0")/../.."
for n in 256 2048 8192; do
  out=runs/sweep_r05/n$n
  mkdir -p "$out"
  echo "=== arm n=$n ==="
  timeout 3600 python -m gif_tpu_torch.train --run_id 8 --synthetic_images renders \
    --synthetic_n "$n" --inception_weights random --out_dir "$out" \
    --total_iters 2000 --fid_every 250 --checkpoint_every 2000 \
    --log_every 10 --fid_n_samples 2000 --fid_real_samples 8192 "$@" \
    >"$out/launch.log" 2>&1
  echo "arm n=$n rc=$?"
done
echo SWEEP DONE

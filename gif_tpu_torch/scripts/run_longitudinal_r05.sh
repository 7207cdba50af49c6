#!/bin/bash
# A long run_id-8 training run on synthetic renders with a liveness
# watchdog: poll metrics.csv, and if it stops advancing for WATCHDOG
# seconds, kill the trainer by pid (never by pattern) and relaunch.
# Training resumes from the newest checkpoint and the synthetic dataset
# comes from its disk cache, so a retry costs minutes, not the run.
#
#   OUT=runs/longitudinal_r05 TOTAL=2500 bash gif_tpu_torch/scripts/run_longitudinal_r05.sh
#
# Extra arguments go to the trainer (e.g. --device cpu).
set -u
cd "$(dirname "$0")/../.."
OUT=${OUT:-runs/longitudinal_r05}
TOTAL=${TOTAL:-2500}
R1W=${R1W:-50.0}
DNOISE=${DNOISE:-0}
WATCHDOG=${WATCHDOG:-2100}   # > one FID eval + slack
FIRST=${FIRST:-2700}         # cold start: kernel builds + dataset render
mkdir -p "$OUT"
PIDFILE="$OUT/trainer.pid"
for attempt in 1 2 3 4; do
  echo "=== attempt $attempt $(date -u +%H:%M:%S) ===" >> "$OUT/launch.log"
  python -m gif_tpu_torch.train --run_id 8 --synthetic_images renders --synthetic_n 8192 \
    --inception_weights random --out_dir "$OUT" --total_iters "$TOTAL" \
    --fid_every 250 --checkpoint_every 500 --log_every 10 \
    --fid_n_samples 2000 --fid_real_samples 8192 --r1_weight "$R1W" \
    --d_input_noise "$DNOISE" "$@" \
    >> "$OUT/launch.log" 2>&1 &
  pid=$!
  echo "$pid" > "$PIDFILE"
  deadline=$FIRST
  while kill -0 "$pid" 2>/dev/null; do
    sleep 60
    m="$OUT/8/metrics.csv"
    if [ -f "$m" ]; then
      age=$(( $(date +%s) - $(stat -c %Y "$m") ))
      deadline=$WATCHDOG
    else
      age=$(( $(date +%s) - $(stat -c %Y "$PIDFILE") ))
    fi
    if [ "$age" -gt "$deadline" ]; then
      echo "WATCHDOG: no progress for ${age}s, killing $pid" >> "$OUT/launch.log"
      kill -9 "$pid" 2>/dev/null
      sleep 5
      break
    fi
  done
  wait "$pid"; rc=$?
  echo "attempt $attempt rc=$rc" >> "$OUT/launch.log"
  # 0 = completed; anything else (watchdog kill, crash) retries.
  [ "$rc" -eq 0 ] && break
done
echo "LONGITUDINAL DONE"

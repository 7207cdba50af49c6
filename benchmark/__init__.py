"""The benchmark of gif_tpu_torch on an NVIDIA GPU:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root of the checkout names the cells; each
configuration, traffic mix, limit set and per-layer metric is a file of
its own under ``benchmark/``, found by its name."""

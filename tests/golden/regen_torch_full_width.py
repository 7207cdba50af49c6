"""Regenerate tests/golden/torch_full_width.npz: the JAX package's outputs of
the port's full-width parity cases, summarised
(:mod:`gif_tpu_torch.tools.full_width_goldens`).

Run on CPU from the repository root (the test platform pinned by
tests/conftest.py; ~36 min on 8 cores, most of it the six train steps
and the two bf16 steps' f32 twins; each step holds 12-19 GB):

    JAX_PLATFORMS=cpu python tests/golden/regen_torch_full_width.py

Regenerate ONLY when an intentional numerical change lands in ``gif_tpu``
(FLAME decode, renderer, generator, discriminator, losses or the train
step), or when the cases, their inputs, the weight rule or the summary
change, and record why in the commit message.  Two runs write bit-equal
files.  ``tests/test_torch_full_width.py`` holds the port on the CPU to
this file, and ``chip_smoke.py`` (phase 23) the port on the card.
"""

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(os.path.dirname(HERE)), os.path.dirname(HERE)]

import numpy as np  # noqa: E402

OUT = os.path.join(HERE, "torch_full_width.npz")


def reference_entries(cases, step_cases) -> dict:
    """The golden entries of ``cases`` and ``step_cases``, from ``gif_tpu``
    on the CPU."""
    from gif_tpu.flame.resources import synthetic_flame_resources

    import full_width_jax as fj
    from gif_tpu_torch.tools import full_width_goldens as fw

    res = synthetic_flame_resources()
    n_texels = len(res.texture_x_coords)
    render = fj.jax_outputs("render", res, fw.inputs("render"))
    entries = {}
    for case in cases:
        out = render if case == "render" else fj.jax_outputs(case, res, fw.inputs(case, n_texels), render["cond"])
        entries.update(fw.golden_entries(case, out))
        print(f"{case}: {sorted(out)}", flush=True)
    for case in step_cases:
        out, draws = fj.jax_step_outputs(case, res, fw.inputs(case))
        entries.update(fw.golden_entries(case, out))
        for k, v in draws.items():
            entries[f"{case}/draws/{k}"] = np.asarray(v)
        print(f"{case}: metrics {dict(zip(fw.step_metrics(case), out['metrics'].tolist()))}", flush=True)
        if case in fw.BF16_STEP_CASES:
            # gif_tpu's own bf16-vs-f32 distance: the same step in f32, its
            # distance from the bf16 run (relative to the bf16 values, as
            # the port's error is taken).
            twin, _ = fj.jax_step_outputs(case, res, fw.inputs(case), compute_dtype="float32")
            dist = fw.distances(twin, out)
            entries.update(fw.bf16_entries(case, dist))
            print(f"{case}: gif_tpu bf16 vs f32: " + ", ".join(
                f"{k} {v[1]:.3g}" for k, v in dist.items()), flush=True)
    return entries


def main(argv=None):
    from gif_tpu_torch.tools import full_width_goldens as fw

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=OUT)
    a = p.parse_args(argv)
    fw.write_npz(a.out, reference_entries(fw.CASES, fw.STEP_CASES))
    print(f"{a.out}: {os.path.getsize(a.out)} bytes")


if __name__ == "__main__":
    main()

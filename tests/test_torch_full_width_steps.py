"""Port parity at full width on the CPU, the slow part (``-m slow``): D,
the serving path as a whole and one train step of each preset, every case
live against ``gif_tpu`` on the same numpy-seeded inputs and rule-made
weights (:mod:`gif_tpu_torch.tools.full_width_goldens` states the cases
and bars; ``tests/test_torch_full_width.py`` holds the port's D and
sampler to ``gif_tpu``'s golden in Tier-1).

- D's scores of a real and a fake batch, the non-saturating loss and its
  first-order parameter gradient (per tensor, relative L2 1e-3), batch 2;
- ``FlameSampler.sample`` (eye-centring, render, G) at 256 px, 512
  channels, batch 2 — against ``gif_tpu/eval/sampling.py``'s;
- one run_id-8 step with R1 (``r1_interval`` 1), and one fused run_id-0
  step with the interpolation loss and R1, on 4 rows (minibatch stddev's
  groups of 4, as in training), both from
  rule-made f32 states with JAX's draws injected: the metrics (d_loss,
  g_loss, R1, g_total, interp), G's and D's gradients (Adam's first
  moments), the updated G and D by the tiny tests' delta rule over each
  whole tree (mean |error| <= 1e-2 mean |update|), and the G EMA (the EMA
  of the port's own updated G, rtol 1e-6, and JAX's EMA step where it is
  32 float spacings or more, by the same rule).  The gradients and the
  metrics are held looser than at the tiny size
  (``full_width_goldens._STEP_GRAD``): at full width they pass through
  D's input gradient, whose float32 noise floor is ~4e-4 in relative L2
  (``test_d_input_gradient_noise_floor``), and G's are taken at a D that
  Adam's first step moved apart wherever a near-zero gradient flipped sign.

Each JAX step compiles and runs for minutes on the CPU; ``chip_smoke.py``
phase 23 runs the same cases on the card against the golden every run."""

import numpy as np
import pytest

import full_width_jax as fj
from gif_tpu.flame.resources import synthetic_flame_resources as j_synth
from gif_tpu_torch.flame.resources import synthetic_flame_resources
from gif_tpu_torch.tools import full_width_goldens as fw
from torch_port_common import cpu_threads

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def resources():
    return j_synth(), synthetic_flame_resources()


def _hold(case, want, got):
    failed = []
    for out_name in sorted(want):
        bar = fw.BARS[(case, out_name)]
        if isinstance(want[out_name], dict):
            held = fw.held_tensors(out_name)
            a, r, ok, worst = fw.check_tree(got[out_name], want[out_name], bar, held)
            what = "rel L2 over all tensors" if bar.kind == "tree_l2" else "rel L2 of the worst tensor"
            print(f"{case}/{out_name}: max abs {a:.3g}, {what} {r:.3g} (worst tensor {worst}; bar {bar.text()})")
        else:
            a, r, ok = fw.check(got[out_name], want[out_name], bar)
            print(f"{case}/{out_name}: max abs {a:.3g}, rel L2 / flips {r:.3g} (bar {bar.text()})")
        if not ok:
            failed.append(out_name)
    assert not failed, failed


@pytest.mark.parametrize("case", ["d", "sampler"])
def test_forward_case_matches_jax(resources, case):
    res_j, res_t = resources
    inp = fw.inputs(case)
    cond = fj.jax_outputs("render", res_j, fw.inputs("render"))["cond"] if case == "d" else None
    want = fj.jax_outputs(case, res_j, inp, cond)
    with cpu_threads(4):
        got = fw.port_outputs(case, res_t, "cpu", inp, cond)
    _hold(case, want, got)


def _delta_rule(got: dict, want: dict, what: str, bar: float = 1e-2) -> None:
    """tests/test_torch_train.py's rule on the updates, over the whole
    tree: one sign flip in a 128-entry bias vector already breaks it for
    that tensor alone (``full_width_goldens._UPDATE``)."""
    err = sum(np.abs(got[n] - dj).sum() for n, dj in want.items())
    ref = sum(np.abs(dj).sum() for dj in want.values())
    flips = sum(int((np.sign(got[n]) != np.sign(dj)).sum()) for n, dj in want.items())
    size = sum(dj.size for dj in want.values())
    print(f"{what} update: mean |error| / mean |update| {err / ref:.3g} (bar {bar:g}); sign flips {flips} of {size}")
    assert err <= bar * ref, what


def _ema_rule(got: dict, want: dict, old_ema: dict) -> None:
    """JAX's EMA step where it is at least 32 float spacings of the old
    value (``torch_port_common.check_step_update``), by the delta rule over
    the whole tree."""
    err = ref = 0.0
    for n, dj in want.items():
        held = np.abs(dj) >= 32 * np.spacing(np.abs(old_ema[n]))
        err += np.abs(got[n] - dj)[held].sum()
        ref += np.abs(dj[held]).sum()
    print(f"g_ema update: mean |error| / mean |update| {err / ref:.3g} (bar 0.01) where held")
    assert err <= 1e-2 * ref


@pytest.mark.parametrize("case", fw.STEP_CASES)
def test_train_step_matches_jax(resources, case):
    from gif_tpu_torch.tools.seeded_params import seeded_generator_state

    res_j, res_t = resources
    inp = fw.inputs(case)
    want, draws = fj.jax_step_outputs(case, res_j, inp)
    with cpu_threads(4):
        got = fw.port_step_outputs(case, res_t, "cpu", inp, draws)
    print(f"{case}: metrics {dict(zip(fw.STEP_METRICS, got['metrics'].tolist()))} (JAX "
          f"{dict(zip(fw.STEP_METRICS, want['metrics'].tolist()))})")
    assert got["metrics"][2] > 0 and (got["metrics"][4] > 0) == (case == "step0")
    _hold(case, want, got)
    _delta_rule(got["g_delta"], want["g_delta"], "generator")
    _delta_rule(got["d_delta"], want["d_delta"], "discriminator")
    cfg = fw.step_config(case)
    old = {k: v.numpy() for k, v in seeded_generator_state(cfg, fw.WEIGHT_SEEDS[f"g{cfg.run_id}"]).items()}
    _ema_rule(got["ema_delta"], want["ema_delta"], old)


def test_d_input_gradient_noise_floor():
    """Why the steps' gradients are held at 1e-2: two float32 evaluations
    of D's input gradient at full width — the port through oneDNN and
    through PyTorch's native convolutions — differ about as much as the
    port and ``gif_tpu`` do (printed); R1 (2.5 |dD/dx|^2) and every
    gradient it or G's loss feeds carry that noise."""
    import jax
    import jax.numpy as jnp
    import torch

    from gif_tpu.train.state import build_models

    inp = fw.inputs("step8")
    rng = np.random.default_rng(0)
    cond = fw.from_levels(rng.integers(0, 256, inp["real_image"].shape[:3] + (6,)).astype(np.uint8))
    _, jdisc = build_models(fj.jax_config(8))
    params = fj.discriminator_tree()
    want = np.asarray(jax.jit(jax.grad(lambda im: jdisc.apply({"params": params}, im, jnp.asarray(cond)).sum()))(
        jnp.asarray(inp["real_image"])))
    disc = fw.rule_discriminator(fw.full_config(8))
    got = {}
    with cpu_threads(4):
        for onednn in (True, False):
            with torch.backends.mkldnn.flags(enabled=onednn):
                x = torch.from_numpy(inp["real_image"]).requires_grad_(True)
                (g,) = torch.autograd.grad(disc(x, torch.from_numpy(cond)).sum(), x)
                got[onednn] = g.numpy()
    floor = fw.rel_l2(got[True], got[False])
    vs_jax = [fw.rel_l2(got[k], want) for k in (True, False)]
    print(f"dD/dx rel L2: port oneDNN vs native {floor:.3g}; port vs gif_tpu {vs_jax[0]:.3g} (oneDNN), "
          f"{vs_jax[1]:.3g} (native)")
    assert 1e-5 < floor and max(vs_jax) < 3 * floor


def test_r1_gradient_is_worse_conditioned_in_pairs():
    """Why the steps run on 4 rows: minibatch stddev's groups of 2 make
    R1's parameter gradient several times more sensitive to a rounding-sized
    change of the input (2 float32 spacings) than groups of 4 (printed)."""
    import torch

    from gif_tpu_torch.train import losses

    disc = fw.rule_discriminator(fw.full_config(8))
    names, params = zip(*disc.named_parameters())
    rng = np.random.default_rng(0)
    moved = {}
    with cpu_threads(4), torch.backends.mkldnn.flags(enabled=False):
        for b in (2, 4):
            x = rng.uniform(-1, 1, (b, 256, 256, 3)).astype(np.float32)
            cond = torch.from_numpy(fw.from_levels(rng.integers(0, 256, (b, 256, 256, 6)).astype(np.uint8)))
            grads = []
            for img in (x, x * np.float32(1 + 2**-22)):
                r1 = losses.r1_penalty(disc, torch.from_numpy(img), cond, 5.0)
                grads.append(torch.autograd.grad(r1, params, materialize_grads=True))
            moved[b] = max((fw.rel_l2(g1.numpy(), g0.numpy()), n) for n, g0, g1 in zip(names, *grads))
    print(f"R1's parameter gradient moved by a 2-spacing input change: worst tensor {moved[2]} in groups of 2, "
          f"{moved[4]} in groups of 4")
    assert moved[2][0] > 2 * moved[4][0]

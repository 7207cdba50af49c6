"""The port's train step under the bf16 policy — the default users train
with (``compute_dtype="bfloat16"``: the G / D conv stacks in bf16; the
parameters, the mapping net, demodulation, the RGB / skip accumulation,
minibatch stddev and every loss in f32) — held to the JAX package's on the
CPU, tiny config (max_channels 16, 32 px, batch 4), from one converted
state, with JAX's draws injected (``tests/torch_port_common.py``).

Cases, each run by both packages in f32 and under bf16 from the same
state: the run_id-8 step with its conditions rendered, step 0 without R1
and step 1 with it (one jitted JAX step, ``r1_interval`` 2, called twice;
the port replays step 1 from JAX's state after step 0 of the same dtype,
as tests/test_torch_train.py does); the fused run_id-0 step with R1; run_id
8 with the path-length penalty, the embedding regularizer, shuffled-
condition negatives, instance noise and a crop / flip batch, with R1; and
fused run_id 0 with the direct-gradient penalty and R1.

The rule, "as close to f32 as JAX" (tests/test_torch_generator.py's for G's
forward): bf16 rounds at other places in the two packages, so the port's
bf16 step cannot equal JAX's bit for bit; what must hold is that it lands
as near the f32 answer as JAX's does.  For every metric, every gradient
tensor (Adam's first moment: beta1 is 0) and each network's update, let
``d_jax`` be JAX's own bf16-vs-f32 distance, measured here on the same
inputs and weights.  Then

- the port's bf16-vs-f32 distance <= ``K_F32 * d_jax`` + the f32 bar;
- the port's bf16 result's distance from JAX's bf16 result <= ``K_JAX *
  d_jax`` + the f32 bar,

``d_jax`` taken relative to JAX's f32 answer in the first and to its bf16
answer in the second, as the port's distance is; the f32 bar being what
the f32 tests hold the same quantity to (metrics
rtol 1e-4, or 2e-3 where the conditions are rendered; gradients 1e-4 in
relative L2; updates the delta rule's 1e-2, or 5e-2 rendered).  A metric,
being one number, is scaled by the largest ``d_jax`` among its step's
losses (one bf16 forward feeds them all: JAX's d_loss may land on f32 by
luck where its g_loss does not).  Distances: metrics ``|a - b| / |b|``,
gradients relative L2 per tensor, updates ``mean |a - b| / mean |b|`` over
each network.

A tolerance can hide a misplaced cast, so ``test_bf16_policy_dtypes``
records, with hooks on the port's modules, the dtype of the mapping
output, the demodulation coefficients, the RGB skip sums, minibatch
stddev's input and output, every loss, Adam's moments and the conv
activations, and holds each to ``gif_tpu/train/config.py:34-37``.

Found while building this file: at this width D's score head has 16
units, and a step can leave one of them within bf16 noise of zero (a
pre-activation of 3.6e-4 against noise of ~5e-3 in either package); where
the noise flips its leaky-ReLU slope, R1 moves by ~27% in that package
alone.  A port chain of two bf16 steps from its own state hit that (R1
0.268 from f32; JAX 0.011 from its own state) though each step, replayed
from one state, agrees — hence the replay from JAX's states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_tpu.flame.resources import synthetic_flame_resources as j_synth
from gif_tpu.train import get_config as j_get_config
from gif_tpu.train.state import create_train_state as j_create_train_state
from gif_tpu.train.step import make_train_step as j_make_train_step
from gif_tpu_torch.flame.resources import synthetic_flame_resources
from gif_tpu_torch.tools import full_width_goldens as fw
from gif_tpu_torch.tools.convert_params import convert_train_state
from gif_tpu_torch.train.config import get_config
from gif_tpu_torch.train.step import make_train_step
from torch_port_common import (
    BRANCH_B as B,
    JaxBranchSteps,
    branch_batch,
    branch_overrides,
    cpu_threads,
    numpy_state,
    port_state,
    tiny_overrides,
    train_batch,
)

RES_T = synthetic_flame_resources(seed=1, n_vertices=503)
DTYPES = ("float32", "bfloat16")

# The port's bf16-vs-f32 distance over JAX's, and the port's bf16 distance
# from JAX's bf16 over JAX's bf16-vs-f32 distance.  Measured worst on the
# CPU (the printed table, net of the f32 bar): 2.08 against f32 (fused_0
# and dg_0, D's out.bias), 1.89 against JAX's bf16 (reg_8, R1); at 256 px
# 2.03 and 1.57.
K_F32 = 4.0
K_JAX = 4.0

# name: (run id, overrides, augmentation keys, fuse_interp); the branch
# harness's state at step 1 with pl_mean 0.5 (R1 on: r1_interval 2).
BRANCH_CASES = {
    "fused_0": (0, {}, (), True),
    "reg_8": (8, dict(gen_reg_type="path_len_reg", embedding_reg_weight=0.01, shfld_cond_as_neg_smpl=True,
                      d_input_noise_std=0.1, render_in_step=True), ("crop", "flip"), True),
    "dg_0": (0, dict(gen_reg_type="direct_grad_reg"), (), True),
}
CASES = ["r1_8/step0", "r1_8/step1"] + list(BRANCH_CASES)


def _r1_overrides(dt):
    return tiny_overrides(batch_size=B, r1_interval=2, apply_texture_space_interpolation_loss=False,
                          render_in_step=True, compute_dtype=dt)


def _r1_batch(cfg):
    return {k: v for k, v in train_batch(cfg, B).items() if k != "cond"}


@pytest.fixture(scope="module")
def jax_runs():
    """Per case and dtype: (state before, state after, metrics, draws,
    port config, batch) of the JAX step."""
    out = {}
    res = j_synth(seed=1, n_vertices=503)
    state0 = None
    for dt in DTYPES:
        jcfg = j_get_config(8, **_r1_overrides(dt))
        if state0 is None:
            state0 = j_create_train_state(jcfg, jax.random.PRNGKey(0))
        step = j_make_train_step(jcfg, res, max_tris_per_tile=res.n_faces)
        batch = _r1_batch(jcfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        s1, m1 = step(state0, jb, jax.random.PRNGKey(1))
        s2, m2 = step(s1, jb, jax.random.PRNGKey(2))
        cfg = get_config(8, **_r1_overrides(dt))
        out["r1_8/step0", dt] = (state0, s1, m1, None, cfg, batch, True)
        out["r1_8/step1", dt] = (s1, s2, m2, None, cfg, batch, True)
    steps = JaxBranchSteps({f"{name}/{dt}": (r, {**extra, "compute_dtype": dt}, aug, fuse)
                            for name, (r, extra, aug, fuse) in BRANCH_CASES.items() for dt in DTYPES})
    for name, (run_id, extra, aug, fuse) in BRANCH_CASES.items():
        for dt in DTYPES:
            start, new, m, draws = steps(f"{name}/{dt}")
            cfg = get_config(run_id, **branch_overrides(run_id, {**extra, "compute_dtype": dt}))
            out[name, dt] = (start, new, m, draws, cfg, branch_batch(cfg, aug), fuse)
    return out


def _jax_outputs(run) -> dict:
    start, new, m, *_ = run
    old, want = convert_train_state(numpy_state(start)), convert_train_state(numpy_state(new))
    return {
        "metrics": {**{k: float(v) for k, v in m.items() if k != "render_overflow"},
                    "pl_mean": float(want["pl_mean"])},
        "g_grad": {k: v.numpy() for k, v in want["g_opt"]["exp_avg"].items()},
        "d_grad": {k: v.numpy() for k, v in want["d_opt"]["exp_avg"].items()},
        "g_delta": {k: v.numpy() - old["generator"][k].numpy() for k, v in want["generator"].items()
                    if k != "embedding"},
        "d_delta": {k: v.numpy() - old["discriminator"][k].numpy() for k, v in want["discriminator"].items()},
    }


def _port_outputs(run) -> dict:
    start, _, _, draws, cfg, batch, fuse = run
    step = make_train_step(cfg, RES_T, device="cpu", max_tris_per_tile=RES_T.n_faces, fuse_interp=fuse)
    with cpu_threads(2):
        state = port_state(cfg, start)
        before = {what: {n: p.detach().clone() for n, p in getattr(state, what).named_parameters()}
                  for what in ("generator", "discriminator")}
        state, m = step(state, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, draws)
    assert m["render_overflow"].item() == 0.0

    def moments(opt, module):
        return {n: opt.state[p]["exp_avg"].numpy() for n, p in module.named_parameters()}

    def deltas(what):
        return {n: (p.detach() - before[what][n]).numpy() for n, p in getattr(state, what).named_parameters()}

    return {
        "metrics": {**{k: v.item() for k, v in m.items() if k != "render_overflow"},
                    "pl_mean": state.pl_mean.item()},
        "g_grad": moments(state.g_opt, state.generator), "d_grad": moments(state.d_opt, state.discriminator),
        "g_delta": deltas("generator"), "d_delta": deltas("discriminator"),
    }


def _distances(x: dict, y: dict) -> dict:
    """{quantity: distance of x from y}: every metric (pl_mean among them)
    and gradient tensor by ``full_width_goldens.distances``, each network's
    update by the delta rule."""
    d = fw.distances({k: x[k] for k in ("metrics", "g_grad", "d_grad")}, y)
    out = {f"{'metric' if g == 'metrics' else g} {k}": v for g in ("metrics", "g_grad", "d_grad")
           for k, v in d[g][0].items()}
    for u in ("g_delta", "d_delta"):
        out[u] = fw.mean_rule(x[u], y[u])
    return out


@pytest.fixture(scope="module")
def outputs(jax_runs):
    """Per case: {(package, dtype): outputs}."""
    return {case: {(pkg, dt): fn(jax_runs[case, dt]) for pkg, fn in (("jax", _jax_outputs), ("port", _port_outputs))
                   for dt in DTYPES} for case in CASES}


def _f32_bar(quantity: str, rendered: bool) -> float:
    if quantity.startswith("metric"):
        return 2e-3 if rendered else 1e-4
    if quantity.endswith("_delta"):
        return 5e-2 if rendered else 1e-2
    return 1e-4


@pytest.mark.parametrize("case", CASES)
def test_bf16_step_is_as_close_to_f32_as_jax(outputs, case):
    out = outputs[case]
    # JAX's distance taken as each comparison takes the port's: from f32
    # relative to f32, and from its bf16 answer relative to that.
    d_jax = _distances(out["jax", "bfloat16"], out["jax", "float32"])
    d_jax_bf16 = _distances(out["jax", "float32"], out["jax", "bfloat16"])
    d_port = _distances(out["port", "bfloat16"], out["port", "float32"])
    d_pj = _distances(out["port", "bfloat16"], out["jax", "bfloat16"])
    # The f32 runs agree, as the f32 tests hold them.
    d_f32 = _distances(out["port", "float32"], out["jax", "float32"])
    rendered = case.startswith(("r1_8", "reg_8"))
    scales = {}
    for what, d in (("f32", d_jax), ("jax", d_jax_bf16)):
        metric_scale = max(v for k, v in d.items() if k.startswith("metric"))
        scales[what] = {q: metric_scale if q.startswith("metric") else v for q, v in d.items()}
    failed, ratios = [], {"f32": [], "jax": []}
    for q in d_jax:
        bar = _f32_bar(q, rendered)
        assert d_f32[q] <= max(bar, 1e-3), (q, d_f32[q])
        for what, got, k in (("f32", d_port[q], K_F32), ("jax", d_pj[q], K_JAX)):
            scale = scales[what][q]
            ratios[what].append(((got - bar) / scale if scale else 0.0, q, got, scale))
            if got > k * scale + bar:
                failed.append(f"{q}: port {what} {got:.3g} > {k:g} x {scale:.3g} + {bar:g}")
    for what, rows in ratios.items():
        rows.sort(reverse=True)
        print(f"{case}: worst (distance - f32 bar) / d_jax, port vs {what}: " + "; ".join(
            f"{q} {r:.3g} ({got:.3g} / {s:.3g})" for r, q, got, s in rows[:3]))
    print(f"{case}: metrics d_jax {scales['f32']['metric d_loss']:.3g}; " + ", ".join(
        f"{k[7:]} jax {d_jax[k]:.3g} port {d_port[k]:.3g}" for k in d_jax if k.startswith("metric")))
    assert not failed, failed
    # bf16 must round somewhere in both packages.
    assert d_jax["g_delta"] > 0 and d_port["g_delta"] > 0


@pytest.mark.parametrize("case", ["reg_8", "dg_0"])
def test_bf16_policy_dtypes(monkeypatch, case):
    """One port step under the bf16 policy with every cast point recorded:
    f32 where ``gif_tpu/train/config.py:34-37`` keeps f32 (the mapping
    output, the demodulation coefficients, every ToRGB's skip sum, minibatch
    stddev's input and output, D's head, every loss and regularizer term,
    the parameters and Adam's moments), bf16 for the G / D conv stacks'
    activations (each modulated conv, condition injection and styled conv
    of G; each conv layer and res block of D below the head)."""
    import gif_tpu_torch.ops as ops
    import gif_tpu_torch.ops.conv as conv_ops
    from gif_tpu_torch.models import layers
    from gif_tpu_torch.train import losses
    from gif_tpu_torch.train.state import create_train_state

    run_id, extra, aug, fuse = BRANCH_CASES[case]
    cfg = get_config(run_id, **branch_overrides(run_id, {**extra, "compute_dtype": "bfloat16"}))
    seen = {}

    def record(what, value):
        for v in value if isinstance(value, tuple) else (value,):
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                seen.setdefault(what, set()).add(v.dtype)

    def wrap(module, name, what=None, inputs=False):
        fn = getattr(module, name)

        def recorded(*args, **kwargs):
            if inputs:
                record(f"{what or name} input", args[0])
            out = fn(*args, **kwargs)
            record(what or name, out)
            return out

        monkeypatch.setattr(module, name, recorded)

    wrap(conv_ops, "demodulation")
    wrap(ops, "minibatch_stddev", inputs=True)
    for name in ("d_ns_loss", "g_ns_loss", "r1_from_scores", "path_length_penalty", "direct_grad_penalty",
                 "l2_param_norm", "interp_penalty_from_images"):
        wrap(losses, name, "loss " + name)
    state = create_train_state(cfg, seed=0, device="cpu")
    state.step = 1
    gen, disc = state.generator, state.discriminator
    hooks = [gen.mapping.register_forward_hook(lambda m, i, o: record("mapping", o))]
    for net, kinds in ((gen, (layers.ModulatedConv2d, layers.ConditionInjection, layers.StyledConv,
                              layers.ToRGB)), (disc, (layers.ConvLayer, layers.ResBlock))):
        for name, m in net.named_modules():
            if isinstance(m, kinds):
                what = "D head" if name.startswith("final") else type(m).__name__
                hooks.append(m.register_forward_hook(lambda m, i, o, what=what: record(what, o)))
    step = make_train_step(cfg, RES_T, device="cpu", max_tris_per_tile=RES_T.n_faces, fuse_interp=fuse)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in branch_batch(cfg, aug).items()}
    with cpu_threads(2):
        state, m = step(state, batch)
    for h in hooks:
        h.remove()
    f32, bf16 = {torch.float32}, {torch.bfloat16}
    losses_run = {"d_ns_loss", "g_ns_loss", "r1_from_scores"} | (
        {"path_length_penalty", "l2_param_norm"} if case == "reg_8" else
        {"direct_grad_penalty", "interp_penalty_from_images"})
    want = {"mapping": f32, "demodulation": f32, "ToRGB": f32, "minibatch_stddev input": f32,
            "minibatch_stddev": f32, "D head": f32, "ModulatedConv2d": bf16, "ConditionInjection": bf16,
            "StyledConv": bf16, "ConvLayer": bf16, "ResBlock": bf16, **{"loss " + k: f32 for k in losses_run}}
    assert seen == want
    assert all(v.dtype == torch.float32 for v in m.values())
    for opt, net in ((state.g_opt, gen), (state.d_opt, disc)):
        for p in net.parameters():
            assert p.dtype == torch.float32
            assert {opt.state[p][k].dtype for k in ("exp_avg", "exp_avg_sq")} == f32


def test_g_gradient_through_d_at_256px_is_as_close_to_f32_as_jax():
    """G's adversarial gradient through D at the users' 256 px (16
    channels, batch 4, conditions on the 8-bit grid), by this file's rule
    per gradient tensor.  The gradients of G's biases sum their maps'
    gradient over 256 x 256 pixels, where rounding an input of the conv
    stacks shows: while G's condition-injection convs read the conditions
    rounded to bf16, the port's bf16 gradients stood up to 5.8x further
    from f32 than ``gif_tpu``'s (to_rgb5's weight: 0.27 against 0.046);
    with the first of them reading the f32 maps
    (``layers.ConditionInjection``), 2.0x.  D's ``from_rgb`` still reads
    its input rounded: reading it in f32 too took the worst to 1.16x but
    cost 9.5% of the bench step on the H100."""
    import jax

    from gif_tpu.train import losses as jl
    from gif_tpu.train.state import build_models
    from gif_tpu_torch.models.discriminator import Discriminator
    from gif_tpu_torch.models.generator import StyledGenerator
    from gif_tpu_torch.tools.convert_params import (
        convert_discriminator_params,
        convert_generator_params,
        convert_params,
    )
    from gif_tpu_torch.train import losses

    s, b = 256, 4

    def over(dt):
        return tiny_overrides(max_size=s, init_size=s, render_image_size=s, compute_dtype=dt)

    jcfg = j_get_config(8, **over("float32"))
    gen, disc = build_models(jcfg)
    gv = jax.jit(lambda k: gen.init(k, jnp.zeros((1, s, s, 6)), input_indices=jnp.zeros((1,), jnp.int32),
                                    step=jcfg.max_step))(jax.random.PRNGKey(0))
    dparams = jax.jit(lambda k: disc.init(k, jnp.zeros((1, s, s, 3)), jnp.zeros((1, s, s, 6))))(
        jax.random.PRNGKey(1))["params"]
    rng = np.random.default_rng(2)
    cond = (np.floor(rng.uniform(0, 1, (b, s, s, 6)) * 255) / 255 * 2 - 1).astype(np.float32)
    idx = np.array([2, 9, 3, 5], np.int32)
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    grads = {}
    for dt in DTYPES:
        g, d = build_models(j_get_config(8, **over(dt)))

        def loss(p, g=g, d=d):
            img = g.apply({"params": p, "buffers": gv["buffers"]}, jnp.asarray(cond), input_indices=jnp.asarray(idx),
                          step=jcfg.max_step)
            return jl.g_ns_loss(d.apply({"params": dparams}, img, jnp.asarray(cond)))

        jgrad = as_np(jax.jit(jax.grad(loss))(gv["params"]))
        grads["jax", dt] = {k: v.numpy() for k, v in convert_params(jgrad).items()}
        cfg = get_config(8, **over(dt))
        gm, dm = StyledGenerator.from_config(cfg), Discriminator.from_config(cfg)
        gm.load_state_dict(convert_generator_params(as_np(gv["params"]), as_np(gv["buffers"])))
        dm.load_state_dict(convert_discriminator_params(as_np(dparams)))
        c = torch.from_numpy(cond)
        with cpu_threads(2):
            img = gm(c, input_indices=torch.from_numpy(idx).long(), step=cfg.max_step)
            names, params = zip(*gm.named_parameters())
            got = torch.autograd.grad(losses.g_ns_loss(dm(img, c)), params)
        grads["port", dt] = {n: t.numpy() for n, t in zip(names, got)}
    failed, worst = [], []
    for n, jf in grads["jax", "float32"].items():
        jb, pf, pb = grads["jax", "bfloat16"][n], grads["port", "float32"][n], grads["port", "bfloat16"][n]
        bar = _f32_bar("grad", False)
        assert fw.rel_l2(pf, jf) <= 1e-3, n
        for what, got, k, d_jax in (("f32", fw.rel_l2(pb, pf), K_F32, fw.rel_l2(jb, jf)),
                                    ("jax", fw.rel_l2(pb, jb), K_JAX, fw.rel_l2(jf, jb))):
            worst.append((got / d_jax, what, n, got, d_jax))
            if got > k * d_jax + bar:
                failed.append(f"{n}: port vs {what} {got:.3g} > {k:g} x {d_jax:.3g} + {bar:g}")
    worst.sort(reverse=True)
    print("256 px: worst distance / d_jax: " + "; ".join(f"{n} vs {w} {r:.3g} ({g:.3g} / {d:.3g})"
                                                           for r, w, n, g, d in worst[:3]))
    assert not failed, failed

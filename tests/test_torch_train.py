"""Port parity of the run_id-8 train step on the CPU, tiny config (f32,
max_channels 16, 32 px, batch 4): the losses, Adam's hyperparameters and
update, the EMA, one step's D and G gradients, and whole steps of
``make_train_step`` against the JAX package's jitted step, from one
converted state.

The comparison rule for parameters after a step: the first Adam step with
beta1 = 0 moves each parameter by about ``lr * g / (|g| + 1e-8)``, so where
float noise flips a near-zero gradient's sign the two packages move it by
up to ``2 lr`` apart.  The gradients are held tight (rtol 1e-4); updated
G and D parameters are held by their update ``delta`` per tensor:
``mean |delta_port - delta_jax| <= 1e-2 * mean |delta_jax|`` (at most
~0.5% of a tensor's elements may flip).  The EMA's own step, ``(1 - decay)
* (g - ema)`` (~4e-6), is held to the JAX EMA's step by the same rule on
the elements where JAX's step is at least 32 float spacings of the old EMA
value (one rounding step is then at most ~3% of it): most of the conv and
modulation weights.  It is below the spacing of the mapping weights (~100,
spacing 7.6e-6), so every EMA tensor is also held to the EMA of the port's
own updated G (rtol 1e-6), which carries G's parity over."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_tpu.flame.resources import synthetic_flame_resources as j_synth
from gif_tpu.train import get_config as j_get_config
from gif_tpu.train import losses as jl
from gif_tpu.train.state import build_models as j_build_models
from gif_tpu.train.state import create_train_state as j_create_train_state
from gif_tpu.train.state import make_optimizers as j_make_optimizers
from gif_tpu.train.step import make_train_step as j_make_train_step
from gif_tpu.utils.ema import ema_update as j_ema_update
from gif_tpu_torch.flame.resources import synthetic_flame_resources
from gif_tpu_torch.tools.convert_params import convert_train_state
from gif_tpu_torch.train import losses as tl
from gif_tpu_torch.train.config import get_config
from gif_tpu_torch.train.state import create_train_state, load_train_state, make_optimizers
from gif_tpu_torch.train.step import (
    d_loss_and_grads,
    g_loss_and_grads,
    g_schedule,
    make_train_step,
)
from gif_tpu_torch.utils.ema import ema_update
from torch_port_common import check_step_update, numpy_state, port_state, tiny_overrides, train_batch

B = 4
RES_T = synthetic_flame_resources(seed=1, n_vertices=503)


def _over(**extra):
    base = dict(batch_size=B, r1_interval=2, apply_texture_space_interpolation_loss=False)
    return tiny_overrides(**{**base, **extra})


def _batch(cfg, seed=0):
    return train_batch(cfg, B, seed)


@pytest.fixture(scope="module")
def jax_steps():
    """Two jitted JAX steps per render mode from one fresh state: step 0
    (no R1) and step 1 (R1, since (1 + 1) % 2 == 0)."""
    out = {}
    res = j_synth(seed=1, n_vertices=503)
    state0 = None
    for render in (False, True):
        jcfg = j_get_config(8, **_over(render_in_step=render))
        if state0 is None:
            state0 = j_create_train_state(jcfg, jax.random.PRNGKey(0))
        step = j_make_train_step(jcfg, res, max_tris_per_tile=res.n_faces)
        batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items() if render is False or k != "cond"}
        s1, m1 = step(state0, batch, jax.random.PRNGKey(1))
        s2, m2 = step(s1, batch, jax.random.PRNGKey(2))
        out[render] = [(state0, None), (s1, m1), (s2, m2)]
    return out


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    real, fake = (rng.standard_normal((B, 1)).astype(np.float32) * 3 for _ in range(2))
    np.testing.assert_allclose(
        tl.d_ns_loss(torch.from_numpy(real), torch.from_numpy(fake)).item(),
        float(jl.d_ns_loss(jnp.asarray(real), jnp.asarray(fake))), rtol=1e-6,
    )
    np.testing.assert_allclose(
        tl.g_ns_loss(torch.from_numpy(fake)).item(), float(jl.g_ns_loss(jnp.asarray(fake))), rtol=1e-6
    )


def test_adam_hyperparameters_and_updates_match_optax():
    cfg = get_config(8, **_over())
    g_tx, d_tx = j_make_optimizers(j_get_config(8, **_over()))
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((3, 5)).astype(np.float32)
    grads = [rng.standard_normal((3, 5)).astype(np.float32) * 10.0 ** -k for k in range(4)]
    pg, pd = torch.nn.Parameter(torch.from_numpy(p0.copy())), torch.nn.Parameter(torch.from_numpy(p0.copy()))
    g_opt, d_opt = make_optimizers(cfg, [pg], [pd])
    assert g_opt.defaults["lr"] == cfg.g_lr == pytest.approx(0.002 * 4 / 5)
    assert d_opt.defaults["betas"] == cfg.d_betas == (0.0, pytest.approx(0.99 ** (16 / 17)))
    for tx, opt, p in ((g_tx, g_opt, pg), (d_tx, d_opt, pd)):
        pj, sj = jnp.asarray(p0), tx.init(jnp.asarray(p0))
        for g in grads:
            upd, sj = tx.update(jnp.asarray(g), sj, pj)
            pj = pj + upd
            p.grad = torch.from_numpy(g)
            opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj), rtol=1e-6, atol=1e-7)


def test_ema_matches_jax():
    rng = np.random.default_rng(2)
    e, p = (rng.standard_normal((4, 6)).astype(np.float32) for _ in range(2))
    want = j_ema_update({"a": jnp.asarray(e)}, {"a": jnp.asarray(p)}, 0.9)["a"]
    et = torch.from_numpy(e.copy())
    ema_update([et], [torch.from_numpy(p)], 0.9)
    np.testing.assert_allclose(et.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_step_gradients_match_jax(jax_steps):
    """D's gradient of d_ns_loss + r1 and G's adversarial gradient, from
    the same state and cond, against jax.grad of the same formula."""
    jcfg = j_get_config(8, **_over(render_in_step=False))
    cfg = get_config(8, **_over(render_in_step=False))
    jstate = jax_steps[False][0][0]
    gen_j, disc_j = j_build_models(jcfg)
    bt = _batch(cfg)
    real, cond, idx = (jnp.asarray(bt[k]) for k in ("real_image", "cond", "indices"))

    def d_apply(p, img, c):
        return disc_j.apply({"params": p}, img, c)

    def g_apply(p):
        return gen_j.apply({"params": p, "buffers": jstate.buffers}, cond, input_indices=idx,
                           step=jcfg.max_step)

    fake_j = g_apply(jstate.g_params)
    d_want = jax.jit(jax.grad(
        lambda p: jl.d_ns_loss(d_apply(p, real, cond), d_apply(p, fake_j, cond))
        + jl.r1_penalty(d_apply, p, real, cond, jcfg.r1_weight)
    ))(jstate.d_params)
    g_want = jax.jit(jax.grad(lambda p: jl.g_ns_loss(d_apply(jstate.d_params, g_apply(p), cond))))(
        jstate.g_params
    )

    state = port_state(cfg, jstate)
    gen, disc = state.generator, state.discriminator
    tb = {k: torch.from_numpy(v) for k, v in bt.items()}
    fake_live = gen(tb["cond"], input_indices=tb["indices"].long(), step=cfg.max_step)
    _, r1, d_grads = d_loss_and_grads(disc, tb["real_image"], tb["cond"], fake_live.detach(), cfg, True)
    assert r1.item() > 0
    _, _, _, g_grads, _ = g_loss_and_grads(gen, disc, fake_live, tb["cond"])
    want = convert_train_state(numpy_state(jstate).replace(d_params=d_want, g_params=g_want))
    for got_grads, module, want_sd in (
        (d_grads, disc, want["discriminator"]), (g_grads, gen, want["generator"])
    ):
        names = [n for n, _ in module.named_parameters()]
        assert len(names) == len(got_grads)
        for name, g in zip(names, got_grads):
            w = want_sd[name].numpy()
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("render", [False, True])
def test_train_steps_match_jax(jax_steps, render):
    """Step 0 (no R1) from the converted fresh state, and step 1 (R1) from
    the converted JAX state after step 0 (its Adam moments and counters
    included): metrics, and updated G, D and EMA under the delta rule.
    With the render in the step both packages rasterize the conditions;
    floor quantization may flip a pixel by one 8-bit step where the two
    renders straddle a bin edge, so there the metrics' bar is rtol 2e-3
    and the delta rule's 5e-2."""
    cfg = get_config(8, **_over(render_in_step=render))
    step = make_train_step(cfg, RES_T, device="cpu", max_tris_per_tile=RES_T.n_faces)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items() if not render or k != "cond"}
    metric_rtol, delta_bar = (2e-3, 5e-2) if render else (1e-4, 1e-2)
    for i in (1, 2):
        jprev, (jnew, jm) = jax_steps[render][i - 1][0], jax_steps[render][i]
        state = port_state(cfg, jprev)
        old = convert_train_state(numpy_state(jprev))
        want = convert_train_state(numpy_state(jnew))
        state, m = step(state, batch)
        assert state.step == want["step"] == i and state.used_samples == want["used_samples"] == B * i
        assert (m["r1"].item() > 0) == (i == 2) and float(jm["r1"] > 0) == (i == 2)
        assert m["render_overflow"].item() == float(jm["render_overflow"]) == 0.0
        for k in ("d_loss", "g_loss", "r1", "g_total"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=metric_rtol, err_msg=k)
        check_step_update(state, old, want, cfg, delta_bar, f"step {i}")


def test_converted_train_state_fits_the_port_exactly(jax_steps):
    cfg = get_config(8, **_over())
    jstate = jax_steps[False][1][0]  # after one step: moments and counters set
    conv = convert_train_state(numpy_state(jstate))
    state = create_train_state(cfg, device="cpu")
    for key, module in (("generator", state.generator), ("g_ema", state.g_ema),
                        ("discriminator", state.discriminator)):
        want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in conv[key].items()} == want, key
    for key, module in (("g_opt", state.generator), ("d_opt", state.discriminator)):
        want = {n: tuple(p.shape) for n, p in module.named_parameters()}
        for moment in ("exp_avg", "exp_avg_sq"):
            assert {k: tuple(v.shape) for k, v in conv[key][moment].items()} == want, (key, moment)
        assert conv[key]["step"] == 1
    load_train_state(state, conv)
    assert state.step == 1 and state.used_samples == B and state.pl_mean.item() == 0.0
    nu = np.asarray(jstate.d_opt_state[0].nu["res5"]["conv1"]["conv"]["weight"])
    st = state.d_opt.state[state.discriminator.res5.conv1.conv.weight]
    np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu.transpose(3, 2, 0, 1))
    assert st["step"].item() == 1.0
    assert state.g_ema.embedding is state.generator.embedding


def test_r1_every_step_form_matches_every_n_form():
    """r1_interval == 1 shares the D(real) forward between the loss and R1;
    on an R1 step it gives the every-N form's values and gradients."""
    cfg1 = get_config(8, **_over(r1_interval=1))
    cfg2 = get_config(8, **_over(r1_interval=2))
    state = create_train_state(cfg1, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg1).items()}
    with torch.no_grad():
        fake = state.generator(tb["cond"], input_indices=tb["indices"].long(), step=cfg1.max_step)
    a = d_loss_and_grads(state.discriminator, tb["real_image"], tb["cond"], fake, cfg1, False)
    b = d_loss_and_grads(state.discriminator, tb["real_image"], tb["cond"], fake, cfg2, True)
    assert a[1].item() > 0
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_allclose(x.item(), y.item(), rtol=1e-6)
    for x, y in zip(a[2], b[2]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4, atol=1e-5 * y.abs().max().item())


def test_n_critic_schedules():
    assert g_schedule(get_config(8, n_critic=1.0)) == (1, 1)
    assert g_schedule(get_config(8, n_critic=2.0)) == (2, 1)
    assert g_schedule(get_config(8, n_critic=0.5)) == (1, 2)
    batch = {k: torch.from_numpy(v) for k, v in _batch(get_config(8, **_over())).items()}
    # Integer n_critic: G trains on steps where (step + 1) % n == 0 only.
    cfg = get_config(8, **_over(render_in_step=False, n_critic=2.0))
    state = create_train_state(cfg, device="cpu")
    step = make_train_step(cfg, RES_T, device="cpu")
    g0 = [p.detach().clone() for p in state.generator.parameters()]
    state, m = step(state, batch)
    assert m["g_loss"].item() == 0.0 and all(torch.equal(a, p) for a, p in zip(g0, state.generator.parameters()))
    state, m = step(state, batch)
    assert m["g_loss"].item() > 0 and not all(torch.equal(a, p) for a, p in zip(g0, state.generator.parameters()))
    # Fractional n_critic: G trains round(1 / n) times every step.
    cfg = get_config(8, **_over(render_in_step=False, n_critic=0.5))
    state = create_train_state(cfg, device="cpu")
    state, m = make_train_step(cfg, RES_T, device="cpu")(state, batch)
    p = next(state.generator.parameters())
    assert state.g_opt.state[p]["step"].item() == 2.0 and state.d_opt.state[
        next(state.discriminator.parameters())]["step"].item() == 1.0


def test_augmented_batches_raise_and_default_device_needs_cuda(monkeypatch):
    """Augmented batches now step (tests/test_torch_train_branches.py); what
    still raises: an unknown regularizer type, and the CUDA default without
    a card."""
    cfg = get_config(8, **_over(render_in_step=False))
    with pytest.raises(ValueError, match="gen_reg_type"):
        make_train_step(get_config(8, **_over(gen_reg_type="pathlen")), RES_T, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg, RES_T)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(cfg)

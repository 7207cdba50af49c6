"""Port parity of the run_id-0 train step (the texture-space interpolation
loss) on the CPU, tiny config (f32, max_channels 16, 32 px, batch 4):
whole steps of ``make_train_step`` against the JAX package's jitted step,
fused and unfused, ``adaptive_interp_loss`` off and on, from one converted
state, with JAX's random draws (replayed from its key chain with
``jax.random``) handed to the port; and one G update's G and D gradients
against ``jax.grad`` of the same formula on the same conditions.

Bars: metrics rtol 1e-5 (the conditions are given, so only the
interpolants' render differs between the packages, and it moves the
penalty far less); gradients rtol 1e-4; updated parameters and EMA by the
delta rule of tests/test_torch_train.py."""

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
from gif_tpu.train.step import make_train_step as j_make_train_step
from gif_tpu.train.step import render_flame_maps as j_render_flame_maps
from gif_tpu_torch.flame.resources import synthetic_flame_resources
from gif_tpu_torch.tools.convert_params import convert_train_state
from gif_tpu_torch.train import losses as tl
from gif_tpu_torch.train.config import get_config
from gif_tpu_torch.train.state import create_train_state
from gif_tpu_torch.train.step import d_loss_and_grads, g_loss_and_grads, make_train_step
from torch_port_common import check_step_update, numpy_state, port_state, tiny_overrides, train_batch

B = 4
RES_T = synthetic_flame_resources(seed=1, n_vertices=503)
VARIANTS = [(fuse, adaptive) for fuse in (True, False) for adaptive in (False, True)]
METRICS = ("d_loss", "g_loss", "r1", "g_total", "interp")


def _over(**extra):
    return tiny_overrides(**{**dict(batch_size=B, r1_interval=2, render_in_step=False), **extra})


def _batch(cfg):
    return train_batch(cfg, B)


def jax_interp_keys(rng, fused: bool):
    """(rng_lerp, rng_id, rng_pairs) of one JAX step called with ``rng``
    (``gif_tpu/train/step.py``: the key split at :216, the fused chain at
    :235-237, the unfused one at :535 and :489 and ``losses.py:294``)."""
    _, rng_g, _, _ = jax.random.split(rng, 4)
    rng_i = jax.random.fold_in(rng_g, 0)
    rng_int = jax.random.split(rng_i)[1] if fused else jax.random.split(rng_i, 3)[1]
    rng_lerp, rng_tex = jax.random.split(rng_int)
    rng_id, rng_pairs = jax.random.split(rng_tex)
    return rng_lerp, rng_id, rng_pairs


def jax_draws(rng, n: int, vocab: int, fused: bool) -> dict:
    """The interpolation loss's draws of that step (``losses.py:151``, the
    identity at ``step.py:240`` / ``losses.py:295``, ``losses.py:231``)."""
    rng_lerp, rng_id, rng_pairs = jax_interp_keys(rng, fused)
    n_pairs = (n - 1) * (n - 2) // 2
    return {
        "interp_t": np.asarray(jax.random.uniform(rng_lerp)),
        "interp_identity": int(jax.random.randint(rng_id, (), 0, vocab)),
        "interp_pairs": np.asarray(
            jax.random.choice(rng_pairs, n_pairs, (min(n - 1, n_pairs),), replace=False)
        ),
    }


@pytest.fixture(scope="module")
def jax_steps():
    """Two jitted JAX steps per variant from one fresh state: step 0 (no
    R1) and step 1 (R1, since (1 + 1) % 2 == 0)."""
    res = j_synth(seed=1, n_vertices=503)
    state0 = j_create_train_state(j_get_config(0, **_over()), jax.random.PRNGKey(0))
    out = {}
    for fuse, adaptive in VARIANTS:
        jcfg = j_get_config(0, **_over(adaptive_interp_loss=adaptive))
        step = j_make_train_step(jcfg, res, max_tris_per_tile=res.n_faces, fuse_interp=fuse)
        batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
        s1, m1 = step(state0, batch, jax.random.PRNGKey(1))
        s2, m2 = step(s1, batch, jax.random.PRNGKey(2))
        out[fuse, adaptive] = [(state0, None), (s1, m1), (s2, m2)]
    return out


@pytest.mark.parametrize("fuse,adaptive", VARIANTS)
def test_interp_train_steps_match_jax(jax_steps, fuse, adaptive):
    cfg = get_config(0, **_over(adaptive_interp_loss=adaptive))
    step = make_train_step(cfg, RES_T, device="cpu", max_tris_per_tile=RES_T.n_faces, fuse_interp=fuse)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    for i in (1, 2):
        jprev, (jnew, jm) = jax_steps[fuse, adaptive][i - 1][0], jax_steps[fuse, adaptive][i]
        state = port_state(cfg, jprev)
        old = convert_train_state(numpy_state(jprev))
        want = convert_train_state(numpy_state(jnew))
        draws = jax_draws(jax.random.PRNGKey(i), B, cfg.embedding_vocab_size, fuse)
        state, m = step(state, batch, draws)
        assert state.step == want["step"] == i
        assert (m["r1"].item() > 0) == (i == 2)
        assert m["render_overflow"].item() == float(jm["render_overflow"]) == 0.0
        assert set(m) == set(jm) and m["interp"].item() > 0
        for k in METRICS:
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(m["g_total"].item(), m["g_loss"].item() + m["interp"].item(), rtol=1e-6)
        if adaptive:
            np.testing.assert_allclose(m["interp"].item(), 0.25 * m["g_loss"].item(), rtol=1e-6)
        check_step_update(state, old, want, cfg, 1e-2, f"step {i}")


@pytest.mark.parametrize("adaptive", [False, True])
def test_interp_step_gradients_match_jax(jax_steps, adaptive):
    """D's gradient (d_ns_loss + R1 on the data rows of the 2B - 1-row G
    forward) and G's gradient of ``g_adv + scale * interp`` through that
    forward, from the same state, conditions and draws, against jax.grad
    of the same formula (JAX's own interpolant render fed to both)."""
    jcfg = j_get_config(0, **_over(adaptive_interp_loss=adaptive))
    cfg = get_config(0, **_over(adaptive_interp_loss=adaptive))
    res_j = j_synth(seed=1, n_vertices=503)
    jstate = jax_steps[True, adaptive][0][0]
    gen_j, disc_j = j_build_models(jcfg)
    bt = _batch(cfg)
    real, cond, idx, flame = (jnp.asarray(bt[k]) for k in ("real_image", "cond", "indices", "flame"))
    rng_lerp, _, rng_pairs = jax_interp_keys(jax.random.PRNGKey(1), True)
    draws = jax_draws(jax.random.PRNGKey(1), B, cfg.embedding_vocab_size, True)
    flm_interp = jl.interpolate_flame_batch(flame, rng_lerp)
    np.testing.assert_array_equal(
        np.asarray(flm_interp),
        tl.interpolate_flame_batch(torch.from_numpy(bt["flame"]), draws["interp_t"]).numpy(),
    )
    maps = j_render_flame_maps(res_j, jl.interp_render_flame(flm_interp), 32, res_j.n_faces)
    interp_cond = jl.interp_condition_channels(
        maps.textured, maps.normal, rendered_flame_as_condition=True, normal_maps_as_cond=True
    )
    all_cond = jnp.concatenate([cond, interp_cond])
    all_idx = jnp.concatenate([idx, jnp.full((B - 1,), draws["interp_identity"], jnp.int32)])
    frm = jnp.asarray(res_j.face_region_mask)

    def d_apply(p, img, c):
        return disc_j.apply({"params": p}, img, c)

    def g_apply(p):
        return gen_j.apply({"params": p, "buffers": jstate.buffers}, all_cond, input_indices=all_idx,
                           step=jcfg.max_step)

    def g_loss(p):
        fake_all = g_apply(p)
        g_adv = jl.g_ns_loss(d_apply(jstate.d_params, fake_all[:B], cond))
        interp_raw = jl.interp_penalty_from_images(res_j, fake_all[B:], flm_interp, rng_pairs, frm)
        scale = 0.25 * jax.lax.stop_gradient(g_adv) / jax.lax.stop_gradient(interp_raw) if adaptive else 1.0
        return g_adv + scale * interp_raw

    fake_j = g_apply(jstate.g_params)[:B]
    d_want = jax.jit(jax.grad(
        lambda p: jl.d_ns_loss(d_apply(p, real, cond), d_apply(p, fake_j, cond))
        + jl.r1_penalty(d_apply, p, real, cond, jcfg.r1_weight)
    ))(jstate.d_params)
    g_want = jax.jit(jax.grad(g_loss))(jstate.g_params)

    state = port_state(cfg, jstate)
    gen, disc = state.generator, state.discriminator
    tb = {k: torch.from_numpy(v) for k, v in bt.items()}
    t_flm = torch.from_numpy(np.array(flm_interp))
    fake_live = gen(torch.from_numpy(np.array(all_cond)), input_indices=torch.from_numpy(np.array(all_idx)).long(),
                    step=cfg.max_step)
    _, r1, d_grads = d_loss_and_grads(disc, tb["real_image"], tb["cond"], fake_live[:B].detach(), cfg, True)
    assert r1.item() > 0
    g_adv, _, interp, g_grads, _ = g_loss_and_grads(
        gen, disc, fake_live, tb["cond"],
        lambda: tl.interp_penalty_from_images(
            RES_T, fake_live[B:], t_flm, draws["interp_pairs"], torch.from_numpy(RES_T.face_region_mask)
        ),
        adaptive,
    )
    assert interp.item() > 0
    want = convert_train_state(numpy_state(jstate).replace(d_params=d_want, g_params=g_want))
    for got_grads, module, want_sd in (
        (d_grads, disc, want["discriminator"]), (g_grads, gen, want["generator"])
    ):
        names = [n for n, _ in module.named_parameters()]
        assert len(names) == len(got_grads)
        for name, g in zip(names, got_grads):
            w = want_sd[name].numpy()
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_port_fused_step_equals_unfused():
    cfg = get_config(0, **_over(render_in_step=True))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items() if k != "cond"}
    draws = jax_draws(jax.random.PRNGKey(3), B, cfg.embedding_vocab_size, True)
    out = {}
    for fuse in (True, False):
        state = create_train_state(cfg, device="cpu")
        step = make_train_step(cfg, RES_T, device="cpu", max_tris_per_tile=RES_T.n_faces, fuse_interp=fuse)
        state, m = step(state, batch, draws)
        out[fuse] = state, m
    (sf, mf), (su, mu) = out[True], out[False]
    assert set(mf) == set(mu) and mf["interp"].item() > 0
    for k in mf:
        np.testing.assert_allclose(mf[k].item(), mu[k].item(), rtol=1e-5, atol=1e-7, err_msg=k)
    for a, b in zip(sf.generator.parameters(), su.generator.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("run_id", [3, 29])
def test_other_interp_presets_step(run_id):
    """Presets 3 (normal maps only) and 29 (the sqrt2 EqualLinear quirk)
    build and step with the generator's own draws; the same generator seed
    gives the same step."""
    cfg = get_config(run_id, **_over(render_in_step=True))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items() if k != "cond"}
    mets = []
    for _ in range(2):
        state = create_train_state(cfg, device="cpu")
        step = make_train_step(cfg, RES_T, device="cpu", generator=torch.Generator().manual_seed(5))
        state, m = step(state, batch)
        mets.append({k: v.item() for k, v in m.items()})
    m = mets[0]
    assert mets[0] == mets[1]
    assert all(np.isfinite(v) for v in m.values()) and m["interp"] > 0 and m["render_overflow"] == 0.0
    np.testing.assert_allclose(m["g_total"], m["g_loss"] + m["interp"], rtol=1e-6)


def test_interp_needs_three_samples_and_skipped_g_reports_zero():
    for fuse in (True, False):
        cfg = get_config(0, **_over(batch_size=2))
        state = create_train_state(cfg, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg, 2).items()}
        with pytest.raises(ValueError, match=">= 3 samples"):
            make_train_step(cfg, RES_T, device="cpu", fuse_interp=fuse)(state, batch)
    # n_critic 2: G (and with it the interpolation loss) trains every 2nd step.
    cfg = get_config(0, **_over(n_critic=2.0))
    state = create_train_state(cfg, device="cpu")
    step = make_train_step(cfg, RES_T, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    state, m = step(state, batch)
    assert m["interp"].item() == 0.0 == m["g_total"].item()
    state, m = step(state, batch)
    assert m["interp"].item() > 0

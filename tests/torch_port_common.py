"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py).

The same seeded-numpy inputs and the same (converted) weights go through
the JAX package and its PyTorch port; JAX stays on the CPU.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import pytest
import torch

from gif_tpu_torch.train.config import TINY_OVERRIDES


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip: the hand-written kernels have no CPU
    mode, so their kernel-vs-plain tests run only where a card is."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@contextlib.contextmanager
def cpu_threads(n: int = 2):
    """Torch's and the BLAS / OpenMP thread pools capped at ``n`` while the
    block runs.  The tier-1 run puts six test processes on one machine;
    each with pools as wide as the machine oversubscribes it, and the
    busy-waiting pool threads of the heavy files (InceptionV3 at 299 px,
    the 2048-d matrix square root) then slow every process down."""
    from threadpoolctl import threadpool_limits

    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        with threadpool_limits(limits=n):
            yield
    finally:
        torch.set_num_threads(old)


def tiny_overrides(**extra):
    return {**TINY_OVERRIDES, "embedding_vocab_size": 16, **extra}


@functools.lru_cache(maxsize=2)
def jax_generator_params(run_id: int = 8):
    """(jax cfg, flax params, buffers) of the tiny generator, G only."""
    import jax
    import jax.numpy as jnp

    from gif_tpu.train import get_config
    from gif_tpu.train.state import build_models

    cfg = get_config(run_id, **tiny_overrides())
    gen, _ = build_models(cfg)
    size = 4 * 2**cfg.max_step
    variables = jax.jit(
        lambda k: gen.init(
            k,
            jnp.zeros((1, size, size, cfg.cond_channels)),
            input_indices=jnp.zeros((1,), jnp.int32),
            step=cfg.max_step,
        )
    )(jax.random.PRNGKey(0))
    return cfg, variables["params"], variables["buffers"]



@functools.lru_cache(maxsize=2)
def jax_discriminator_params(compute_dtype: str = "float32"):
    """(jax cfg, flax D params) of the tiny discriminator."""
    import jax
    import jax.numpy as jnp

    from gif_tpu.train import get_config
    from gif_tpu.train.state import build_models

    cfg = get_config(8, **tiny_overrides(compute_dtype=compute_dtype))
    _, disc = build_models(cfg)
    size = cfg.max_size
    variables = jax.jit(
        lambda k: disc.init(
            k, jnp.zeros((1, size, size, 3)), jnp.zeros((1, size, size, cfg.cond_channels))
        )
    )(jax.random.PRNGKey(1))
    return cfg, variables["params"]


def train_batch(cfg, b: int, seed: int = 0) -> dict:
    """bench.py's seeded batch at the config's size, plus precomputed
    conditions on the 8-bit grid."""
    rng = np.random.default_rng(seed)
    s = cfg.max_size
    flame = np.zeros((b, 236), np.float32)
    flame[:, :100] = rng.standard_normal((b, 100)) * 0.1
    flame[:, 150:156] = rng.standard_normal((b, 6)) * 0.05
    flame[:, 156] = 8.0
    flame[:, 209:212] = 3.0
    return {
        "real_image": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
        "flame": flame,
        "indices": rng.integers(0, cfg.embedding_vocab_size, b).astype(np.int32),
        "cond": (np.floor(rng.uniform(0, 1, (b, s, s, 6)) * 255) / 255 * 2 - 1).astype(np.float32),
    }


def numpy_state(state):
    """A JAX train state with every leaf a numpy array."""
    import jax

    return jax.tree_util.tree_map(np.asarray, jax.device_get(state))


def port_state(cfg, jstate):
    """A CPU port state loaded from a JAX train state."""
    from gif_tpu_torch.tools.convert_params import convert_train_state
    from gif_tpu_torch.train.state import create_train_state, load_train_state

    return load_train_state(create_train_state(cfg, device="cpu"), convert_train_state(numpy_state(jstate)))


def check_step_update(state, old: dict, want: dict, cfg, delta_bar: float, what_step: str,
                      g_updates: int = 1) -> None:
    """Hold a port state after one step to the JAX state after the same step
    (both converted: ``old`` before, ``want`` after) by the delta rule of
    tests/test_torch_train.py: updated G and D by their mean update delta,
    the EMA by its own step where JAX's step is at least 32 float spacings
    of the old EMA value, and — where the step updated G once — every EMA
    tensor to the EMA of the port's own updated G (rtol 1e-6)."""
    for what, module in (("generator", state.generator), ("discriminator", state.discriminator)):
        got = dict(module.named_parameters())
        for name, w in want[what].items():
            if name not in got:  # the frozen embedding buffer
                continue
            dj = w.numpy() - old[what][name].numpy()
            dt = got[name].detach().numpy() - old[what][name].numpy()
            bar = delta_bar * np.abs(dj).mean() + 1e-12
            assert np.abs(dt - dj).mean() <= bar, f"{what_step} {what} {name}"
    decay = np.float32(cfg.ema_decay)
    n_held, n_conv = 0, 0
    for name, p in state.g_ema.named_parameters():
        e_old = old["g_ema"][name].numpy()
        if g_updates == 1:
            g_new = state.generator.get_parameter(name).detach().numpy()
            np.testing.assert_allclose(p.numpy(), e_old * decay + g_new * (1 - decay),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
        dj = want["g_ema"][name].numpy() - e_old
        dt = p.detach().numpy() - e_old
        held = np.abs(dj) >= 32 * np.spacing(np.abs(e_old))
        if held.any():
            bar = delta_bar * np.abs(dj[held]).mean()
            assert np.abs(dt - dj)[held].mean() <= bar, f"{what_step} g_ema {name}"
        if not name.startswith("mapping."):
            n_held, n_conv = n_held + held.sum(), n_conv + held.size
    assert n_held >= 0.5 * n_conv, (n_held, n_conv)
    moved = [np.abs(p.detach().numpy() - old["generator"][n].numpy()).mean()
             for n, p in state.generator.named_parameters()]
    moved_ema = [np.abs(p.detach().numpy() - old["g_ema"][n].numpy()).mean()
                 for n, p in state.g_ema.named_parameters()]
    assert 0 < sum(moved_ema) < sum(moved)


# --- the branch harness of tests/test_torch_train_branches*.py ---

BRANCH_B = 4
BRANCH_PL_MEAN = 0.5


def branch_overrides(run_id, extra):
    """Tiny overrides of a branch case: batch 4, R1 every 2nd step,
    conditions given unless the case renders them."""
    base = dict(batch_size=BRANCH_B, r1_interval=2, render_in_step=False)
    if run_id == 8:
        base["apply_texture_space_interpolation_loss"] = False
    return tiny_overrides(**{**base, **extra})


def branch_batch(cfg, aug) -> dict:
    """bench.py's seeded batch; augmented, it carries crops in [-4, 4] px,
    flips, the true fit as ``flame_render`` and a label whose flipped rows
    hold the sentinel (the render must not read it)."""
    from gif_tpu_torch.data.augment import FLIPPED_LABEL_SENTINEL

    b = BRANCH_B
    batch = train_batch(cfg, b)
    if not aug:
        return batch
    del batch["cond"]
    rng = np.random.default_rng(7)
    batch["flame_render"] = batch["flame"].copy()
    if "crop" in aug:
        batch["crop"] = rng.integers(-4, 5, (b, 2)).astype(np.int32)
    if "flip" in aug:
        batch["flip"] = np.arange(b) % 2 == 0
        batch["flame"][batch["flip"]] = FLIPPED_LABEL_SENTINEL
    return batch


def jax_branch_draws(rng, jcfg, fused: bool, b: int = BRANCH_B, shard=None) -> dict:
    """Every random draw of one JAX step on ``b`` rows called with ``rng``
    (``gif_tpu/train/step.py``; with ``shard``, that shard's draws in the
    sharded step, whose key is first folded with the axis index at
    :214-215): the key split at :216; the derangement's
    shift (:333, ``losses.py:98``) and the instance noise on D's reals and
    fakes (:359-360); per G iteration (:535, :615-617 or :624) the noise on
    G's scored fakes (:417), the path-length z and projection noise
    (:432-433, ``losses.py:69``); and the interpolation loss's draws (the
    fused chain at :235-237, the unfused one at :489 and ``losses.py:294``)."""
    import jax

    from gif_tpu_torch.train.step import g_schedule

    s = jcfg.max_size
    if shard is not None:
        rng = jax.random.fold_in(rng, shard)
    rng_d, rng_g, _, _ = jax.random.split(rng, 4)
    g_interval, g_iters = g_schedule(jcfg)
    n_fake = 2 * b if jcfg.shfld_cond_as_neg_smpl else b
    img = (b, s, s, 3)
    draws = {
        "shuffle_shift": int(jax.random.randint(jax.random.fold_in(rng_d, 1), (), 1, b)),
        "noise_real": np.asarray(jax.random.normal(jax.random.fold_in(rng_d, 2), img)),
        "noise_fake": np.asarray(jax.random.normal(jax.random.fold_in(rng_d, 3), (n_fake, s, s, 3))),
        "noise_g": [], "pl_z": [], "pl_noise": [],
    }
    for it in range(g_iters):
        rng_i = jax.random.fold_in(rng_g, it) if g_interval == 1 else rng_g
        rng_pl, rng_int, rng_adv = jax.random.split(rng_i, 3)
        rng_z, rng_noise = jax.random.split(rng_pl)
        draws["noise_g"].append(np.asarray(jax.random.normal(rng_adv, img)))
        draws["pl_z"].append(np.asarray(jax.random.normal(rng_z, (b, 512))))
        draws["pl_noise"].append(np.asarray(jax.random.normal(rng_noise, img)))
        if it == 0 and jcfg.apply_texture_space_interpolation_loss:
            if fused:
                rng_int = jax.random.split(jax.random.fold_in(rng_g, 0))[1]
            rng_lerp, rng_tex = jax.random.split(rng_int)
            rng_id, rng_pairs = jax.random.split(rng_tex)
            n_pairs = (b - 1) * (b - 2) // 2
            draws["interp_t"] = np.asarray(jax.random.uniform(rng_lerp))
            draws["interp_identity"] = int(jax.random.randint(rng_id, (), 0, jcfg.embedding_vocab_size))
            draws["interp_pairs"] = np.asarray(
                jax.random.choice(rng_pairs, n_pairs, (min(b - 1, n_pairs),), replace=False))
    return draws


def mapping_biases_off_zero(jstate):
    """The JAX state with seeded N(0, 0.1) mapping biases."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    mapping = {k: {**v, "bias": jnp.asarray(rng.standard_normal(v["bias"].shape).astype(np.float32) * 0.1)}
               for k, v in jstate.g_params["mapping"].items()}
    return jstate.replace(g_params={**jstate.g_params, "mapping": mapping})


class JaxBranchSteps:
    """Per case of ``cases`` (name: (run id, overrides, augmentation keys,
    fuse_interp)), on first use: (state before, state after, metrics,
    draws) of one jitted JAX step with ``jax.random.PRNGKey(1)``, from the
    fresh state set to step 1 (R1 on) and ``pl_mean`` 0.5 (mapping biases
    off zero under the embedding regularizer)."""

    def __init__(self, cases):
        from gif_tpu.flame.resources import synthetic_flame_resources

        self.cases, self.done, self.state0 = cases, {}, {}
        self.res = synthetic_flame_resources(seed=1, n_vertices=503)

    def __call__(self, case):
        import jax
        import jax.numpy as jnp

        from gif_tpu.train import get_config
        from gif_tpu.train.state import create_train_state
        from gif_tpu.train.step import make_train_step

        if case not in self.done:
            run_id, extra, aug, fuse = self.cases[case]
            jcfg = get_config(run_id, **branch_overrides(run_id, extra))
            if run_id not in self.state0:
                self.state0[run_id] = create_train_state(jcfg, jax.random.PRNGKey(0)).replace(
                    step=jnp.int32(1), pl_mean=jnp.float32(BRANCH_PL_MEAN))
            start = self.state0[run_id]
            if jcfg.embedding_reg_weight > 0:
                start = mapping_biases_off_zero(start)
            step = make_train_step(jcfg, self.res, max_tris_per_tile=self.res.n_faces, fuse_interp=fuse)
            batch = {k: jnp.asarray(v) for k, v in branch_batch(jcfg, aug).items()}
            s1, m1 = step(start, batch, jax.random.PRNGKey(1))
            self.done[case] = (start, s1, m1, jax_branch_draws(jax.random.PRNGKey(1), jcfg, fuse))
        return self.done[case]


def check_branch_step(jax_steps: JaxBranchSteps, case: str, res) -> None:
    """One port step of ``case`` from the converted JAX state, with JAX's
    draws, against the JAX step: metrics (rtol 1e-4, or 2e-3 where both
    render the conditions), ``pl_mean`` (rtol 1e-4; moved only under the
    path-length penalty), the adaptive scale, Adam's step count and the
    updated G, D and EMA by the delta rule (1e-2, or 5e-2 rendered)."""
    from gif_tpu_torch.tools.convert_params import convert_train_state
    from gif_tpu_torch.train.config import get_config
    from gif_tpu_torch.train.step import g_schedule, make_train_step

    run_id, extra, aug, fuse = jax_steps.cases[case]
    cfg = get_config(run_id, **branch_overrides(run_id, extra))
    jprev, jnew, jm, draws = jax_steps(case)
    step = make_train_step(cfg, res, device="cpu", max_tris_per_tile=res.n_faces, fuse_interp=fuse)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in branch_batch(cfg, aug).items()}
    state = port_state(cfg, jprev)
    old = convert_train_state(numpy_state(jprev))
    want = convert_train_state(numpy_state(jnew))
    state, m = step(state, batch, draws)
    metric_rtol, delta_bar = (2e-3, 5e-2) if aug else (1e-4, 1e-2)
    assert state.step == want["step"] == 2 and m["r1"].item() > 0 and float(jm["r1"]) > 0
    assert set(m) == set(jm) and m["render_overflow"].item() == float(jm["render_overflow"]) == 0.0
    for k in set(m) - {"render_overflow"}:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=metric_rtol, err_msg=k)
    np.testing.assert_allclose(state.pl_mean.item(), float(want["pl_mean"]), rtol=1e-4)
    if cfg.gen_reg_type == "path_len_reg":
        assert state.pl_mean.item() != BRANCH_PL_MEAN
        assert m["g_total"].item() > m["g_loss"].item() + m.get("interp", torch.zeros(())).item()
    else:
        assert state.pl_mean.item() == BRANCH_PL_MEAN
    if cfg.adaptive_interp_loss:
        rest = m["g_total"].item() - m["g_loss"].item() - m["interp"].item()
        np.testing.assert_allclose(m["interp"].item(), 0.25 * (m["g_loss"].item() + rest), rtol=1e-5)
    g_updates = g_schedule(cfg)[1]
    p = next(state.generator.parameters())
    assert state.g_opt.state[p]["step"].item() == g_updates
    check_step_update(state, old, want, cfg, delta_bar, case, g_updates=g_updates)

"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py).

The same seeded-numpy inputs and the same (converted) weights go through
the JAX package and its PyTorch port; JAX stays on the CPU.
"""

from __future__ import annotations

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


def check_step_update(state, old: dict, want: dict, cfg, delta_bar: float, what_step: str) -> None:
    """Hold a port state after one step to the JAX state after the same step
    (both converted: ``old`` before, ``want`` after) by the delta rule of
    tests/test_torch_train.py: updated G and D by their mean update delta,
    the EMA by its own step where JAX's step is at least 32 float spacings
    of the old EMA value, and every EMA tensor to the EMA of the port's own
    updated G (rtol 1e-6)."""
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

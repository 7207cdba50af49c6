"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py).

The same seeded-numpy inputs and the same (converted) weights go through
the JAX package and its PyTorch port; JAX stays on the CPU.
"""

from __future__ import annotations

import functools

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

"""Port parity of every branch of the train step on the CPU, tiny config
(f32, max_channels 16, 32 px, batch 4): one whole step of
``make_train_step`` per branch against the JAX package's jitted step, from
one converted state (at step 1, so R1 fires, with ``pl_mean`` 0.5), with
JAX's random draws (replayed from its key chain with ``jax.random``)
handed to the port.

Branches: the path-length and direct-gradient regularizers, the embedding
regularizer, shuffled-condition negatives, instance noise, and ``n_critic = 0.5`` (two G updates, a fresh instance-noise draw each)
with instance noise; crop / flip batches and the regularizers beside the
interpolation loss are in tests/test_torch_train_branches_interp_aug.py.
The harness (draws, batches, the comparison) is in
tests/torch_port_common.py.

The embedding regularizer's case starts from mapping biases set off zero:
at the zero-initialised biases JAX's ``jnp.linalg.norm`` has a NaN
gradient, which the JAX step writes into the biases, while the port (as
torch's norm, and the original PyTorch code) takes the zero subgradient
(``test_embedding_reg_at_zero_biases``).

Bars: metrics rtol 1e-4 where the conditions are given, rtol 2e-3 where
both packages render them (floor quantization may flip a pixel by one
8-bit step where the two renders straddle a bin edge); ``pl_mean`` rtol
1e-4; updated parameters and EMA by the delta rule of
tests/test_torch_train.py (1e-2, or 5e-2 with the render)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_tpu.flame.resources import synthetic_flame_resources as j_synth
from gif_tpu.train import get_config as j_get_config
from gif_tpu.train.step import make_train_step as j_make_train_step
from gif_tpu_torch.flame.resources import synthetic_flame_resources
from gif_tpu_torch.train.config import get_config
from gif_tpu_torch.train.state import create_train_state
from gif_tpu_torch.train.step import make_train_step
from torch_port_common import (
    BRANCH_B as B,
    JaxBranchSteps,
    branch_batch,
    branch_overrides,
    check_branch_step,
    port_state,
    train_batch,
)

S = 32
RES_T = synthetic_flame_resources(seed=1, n_vertices=503)

# name: (run id, overrides, augmentation keys, fuse_interp)
CASES = {
    "path_len_reg": (8, dict(gen_reg_type="path_len_reg"), (), True),
    "direct_grad_reg": (8, dict(gen_reg_type="direct_grad_reg"), (), True),
    "embedding_reg": (8, dict(embedding_reg_weight=0.01), (), True),
    "shuffled_negatives": (8, dict(shfld_cond_as_neg_smpl=True), (), True),
    "instance_noise": (8, dict(d_input_noise_std=0.1), (), True),
    "n_critic_half_instance_noise": (8, dict(n_critic=0.5, d_input_noise_std=0.1), (), True),
}


@pytest.fixture(scope="module")
def jax_step():
    return JaxBranchSteps(CASES)


@pytest.mark.parametrize("case", list(CASES))
def test_branch_step_matches_jax(jax_step, case):
    check_branch_step(jax_step, case, RES_T)


def _port_step(cfg, draws=None, generator=None):
    """One port step from a seeded fresh state: (metrics, state)."""
    state = create_train_state(cfg, seed=0, device="cpu")
    state.step = 1
    step = make_train_step(cfg, RES_T, device="cpu", max_tris_per_tile=RES_T.n_faces, generator=generator)
    batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg, B).items()}
    return step(state, batch, draws)[::-1]


def test_zero_instance_noise_is_the_plain_step_bit_for_bit():
    """``d_input_noise_std == 0`` adds nothing and draws nothing: given noise
    draws, it steps exactly as the default config without them, and the
    step's generator is left untouched; std 0.1 with all-zero noise draws
    steps exactly so too (the noise enters only as ``x + noise * std``)."""
    plain_cfg = get_config(8, **branch_overrides(8, {}))
    assert plain_cfg.d_input_noise_std == 0.0
    m0, s0 = _port_step(plain_cfg)
    rng = torch.Generator().manual_seed(3)
    before = rng.get_state()
    noise = {"noise_real": np.ones((B, S, S, 3), np.float32), "noise_fake": np.ones((B, S, S, 3), np.float32),
             "noise_g": np.ones((1, B, S, S, 3), np.float32)}
    m1, s1 = _port_step(get_config(8, **branch_overrides(8, dict(d_input_noise_std=0.0))), noise, rng)
    assert torch.equal(rng.get_state(), before)
    zeros = {k: np.zeros_like(v) for k, v in noise.items()}
    m2, s2 = _port_step(get_config(8, **branch_overrides(8, dict(d_input_noise_std=0.1))), zeros)
    for m, s in ((m1, s1), (m2, s2)):
        assert all(torch.equal(m[k], m0[k]) for k in m0)
        for key in ("generator", "discriminator", "g_ema"):
            for a, b in zip(getattr(s, key).parameters(), getattr(s0, key).parameters()):
                assert torch.equal(a, b)


def test_embedding_reg_at_zero_biases(jax_step):
    """At the zero-initialised mapping biases the embedding regularizer's
    norm has no gradient: JAX's step writes NaN into the biases (the norm's
    0 / 0), the port takes the zero subgradient, so its biases move by the
    adversarial gradient alone and stay finite."""
    cfg = get_config(8, **branch_overrides(8, dict(embedding_reg_weight=0.01)))
    jcfg = j_get_config(8, **branch_overrides(8, dict(embedding_reg_weight=0.01)))
    jprev = jax_step("embedding_reg")[0]
    jprev = jprev.replace(g_params={**jprev.g_params, "mapping": jax.tree_util.tree_map(
        lambda x: jnp.zeros_like(x) if x.ndim == 1 else x, jprev.g_params["mapping"])})
    step = j_make_train_step(jcfg, j_synth(seed=1, n_vertices=503), max_tris_per_tile=RES_T.n_faces)
    batch = branch_batch(cfg, ())
    jnew, _ = step(jprev, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
    assert np.isnan(np.asarray(jnew.g_params["mapping"]["dense0"]["bias"])).all()
    state = port_state(cfg, jprev)
    state, m = make_train_step(cfg, RES_T, device="cpu", max_tris_per_tile=RES_T.n_faces)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, jax_step("embedding_reg")[3])
    assert all(torch.isfinite(p).all() for p in state.generator.parameters())
    assert torch.isfinite(m["g_total"]) and m["g_total"].item() > m["g_loss"].item()


def test_pl_mean_holds_on_steps_that_skip_g():
    """With ``n_critic = 2`` G trains on odd steps only: ``pl_mean`` stays
    put on the step that skips G and moves on the next."""
    cfg = get_config(8, **branch_overrides(8, dict(gen_reg_type="path_len_reg", n_critic=2.0)))
    state = create_train_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, RES_T, device="cpu", generator=torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg, B).items()}
    state.pl_mean = torch.tensor(0.5)
    state, m = step(state, batch)
    assert m["g_total"].item() == 0.0 and state.pl_mean.item() == 0.5
    state, m = step(state, batch)
    assert m["g_total"].item() > m["g_loss"].item() > 0 and state.pl_mean.item() != 0.5

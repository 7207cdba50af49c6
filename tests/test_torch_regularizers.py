"""Port parity of the train step's regularizers and augmentation on the CPU
(f32): the path-length and direct-gradient penalties with their G
parameter gradients (a second-order pass through the tiny generator),
against ``jax.grad`` of the JAX package's formulas on the same converted
weights, inputs and noise (rtol 1e-4 for values, gradients rtol 1e-3 with
an absolute floor of 1e-4 of the tensor's largest entry: a double backward
sums in another order than XLA's); the derangement, the L2 parameter norm,
``wgan_gp_loss`` and ``disentanglement_penalty``; and the torch crop twin
for every shift in [-10, 10] at 32 px, with the crop-then-flip order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_tpu.data import augment as ja
from gif_tpu.train import losses as jl
from gif_tpu.train.state import build_models
from gif_tpu.train.step import apply_condition_augment as j_apply_condition_augment
from gif_tpu_torch.data import augment as ta
from gif_tpu_torch.device import second_order_safe
from gif_tpu_torch.models.generator import StyledGenerator
from gif_tpu_torch.tools.convert_params import convert_generator_params
from gif_tpu_torch.train import losses as tl
from gif_tpu_torch.train.config import get_config
from gif_tpu_torch.train.step import apply_condition_augment
from torch_port_common import jax_generator_params, tiny_overrides

B = 3


def _generators():
    jcfg, params, buffers = jax_generator_params()
    gen = StyledGenerator.from_config(get_config(8, **tiny_overrides()))
    gen.load_state_dict(convert_generator_params(params, buffers))
    jgen, _ = build_models(jcfg)
    return jcfg, jgen, params, buffers, gen


def _cond(seed=0, s=32):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (B, s, s, 6)).astype(np.float32)


def _param_grads(gen, loss):
    names, params = zip(*gen.named_parameters())
    with second_order_safe(torch.device("cpu")):
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
    return dict(zip(names, grads))


def _check_grads(got: dict, want_tree, buffers):
    want = convert_generator_params(want_tree, buffers)
    n_checked = 0
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-4 * np.abs(w).max() + 1e-30, err_msg=name)
        n_checked += bool(np.any(w))
    assert n_checked > len(got) // 2


def test_path_length_penalty_matches_jax():
    """Penalty, new running mean and the G parameter gradient of the
    penalty (through ``new_pl_mean`` too, as JAX differentiates it)."""
    jcfg, jgen, params, buffers, gen = _generators()
    cond = _cond()
    rng = np.random.default_rng(1)
    z = rng.standard_normal((B, 512)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (B, 32, 32, 3)))
    pl_mean = 0.25

    def j_loss(p):
        def g_z(zz):
            return jgen.apply({"params": p, "buffers": buffers}, jnp.asarray(cond), z=zz, step=jcfg.max_step)

        return jl.path_length_penalty(g_z, jnp.asarray(z), jnp.float32(pl_mean), rng=key)

    (want_pen, want_mean), want_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params)
    pen, new_mean = tl.path_length_penalty(
        lambda zz: gen(torch.from_numpy(cond), z=zz, step=jcfg.max_step), torch.from_numpy(z),
        torch.tensor(pl_mean), noise=noise,
    )
    assert new_mean.requires_grad  # not detached: the gradient reaches G through it too
    np.testing.assert_allclose(pen.item(), float(want_pen), rtol=1e-4)
    np.testing.assert_allclose(new_mean.item(), float(want_mean), rtol=1e-5)
    assert pen.item() > 0 and new_mean.item() != pl_mean
    _check_grads(_param_grads(gen, pen), want_grads, buffers)


def test_direct_grad_penalty_matches_jax():
    """The penalty (JAX's inline form in ``step.py:458-469``, unweighted) and
    its G parameter gradient."""
    jcfg, jgen, params, buffers, gen = _generators()
    cond = _cond(2)
    idx = np.array([1, 7, 12], np.int32)

    def j_loss(p):
        def img_pow_sum(c):
            out = jgen.apply({"params": p, "buffers": buffers}, c, input_indices=jnp.asarray(idx),
                             step=jcfg.max_step)
            return jnp.sum(out**2)

        g_c = jax.grad(img_pow_sum)(jnp.asarray(cond))
        return jnp.sum(g_c.reshape(g_c.shape[0], -1) ** 2, axis=1).mean()

    want, want_grads = jax.jit(jax.value_and_grad(j_loss))(params)
    pen = tl.direct_grad_penalty(
        lambda c: gen(c, input_indices=torch.from_numpy(idx), step=jcfg.max_step), torch.from_numpy(cond))
    np.testing.assert_allclose(pen.item(), float(want), rtol=1e-4)
    _check_grads(_param_grads(gen, pen), want_grads, buffers)


def test_derangement_indices_match_jax():
    for n in (2, 3, 4, 16):
        for k in range(6):
            key = jax.random.PRNGKey(k)
            want = np.asarray(jl.derangement_indices(key, n))
            shift = int(jax.random.randint(key, (), 1, n))
            got = tl.derangement_indices(n, shift).numpy()
            np.testing.assert_array_equal(got, want)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        perm = tl.derangement_indices(5, generator=gen).numpy()
        assert sorted(perm) == list(range(5)) and not np.any(perm == np.arange(5))
    for bad in (0, 1):
        with pytest.raises(ValueError, match="n >= 2"):
            tl.derangement_indices(bad)
        with pytest.raises(ValueError, match="n >= 2"):
            jl.derangement_indices(jax.random.PRNGKey(0), bad)
    with pytest.raises(ValueError, match="shift"):
        tl.derangement_indices(4, 4)


def test_l2_param_norm_and_wgan_gp_loss_match_jax():
    _, _, params, buffers, gen = _generators()
    want = jl.l2_param_norm(params["mapping"])
    got = tl.l2_param_norm(gen.mapping.parameters())
    # Sums of 2^18 squares in f32, in another order: ~2e-6 apart.
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    p = np.random.default_rng(3).standard_normal((5, 1)).astype(np.float32) * 30
    np.testing.assert_allclose(tl.wgan_gp_loss(torch.from_numpy(p)).numpy(),
                               np.asarray(jl.wgan_gp_loss(jnp.asarray(p))), rtol=1e-6)


def test_disentanglement_penalty_matches_jax():
    """A five-column scorer of (image, FLAME) that mixes both, the same
    weights in both packages: per-sample penalties and their gradient with
    respect to the scorer's weight (second order)."""
    rng = np.random.default_rng(4)
    img = rng.standard_normal((B, 4, 4, 3)).astype(np.float32)
    flame = rng.standard_normal((B, 236)).astype(np.float32) * 0.3
    w_f = rng.standard_normal((236, 8)).astype(np.float32) * 0.2
    w_i = rng.standard_normal((48, 8)).astype(np.float32) * 0.2
    w_o = rng.standard_normal((8, 5)).astype(np.float32)

    def j_apply(p, image, f):
        return jnp.tanh(f @ p + image.reshape(B, -1) @ w_i) @ w_o

    def j_total(p):
        return jl.disentanglement_penalty(j_apply, p, jnp.asarray(img), jnp.asarray(flame)).sum()

    want = jl.disentanglement_penalty(j_apply, jnp.asarray(w_f), jnp.asarray(img), jnp.asarray(flame))
    want_grad = jax.grad(j_total)(jnp.asarray(w_f))
    wt = torch.from_numpy(w_f).requires_grad_(True)

    def t_apply(image, f):
        return torch.tanh(f @ wt + image.reshape(B, -1) @ torch.from_numpy(w_i)) @ torch.from_numpy(w_o)

    got = tl.disentanglement_penalty(t_apply, torch.from_numpy(img), torch.from_numpy(flame))
    (got_grad,) = torch.autograd.grad(got.sum(), wt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(want_grad)).max())


@pytest.mark.parametrize("shift", range(-10, 11))
def test_same_padding_crop_twin_matches_jax(shift):
    """Rows shifted by ``shift`` with columns by ``-shift``, and both by
    ``shift``: the torch twin equals JAX's ``same_padding_crop_jax`` and both
    packages' numpy ``same_padding_crop`` exactly."""
    rng = np.random.default_rng(shift + 10)
    x = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    crops = np.array([[shift, -shift], [shift, shift]], np.int32)
    got = ta.same_padding_crop_torch(torch.from_numpy(x), torch.from_numpy(crops)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ja.same_padding_crop_jax(jnp.asarray(x), jnp.asarray(crops))))
    for i, (r, c) in enumerate(crops):
        np.testing.assert_array_equal(got[i], ta.same_padding_crop(x[i], r, c))
        np.testing.assert_array_equal(got[i], ja.same_padding_crop(x[i], r, c))
    if shift > 0:  # the reference's fill: the original row n - c, not n - 1
        np.testing.assert_array_equal(got[1, 32 - shift:, 32 - shift:], np.broadcast_to(
            x[1, 32 - shift, 32 - shift], (shift, shift, 4)))


def test_condition_augment_crops_then_flips_as_jax():
    rng = np.random.default_rng(9)
    cond = rng.standard_normal((4, 32, 32, 6)).astype(np.float32)
    batch = {"crop": np.array([[3, -5], [-2, 7], [0, 0], [10, -10]], np.int32),
             "flip": np.array([True, False, True, True])}
    got = apply_condition_augment(torch.from_numpy(cond), {k: torch.from_numpy(v) for k, v in batch.items()})
    want = j_apply_condition_augment(jnp.asarray(cond), {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flipped_first = ta.same_padding_crop_torch(torch.from_numpy(cond[:, :, ::-1].copy()),
                                               torch.from_numpy(batch["crop"]))
    assert not torch.equal(got[0], flipped_first[0])  # the two orders differ
    assert ta.FLIPPED_LABEL_SENTINEL == ja.FLIPPED_LABEL_SENTINEL

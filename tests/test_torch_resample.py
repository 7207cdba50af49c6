"""The port's resampling modes against the JAX package's, on the CPU.

``GIF_TPU_TORCH_RESAMPLE`` (the port) and ``GIF_TPU_RESAMPLE`` (JAX) set to
the same mode: the tiny generator's images and its gradients (with respect
to the condition maps and every parameter), and the tiny discriminator's
scores and gradients (image and parameters), under ``even`` and ``phase``,
from one set of converted weights — images at the generator's bars (rtol
1e-4 / atol 1e-5), each gradient within 1e-4 of its largest value (f32,
sums in another order).  In the port ``even`` equals ``legacy`` bit for
bit, as in JAX (one provably-zero row and column traded for a blur pad).
``ops.fused_resample`` against ``gif_tpu.ops.fused_resample`` on the cases
of tests/test_fused_resample.py: outputs rtol 1e-5 / atol 2e-5, gradients
rtol 1e-5 / atol 3e-5 (those tests' own bars).  JAX runs un-jitted here or
under a fresh ``jax.jit``: it reads its mode while tracing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_tpu import ops as jops
from gif_tpu.ops import fused_resample as jfr
from gif_tpu.train.state import build_models
from gif_tpu_torch import ops
from gif_tpu_torch.models.discriminator import Discriminator
from gif_tpu_torch.models.generator import StyledGenerator
from gif_tpu_torch.ops import fused_resample as fr
from gif_tpu_torch.tools.convert_params import convert_discriminator_params, convert_generator_params
from gif_tpu_torch.train.config import get_config
from torch_port_common import cpu_threads, jax_discriminator_params, jax_generator_params, tiny_overrides


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # Six test processes share the machine under tier-1: cap each one's
    # thread pools (torch_port_common.cpu_threads).
    with cpu_threads():
        yield


@pytest.fixture
def set_mode(monkeypatch):
    def set_(mode):
        monkeypatch.setenv("GIF_TPU_RESAMPLE", mode)
        monkeypatch.setenv("GIF_TPU_TORCH_RESAMPLE", mode)

    return set_


def _close(got: torch.Tensor, want, what: str, rel: float = 1e-4):
    want = torch.from_numpy(np.array(want))
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item() + 1e-7, (what, err, want.abs().max().item())


def _generator():
    jcfg, params, buffers = jax_generator_params()
    cfg = get_config(8, **tiny_overrides())
    gen = StyledGenerator.from_config(cfg)
    gen.load_state_dict(convert_generator_params(params, buffers))
    return jcfg, params, buffers, cfg, gen


def _g_inputs(cfg):
    rng = np.random.default_rng(3)
    size = 4 * 2**cfg.max_step
    cond = rng.uniform(-1, 1, (2, size, size, cfg.cond_channels)).astype(np.float32)
    proj = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    return cond, np.array([1, 7], np.int32), proj


def _port_generator(gen, cfg, cond, idx, proj):
    ct = torch.from_numpy(cond).requires_grad_(True)
    gen.zero_grad(set_to_none=True)
    out = gen(ct, input_indices=torch.from_numpy(idx), step=cfg.max_step)
    (out * torch.from_numpy(proj)).sum().backward()
    return out.detach(), ct.grad, {k: p.grad for k, p in gen.named_parameters()}


@pytest.mark.parametrize("mode", ["even", "phase"])
def test_generator_modes_match_jax(set_mode, mode):
    jcfg, params, buffers, cfg, gen = _generator()
    jgen, _ = build_models(jcfg)
    cond, idx, proj = _g_inputs(cfg)
    set_mode(mode)

    def loss(p, c):
        out = jgen.apply({"params": p, "buffers": buffers}, c, input_indices=jnp.asarray(idx), step=cfg.max_step)
        return jnp.sum(out * proj), out

    (_, want), (gp, gc) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(cond))
    out, g_cond, g_params = _port_generator(gen, cfg, cond, idx, proj)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    _close(g_cond, gc, "cond")
    want_g = convert_generator_params(gp, buffers)
    assert set(g_params) <= set(want_g)
    for k, g in g_params.items():
        _close(g, want_g[k], k)


def test_generator_even_mode_is_bitwise_legacy(set_mode):
    """With PyTorch's native CPU convolution: oneDNN's transposed conv sums
    in an order that depends on the output size (7e-7 of 3.2 apart)."""
    _, _, _, cfg, gen = _generator()
    cond, idx, proj = _g_inputs(cfg)
    with torch.backends.mkldnn.flags(enabled=False):
        set_mode("legacy")
        legacy = _port_generator(gen, cfg, cond, idx, proj)
        set_mode("even")
        even = _port_generator(gen, cfg, cond, idx, proj)
    assert torch.equal(legacy[0], even[0]) and torch.equal(legacy[1], even[1])
    assert all(torch.equal(legacy[2][k], even[2][k]) for k in legacy[2])


@pytest.mark.parametrize("mode", ["even", "phase"])
def test_discriminator_modes_match_jax(set_mode, mode):
    jcfg, params = jax_discriminator_params()
    _, jdisc = build_models(jcfg)
    disc = Discriminator.from_config(get_config(8, **tiny_overrides()))
    disc.load_state_dict(convert_discriminator_params(params))
    rng = np.random.default_rng(4)
    real = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    cond = rng.uniform(-1, 1, (4, 32, 32, 6)).astype(np.float32)
    set_mode(mode)

    def loss(p, img):
        s = jdisc.apply({"params": p}, img, jnp.asarray(cond))
        return jnp.sum(s * jnp.arange(1.0, 5.0)[:, None]), s

    (_, want), (gp, gi) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(real))
    rt = torch.from_numpy(real).requires_grad_(True)
    scores = disc(rt, torch.from_numpy(cond))
    (scores * torch.arange(1.0, 5.0)[:, None]).sum().backward()
    np.testing.assert_allclose(scores.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    _close(rt.grad, gi, "image")
    want_g = convert_discriminator_params(gp)
    for k, p in disc.named_parameters():
        _close(p.grad, want_g[k], k)


def test_resample_mode_and_even_extended_pad_match_jax(set_mode):
    for mode in ("legacy", "even", "phase"):
        set_mode(mode)
        assert ops.resample_mode() == mode
        for h in (7, 8, 9, 16, 255, 256):
            for pads, k in (((2, 2), 3), ((1, 1), 1), ((1, 2), 3)):
                assert ops.even_extended_pad(h, *pads, 4, k) == jops.even_extended_pad(h, *pads, 4, k)
    set_mode("phase ")
    with pytest.raises(ValueError):
        ops.resample_mode()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("h", [4, 8, 14])
@pytest.mark.parametrize("ci,co", [(3, 5), (8, 4)])
def test_fused_upsample_conv_matches_jax(h, ci, co):
    rng = np.random.default_rng(h * 100 + ci)
    x = rng.standard_normal((2, h, h, ci)).astype(np.float32)
    w = rng.standard_normal((3, 3, ci, co)).astype(np.float32)
    want = jfr.upsample_conv_2x(jnp.asarray(x), jnp.asarray(w))
    got = fr.upsample_conv_2x(_nchw(x), _oihw(w))
    assert got.shape == (2, co, 2 * h, 2 * h)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("h", [8, 14])
def test_fused_downsample_conv_matches_jax(k, h):
    rng = np.random.default_rng(k * 10 + h)
    x = rng.standard_normal((2, h, h, 6)).astype(np.float32)
    w = rng.standard_normal((k, k, 6, 5)).astype(np.float32)
    want = jfr.downsample_conv_2x(jnp.asarray(x), jnp.asarray(w))
    got = fr.downsample_conv_2x(_nchw(x), _oihw(w))
    assert got.shape == (2, 5, h // 2, h // 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
    np.testing.assert_array_equal(fr._down_basis(k, (1, 3, 3, 1)), jfr._down_basis(k, (1, 3, 3, 1)))


@pytest.mark.parametrize("which", ["up", "down"])
def test_fused_resample_gradients_match_jax(which):
    rng = np.random.default_rng(0 if which == "up" else 1)
    h = 6 if which == "up" else 8
    x = rng.standard_normal((2, h, h, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 3)).astype(np.float32)
    jf, tf = (jfr.upsample_conv_2x, fr.upsample_conv_2x) if which == "up" else (jfr.downsample_conv_2x,
                                                                                 fr.downsample_conv_2x)
    gx, gw = jax.grad(lambda a, b: jnp.sum(jnp.sin(jf(a, b))), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _nchw(x).requires_grad_(True), _oihw(w).requires_grad_(True)
    torch.sin(tf(xt, wt)).sum().backward()
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx), atol=3e-5, rtol=1e-5)
    np.testing.assert_allclose(wt.grad.permute(2, 3, 1, 0).numpy(), np.asarray(gw), atol=3e-5, rtol=1e-5)
    if which == "up":
        np.testing.assert_array_equal(fr._up_basis((1, 3, 3, 1)), jfr._up_basis((1, 3, 3, 1)))

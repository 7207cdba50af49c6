"""Port parity of the generator: the converted JAX weights load into the
port's StyledGenerator key for key, and its forward at f32 matches the JAX
generator's (rtol 1e-4 / atol 1e-5); the port's own seeded initialisation
follows the reference's distributions."""

import jax.numpy as jnp
import numpy as np
import torch

from gif_tpu.train.state import build_models
from gif_tpu_torch.models.generator import StyledGenerator, synthesis_channels
from gif_tpu_torch.tools.convert_params import convert_generator_params
from gif_tpu_torch.train.config import get_config
from torch_port_common import jax_generator_params, tiny_overrides


def _ported():
    jcfg, params, buffers = jax_generator_params()
    cfg = get_config(8, **tiny_overrides())
    gen = StyledGenerator.from_config(cfg)
    gen.load_state_dict(convert_generator_params(params, buffers))
    return jcfg, params, buffers, cfg, gen.eval()


def test_converted_params_fit_the_port_exactly():
    _, params, buffers = jax_generator_params()
    sd = convert_generator_params(params, buffers)
    gen = StyledGenerator.from_config(get_config(8, **tiny_overrides()))
    want = {k: tuple(v.shape) for k, v in gen.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    np.testing.assert_array_equal(sd["embedding"].numpy(), np.asarray(buffers["embedding"]))
    w = np.asarray(params["synthesis"]["block1"]["conv1"]["noise"]["conv0"]["kernel"])
    np.testing.assert_array_equal(sd["synthesis.block1.conv1.noise.conv0.weight"].numpy(), w.transpose(3, 2, 0, 1))


def test_generator_forward_matches_jax():
    jcfg, params, buffers, cfg, gen = _ported()
    jgen, _ = build_models(jcfg)
    rng = np.random.default_rng(0)
    size = 4 * 2**cfg.max_step
    cond = rng.uniform(-1, 1, size=(3, size, size, cfg.cond_channels)).astype(np.float32)
    idx = np.array([0, 5, 15], np.int32)
    want = jgen.apply(
        {"params": params, "buffers": buffers}, jnp.asarray(cond),
        input_indices=jnp.asarray(idx), step=cfg.max_step,
    )
    with torch.inference_mode():
        got = gen(torch.from_numpy(cond), input_indices=torch.from_numpy(idx), step=cfg.max_step)
    assert got.shape == (3, size, size, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)

    z = rng.standard_normal((3, 512)).astype(np.float32)
    want_z = jgen.apply({"params": params, "buffers": buffers}, jnp.asarray(cond), z=jnp.asarray(z),
                        step=cfg.max_step)
    with torch.inference_mode():
        got_z = gen(torch.from_numpy(cond), z=torch.from_numpy(z), step=cfg.max_step)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), rtol=1e-4, atol=1e-5)


def test_truncated_generator_matches_jax():
    jcfg, params, buffers, cfg, gen = _ported()
    jgen, _ = build_models(jcfg, w_truncation_factor=0.7)
    tgen = StyledGenerator.from_config(cfg, w_truncation_factor=0.7)
    tgen.load_state_dict(gen.state_dict())
    variables = {"params": params, "buffers": buffers}
    mean_j = jgen.apply(variables, method=lambda m: m.mean_latent())
    cond = np.random.default_rng(1).uniform(-1, 1, size=(2, 32, 32, 6)).astype(np.float32)
    want = jgen.apply(variables, jnp.asarray(cond), input_indices=jnp.asarray([1, 2]),
                      step=cfg.max_step, mean_w=mean_j)
    with torch.inference_mode():
        mean_t = tgen.mean_latent()
        got = tgen(torch.from_numpy(cond), input_indices=torch.tensor([1, 2]), step=cfg.max_step,
                   mean_w=mean_t)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_seeded_init_follows_reference_distributions():
    cfg = get_config(8, **tiny_overrides(embedding_vocab_size=4096))
    a = StyledGenerator.from_config(cfg, seed=3).state_dict()
    b = StyledGenerator.from_config(cfg, seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert synthesis_channels(2, 512) == [512, 512, 512, 512, 512, 256, 128, 64, 32]
    assert abs(a["embedding"].std().item() - 1.0) < 0.01
    assert abs(a["mapping.dense0.weight"].std().item() - 100.0) < 5.0  # 1 / lr_mul
    assert torch.all(a["synthesis.block1.conv1.conv.modulation.bias"] == 1.0)
    assert abs(a["synthesis.block1.conv1.noise.conv0.weight"].std().item() - 0.01) < 0.003
    assert torch.allclose(a["synthesis.block1.conv1.noise.conv2.bias"], torch.tensor(1e-4))
    assert torch.all(a["synthesis.block1.conv1.act_bias"] == 0.0)

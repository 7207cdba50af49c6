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


def _g_outputs_jax(compute_dtype, cond, idx, r):
    """(image, gradient of sum(image * r) by port parameter name) of the
    JAX generator at ``compute_dtype`` on the tiny f32 weights."""
    import dataclasses

    import jax

    jcfg, params, buffers = jax_generator_params()
    jgen, _ = build_models(dataclasses.replace(jcfg, compute_dtype=compute_dtype))

    def out(p):
        return jgen.apply({"params": p, "buffers": buffers}, jnp.asarray(cond),
                          input_indices=jnp.asarray(idx), step=jcfg.max_step)

    img = out(params)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(out(p) * jnp.asarray(r))))(params)
    named = {k: v.numpy() for k, v in convert_generator_params(grads, buffers).items() if k != "embedding"}
    return np.asarray(img), named


def _g_outputs_port(gen, cond, idx, r):
    img = gen(torch.from_numpy(cond), input_indices=torch.from_numpy(idx), step=gen.synthesis.max_step)
    names, params = zip(*gen.named_parameters())
    grads = torch.autograd.grad((img * torch.from_numpy(r)).sum(), params)
    return img.detach().numpy(), {n: g.numpy() for n, g in zip(names, grads)}


def test_generator_bf16_policy_is_as_close_to_f32_as_jax():
    """Under the bf16 policy (convs in bf16, the rest f32) both packages land
    near the f32 answer, rounding bf16 at other places.  The port's error
    against its f32 generator (held to JAX's at 1e-4 above) must stay within
    1.5x the JAX package's (+1e-3) for the image and for the whole gradient
    of a fixed projection of it; and each weight's gradient must point the
    JAX one's way (cosine >= 0.98)."""
    _, params, buffers, cfg, gen32 = _ported()
    gen16 = StyledGenerator.from_config(get_config(8, **tiny_overrides(compute_dtype="bfloat16")))
    gen16.load_state_dict(gen32.state_dict())
    rng = np.random.default_rng(2)
    size = 4 * 2**cfg.max_step
    cond = rng.uniform(-1, 1, size=(3, size, size, cfg.cond_channels)).astype(np.float32)
    idx = np.array([2, 9, 14], np.int32)
    r = rng.standard_normal((3, size, size, 3)).astype(np.float32)
    ref = _g_outputs_port(gen32, cond, idx, r)
    got = _g_outputs_port(gen16, cond, idx, r)
    want = _g_outputs_jax("bfloat16", cond, idx, r)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    def flat(named):
        return np.concatenate([named[k].ravel() for k in sorted(named)])

    assert rel(want[0], ref[0]) > 0  # bf16 rounds somewhere in JAX too
    assert rel(got[0], ref[0]) <= 1.5 * rel(want[0], ref[0]) + 1e-3
    assert rel(flat(got[1]), flat(ref[1])) <= 1.5 * rel(flat(want[1]), flat(ref[1])) + 1e-3
    for name, w in want[1].items():
        g = got[1][name]
        if w.ndim >= 2 and np.any(w):
            cos = np.dot(g.ravel(), w.ravel()) / np.linalg.norm(g) / np.linalg.norm(w)
            assert cos >= 0.98, (name, cos)

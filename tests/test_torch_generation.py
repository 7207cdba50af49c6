"""Port parity of the generation path's library pieces: style mixing in G
(the crossover walk over ``inject_index`` with 2 and 3 styles, and a
``mixing_range``) at the generator's bars (rtol 1e-4 / atol 1e-5), with
the same errors as JAX; and ``load_generator_params`` from a port run
checkpoint and from a trees pickle, whose sampler images match the JAX
sampler's from the same pickle (the sampler bars of
tests/test_torch_sampling.py)."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_tpu.eval.sampling import FlameSampler as JFlameSampler
from gif_tpu.eval.sampling import load_generator_params as j_load_generator_params
from gif_tpu.flame.resources import synthetic_flame_resources as j_synth
from gif_tpu.train.state import build_models
from gif_tpu_torch.eval.sampling import FlameSampler, load_generator_params, random_flame_params
from gif_tpu_torch.flame.resources import synthetic_flame_resources
from gif_tpu_torch.models.generator import StyledGenerator
from gif_tpu_torch.tools.convert_params import convert_generator_params, train_state_trees
from gif_tpu_torch.train.checkpoint import CheckpointManager
from gif_tpu_torch.train.config import get_config
from gif_tpu_torch.train.state import create_train_state
from torch_port_common import jax_generator_params, tiny_overrides

RTOL, ATOL = 1e-4, 1e-5  # the generator's parity bars (tests/test_torch_generator.py)


@pytest.fixture(scope="module")
def generators():
    jcfg, params, buffers = jax_generator_params()
    cfg = get_config(8, **tiny_overrides())
    gen = StyledGenerator.from_config(cfg)
    gen.load_state_dict(convert_generator_params(params, buffers))
    jgen, _ = build_models(jcfg)
    return jgen, {"params": params, "buffers": buffers}, gen.eval(), cfg


def _inputs(cfg, n_styles, seed=0):
    rng = np.random.default_rng(seed)
    size = 4 * 2**cfg.max_step
    cond = rng.uniform(-1, 1, size=(3, size, size, cfg.cond_channels)).astype(np.float32)
    zs = [rng.standard_normal((3, 512)).astype(np.float32) for _ in range(n_styles)]
    return cond, zs


@pytest.mark.parametrize(
    "n_styles,inject_index,mixing_range",
    [
        (2, [1], (-1, -1)),  # blocks 0-1 style 0, blocks 2-3 style 1
        (2, [0], (-1, -1)),
        (3, [0, 2], (-1, -1)),  # block 0 style 0, 1-2 style 1, 3 style 2
        (2, None, (1, 2)),  # blocks 1-2 style 1, the rest style 0
        (3, None, (0, 1)),  # a range uses styles 0 and 1 only
    ],
)
def test_style_mixing_matches_jax(generators, n_styles, inject_index, mixing_range):
    jgen, variables, gen, cfg = generators
    cond, zs = _inputs(cfg, n_styles)
    want = jgen.apply(variables, jnp.asarray(cond), z=[jnp.asarray(z) for z in zs], step=cfg.max_step,
                      inject_index=inject_index, mixing_range=mixing_range)
    with torch.inference_mode():
        got = gen(torch.from_numpy(cond), z=[torch.from_numpy(z) for z in zs], step=cfg.max_step,
                  inject_index=inject_index, mixing_range=mixing_range)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # Mixing changed the image: it is not the first style's alone.
    with torch.inference_mode():
        single = gen(torch.from_numpy(cond), z=torch.from_numpy(zs[0]), step=cfg.max_step)
    assert (got - single).abs().max() > 1e-3


def test_one_style_in_a_list_is_the_plain_forward(generators):
    _, _, gen, cfg = generators
    cond, zs = _inputs(cfg, 1)
    with torch.inference_mode():
        a = gen(torch.from_numpy(cond), z=[torch.from_numpy(zs[0])], step=cfg.max_step, inject_index=[5])
        b = gen(torch.from_numpy(cond), z=torch.from_numpy(zs[0]), step=cfg.max_step)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize(
    "n_styles,inject_index,match",
    [(2, None, "inject_index"), (3, [1], "3 styles need 2 injection points"), (2, [0, 1], "need 1 injection")],
)
def test_style_mixing_errors_match_jax(generators, n_styles, inject_index, match):
    jgen, variables, gen, cfg = generators
    cond, zs = _inputs(cfg, n_styles)
    with pytest.raises(ValueError, match=match):
        jgen.apply(variables, jnp.asarray(cond), z=[jnp.asarray(z) for z in zs], step=cfg.max_step,
                   inject_index=inject_index)
    with pytest.raises(ValueError, match=match):
        gen(torch.from_numpy(cond), z=[torch.from_numpy(z) for z in zs], step=cfg.max_step,
            inject_index=inject_index)


@pytest.fixture(scope="module")
def saved_run(tmp_path_factory):
    """A port train state whose EMA holds the JAX generator's weights and
    whose G holds other (seeded) ones, saved by the CheckpointManager and
    written as a trees pickle."""
    _, params, buffers = jax_generator_params()
    cfg = get_config(8, **tiny_overrides())
    state = create_train_state(cfg, seed=3, device="cpu")
    state.g_ema.load_state_dict(convert_generator_params(params, buffers))
    state.step = 7
    tmp = tmp_path_factory.mktemp("run")
    CheckpointManager(str(tmp / "checkpoint")).save(state)
    trees = train_state_trees(state)
    with open(tmp / "trees.pkl", "wb") as f:
        pickle.dump(trees, f)
    return cfg, tmp, trees, state


def test_trees_pickle_round_trips_the_jax_trees(saved_run):
    _, params, buffers = jax_generator_params()
    _, _, trees, state = saved_run
    flat_want = dict(_leaves(params))
    flat_got = dict(_leaves(trees["g_ema_params"]))
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_got[k], np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(trees["buffers"]["embedding"], np.asarray(buffers["embedding"]))
    # The generator and D trees convert back to the port's own weights.
    for name, want in convert_generator_params(trees["g_params"], trees["buffers"]).items():
        torch.testing.assert_close(want, state.generator.state_dict()[name], rtol=0, atol=0)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_load_generator_params_sources(saved_run):
    cfg, tmp, _, state = saved_run
    from_ckpt = load_generator_params(cfg, ckpt=str(tmp / "checkpoint"))
    from_pickle = load_generator_params(cfg, converted_ckpt=str(tmp / "trees.pkl"))
    want = state.g_ema.state_dict()
    assert from_ckpt.keys() == from_pickle.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(from_ckpt[k], want[k], rtol=0, atol=0)
        torch.testing.assert_close(from_pickle[k], want[k], rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        load_generator_params(cfg, ckpt=str(tmp / "no_such_dir"))


def test_loaded_generators_sample_the_jax_samplers_images(saved_run):
    """The port sampler with G from the run checkpoint and from the trees
    pickle against the JAX sampler with ``load_generator_params(
    converted_ckpt=)`` of the same pickle; conditions within one 8-bit
    step on < 0.5% of values, images at the generator's bars where the
    conditions agree (the port G is fed JAX's conditions)."""
    cfg, tmp, _, _ = saved_run
    jcfg, _, _ = jax_generator_params()
    j_params, j_buffers = j_load_generator_params(jcfg, converted_ckpt=str(tmp / "trees.pkl"))
    fl = random_flame_params(np.random.default_rng(4), 5)
    idx = np.array([1, 2, 3, 9, 15])
    j_img, j_cond = JFlameSampler(jcfg, j_synth(seed=1, n_vertices=503), j_params, j_buffers, batch_size=4,
                                  eye_center=False).sample(fl, idx)
    res = synthetic_flame_resources(seed=1, n_vertices=503)
    step = 2.0 / 255.0
    for source in ({"ckpt": str(tmp / "checkpoint")}, {"converted_ckpt": str(tmp / "trees.pkl")}):
        sampler = FlameSampler(cfg, res, load_generator_params(cfg, **source), batch_size=4, eye_center=False,
                               device="cpu")
        t_img, t_cond = sampler.sample(fl, idx)
        diff = np.abs(t_cond - j_cond)
        assert diff.max() <= step * 1.001 and (diff > step * 0.5).mean() < 0.005, source
        with torch.inference_mode():
            g_img = sampler.generator(torch.from_numpy(j_cond), input_indices=torch.from_numpy(idx),
                                      step=cfg.max_step).numpy()
        np.testing.assert_allclose(g_img, j_img, rtol=RTOL, atol=ATOL)
        if diff.max() == 0:
            np.testing.assert_allclose(t_img, j_img, rtol=RTOL, atol=ATOL)

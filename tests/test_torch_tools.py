"""The port's tools against the JAX package's, on the CPU: the reference
``.model`` converter (the same pickle of flax-layout trees, leaf for
leaf), the ``--converted_ckpt`` warm start (the same G forward, rtol 1e-4
/ atol 1e-5 as tests/test_torch_generator.py; optimizers and counters
fresh; a misfit names its leaf), the architecture reports (parameter
counts equal to JAX's ``param_summary``; ``draw`` writes text and HTML)
and the manifest checks (the same errors)."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_tpu.tools import convert_checkpoint as jcc
from gif_tpu.tools import manifest as jman
from gif_tpu.train import get_config as j_get_config
from gif_tpu.train.state import build_models as j_build_models
from gif_tpu.train.state import create_train_state as j_create_train_state
from gif_tpu.train.state import warm_start_from_converted as j_warm_start
from gif_tpu.utils.graph import param_summary as j_param_summary
from gif_tpu_torch.models.discriminator import Discriminator
from gif_tpu_torch.models.generator import StyledGenerator
from gif_tpu_torch.tools import convert_checkpoint as tcc
from gif_tpu_torch.tools import manifest as tman
from gif_tpu_torch.train.config import get_config
from gif_tpu_torch.train.state import create_train_state, warm_start_from_converted
from gif_tpu_torch.utils.graph import draw, param_summary
from test_tools import _fake_discriminator_sd, _fake_generator_sd
from torch_port_common import jax_discriminator_params, jax_generator_params, tiny_overrides


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def test_convert_checkpoint_matches_jax(tmp_path):
    """A synthetic reference checkpoint (32 px G, DataParallel ``module.``
    prefixes on the EMA) through both converters: the same pickled trees."""
    to_t = lambda sd, pre="": {pre + k: torch.from_numpy(v) for k, v in sd.items()}
    ckpt = {
        "generator": to_t(_fake_generator_sd(step=3)),
        "generator_running": to_t(_fake_generator_sd(step=3), "module."),
        "discriminator_flm": to_t(_fake_discriminator_sd(size=32)),
        "g_optimizer": {"state": {}, "param_groups": []},
    }
    model = tmp_path / "ref.model"
    torch.save(ckpt, model)
    jcc.convert_checkpoint(str(model), str(tmp_path / "jax.pkl"), size=32)
    tcc.convert_checkpoint(str(model), str(tmp_path / "port.pkl"), size=32)
    trees = []
    for name in ("jax.pkl", "port.pkl"):
        with open(tmp_path / name, "rb") as f:
            trees.append(pickle.load(f))
    want, got = trees
    assert sorted(got) == sorted(want) == ["buffers", "d_params", "g_ema_params", "g_params"]
    for key in want:
        lw, lg = _leaves(want[key]), _leaves(got[key])
        assert sorted(lg) == sorted(lw), key
        for name, w in lw.items():
            assert lg[name].dtype == w.dtype and lg[name].shape == w.shape, (key, name)
            np.testing.assert_array_equal(lg[name], w, err_msg=f"{key}{name}")


def test_convert_checkpoint_fails_loudly_as_jax(tmp_path):
    sd = {"module.image_embedding.embd_weight": np.zeros((16, 256))}
    with pytest.raises(jman.ManifestError) as want:
        jcc.convert_generator(sd)
    with pytest.raises(tman.ManifestError) as got:
        tcc.convert_generator(sd)
    assert str(got.value) == str(want.value)
    model = tmp_path / "bad.model"
    torch.save({"generator": {}}, model)
    with pytest.raises(tman.ManifestError, match="generator_running"):
        tcc.convert_checkpoint(str(model), str(tmp_path / "out.pkl"))


WARM = dict(embedding_vocab_size=8, max_size=16, init_size=16, render_image_size=16, batch_size=4,
            max_channels=16, nmlp_for_z_to_w=2, compute_dtype="float32")


def test_warm_start_matches_jax(tmp_path):
    jcfg = j_get_config(8, **WARM)
    jstate = j_create_train_state(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    bump = lambda t: jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.standard_normal(np.shape(x)).astype(np.float32) * 0.1, t)
    trees = {k: bump(getattr(jstate, k)) for k in ("g_params", "g_ema_params", "d_params", "buffers")}
    path = tmp_path / "conv.pkl"
    with open(path, "wb") as f:
        pickle.dump(trees, f)
    jout = j_warm_start(jstate, str(path))

    cfg = get_config(8, **WARM)
    state = warm_start_from_converted(create_train_state(cfg, device="cpu"), str(path))
    jgen, jdisc = j_build_models(jcfg)
    cond = rng.uniform(-1, 1, (3, 16, 16, cfg.cond_channels)).astype(np.float32)
    idx = np.array([0, 3, 7], np.int32)
    for params, module in ((jout.g_params, state.generator), (jout.g_ema_params, state.g_ema)):
        want = jgen.apply({"params": params, "buffers": jout.buffers}, jnp.asarray(cond),
                          input_indices=jnp.asarray(idx), step=cfg.max_step)
        with torch.inference_mode():
            got = module(torch.from_numpy(cond), input_indices=torch.from_numpy(idx), step=cfg.max_step)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    img = rng.uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    want = jdisc.apply({"params": jout.d_params}, jnp.asarray(img), jnp.asarray(cond))
    with torch.inference_mode():
        got = state.discriminator(torch.from_numpy(img), torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    # Optimizers fresh, counters zero, the EMA sharing G's embedding.
    assert not state.g_opt.state and not state.d_opt.state
    assert state.step == state.used_samples == 0 and state.pl_mean.item() == 0.0
    assert state.g_ema.embedding is state.generator.embedding

    trees["buffers"] = {"embedding": np.zeros((3, 7), np.float32)}
    with open(path, "wb") as f:
        pickle.dump(trees, f)
    with pytest.raises(ValueError, match="embedding: checkpoint has \\(3, 7\\)"):
        warm_start_from_converted(create_train_state(cfg, device="cpu"), str(path))
    del trees["d_params"]
    with open(path, "wb") as f:
        pickle.dump(trees, f)
    with pytest.raises(ValueError, match="d_params"):
        warm_start_from_converted(create_train_state(cfg, device="cpu"), str(path))


def test_param_summary_matches_jax():
    _, g_params, _ = jax_generator_params()
    _, d_params = jax_discriminator_params()
    cfg = get_config(8, **tiny_overrides())
    for depth in (1, 2, 3):
        assert param_summary(StyledGenerator.from_config(cfg), depth) == j_param_summary(g_params, depth)
        assert param_summary(Discriminator.from_config(cfg), depth) == j_param_summary(d_params, depth)


def test_draw_writes_both_reports(tmp_path):
    cfg = get_config(8, **tiny_overrides())
    s = cfg.max_size
    gen, disc = StyledGenerator.from_config(cfg), Discriminator.from_config(cfg)
    cond = torch.zeros((1, s, s, cfg.cond_channels))
    out = draw(gen, str(tmp_path / "g.txt"), cond, input_indices=torch.zeros((1,), dtype=torch.long),
               step=cfg.max_step)
    draw(disc, str(tmp_path / "d.txt"), torch.zeros((1, s, s, 3)), cond)
    g_text, d_text = (tmp_path / "g.txt").read_text(), (tmp_path / "d.txt").read_text()
    assert out == str(tmp_path / "g.txt")
    assert g_text.startswith(f"StyledGenerator: {sum(p.numel() for p in gen.parameters()):,} parameters")
    assert f"(1, {s}, {s}, 3)" in g_text and "synthesis.block0.conv1" in g_text
    assert "Discriminator" in d_text and "(1, 1)" in d_text
    for name in ("g.html", "d.html"):
        assert (tmp_path / name).read_text().startswith("<html>")


@pytest.mark.parametrize("manifest", [
    {"a": (3, 5), "b": (2,), "c": (1,)},
    {"a": ((9, 9), (None, 4))},
    {"a": (None, None, None)},
])
def test_check_manifest_as_jax(manifest):
    data = {"a": np.zeros((3, 4)), "b": np.zeros((2,))}
    try:
        jman.check_manifest(data, manifest, "artifact")
        want = None
    except jman.ManifestError as e:
        want = str(e)
    if want is None:
        tman.check_manifest(data, manifest, "artifact")
    else:
        with pytest.raises(tman.ManifestError) as got:
            tman.check_manifest(data, manifest, "artifact")
        assert str(got.value) == want


def test_require_keys_as_jax():
    data = {f"k{i}": i for i in range(25)}
    tman.require_keys(data, ["k1", "k2"], "ok")
    with pytest.raises(jman.ManifestError) as want:
        jman.require_keys(data, ["k1", "missing"], "keys artifact")
    with pytest.raises(tman.ManifestError) as got:
        tman.require_keys(data, ["k1", "missing"], "keys artifact")
    assert str(got.value) == str(want.value)
    assert tman.as_np_dict({"x": [1, 2]})["x"].shape == (2,)

"""The port's study and analysis scripts that drive a model
(``python -m gif_tpu_torch.scripts.<name>``: ``mturk_stimuli``,
``voca_animation``, ``show_training_data``, ``compute_fid_for_models``,
``recon_trend``) against their ``scripts/`` counterparts, each run in this
process at the tiny config through the harness of
tests/test_torch_scripts.py (``run_pair``: the port with ``--tiny
--device cpu``; the JAX scripts, which have no ``--tiny``, with
``TINY_OVERRIDES`` through a patched ``get_config``), from one trees
pickle written from a JAX tiny train state, on the FLAME-sized synthetic
mesh.

Tolerances (that file's own):
- keys, ``key.json``, the JSON's keys and the printed lines: equal;
- condition renders before the uint8 cast: within one 8-bit step,
  flipped on < 0.5% of values;
- generated images (every ``FlameSampler.sample`` call, recorded): the
  port's G fed the JAX conditions gives the JAX images at rtol 1e-4 /
  atol 1e-5, and so do the port's own images of samples whose conditions
  flipped no 8-bit step;
- PNGs: within one level;
- ``compute_fid_for_models``: the statistics each package hands the
  Fréchet distance, and the FID values, within 1e-3 of the statistics'
  largest magnitude (tests/test_torch_eval.py's statistics bar); one sigma
  (each 2048-d ``sqrtm`` costs ~11 s here);
- ``recon_trend``: both packages restore the same states (the port's
  checkpoints converted from the JAX states) on the same render dataset
  (JAX's, at 32 px); the MSE rows within 1e-4 relative.
"""

import json
import os

import numpy as np
import pytest

from test_torch_scripts import (  # noqa: F401  (trees_pickle is a fixture)
    VOCAB,
    _check_cond,
    _check_saved,
    _png_levels,
    run_pair,
    trees_pickle,
)
from torch_port_common import cpu_threads

MODEL_ARGS = ("--flame_resources", "synthetic", "--vocab", str(VOCAB))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # Six test processes share the machine under tier-1: cap each one's
    # thread pools (torch_port_common.cpu_threads).
    with cpu_threads():
        yield


@pytest.mark.parametrize("mode", ["association", "comparison"])
def test_mturk_stimuli_matches_jax(mode, trees_pickle, tmp_path, monkeypatch, capsys):
    argv = [mode, *MODEL_ARGS, "--converted_ckpt", trees_pickle, "--n", "6"]
    if mode == "comparison":
        # Model B from its own pickle: a G with other weights.
        b = tmp_path / "b.pkl"
        _scaled_trees(trees_pickle, b, 0.5)
        argv += ["--converted_ckpt_b", str(b)]
    j, t = run_pair("mturk_stimuli", argv, tmp_path, monkeypatch, capsys, jax_tiny=False)
    _check_saved(j, t, tmp_path)
    if mode == "association":
        assert {r for r, _ in t.saved} == {"out/faces", "out/renders"}
        got, want = (json.loads((tmp_path / p / "out" / "key.json").read_text()) for p in ("port", "jax"))
        assert got == want and len(got["is_match"]) == 6
    else:
        assert {r for r, _ in t.saved} == {"out/model_a", "out/model_b"}
        a, b = t.saved[("out/model_a", "s_")], t.saved[("out/model_b", "s_")]
        assert np.abs(a - b).max() > 1e-3  # model B's own weights, not A's
    assert t.stdout == j.stdout


def _scaled_trees(src, dst, factor: float) -> None:
    import pickle

    with open(src, "rb") as f:
        trees = pickle.load(f)

    def scale(tree):
        if isinstance(tree, dict):
            return {k: scale(v) for k, v in tree.items()}
        return np.asarray(tree) * np.asarray(factor, np.asarray(tree).dtype)

    trees["g_ema_params"] = scale(trees["g_ema_params"])
    with open(dst, "wb") as f:
        pickle.dump(trees, f)


def test_voca_animation_frames_and_grid_match_jax(trees_pickle, tmp_path, monkeypatch, capsys):
    from PIL import Image

    argv = ["frames", *MODEL_ARGS, "--converted_ckpt", trees_pickle, "--identities", "1", "4", "--n_frames", "5"]
    j, t = run_pair("voca_animation", argv, tmp_path, monkeypatch, capsys, jax_tiny=False)
    _check_saved(j, t, tmp_path)
    assert {p for _, p in t.saved} == {"mesh_textured_", "mesh_normal_", ""}
    assert t.stdout == j.stdout
    # The display render draws the mesh (constant albedo 0.6, lit).
    tex = t.saved[("out/selected_ids_1", "mesh_textured_")]
    assert tex.max() > 0.1
    j, t = run_pair("voca_animation", ["grid"], tmp_path, monkeypatch, capsys, jax_tiny=False)
    frames = {}
    for pkg in ("jax", "port"):
        with Image.open(tmp_path / pkg / "out" / "voca_selected_ids.gif") as im:
            frames[pkg] = [np.asarray(im.seek(i) or im.convert("RGB")).astype(int) for i in range(im.n_frames)]
    # GIF merges equal neighbouring frames (at 32 px some of the five are).
    assert len(frames["port"]) == len(frames["jax"]) >= 2
    # Two identities and the mesh: one row of 5 cells of 32 px, 4 px apart.
    assert frames["port"][0].shape == (32, 5 * 32 + 4 * 4, 3)
    for a, b in zip(frames["port"], frames["jax"]):
        assert np.abs(a - b).max() <= 1
    assert t.stdout == j.stdout


def test_voca_animation_gt_writes_mesh_frames_only(tmp_path, monkeypatch, capsys):
    argv = ["frames", *MODEL_ARGS, "--gt", "--identities", "2", "--n_frames", "2"]
    j, t = run_pair("voca_animation", argv, tmp_path, monkeypatch, capsys, jax_tiny=False)
    _check_saved(j, t, tmp_path, samples=False)
    assert {p for _, p in t.saved} == {"mesh_textured_", "mesh_normal_"} and not t.samples and not j.samples
    assert t.stdout == j.stdout


def test_voca_sequence_from_npz_equals_jax(tmp_path):
    from gif_tpu_torch.scripts.voca_animation import load_voca_sequence
    from scripts.voca_animation import load_voca_sequence as j_load

    rng = np.random.default_rng(3)
    path = tmp_path / "seq.npz"
    np.savez(path, frame_exp_params=rng.standard_normal((5, 100)), frame_pose_params=rng.standard_normal((5, 15)),
             seq_shape_params=rng.standard_normal(300))
    for p, n in ((str(path), 0), (None, 7)):
        np.testing.assert_array_equal(load_voca_sequence(p, n, 1), j_load(p, n, 1))


def test_show_training_data_matches_jax(tmp_path, monkeypatch, capsys):
    import gif_tpu.data.pipeline as jpipe

    synth = jpipe.SyntheticFlameDataset
    # The JAX script's synthetic frames are 256 px; at the tiny config 32.
    patch_jax = lambda m, root: m.setattr(jpipe, "SyntheticFlameDataset", lambda n, size: synth(n=n, size=32))
    argv = ["--flame_resources", "synthetic", "--batch", "3", "--n_batches", "2"]
    j, t = run_pair("show_training_data", argv, tmp_path, monkeypatch, capsys, jax_tiny=False, patch_jax=patch_jax)
    assert len(t.uint8) == len(j.uint8) == 2
    for got, want in zip(t.uint8, j.uint8):
        assert got.shape == want.shape == (3, 32, 96, 3)
        np.testing.assert_array_equal(got[:, :, :32], want[:, :, :32])  # the real frames
        _check_cond((got[:, :, 32:] + 1) / 2, (want[:, :, 32:] + 1) / 2, "conditions")
    for b in range(2):
        levels = _png_levels(tmp_path / "jax" / "out" / f"batch_{b}.png", tmp_path / "port" / "out" / f"batch_{b}.png")
        assert levels.max() <= 1, b
    assert t.stdout == j.stdout


def test_compute_fid_for_models_matches_jax(trees_pickle, tmp_path, monkeypatch, capsys):
    import gif_tpu.eval.fid as jfid

    import gif_tpu_torch.eval.fid as tfid

    stats = {"jax": [], "port": []}

    def recording(mod, key):
        orig = mod.frechet_distance

        def patch(m, root):
            def frechet(*a):
                stats[key].append([np.asarray(x, np.float64) for x in a])
                return orig(*a)
            m.setattr(mod, "frechet_distance", frechet)
        return patch

    argv = [*MODEL_ARGS, "--converted_ckpt", trees_pickle, "--n_samples", "20", "--sigmas", "1.0"]
    out_args = lambda root: ["--out", os.path.join(root, "fid.json")]
    j, t = run_pair("compute_fid_for_models", argv, tmp_path, monkeypatch, capsys, jax_tiny=False,
                    out_args=out_args, patch_jax=recording(jfid, "jax"), patch_port=recording(tfid, "port"))
    assert len(stats["port"]) == len(stats["jax"]) == 1
    scale = max(np.abs(x).max() for x in stats["jax"][0])
    for got, want in zip(stats["port"][0], stats["jax"][0]):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * scale)
    got, want = (json.loads((tmp_path / p / "fid.json").read_text()) for p in ("port", "jax"))
    assert got["mode"] == want["mode"] == "shape" and got["fid"].keys() == want["fid"].keys() == {"1.0"}
    assert abs(got["fid"]["1.0"] - want["fid"]["1.0"]) <= 1e-3 * scale
    for line in ("random Inception weights", "sigma=0 generations as the reference", "wrote <out>/fid.json"):
        assert line in t.stdout and line in j.stdout


def test_corrupt_flame_draws_as_jax():
    from gif_tpu_torch.scripts.compute_fid_for_models import corrupt_flame
    from scripts.compute_fid_for_models import corrupt_flame as j_corrupt

    base = np.random.default_rng(0).standard_normal((4, 236)).astype(np.float32)
    for mode in ("shape", "exp_jaw", "pose"):
        r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
        for sigma in (0.0, 0.5, 2.0):
            np.testing.assert_array_equal(corrupt_flame(base, sigma, mode, r1), j_corrupt(base, sigma, mode, r2))
    with pytest.raises(ValueError):
        corrupt_flame(base, 1.0, "light", np.random.default_rng(0))


def test_recon_trend_matches_jax(tmp_path, monkeypatch, capsys):
    """Step 0 and two checkpoints (3 and 6: the fresh JAX state with G and
    its EMA scaled apart), restored by each package's own manager."""
    import jax

    import gif_tpu.data.pipeline as jpipe
    import gif_tpu.train as jtrain
    import gif_tpu_torch.data.pipeline as tpipe
    import gif_tpu_torch.train.state as tstate
    from gif_tpu.flame.resources import load_flame_resources
    from gif_tpu.train.checkpoint import CheckpointManager as JManager
    from gif_tpu.train.config import TINY_OVERRIDES
    from gif_tpu_torch.train.checkpoint import CheckpointManager as TManager
    from gif_tpu_torch.train.config import get_config
    from torch_port_common import port_state

    monkeypatch.setenv("GIF_TPU_NO_CACHE", "1")  # JAX's script would re-point the compile cache
    ds = jpipe.SyntheticRenderDataset(load_flame_resources(None), n=12, size=32)
    jcfg = jtrain.get_config(8, batch_size=16, embedding_vocab_size=len(ds), **TINY_OVERRIDES)
    tcfg = get_config(8, batch_size=16, embedding_vocab_size=len(ds), **TINY_OVERRIDES)
    s0 = jtrain.create_train_state(jcfg, jax.random.PRNGKey(8))
    scale = lambda tree, f: jax.tree_util.tree_map(lambda x: x * f, tree)
    states = {
        3: s0.replace(step=s0.step + 3, g_params=scale(s0.g_params, 0.9)),
        6: s0.replace(step=s0.step + 6, g_params=scale(s0.g_params, 0.8), g_ema_params=scale(s0.g_ema_params, 0.95)),
    }
    jmgr = JManager(str(tmp_path / "jax" / "8" / "checkpoint"))
    tmgr = TManager(str(tmp_path / "port" / "8" / "checkpoint"))
    for st in states.values():
        jmgr.save(st)
        tmgr.save(port_state(tcfg, st))
    jmgr.close()

    create = tstate.create_train_state
    state0 = port_state(tcfg, s0)

    def patch_port(m, root):
        m.setattr(tpipe, "SyntheticRenderDataset",
                  lambda res, n, size, device: tpipe.FlameDataset(ds.images, ds.flame_params))
        m.setattr(tstate, "create_train_state", lambda cfg, seed, device: state0 if seed == 8 else create(cfg))

    patch_jax = lambda m, root: m.setattr(jpipe, "SyntheticRenderDataset", lambda res, n, size: ds)
    argv = ["--run_id", "8", "--synthetic_n", "12", "--k", "10"]
    out_args = lambda root: ["--out_dir", root]
    j, t = run_pair("recon_trend", argv, tmp_path, monkeypatch, capsys, jax_tiny=False, out_args=out_args,
                    patch_jax=patch_jax, patch_port=patch_port)
    got, want = (json.loads((tmp_path / p / "8" / "recon_trend.json").read_text()) for p in ("port", "jax"))
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 3, 6]
    for g, w in zip(got, want):
        for k in ("ema_recon", "live_recon"):
            assert g[k] == pytest.approx(w[k], rel=1e-4), (g, w)
    # Scaled weights move the error: the rows are not one state read thrice.
    assert len({round(r["live_recon"], 6) for r in got}) == 3
    assert len(t.samples) == len(j.samples) == 6

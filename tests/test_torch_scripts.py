"""The port's figure scripts (``python -m gif_tpu_torch.scripts.<name>``)
against their ``scripts/`` counterparts, each run in this process at the
tiny config (``--tiny --device cpu``; the two JAX scripts without
``--tiny`` get the same config through ``get_config``) on the FLAME-sized
synthetic mesh, from one trees pickle written from a JAX tiny train state.

Tolerances:
- ``params.npy`` and ``rows.txt``: equal.
- Condition renders before the uint8 cast: within one 8-bit step,
  flipped on < 0.5% of values (tests/test_torch_sampling.py's bar: the
  two rasterizers' floors may straddle a bin edge).
- Generated images before the uint8 cast (every ``FlameSampler.sample``
  call, recorded): the port's G fed the JAX conditions gives the JAX
  images at rtol 1e-4 / atol 1e-5, the generator's bar, and so does the
  port's own image of every sample with no 8-bit step flipped.
- Stolen textures: at the render bars (rtol / atol 1e-3), except texels
  whose visibility flips (the sign of a blended vertex normal's z, summed
  in another order in each package): at most 4 texels an image.
- PNGs: within one level, bar those flipped texels.
- ``landmark_overlay``'s projected points: within 1e-4 px; its printed
  re-inference error: equal.
"""

import importlib
import os
import pickle
import sys

import numpy as np
import pytest

import torch

import gif_tpu.train as jtrain
from gif_tpu.eval.sampling import FlameSampler as JFlameSampler
from gif_tpu.train.config import TINY_OVERRIDES
from gif_tpu.utils import viz as jviz
from gif_tpu_torch.eval.sampling import FlameSampler as TFlameSampler
from gif_tpu_torch.utils import viz as tviz
from torch_port_common import cpu_threads

VOCAB = 16
COND_STEP = 1.0 / 255.0  # one 8-bit step of a [0, 1] map
RTOL, ATOL = 1e-4, 1e-5
TEX_RTOL = TEX_ATOL = 1e-3
MAX_FLIPPED_TEXELS = 4
# What save_set_of_images writes that is a condition render: by prefix,
# or by directory (the perceptual study's renders/).
COND_PREFIXES = ("cond_", "rndr_", "norm_", "mesh_", "mesh_textured_", "mesh_normal_")
COND_DIRS = ("renders",)

# script: (its arguments, whether the JAX script has --tiny)
SCRIPTS = {
    "generate_random_samples": (["--n", "5", "--batch", "4"], True),
    "role_of_different_parameters": (["--n_pairs", "1"], True),
    "generate_gif": (["--n_keyframes", "2", "--steps", "3"], True),
    "animate_teaser": (["--steps", "2"], False),
    "teaser": (["--n_identities", "1", "--steal_textures"], True),
    "landmark_overlay": (["--n", "3"], False),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # Six test processes share the machine under tier-1: cap each one's
    # thread pools (torch_port_common.cpu_threads).
    with cpu_threads():
        yield


@pytest.fixture(scope="module")
def trees_pickle(tmp_path_factory):
    import jax

    from gif_tpu.train.state import create_train_state

    cfg = jtrain.get_config(0, embedding_vocab_size=VOCAB, **TINY_OVERRIDES)
    state = jax.device_get(create_train_state(cfg, jax.random.PRNGKey(0)))
    trees = {k: jax.tree_util.tree_map(np.asarray, getattr(state, k))
             for k in ("g_params", "g_ema_params", "d_params", "buffers")}
    path = tmp_path_factory.mktemp("trees") / "trees.pkl"
    with open(path, "wb") as f:
        pickle.dump(trees, f)
    return str(path)


class Recorder:
    """The arrays a script hands its image writers, by call order."""

    def __init__(self, monkeypatch, viz, sampler_cls, script_mod, root):
        self.saved, self.uint8, self.landmarks, self.samples = {}, [], [], []
        save, to_uint8, sample = viz.save_set_of_images, viz.to_uint8, sampler_cls.sample

        def sample_and_record(sampler, flame, indices):
            images, conds = sample(sampler, flame, indices)
            self.samples.append((sampler, np.array(indices), images, conds))
            return images, conds

        def save_set(path, prefix, images):
            self.saved[(os.path.relpath(path, root), prefix)] = np.array(images)
            return save(path, prefix, images)

        def to_u8(images):
            self.uint8.append(np.array(images))
            return to_uint8(images)

        monkeypatch.setattr(viz, "save_set_of_images", save_set)
        monkeypatch.setattr(viz, "to_uint8", to_u8)
        monkeypatch.setattr(sampler_cls, "sample", sample_and_record)
        if hasattr(script_mod, "project_landmarks"):
            project = script_mod.project_landmarks

            def record(*a, **kw):
                # The port's helper defaults to the card: callers name the device.
                assert script_mod.__name__.startswith("scripts.") or len(a) == 4 or "device" in kw
                pts = project(*a, **kw)
                self.landmarks.append(pts)
                return pts

            monkeypatch.setattr(script_mod, "project_landmarks", record)


def run_pair(name, argv, tmp_path, monkeypatch, capsys, jax_tiny, out_args=None, patch_jax=None,
             patch_port=None):
    """Run ``scripts.<name>`` and ``gif_tpu_torch.scripts.<name>`` in this
    process with ``argv`` plus their output flags (``out_args(root)``;
    default ``--out_dir <root>/out``), each under a :class:`Recorder`; the
    port with ``--tiny --device cpu``, the JAX script with ``--tiny`` or,
    without it, ``TINY_OVERRIDES`` through a patched ``get_config``.
    ``patch_jax`` / ``patch_port`` take the monkeypatch context and the
    run's root before their script runs.  Returns the two recorders (each
    with ``stdout``, its root replaced by ``<out>``)."""
    out_args = out_args or (lambda root: ["--out_dir", os.path.join(root, "out")])
    runs = {}
    for pkg in ("jax", "port"):
        root = str(tmp_path / pkg)
        os.makedirs(root, exist_ok=True)
        with monkeypatch.context() as m:
            if pkg == "jax":
                mod = importlib.import_module(f"scripts.{name}")
                rec = Recorder(m, jviz, JFlameSampler, mod, root)
                if not jax_tiny:
                    get_config = jtrain.get_config
                    m.setattr(jtrain, "get_config", lambda run_id, **kw: get_config(run_id, **kw, **TINY_OVERRIDES))
                if patch_jax:
                    patch_jax(m, root)
                m.setattr(sys, "argv", [name, *argv, *out_args(root), *(["--tiny"] if jax_tiny else [])])
                mod.main()
            else:
                mod = importlib.import_module(f"gif_tpu_torch.scripts.{name}")
                rec = Recorder(m, tviz, TFlameSampler, mod, root)
                if patch_port:
                    patch_port(m, root)
                mod.main([*argv, *out_args(root), "--tiny", "--device", "cpu"])
        rec.stdout = capsys.readouterr().out.replace(root, "<out>")
        runs[pkg] = rec
    return runs["jax"], runs["port"]


def _run_both(name, trees, tmp_path, monkeypatch, capsys, extra=()):
    args, jax_tiny = SCRIPTS[name]
    common = ["--flame_resources", "synthetic", "--vocab", str(VOCAB), "--converted_ckpt", trees, *args, *extra]
    if name == "generate_gif":
        out_args = lambda root: ["--out", os.path.join(root, "anim.gif")]
    else:
        out_args = None
    return run_pair(name, common, tmp_path, monkeypatch, capsys, jax_tiny, out_args)


def _check_cond(got, want, what):
    diff = np.abs(got - want)
    assert diff.max() <= COND_STEP * 1.001, what
    assert (diff > COND_STEP * 0.5).mean() < 0.005, what


def _png_levels(path_a, path_b):
    from PIL import Image

    with Image.open(path_a) as a, Image.open(path_b) as b:
        return np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))


def _check_samples(j, t):
    """Every FlameSampler.sample call: conditions at the condition bar, the
    port's G on JAX's conditions and the port's images of samples with
    equal conditions at the generator's bar."""
    assert len(t.samples) == len(j.samples) > 0
    for (sampler, idx, t_img, t_cond), (_, j_idx, j_img, j_cond) in zip(t.samples, j.samples):
        np.testing.assert_array_equal(idx, j_idx)
        assert t_img.shape == j_img.shape and t_cond.shape == j_cond.shape
        _check_cond((t_cond + 1) / 2, (j_cond + 1) / 2, "conditions")
        with torch.inference_mode():
            g_img = sampler.generator(torch.from_numpy(j_cond), input_indices=torch.from_numpy(idx).long(),
                                      step=sampler.cfg.max_step).numpy()
        np.testing.assert_allclose(g_img, j_img, rtol=RTOL, atol=ATOL)
        unflipped = (np.abs(t_cond - j_cond) <= COND_STEP).reshape(len(t_cond), -1).all(1)
        assert unflipped.any()
        np.testing.assert_allclose(t_img[unflipped], j_img[unflipped], rtol=RTOL, atol=ATOL)


def _check_saved(j, t, tmp_path, samples=True):
    """Every array handed to save_set_of_images, and the PNGs written (and
    with ``samples`` every sample call, :func:`_check_samples`)."""
    if samples:
        _check_samples(j, t)
    assert j.saved.keys() == t.saved.keys()
    for (rel, prefix), want in j.saved.items():
        got = t.saved[(rel, prefix)]
        assert got.shape == want.shape, (rel, prefix)
        what = f"{rel}/{prefix}"
        flipped = np.zeros(got.shape[:3], bool)
        if prefix in COND_PREFIXES or os.path.basename(rel) in COND_DIRS:
            _check_cond(got, want, what)
        elif prefix == "texture_":
            off = ~np.isclose(got, want, rtol=TEX_RTOL, atol=TEX_ATOL)
            flipped = off.any(-1)
            assert flipped.reshape(len(got), -1).sum(1).max() <= MAX_FLIPPED_TEXELS, what
        for i in range(len(got)):
            levels = _png_levels(os.path.join(tmp_path, "jax", rel, f"{prefix}{i}.png"),
                                 os.path.join(tmp_path, "port", rel, f"{prefix}{i}.png"))
            assert levels[~flipped[i]].max() <= 1, (what, i)


def test_generate_random_samples_matches_jax(trees_pickle, tmp_path, monkeypatch, capsys):
    j, t = _run_both("generate_random_samples", trees_pickle, tmp_path, monkeypatch, capsys)
    _check_saved(j, t, tmp_path)
    want = np.load(tmp_path / "jax" / "out" / "params.npy", allow_pickle=True).item()
    got = np.load(tmp_path / "port" / "out" / "params.npy", allow_pickle=True).item()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert t.stdout == j.stdout


def test_role_of_different_parameters_matches_jax(trees_pickle, tmp_path, monkeypatch, capsys):
    j, t = _run_both("role_of_different_parameters", trees_pickle, tmp_path, monkeypatch, capsys)
    _check_saved(j, t, tmp_path)
    assert {p for _, p in t.saved} == {"img_", "rndr_", "norm_"}
    assert t.stdout == j.stdout


@pytest.mark.parametrize("name", ["generate_gif", "animate_teaser"])
def test_animations_match_jax(name, trees_pickle, tmp_path, monkeypatch, capsys):
    from PIL import Image

    j, t = _run_both(name, trees_pickle, tmp_path, monkeypatch, capsys)
    _check_saved(j, t, tmp_path)
    (want,), (got,) = j.uint8, t.uint8
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    gif = "anim.gif" if name == "generate_gif" else os.path.join("out", "teaser_animation.gif")
    frames = {}
    for pkg in ("jax", "port"):
        with Image.open(tmp_path / pkg / gif) as im:
            frames[pkg] = [np.asarray(im.seek(i) or im.convert("RGB")).astype(int) for i in range(im.n_frames)]
    assert len(frames["port"]) == len(frames["jax"])
    for a, b in zip(frames["port"], frames["jax"]):
        assert np.abs(a - b).max() <= 1
    assert t.stdout == j.stdout


def test_teaser_with_texture_steal_matches_jax(trees_pickle, tmp_path, monkeypatch, capsys):
    j, t = _run_both("teaser", trees_pickle, tmp_path, monkeypatch, capsys)
    _check_saved(j, t, tmp_path)
    d = os.path.join("out", "identity_0")
    assert (tmp_path / "port" / d / "rows.txt").read_text() == (tmp_path / "jax" / d / "rows.txt").read_text()
    assert {p for r, p in t.saved} == {"img_", "cond_", "texture_"}
    # The stolen textures see the face: visible texels on every row.
    tex = t.saved[(d, "texture_")]
    assert (np.abs(tex).reshape(len(tex), -1).max(1) > 0).all()
    assert t.stdout == j.stdout


def test_teaser_from_a_flame_npz_dir_matches_jax(trees_pickle, tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(0)
    npz = tmp_path / "fits"
    for child, n in (("exp", 2), ("pose", 1), ("shape", 1)):
        os.makedirs(npz / child)
        for i in range(n):
            np.savez(npz / child / f"v{i}.npz", shape_params=rng.standard_normal((1, 100)) * 0.5,
                     exp_params=rng.standard_normal((1, 50)) * 0.5, pose_params=rng.standard_normal(6) * 0.05)
    j, t = _run_both("teaser", trees_pickle, tmp_path, monkeypatch, capsys, extra=["--flame_npz_dir", str(npz)])
    _check_saved(j, t, tmp_path)
    rows = (tmp_path / "port" / "out" / "identity_0" / "rows.txt").read_text()
    assert rows == (tmp_path / "jax" / "out" / "identity_0" / "rows.txt").read_text()
    assert rows.splitlines() == ["v0_exp", "v1_exp", "v0_pose", "v0_shape"]


def test_landmark_overlay_matches_jax(trees_pickle, tmp_path, monkeypatch, capsys):
    other = np.zeros((3, 236), np.float32)
    rng = np.random.default_rng(1)
    other[:, :156] = rng.standard_normal((3, 156)) * 0.1
    other[:, 156] = 9.0
    np.save(tmp_path / "fits.npy", other)
    j, t = _run_both("landmark_overlay", trees_pickle, tmp_path, monkeypatch, capsys,
                     extra=["--reinferred", str(tmp_path / "fits.npy")])
    assert len(t.landmarks) == len(j.landmarks) == 2
    for got, want in zip(t.landmarks, j.landmarks):
        assert got.shape == want.shape == (3, 68, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # The images and renders the points are drawn on, before the uint8 cast.
    _check_samples(j, t)
    for i in range(3):
        for kind in ("face", "render"):
            levels = _png_levels(tmp_path / "jax" / "out" / f"lmk_{kind}_{i}.png",
                                 tmp_path / "port" / "out" / f"lmk_{kind}_{i}.png")
            assert levels.max() <= 1, (kind, i)
    assert "re-inference error" in t.stdout and t.stdout == j.stdout

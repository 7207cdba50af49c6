"""The training run of the port against the JAX package's, on the CPU:
``gif_tpu.train.loop.train`` and ``gif_tpu_torch.train.loop.train`` at the
tiny run_id-8 config (f32, max_channels 16, 32 px, batch 4, R1 every 2nd
step), 4 steps, a metrics row every step, FID every 2 steps with the random
InceptionV3 on 8 samples against 8 frames, from the same converted initial
state and the same dataset arrays.

Tolerances: every ``metrics.csv`` column (the losses, R1, the FID and the
EMA reconstruction error; ``imgs_per_sec`` is a host clock and only
checked finite) within rtol 1e-3; the generated sets' pool3 statistics
behind each FID within 1e-3 of their largest magnitude; the final G, D and
EMA parameters within rtol 1e-3 of each tensor's largest magnitude (Adam's
first steps move a parameter whose gradient is near zero by up to ``2 lr``
either way, so elementwise relative error is no measure there).  In both
runs the Fréchet distance is replaced by a stand-in without its matrix
square root (2048-d, ~11 s on an 8-core CPU) that records the statistics;
tests/test_torch_eval.py holds the distance itself to JAX's, and
tests/test_torch_cli.py runs the full one.

Also: an exact resume on the CPU, the metrics logger's resume with a new
column, and the loop's guards.
"""

import csv
import os

import jax
import numpy as np
import pytest
import torch

from gif_tpu.data import pipeline as jp
from gif_tpu.eval import fid as jfid
from gif_tpu.eval import inception as jinc
from gif_tpu.flame.resources import synthetic_flame_resources as j_synth
from gif_tpu.train import get_config as j_get_config
from gif_tpu.train import loop as jloop
from gif_tpu.train.state import create_train_state as j_create_train_state
from gif_tpu_torch.data import pipeline as tp
from gif_tpu_torch.eval import fid as tfid
from gif_tpu_torch.eval.inception import random_fid_params
from gif_tpu_torch.flame.resources import synthetic_flame_resources
from gif_tpu_torch.tools.convert_params import convert_train_state
from gif_tpu_torch.train import loop as tloop
from gif_tpu_torch.train.checkpoint import CheckpointManager
from gif_tpu_torch.train.config import get_config
from gif_tpu_torch.train.state import create_train_state, load_train_state
from torch_port_common import cpu_threads, numpy_state, tiny_overrides

RUN_ID = 8
STEPS = 4
FID_SAMPLES = 8


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    with cpu_threads():
        yield


def _overrides(**extra):
    base = dict(batch_size=4, r1_interval=2, fid_every=2, checkpoint_every=2,
                apply_texture_space_interpolation_loss=False)
    return tiny_overrides(**{**base, **extra})


def _arrays():
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8)
    return images, jp.sample_flame_params(rng, 16)


def _stand_in(record):
    """A Fréchet-distance stand-in that records the statistics: |mu_r -
    mu_g|^2 + tr(S_r) + tr(S_g), the distance without its square-root
    term."""
    def distance(mu1, sigma1, mu2, sigma2):
        record.append((mu2, sigma2))
        d = mu1 - mu2
        return float(d.dot(d) + np.trace(sigma1) + np.trace(sigma2))

    return distance


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run and the port's run from the same initial state, the
    statistics behind each FID, and both final states."""
    out = tmp_path_factory.mktemp("loop")
    mp = pytest.MonkeyPatch()
    j_stats, t_stats = [], []
    mp.setattr(jfid, "frechet_distance", _stand_in(j_stats))
    mp.setattr(tfid, "frechet_distance", _stand_in(t_stats))
    try:
        images, flame = _arrays()
        jds = jp.FlameDataset(images, flame)
        jds.conditionally_exact = True
        jcfg = j_get_config(RUN_ID, **_overrides())
        # train() seeds its fresh state with PRNGKey(seed), seed = run_id.
        jstate0 = j_create_train_state(jcfg, jax.random.PRNGKey(RUN_ID))
        jfc = jfid.FidComputer(jinc.random_fid_params(0), stats_dir=str(out / "jax_stats"), batch_size=8)
        jstate = jloop.train(
            jcfg, jds, j_synth(seed=1, n_vertices=503), str(out / "jax"), total_iters=STEPS,
            fid_computer=jfc, log_every=1, fid_n_samples=FID_SAMPLES, fid_real_samples=FID_SAMPLES,
        )

        cfg = get_config(RUN_ID, **_overrides())
        state0 = load_train_state(create_train_state(cfg, device="cpu"), convert_train_state(numpy_state(jstate0)))
        ckpt = CheckpointManager(str(out / "port" / str(RUN_ID) / "checkpoint"))
        ckpt.save(state0)  # the run resumes from the converted state at step 0
        tds = tp.FlameDataset(images, flame)
        tds.conditionally_exact = True
        tfc = tfid.FidComputer(random_fid_params(0), stats_dir=str(out / "port_stats"), batch_size=8, device="cpu")
        state = tloop.train(
            cfg, tds, synthetic_flame_resources(seed=1, n_vertices=503), str(out / "port"),
            total_iters=STEPS, fid_computer=tfc, log_every=1, fid_n_samples=FID_SAMPLES,
            fid_real_samples=FID_SAMPLES, device="cpu",
        )
    finally:
        mp.undo()
    return dict(out=out, jstate=jstate, state=state, j_stats=j_stats, t_stats=t_stats)


def test_metrics_csv_matches_jax(runs):
    want = _rows(runs["out"] / "jax" / str(RUN_ID) / "metrics.csv")
    got = _rows(runs["out"] / "port" / str(RUN_ID) / "metrics.csv")
    assert [r["step"] for r in got] == [r["step"] for r in want] == ["1", "2", "3", "4"]
    assert sorted(got[0]) == sorted(want[0])
    assert {"d_loss", "g_loss", "r1", "g_total", "render_overflow", "fid", "ema_recon"} <= set(got[0])
    for g, w in zip(got, want):
        for k in w:
            if k == "imgs_per_sec":
                assert np.isfinite(float(g[k])) and float(g[k]) > 0
                continue
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-3, err_msg=f"step {w['step']} {k}")
    # R1 on steps 2 and 4 ((step + 1) % 2 == 0 at state steps 1 and 3).
    assert [float(r["r1"]) > 0 for r in got] == [False, True, False, True]
    # The FID column carries the latest sweep: baseline, step 2, step 4.
    assert got[0]["fid"] == got[1]["fid"] != got[2]["fid"] == got[3]["fid"]


def test_fid_statistics_match_jax(runs):
    assert len(runs["t_stats"]) == len(runs["j_stats"]) == 3
    for (mu, sigma), (jmu, jsigma) in zip(runs["t_stats"], runs["j_stats"]):
        np.testing.assert_allclose(mu, jmu, rtol=0, atol=1e-3 * np.abs(jmu).max())
        np.testing.assert_allclose(sigma, jsigma, rtol=0, atol=1e-3 * np.abs(jsigma).max())


def test_final_parameters_match_jax(runs):
    from gif_tpu_torch.tools.convert_params import convert_discriminator_params, convert_generator_params

    jstate, state = numpy_state(runs["jstate"]), runs["state"]
    assert state.step == int(jstate.step) == STEPS and state.used_samples == int(jstate.used_samples)
    for module, want in (
        (state.generator, convert_generator_params(jstate.g_params, jstate.buffers)),
        (state.g_ema, convert_generator_params(jstate.g_ema_params, jstate.buffers)),
        (state.discriminator, convert_discriminator_params(jstate.d_params)),
    ):
        got = module.state_dict()
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                       atol=1e-3 * np.abs(w.numpy()).max(), err_msg=name)


def test_run_artifacts(runs):
    run = runs["out"] / "port" / str(RUN_ID)
    assert CheckpointManager(str(run / "checkpoint")).all_steps() == [0, 2, 4]
    grids = sorted(os.listdir(run / "sample" / str(RUN_ID)))
    assert [g[:6] for g in grids] == ["000000", "000002", "000004"]
    jgrids = sorted(os.listdir(runs["out"] / "jax" / str(RUN_ID) / "sample" / str(RUN_ID)))
    assert [g.rsplit("_", 1)[0] for g in grids] == [g.rsplit("_", 1)[0] for g in jgrids]
    assert os.listdir(runs["out"] / "port_stats") == ["ffhq_32X32_fid_stats.npz"]


def _resume_cfg():
    # Instance noise makes every step draw: the resume must replay draws too.
    return get_config(RUN_ID, **_overrides(d_input_noise_std=0.1, fid_every=10_000))


def test_resume_is_exact(tmp_path):
    """Run to 4 == run to 2 + resume to 4, bit for bit: counter-based
    batches (flip augmentation on) and per-step reseeded draws."""
    cfg = _resume_cfg()
    res = synthetic_flame_resources(seed=1, n_vertices=503)
    images, flame = _arrays()

    def ds():
        return tp.FlameDataset(images, flame, horizontal_flip=True)

    a = tloop.train(cfg, ds(), res, str(tmp_path / "a"), total_iters=4, log_every=1, device="cpu")
    tloop.train(cfg, ds(), res, str(tmp_path / "b"), total_iters=2, log_every=1, device="cpu")
    b = tloop.train(cfg, ds(), res, str(tmp_path / "b"), total_iters=4, log_every=1, device="cpu")
    assert a.step == b.step == 4 and a.used_samples == b.used_samples == 16
    sa, sb = a.state_dict(), b.state_dict()
    for key in ("generator", "g_ema", "discriminator"):
        for name, t in sa[key].items():
            assert torch.equal(t, sb[key][name]), (key, name)
    for key in ("g_opt", "d_opt"):
        for i, st in sa[key]["state"].items():
            for k, v in st.items():
                assert torch.equal(v, sb[key]["state"][i][k]), (key, i, k)
    assert torch.equal(sa["pl_mean"], sb["pl_mean"])
    ra = _rows(tmp_path / "a" / str(RUN_ID) / "metrics.csv")
    rb = _rows(tmp_path / "b" / str(RUN_ID) / "metrics.csv")
    assert [r["step"] for r in rb] == ["1", "2", "3", "4"]
    for x, y in zip(ra, rb):
        assert {k: v for k, v in x.items() if k != "imgs_per_sec"} == \
            {k: v for k, v in y.items() if k != "imgs_per_sec"}
    # The EMA still shares the generator's frozen embedding after restore.
    assert b.g_ema.embedding is b.generator.embedding


def test_checkpoint_round_trip_and_retention(tmp_path):
    cfg = get_config(RUN_ID, **_overrides())
    state = create_train_state(cfg, seed=3, device="cpu")
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, save_every=2)
    for step in range(1, 7):
        state.step = step
        state.pl_mean = torch.tensor(0.25 * step)
        mgr.maybe_save(state, step=step)
    assert mgr.all_steps() == [4, 6] and mgr.latest_step() == 6
    assert not [f for f in os.listdir(tmp_path) if "tmp" in f]
    fresh = create_train_state(cfg, seed=4, device="cpu")
    mgr.restore(fresh, step=4)
    assert fresh.step == 4 and float(fresh.pl_mean) == 1.0
    for (n, p), q in zip(state.generator.named_parameters(), fresh.generator.parameters()):
        assert torch.equal(p, q), n
    assert fresh.g_ema.embedding is fresh.generator.embedding
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(fresh)


def test_metrics_logger_resume_with_new_column(tmp_path):
    """Resuming reads the existing header; a new column rewrites the file
    under the union header, so every row parses (the JAX logger appends
    rows under a header they do not match)."""
    path = str(tmp_path / "metrics.csv")
    first = tloop.MetricsLogger(path)
    first.log(1, {"a": 1.0, "b": 2.0})
    resumed = tloop.MetricsLogger(path)
    assert resumed.fields == ["step", "a", "b"]
    resumed.log(2, {"b": 4.0, "a": 3.0})  # another order: written by the header
    resumed.log(3, {"a": 5.0, "b": 6.0, "c": 7.0})
    tloop.MetricsLogger(path).log(4, {"c": 8.0})
    rows = _rows(path)
    assert list(rows[0]) == ["step", "a", "b", "c"]
    assert rows == [
        {"step": "1", "a": "1.0", "b": "2.0", "c": ""},
        {"step": "2", "a": "3.0", "b": "4.0", "c": ""},
        {"step": "3", "a": "5.0", "b": "6.0", "c": "7.0"},
        {"step": "4", "a": "", "b": "", "c": "8.0"},
    ]


def test_loop_guards(tmp_path):
    res = synthetic_flame_resources(seed=1, n_vertices=503)
    images, flame = _arrays()
    with pytest.raises(NotImplementedError):
        tloop.train(_resume_cfg(), tp.FlameDataset(images, flame), res, str(tmp_path), total_iters=1,
                    converted_ckpt="reference.pkl", device="cpu")
    cfg0 = get_config(0, **tiny_overrides(batch_size=4))
    with pytest.raises(ValueError, match="flip/crop"):
        tloop.train(cfg0, tp.FlameDataset(images, flame, random_crop=True), res, str(tmp_path),
                    total_iters=1, device="cpu")

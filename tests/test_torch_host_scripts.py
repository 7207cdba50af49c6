"""The port's host-only scripts (``make_image_grid``, ``plot_fid``,
``mturk_results``) against their ``scripts/`` counterparts: the same
inputs give the same files (PNGs pixel for pixel, CSVs and keys byte for
byte) and the same printed lines; the training shell scripts'
(``gif_tpu_torch/scripts/*.sh``) flags against the port CLI's parser; and
``landmark_overlay.project_landmarks``' default device.
"""

import csv
import importlib
import json
import os
import re
import shlex
import subprocess
import sys

import numpy as np
import pytest

from gif_tpu_torch.train import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_both(name, argv, monkeypatch, capsys, tmp_path):
    """Each package's script with ``argv`` (every ``{out}`` replaced by
    its own directory); their printed lines with the directory as
    ``<out>``."""
    import matplotlib.pyplot as plt

    out = {}
    for pkg in ("jax", "port"):
        plt.close("all")  # the JAX scripts draw on pyplot's current figure and leave it open
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        args = [a.replace("{out}", str(d)) for a in argv]
        if pkg == "jax":
            with monkeypatch.context() as m:
                m.setattr(sys, "argv", [name, *args])
                importlib.import_module(f"scripts.{name}").main()
        else:
            importlib.import_module(f"gif_tpu_torch.scripts.{name}").main(args)
        out[pkg] = capsys.readouterr().out.replace(str(d), "<out>")
    assert out["port"] == out["jax"]
    return out["port"]


def _pixels(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _same_png(tmp_path, rel):
    np.testing.assert_array_equal(_pixels(tmp_path / "port" / rel), _pixels(tmp_path / "jax" / rel))


@pytest.fixture
def images(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(7):
        Image.fromarray(rng.integers(0, 256, (6, 5, 4), dtype=np.uint8)).save(d / f"mesh_{i}.png")
    return d


@pytest.mark.parametrize("pad", ["0", "3"])
def test_make_image_grid_matches_jax(pad, images, tmp_path, monkeypatch, capsys):
    argv = ["--pattern", str(images / "mesh_*.png"), "--n_row", "2", "--n_col", "3", "--pad", pad,
            "--out", "{out}/grid.png"]
    assert _run_both("make_image_grid", argv, monkeypatch, capsys, tmp_path) == "wrote <out>/grid.png\n"
    _same_png(tmp_path, "grid.png")
    assert _pixels(tmp_path / "port" / "grid.png").shape == (12 + int(pad), 15 + 2 * int(pad), 3)


def test_make_image_grid_needs_enough_images(images):
    from gif_tpu_torch.scripts import make_image_grid

    with pytest.raises(SystemExit, match="need 8 images, found 7"):
        make_image_grid.main(["--pattern", str(images / "*.png"), "--n_row", "2", "--n_col", "4"])


def _metrics_csv(path, fids):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["step", "d_loss", "g_loss", "fid", "ema_recon"])
        for i, fid in enumerate(fids):
            w.writerow([10 * (i + 1), 1.0, 2.0, fid, "nan"])


def test_plot_fid_from_metrics_csv_matches_jax(tmp_path, monkeypatch, capsys):
    run = tmp_path / "run"
    run.mkdir()
    _metrics_csv(run / "metrics.csv", ["nan", 41.5, "nan", 12.25, 30.0])
    out = _run_both("plot_fid", ["--run_dir", str(run), "--out", "{out}/fid.png"], monkeypatch, capsys, tmp_path)
    assert out.splitlines() == ["best checkpoint: step 40 (FID 12.25)", "wrote <out>/fid.png"]
    _same_png(tmp_path, "fid.png")


def test_plot_fid_from_sample_names_matches_jax(tmp_path, monkeypatch, capsys):
    from gif_tpu.utils import viz
    from gif_tpu_torch.scripts.plot_fid import fid_from_metrics_csv, fid_from_sample_names
    from scripts.plot_fid import fid_from_metrics_csv as j_csv
    from scripts.plot_fid import fid_from_sample_names as j_names

    run = tmp_path / "run"
    grid = np.zeros((4, 4, 3), np.uint8)
    for it, fid in ((99, 33.3), (199, 21.07), (299, 25.5)):
        viz.save_png(str(run / "sample" / "0" / f"{it + 1:06d}_res256_fid_{fid:.2f}.png"), grid)
    _metrics_csv(run / "metrics.csv", ["nan", "nan"])  # no FID rows: the names are read
    assert fid_from_sample_names(str(run / "sample" / "0")) == j_names(str(run / "sample" / "0"))
    assert fid_from_metrics_csv(str(run / "metrics.csv")) == j_csv(str(run / "metrics.csv")) == []
    out = _run_both("plot_fid", ["--run_dir", str(run), "--out", "{out}/fid.png", "--ylim", "40"],
                    monkeypatch, capsys, tmp_path)
    assert out.startswith("best checkpoint: step 200 (FID 21.07)")
    _same_png(tmp_path, "fid.png")


@pytest.fixture
def stimuli(tmp_path):
    d = tmp_path / "study"
    for sub in ("faces", "model_a"):
        (d / sub).mkdir(parents=True)
        for i in range(9):
            (d / sub / f"s_{i}.png").write_bytes(b"")
    return d


@pytest.mark.parametrize("study", ["association", "comparison"])
def test_mturk_results_csv_matches_jax(study, stimuli, tmp_path, monkeypatch, capsys):
    argv = ["csv", "--study", study, "--stimulus_dir", str(stimuli), "--base_url", "https://host/s/",
            "--out", "{out}/batch.csv"]
    assert _run_both("mturk_results", argv, monkeypatch, capsys, tmp_path) == "wrote 9 rows to <out>/batch.csv\n"
    files = ["batch.csv"] + (["batch.csv.key.json"] if study == "comparison" else [])
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    if study == "comparison":
        swapped = json.loads((tmp_path / "port" / "batch.csv.key.json").read_text())["swapped"]
        assert 0 < sum(swapped) < 9  # seed 2's draws swap some rows, not all


def test_mturk_results_score_and_likert_match_jax(tmp_path, monkeypatch, capsys):
    from gif_tpu_torch.scripts.mturk_results import LIKERT, comparison_rows, likert_modal_scores, score_comparison
    from scripts import mturk_results as jm

    names = [f"s_{i}.png" for i in range(12)]
    rows, swapped = comparison_rows(names, "u/", np.random.default_rng(7))
    assert (rows, swapped) == jm.comparison_rows(names, "u/", np.random.default_rng(7))
    rng = np.random.default_rng(1)
    scored = [{**r, "answer1": str(rng.choice(["1", "0", "true", "no"]))} for r in rows]
    assert score_comparison(scored) == jm.score_comparison(scored)
    likert = [{"image_url": f"u/faces/{i % 4}_{i}.png", "label": LIKERT[int(rng.integers(0, 5))]} for i in range(20)]
    assert likert_modal_scores(likert) == jm.likert_modal_scores(likert)

    for mode, table in (("score", scored), ("likert", likert)):
        path = tmp_path / f"{mode}.csv"
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(table[0]))
            w.writeheader()
            w.writerows(table)
        out = _run_both("mturk_results", [mode, "--results", str(path), "--out", "{out}/" + f"{mode}.png"],
                        monkeypatch, capsys, tmp_path)
        assert out.endswith(f"wrote <out>/{mode}.png\n")
        _same_png(tmp_path, f"{mode}.png")


def _train_flags(script: str, launcher: str) -> list:
    """The flags ``script`` passes to the trainer it launches with
    ``launcher``: its continuation lines joined, shell variables given a
    value, redirections and the pass-through ``"$@"`` dropped."""
    text = open(os.path.join(ROOT, script)).read()
    start = text.index(launcher) + len(launcher)
    lines = []
    for line in text[start:].splitlines():
        lines.append(line.rstrip("\\").strip())
        if not line.rstrip().endswith("\\"):
            break
    words = shlex.split(re.sub(r'"\$\{?(\w+)\}?"', "7", " ".join(lines).replace('"$@"', "")))
    return words[: next((i for i, w in enumerate(words) if w.startswith((">", "&"))), len(words))]


@pytest.mark.parametrize("name", ["run_longitudinal_r05.sh", "sweep_dataset_size.sh"])
def test_shell_scripts_pass_the_port_cli_its_flags(name):
    port = _train_flags(f"gif_tpu_torch/scripts/{name}", "python -m gif_tpu_torch.train")
    jax = _train_flags(f"scripts/{name}", "python train.py")
    assert port == jax and "--run_id" in port
    args = cli.parse_args(port)
    assert args.run_id == 8 and args.synthetic_images == "renders" and args.inception_weights == "random"
    assert args.fid_every == 250 and args.log_every == 10
    subprocess.run(["bash", "-n", os.path.join(ROOT, "gif_tpu_torch", "scripts", name)], check=True)


def test_project_landmarks_defaults_to_the_card():
    import torch

    from gif_tpu_torch.flame.resources import synthetic_flame_resources
    from gif_tpu_torch.scripts.landmark_overlay import project_landmarks

    res = synthetic_flame_resources(seed=1, n_vertices=503)
    flame = np.zeros((2, 236), np.float32)
    flame[:, 156] = 8.0
    assert project_landmarks(res, flame, 32, "cpu").shape == (2, 68, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            project_landmarks(res, flame, 32)

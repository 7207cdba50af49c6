"""A run with the timed path broken underneath comes out not correct; a
sound one comes out correct; the control (the reference with its bf16
convolutions on float8 operands) fails the limits.  Each drives the rest
of a run on the CPU at a small size, past the harness's look for a card,
with the cell's own limits."""

import copy
import time

import pytest
import torch

from benchmark.harness import compare, registry, train

TINY = dict(max_size=32, init_size=32, render_image_size=32, max_channels=16, nmlp_for_z_to_w=2,
            compute_dtype="bfloat16", embedding_vocab_size=16)
MESH = {"seed": 1, "n_vertices": 503}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def train_run(name, seed=11, keep=False):
    cell = registry.cell(name)
    cell.traffic = dict(cell.traffic, batch=8, ring=4)
    return train.run(cell, seed, 0.0, False, time.perf_counter(), device="cpu", overrides=TINY, mesh=MESH,
                     keep=keep)


def broken(monkeypatch, wrap):
    """Make the program's train step the broken one ``wrap(real_step)``."""
    import gif_tpu_torch.train.step as step_mod

    real = step_mod.make_train_step
    monkeypatch.setattr(step_mod, "make_train_step", lambda *a, **k: wrap(real(*a, **k)))


@pytest.mark.parametrize("name", ["r0-train-b16", "r8-train-b16"])
def test_a_sound_train_run_is_correct(name):
    out = train_run(name)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["r0-train-b16", "r8-train-b16"])
def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch, name):
    def wrap(step):
        def unchanged(state, batch, draws=None):
            _, m = step(copy.deepcopy(state), batch, draws)
            state.step += 1
            return state, m
        return unchanged

    broken(monkeypatch, wrap)
    out = train_run(name)
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["r0-train-b16", "r8-train-b16"])
def test_half_the_batch_left_out_is_caught(monkeypatch, name):
    def wrap(step):
        def half(state, batch, draws=None):
            b = batch["flame"].shape[0] // 2
            draws = {k: v for k, v in (draws or {}).items() if k != "interp_pairs"}
            return step(state, {k: v[:b] for k, v in batch.items()}, draws)
        return half

    broken(monkeypatch, wrap)
    out = train_run(name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["r0-train-b16", "r8-train-b16"])
def test_the_control_fails_the_limits(name):
    out = train_run(name, keep=True)
    ctrl = train.reference_steps(out["train_config"], out["ref_res"], out["first"], 11, "cpu", lower=True)
    ok, checks = compare.checks(compare.train_numbers(ctrl, out["reference"]), registry.cell(name).limits)
    assert not ok, checks


@pytest.mark.parametrize("name", ["r0-train-b16", "r8-train-b16"])
@pytest.mark.parametrize("fault", ["lr_x1.25", "ema_decay_0.999"])
def test_a_wrong_learning_rate_or_ema_decay_is_caught(monkeypatch, name, fault):
    """The program's step run at a learning rate 1.25x the configuration's,
    or with the EMA decay 0.999: ``change_ratio`` sees the scale of each
    tree's change."""
    import dataclasses

    import gif_tpu_torch.train.step as step_mod

    real = step_mod.make_train_step

    def make(cfg, *a, **k):
        if fault == "ema_decay_0.999":
            return real(dataclasses.replace(cfg, ema_decay=0.999), *a, **k)
        step = real(cfg, *a, **k)

        def faster(state, batch, draws=None):
            for opt in (state.g_opt, state.d_opt):
                for group in opt.param_groups:
                    group.setdefault("benchmark_base_lr", group["lr"])
                    group["lr"] = 1.25 * group["benchmark_base_lr"]
            return step(state, batch, draws)
        return faster

    monkeypatch.setattr(step_mod, "make_train_step", make)
    out = train_run(name)
    assert not out["correct"], out["checks"]
    assert out["checks"]["change_ratio"]["value"] > out["checks"]["change_ratio"]["limit"], out["checks"]


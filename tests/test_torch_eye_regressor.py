"""The port's eye-camera regressor against the JAX package's, on the CPU:
the forward from converted flax variables in train mode (batch statistics,
and the running statistics it updates) and in eval mode, rtol 1e-5 /
atol 1e-5 (float32, sums in another order); ``generate_training_data``
from the same FLAME rows, rtol 1e-5 / atol 1e-6 (the decode and the
pseudo-inverse solve in float32); and ``train_regressor`` from the same
initial variables over the same permutation for 3 Adam steps (betas
(0, 0.99), lr 1e-3): with beta1 = 0 Adam moves every weight by about
+-lr a step whatever its gradient's size, so where float32 rounding can
flip a gradient's sign a weight lands a whole step away.  The dense
biases ahead of a BatchNorm have an exact gradient of 0 (the norm removes
them), so they are noise in both and not compared; of every other weight
at most 1% of elements may be more than lr / 10 apart; the running
statistics within rtol 1e-3 / atol 1e-4; the predictions within 1e-3 of
their largest value; the held-out MSE within 1e-3 relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_tpu.flame import eye_regressor as jer
from gif_tpu.flame.resources import synthetic_flame_resources as j_synth
from gif_tpu_torch.flame import eye_regressor as er
from gif_tpu_torch.flame.resources import synthetic_flame_resources
from gif_tpu_torch.tools.convert_params import convert_eye_regressor_variables
from torch_port_common import cpu_threads


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # Six test processes share the machine under tier-1: cap each one's
    # thread pools (torch_port_common.cpu_threads).
    with cpu_threads():
        yield


E1, E2 = 100, 200  # symmetric stand-in eye vertices (tests/test_aux.py)


def _with_eyes(res):
    vt = res.v_template.copy()
    vt[E1] = [-0.03, 0.03, 0.08]
    vt[E2] = [0.03, 0.03, 0.08]
    return dataclasses.replace(res, v_template=vt)


def _flame(n, seed=0):
    rng = np.random.default_rng(seed)
    flame = np.zeros((n, 236), np.float32)
    flame[:, :3] = rng.standard_normal((n, 3)) * 0.3
    flame[:, 100:103] = rng.standard_normal((n, 3)) * 0.2
    flame[:, 150:156] = rng.standard_normal((n, 6)) * 0.05
    return flame


@pytest.fixture(scope="module")
def jax_model():
    model = jer.CameraRegressor()
    variables = model.init(jax.random.PRNGKey(3), jnp.zeros((2, 12)), train=True)
    # Non-trivial running statistics.
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(lambda v: jnp.asarray(rng.uniform(0.5, 1.5, v.shape), jnp.float32),
                                   variables["batch_stats"])
    return model, {"params": variables["params"], "batch_stats": stats}


def _port(variables):
    net = er.CameraRegressor()
    net.load_state_dict(convert_eye_regressor_variables(jax.tree_util.tree_map(np.asarray, variables)))
    return net


def test_forward_from_converted_variables_in_train_and_eval_mode(jax_model):
    model, variables = jax_model
    x = np.random.default_rng(2).standard_normal((32, 12)).astype(np.float32)
    net = _port(variables)
    want_eval = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got_eval = net.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_eval, want_eval, rtol=1e-5, atol=1e-5)
    want_train, upd = model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got_train = net.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_train, np.asarray(want_train), rtol=1e-5, atol=1e-5)
    # The running statistics updated in train mode: flax's momentum and its
    # biased batch variance.
    want_sd = convert_eye_regressor_variables(jax.tree_util.tree_map(
        np.asarray, {"params": variables["params"], "batch_stats": upd["batch_stats"]}))
    got_sd = net.state_dict()
    for k in want_sd:
        if "running" in k:
            torch.testing.assert_close(got_sd[k], want_sd[k], rtol=1e-5, atol=1e-6)


def test_generate_training_data_matches_jax():
    res, jres = _with_eyes(synthetic_flame_resources(seed=1, n_vertices=503)), _with_eyes(
        j_synth(seed=1, n_vertices=503))
    flame = _flame(40)
    x, y = er.generate_training_data(res, flame, batch_size=16, eye_left=E1, eye_right=E2, device="cpu")
    jx, jy = jer.generate_training_data(jres, flame, batch_size=16, eye_left=E1, eye_right=E2)
    assert x.shape == (40, 12) and y.shape == (40, 3)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        er.generate_training_data(res, flame[:4], device="cpu")  # FLAME's eye ids on a 503-vertex mesh


def test_three_adam_steps_match_jax(jax_model):
    """train_regressor from one initialization: 100 rows -> 90 training rows
    in 3 batches of 30 (one epoch, the same permutation), 10 held out."""
    model, _ = jax_model
    res, jres = _with_eyes(synthetic_flame_resources(seed=1, n_vertices=503)), _with_eyes(
        j_synth(seed=1, n_vertices=503))
    flame = _flame(100, seed=4)
    kw = dict(epochs=1, batch_size=30, lr=1e-3, seed=0, eye_left=E1, eye_right=E2)
    jreg = jer.train_regressor(jres, flame, **kw)
    init = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 12)), train=True)  # train_regressor's own init
    reg = er.train_regressor(res, flame, device="cpu", model=_port(init), **kw)
    want = convert_eye_regressor_variables(jax.tree_util.tree_map(np.asarray, jreg.variables))
    start = convert_eye_regressor_variables(jax.tree_util.tree_map(np.asarray, init))
    got = reg.model.state_dict()
    assert got.keys() == want.keys()
    pre_bn_biases = {"stem.bias"} | {f"skip{i}.dense{j}.bias" for i in range(2) for j in range(2)}
    for k in want:
        if "running" in k:
            torch.testing.assert_close(got[k], want[k], rtol=1e-3, atol=1e-4, msg=k)
        elif k not in pre_bn_biases:
            off = ((got[k] - want[k]).abs() > kw["lr"] / 10).float().mean().item()
            assert off <= 0.01, (k, off)
            assert (want[k] - start[k]).abs().max().item() > kw["lr"] / 2, k  # the steps moved it
    assert abs(reg.val_mse - jreg.val_mse) <= 1e-3 * abs(jreg.val_mse)
    for a in ("mean_in", "std_in", "mean_out", "std_out"):
        np.testing.assert_allclose(getattr(reg, a), getattr(jreg, a), rtol=1e-5, atol=1e-7)
    rows = np.concatenate([flame[-10:, er.FEATURE_IDX],
                           np.random.default_rng(5).standard_normal((8, 12)).astype(np.float32) * 0.2])
    want_pred = np.asarray(jreg.predict(jnp.asarray(rows)))
    assert np.abs(reg.predict(rows).numpy() - want_pred).max() <= 1e-3 * np.abs(want_pred).max()
    out = reg.substitute_camera(torch.from_numpy(flame[:4]))
    want_out = np.asarray(jreg.substitute_camera(jnp.asarray(flame[:4])))
    assert np.abs(out.numpy() - want_out).max() <= 1e-3 * np.abs(want_out).max()
    np.testing.assert_array_equal(out.numpy()[:, :156], flame[:4, :156])

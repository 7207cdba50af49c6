"""Port parity of the conditional discriminator: the converted JAX weights
load into the port's Discriminator key for key; its scores, its gradient
with respect to the image, and R1's gradient with respect to its
parameters (grad-of-grad through kernels 3-5's plain versions) match the
JAX discriminator's in f32 (rtol 1e-4).  Under the bf16 policy the two
frameworks round bf16 at other places, so there the port is held to be as
close to the f32 answer as the JAX package is (see the test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_tpu.train import losses as jl
from gif_tpu.train.state import build_models
from gif_tpu_torch.device import second_order_safe
from gif_tpu_torch.models.discriminator import Discriminator, discriminator_channels
from gif_tpu_torch.tools.convert_params import convert_discriminator_params
from gif_tpu_torch.train import losses as tl
from gif_tpu_torch.train.config import get_config
from torch_port_common import jax_discriminator_params, tiny_overrides


def _ported(compute_dtype):
    jcfg, params = jax_discriminator_params(compute_dtype)
    disc = Discriminator.from_config(get_config(8, **tiny_overrides(compute_dtype=compute_dtype)))
    disc.load_state_dict(convert_discriminator_params(params))
    return jcfg, params, disc


def _inputs(seed=0, b=4, size=32):
    rng = np.random.default_rng(seed)
    real = rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
    cond = (np.floor(rng.uniform(0, 1, (b, size, size, 6)) * 255) / 255 * 2 - 1).astype(np.float32)
    return real, cond


def _jax_outputs(compute_dtype, real, cond):
    """(scores, image gradient, R1, R1's parameter gradient by port name)."""
    jcfg, params = jax_discriminator_params(compute_dtype)
    _, jdisc = build_models(jcfg)

    def d_apply(p, img, c):
        return jdisc.apply({"params": p}, img, c)

    rj, cj = jnp.asarray(real), jnp.asarray(cond)
    scores = d_apply(params, rj, cj)
    gin = jax.jit(jax.grad(lambda img: d_apply(params, img, cj).sum()))(rj)
    r1, r1_grads = jax.jit(jax.value_and_grad(lambda p: jl.r1_penalty(d_apply, p, rj, cj, 5.0)))(params)
    named = {k: v.numpy() for k, v in convert_discriminator_params(r1_grads).items()}
    return np.asarray(scores), np.asarray(gin), float(r1), named


def _port_outputs(disc, real, cond):
    rt = torch.from_numpy(real).requires_grad_(True)
    ct = torch.from_numpy(cond)
    scores = disc(rt, ct)
    assert scores.shape == (4, 1) and scores.dtype == torch.float32
    (gin,) = torch.autograd.grad(scores.sum(), rt)
    r1 = tl.r1_penalty(disc, torch.from_numpy(real), ct, 5.0)
    names, params = zip(*disc.named_parameters())
    with second_order_safe(torch.device("cpu")):  # oneDNN's bf16 double backward is wrong
        grads = torch.autograd.grad(r1, params, materialize_grads=True)
    return scores.detach().numpy(), gin.numpy(), r1.item(), {n: g.numpy() for n, g in zip(names, grads)}


def _flat(named):
    return np.concatenate([named[k].ravel() for k in sorted(named)]).astype(np.float64)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_converted_discriminator_params_fit_the_port_exactly():
    _, params = jax_discriminator_params()
    sd = convert_discriminator_params(params)
    disc = Discriminator.from_config(get_config(8, **tiny_overrides()))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in disc.state_dict().items()
    }
    w = np.asarray(params["res5"]["conv2"]["conv"]["weight"])
    np.testing.assert_array_equal(sd["res5.conv2.conv.weight"].numpy(), w.transpose(3, 2, 0, 1))
    # final_dense reads the 4x4 map in H, W, C order: its weight is copied as it is.
    np.testing.assert_array_equal(sd["final_dense.weight"].numpy(), np.asarray(params["final_dense"]["weight"]))


def test_discriminator_scores_input_grad_and_r1_match_jax_f32():
    _, params, disc = _ported("float32")
    real, cond = _inputs()
    want = _jax_outputs("float32", real, cond)
    got = _port_outputs(disc, real, cond)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * np.abs(w).max())
    assert set(got[3]) == set(want[3])
    for name, w in want[3].items():
        np.testing.assert_allclose(got[3][name], w, rtol=1e-4, atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_discriminator_bf16_policy_is_as_close_to_f32_as_jax():
    """Under the bf16 policy both packages land a few percent from the f32
    answer (the port's f32 D, held to JAX's at 1e-4 above).  The port's
    error must stay within 1.5x the JAX package's (+1e-3) for the scores,
    the image gradient, R1 and the whole R1 parameter gradient; and each
    parameter's R1 gradient must point the JAX one's way (cosine >= 0.98;
    the act_bias gradients are ~1e-7 and mostly bf16 rounding in both)."""
    real, cond = _inputs()
    _, _, disc32 = _ported("float32")
    _, _, disc16 = _ported("bfloat16")
    ref = _port_outputs(disc32, real, cond)
    got = _port_outputs(disc16, real, cond)
    want = _jax_outputs("bfloat16", real, cond)
    for i in range(3):
        assert _rel(got[i], ref[i]) <= 1.5 * _rel(want[i], ref[i]) + 1e-3, i
    assert _rel(_flat(got[3]), _flat(ref[3])) <= 1.5 * _rel(_flat(want[3]), _flat(ref[3])) + 1e-3
    for name, w in want[3].items():
        g = got[3][name].ravel()
        if np.any(w):  # the score head's biases get no R1 gradient
            assert np.dot(g, w.ravel()) / np.linalg.norm(g) / np.linalg.norm(w) >= 0.98, name


def test_discriminator_without_condition_and_seeded_init():
    cfg = get_config(8, **tiny_overrides())
    a = Discriminator.from_config(cfg, seed=3).state_dict()
    b = Discriminator.from_config(cfg, seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert discriminator_channels(2, 512)[256] == 128 and discriminator_channels(2, 16)[4] == 16
    assert abs(a["res5.conv1.conv.weight"].std().item() - 1.0) < 0.1
    assert torch.all(a["from_rgb.act_bias"] == 0.0) and "res5.skip.act_bias" not in a
    assert a["from_rgb.conv.weight"].shape == (16, 9, 1, 1)
    disc = Discriminator(size=32, in_channels=3, max_channels=16)
    with torch.no_grad():
        out = disc(torch.zeros((4, 32, 32, 3)))
    assert out.shape == (4, 1) and torch.isfinite(out).all()


def test_convert_params_cli_writes_the_discriminator(tmp_path):
    import pickle

    from gif_tpu_torch.tools.convert_params import main

    _, params = jax_discriminator_params()
    trees = tmp_path / "trees.pkl"
    with open(trees, "wb") as f:
        pickle.dump({"d_params": jax.tree_util.tree_map(np.asarray, params)}, f)
    out = tmp_path / "d.pt"
    main([str(trees), str(out), "--params", "d_params"])
    sd = torch.load(out, weights_only=True)
    disc = Discriminator.from_config(get_config(8, **tiny_overrides()))
    disc.load_state_dict(sd)  # strict: every key, every shape
    want = convert_discriminator_params(params)
    assert all(torch.equal(sd[k], want[k]) for k in want)


def test_second_order_safe_gives_the_right_bf16_conv_double_backward():
    """R1's weight gradient through one bf16 3x3 'same' conv, within bf16
    rounding (1e-2 relative) of the f32 one under ``second_order_safe``
    (oneDNN's bf16 double backward of this conv is off by ~50% on the CPU)."""
    import torch.nn.functional as F

    def r1_weight_grad(dtype):
        gen = torch.Generator().manual_seed(0)
        x = torch.randn((4, 16, 16, 16), generator=gen).requires_grad_(True)
        w = torch.randn((16, 16, 3, 3), generator=gen).requires_grad_(True)
        out = F.conv2d(x.to(dtype), (w * 0.1).to(dtype), padding=1)
        (gx,) = torch.autograd.grad(out.float().square().sum(), x, create_graph=True)
        with second_order_safe(torch.device("cpu")):
            (gw,) = torch.autograd.grad(gx.square().sum(), w)
        return gw

    want, got = r1_weight_grad(torch.float32), r1_weight_grad(torch.bfloat16)
    assert ((got - want).norm() / want.norm()).item() < 1e-2


def _nchw_forward(disc, image, cond):
    """D's forward with every map NCHW-contiguous, as the port ran it
    before its maps went channels-last."""
    from gif_tpu_torch import ops

    x = disc.from_rgb(torch.cat([image, cond], dim=-1).permute(0, 3, 1, 2).contiguous())
    for i in range(disc.log_size, 2, -1):
        x = getattr(disc, f"res{i}")(x)
        assert x.is_contiguous()
    x = ops.minibatch_stddev(x.float(), disc.stddev_group, disc.stddev_feat).contiguous()
    x = disc.final_conv(x)
    assert x.is_contiguous()
    return disc.out(disc.final_dense(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)))


def _score_grad_r1(d_apply, params, real, cond):
    rt = torch.from_numpy(real).requires_grad_(True)
    ct = torch.from_numpy(cond)
    scores = d_apply(rt, ct)
    (gin,) = torch.autograd.grad(scores.sum(), rt)
    r1 = tl.r1_penalty(d_apply, torch.from_numpy(real), ct, 5.0)
    grads = torch.autograd.grad(r1, params, materialize_grads=True)
    return [scores.detach().numpy(), gin.numpy(), r1.item()] + [g.numpy() for g in grads]


def test_channels_last_discriminator_equals_the_nchw_one_f32():
    """The score, the image gradient, R1 and R1's parameter gradient of D
    on channels-last maps against the same D on NCHW-contiguous ones."""
    _, _, disc = _ported("float32")
    real, cond = _inputs(seed=3)
    params = list(disc.parameters())
    got = _score_grad_r1(disc, params, real, cond)
    want = _score_grad_r1(lambda i, c: _nchw_forward(disc, i, c), params, real, cond)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.all(np.isfinite(g)), i
        # Reassociated f32 sums (oneDNN's channels-last conv): the bar of
        # the parity test against JAX above.
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * np.abs(w).max(), err_msg=str(i))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_every_resblock_and_head_map_is_channels_last(compute_dtype):
    """Forward and R1's backward: every ResBlock's output, the head's conv
    output and the gradient reaching each ResBlock output are channels-last
    (NHWC strides on the NCHW shape)."""
    from gif_tpu_torch.ops import layout

    _, _, disc = _ported(compute_dtype)
    real, cond = _inputs(seed=1)
    seen = []

    def record(name, out):
        seen.append((name, layout.is_channels_last(out)))
        out.register_hook(lambda g: seen.append((name + " grad", layout.is_channels_last(g))))

    hooks = [m.register_forward_hook(lambda m, i, o, name=name: record(name, o))
             for name, m in disc.named_modules()
             if name.startswith("res") and "." not in name or name == "final_conv"]
    tl.r1_penalty(disc, torch.from_numpy(real), torch.from_numpy(cond), 5.0)
    for h in hooks:
        h.remove()
    names = [f"res{i}" for i in range(disc.log_size, 2, -1)]
    assert [n for n, _ in seen if not n.endswith("grad")] == names + ["final_conv"]
    assert {n for n, _ in seen if n.endswith("grad")} == {n + " grad" for n in names + ["final_conv"]}
    assert all(cl for _, cl in seen), seen


def test_d_gradients_come_back_in_their_parameters_strides():
    """cuDNN and oneDNN hand a channels-last map's conv weight gradient
    back with NHWC strides; D's convs return each one in its parameter's
    strides, so the step hands Adam dense OIHW gradients."""
    from gif_tpu_torch.train.step import d_loss_and_grads

    cfg = get_config(8, **tiny_overrides(compute_dtype="bfloat16"))
    _, _, disc = _ported("bfloat16")
    real, cond = (torch.from_numpy(a) for a in _inputs(seed=2))
    fake = torch.flip(real, (0,))
    for do_r1 in (False, True):
        _, r1, grads = d_loss_and_grads(disc, real, cond, fake, cfg, do_r1)
        assert (float(r1) > 0) == do_r1
        for (name, p), g in zip(disc.named_parameters(), grads):
            assert g.shape == p.shape and g.stride() == p.stride(), name

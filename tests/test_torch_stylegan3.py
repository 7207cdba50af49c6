"""StyleGAN3-T in the port (models/stylegan3.py, ops/filtered_lrelu.py,
train/uncond_step.py) against the benchmark's plain reference
(benchmark/reference/stylegan3.py, train_uncond.py) on seeded weights, at
tiny sizes on the CPU; the filter design against scipy; the 1024 px
schedule against the published layer names; and a float64 transcription
of the filtered-leaky-ReLU kernel's tiles (csrc/filtered_lrelu.cu, forward
and backward) against the plain version, which is what the kernel is held
to on the card."""

import math

import numpy as np
import pytest
import torch

from benchmark.harness import registry
from benchmark.harness import train_uncond as driver
from benchmark.reference import stylegan3 as ref_sg3
from gif_tpu_torch.models import stylegan3
from gif_tpu_torch.ops import filtered_lrelu as fl
from gif_tpu_torch.train.config import SG3_TINY_OVERRIDES, get_config
from torch_port_common import cpu_threads

PUBLISHED = ("L0_36_512 L1_36_512 L2_52_512 L3_52_512 L4_84_512 L5_148_512 L6_148_512 L7_276_323 "
             "L8_276_203 L9_532_128 L10_1044_81 L11_1044_51 L12_1044_32 L13_1024_32 L14_1024_3").split()
TINY = dict(SG3_TINY_OVERRIDES, batch_size=4)
# R1 every other step keeps the driver's one-cycle window short; 16
# channels at most keep the six steps (program and reference) fast.
STEP_TINY = dict(TINY, r1_interval=2, channel_base=512, max_channels=16)


def test_schedule_gives_the_published_layers():
    sched = stylegan3.synthesis_schedule(1024)
    assert [s["name"] for s in sched[1:]] == PUBLISHED
    assert sched[0] == dict(channels=512, size=36, sampling_rate=16.0, bandwidth=2.0)
    factors = [(s["up"], s["down"]) for s in sched[1:]]
    assert [i for i, f in enumerate(factors) if f == (4, 2)] == [2, 4, 5, 7, 9, 10]
    assert factors[-1] == (1, 1) and set(factors[:-1]) <= {(2, 2), (4, 2)}
    assert [s["low_precision"] for s in sched[1:]] == [False] * 5 + [True] * 10
    # The reference's own schedule agrees, padding and filters included.
    _, specs = ref_sg3.layer_specs(1024, 32768, 512)
    for s, r in zip(sched[1:], specs):
        assert (s["name"], s["up"], s["down"], list(s["padding"])) == (r["name"], r["up"], r["down"], r["padding"])
        for mine, theirs in ((s["up_filter"], r["fu"]), (s["down_filter"], r["fd"])):
            assert (mine is None) == (theirs is None)
            if mine is not None:
                np.testing.assert_array_equal(mine, theirs.numpy())


@pytest.mark.parametrize("numtaps,cutoff,width,fs", [(12, 2.0, 12.0, 32), (24, 5.04, 14.6, 64), (12, 512, 118.2, 2048),
                                                     (24, 203.2, 309.6, 2048), (12, 16.0, 8.3, 64)])
def test_filter_design_matches_scipy_firwin(numtaps, cutoff, width, fs):
    signal = pytest.importorskip("scipy.signal")
    want = signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs)
    got = fl.design_lowpass_filter(numtaps, cutoff, width, fs)
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-6, atol=1e-8)
    assert fl.design_lowpass_filter(1, cutoff, width, fs) is None


def _plain_args(spec, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    size = spec["in_size"] + spec["kernel"] - 1
    x = torch.randn((1, 3, size, size), generator=g, dtype=dtype)
    b = torch.randn(3, generator=g, dtype=dtype) * 0.3
    fu, fd = (torch.from_numpy(spec[k]).to(dtype) for k in ("up_filter", "down_filter"))
    return x, b, fu, fd, (spec["up"], spec["down"], spec["padding"], math.sqrt(2), 0.2, 256.0)


TINY_LAYERS = [s for s in stylegan3.synthesis_schedule(32, 1024, 32)[1:] if not s["torgb"]]
KERNEL_LAYERS = {(s["up"], s["padding"]): s for s in TINY_LAYERS}.values()


def test_filtered_lrelu_plain_matches_the_reference_values_and_gradients():
    with cpu_threads():
        for spec in KERNEL_LAYERS:
            x, b, fu, fd, args = _plain_args(spec)
            outs = []
            for fn in (fl.filtered_lrelu, ref_sg3.filtered_lrelu):
                xi, bi = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
                y = fn(xi, fu, fd, bi, *args)
                y.backward(torch.cos(torch.arange(y.numel(), dtype=y.dtype)).reshape(y.shape))
                outs.append((y.detach(), xi.grad, bi.grad))
            for a, r in zip(*outs):
                torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-12)


# A transcription of csrc/filtered_lrelu.cu's tiles, one plane at a time:
# the same tile origins, staged index ranges and phase arithmetic, the
# sums as tensor ops.  Every staged index is asserted inside its array
# (the kernel does not check).
FS = 6


def _cdiv(a, b):
    return -((-a) // b)


def _gather(arr, idx, axis):
    assert int(idx.min()) >= 0 and int(idx.max()) < arr.shape[axis], (int(idx.min()), int(idx.max()), arr.shape)
    return arr.index_select(axis, idx.reshape(-1)).reshape(*arr.shape[:axis], *idx.shape, *arr.shape[axis + 1:])


def _up_pass(src, k0, n_out, p0, i0, up, cu, axis):
    """up_x (axis 1) / up_y (axis 0): the zero-stuffed correlation, 6 taps
    a sample, for upsampled indices k0 ... k0 + n_out - 1."""
    k = k0 + torch.arange(n_out)
    ph = (p0 - k) % up
    first = (k + ph - p0) // up - i0
    acc = 0
    for q in range(FS):
        taps = cu[ph + q * up]
        vals = _gather(src, first + q, axis)
        acc = acc + (taps[None, :] if axis == 1 else taps[:, None]) * vals
    return acc


def _round4(n):
    return -(-n // 4) * 4


def _transcribe_forward(x, b, cu, cd, up, down, p0y, p0x, oh, ow):
    lu, ld, ot = FS * up, FS * down, 32
    tn = (ot - 1) * down + ld  # upsampled samples the outputs read
    tt = _round4(tn)  # the tile the up pass computes, in cells of 4
    it = (tt + lu) // up + 2
    h, w = x.shape
    out = torch.zeros((oh, ow), dtype=x.dtype)
    for oy0 in range(0, oh, ot):
        for ox0 in range(0, ow, ot):
            ky0, kx0 = oy0 * down, ox0 * down
            iy0, ix0 = _cdiv(ky0 - p0y, up), _cdiv(kx0 - p0x, up)
            gy, gx = iy0 + torch.arange(it), ix0 + torch.arange(it)
            ok = ((gy >= 0) & (gy < h))[:, None] & ((gx >= 0) & (gx < w))[None, :]
            xs = torch.where(ok, x[gy.clamp(0, h - 1)][:, gx.clamp(0, w - 1)] + b, torch.zeros((), dtype=x.dtype))
            a = _up_pass(xs, kx0, tt, p0x, ix0, up, cu, axis=1)
            t = _up_pass(a, ky0, tt, p0y, iy0, up, cu, axis=0)
            t = (torch.where(t >= 0, t, t * 0.2) * math.sqrt(2)).clamp(-256, 256)
            d1 = sum(cd[s] * _gather(t[:tn], torch.arange(ot) * down + s, 1) for s in range(ld))
            o = sum(cd[s] * _gather(d1, torch.arange(ot) * down + s, 0) for s in range(ld))
            out[oy0:oy0 + ot, ox0:ox0 + ot] = o[: oh - oy0, : ow - ox0]
    return out


def _transcribe_backward(x, b, dy, cu, cd, up, down, p0y, p0x):
    lu, ld, rt = FS * up, FS * down, 64 // up
    tn = (rt - 1) * up + lu
    tt = _round4(tn)
    xt, dt = (tt + lu) // up + 2, (tt + ld) // down + 2
    h, w = x.shape
    oh, ow = dy.shape
    dx = torch.zeros_like(x)
    db = torch.zeros((), dtype=x.dtype)
    for ry0 in range(0, h, rt):
        for rx0 in range(0, w, rt):
            ky0, kx0 = ry0 * up + p0y - (lu - 1), rx0 * up + p0x - (lu - 1)
            iy0, ix0 = _cdiv(ky0 - p0y, up), _cdiv(kx0 - p0x, up)
            dy0, dx0 = _cdiv(ky0 - ld + 1, down), _cdiv(kx0 - ld + 1, down)
            gy, gx = iy0 + torch.arange(xt), ix0 + torch.arange(xt)
            ok = ((gy >= 0) & (gy < h))[:, None] & ((gx >= 0) & (gx < w))[None, :]
            xs = torch.where(ok, x[gy.clamp(0, h - 1)][:, gx.clamp(0, w - 1)] + b, torch.zeros((), dtype=x.dtype))
            t = _up_pass(_up_pass(xs, kx0, tt, p0x, ix0, up, cu, axis=1), ky0, tt, p0y, iy0, up, cu, axis=0)
            slope = torch.where(t >= 0, torch.ones_like(t), torch.full_like(t, 0.2))
            deriv = torch.where((t * slope * math.sqrt(2)).abs() <= 256, slope * math.sqrt(2), 0.0)
            gy, gx = dy0 + torch.arange(dt), dx0 + torch.arange(dt)
            ok = ((gy >= 0) & (gy < oh))[:, None] & ((gx >= 0) & (gx < ow))[None, :]
            ds = torch.where(ok, dy[gy.clamp(0, oh - 1)][:, gx.clamp(0, ow - 1)], torch.zeros((), dtype=x.dtype))
            kx = kx0 + torch.arange(tt)
            ph = kx % down
            e1 = sum(cd[ph + q * down][None, :] * _gather(ds, (kx - ph) // down - dx0 - q, 1) for q in range(FS))
            ky = ky0 + torch.arange(tt)
            ph = ky % down
            da = sum(cd[ph + q * down][:, None] * _gather(e1, (ky - ph) // down - dy0 - q, 0) for q in range(FS))
            g = (da * deriv)[:tn]
            o = torch.arange(rt) * up + lu - 1
            f1 = sum(cu[s] * _gather(g, o - s, 1) for s in range(lu))
            tile = sum(cu[s] * _gather(f1, o - s, 0) for s in range(lu))[: h - ry0, : w - rx0]
            dx[ry0:ry0 + rt, rx0:rx0 + rt] = tile
            db = db + tile.sum()
    return dx, db


@pytest.mark.parametrize("spec", list(KERNEL_LAYERS), ids=lambda s: s["name"])
def test_kernel_transcription_matches_plain(spec):
    x, b, fu, fd, args = _plain_args(spec, seed=3)
    up, down, padding = args[:3]
    x, b = x[:1, :1], b[:1]
    xi, bi = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
    want = fl.filtered_lrelu_plain(xi, fu, fd, bi, *args)
    dy = torch.sin(torch.arange(want.numel(), dtype=want.dtype)).reshape(want.shape)
    want.backward(dy)
    cu, cd = torch.flip(fu, (0,)) * up, torch.flip(fd, (0,))
    p0x, _, p0y, _ = padding
    got = _transcribe_forward(x[0, 0], b[0], cu, cd, up, down, p0y, p0x, *want.shape[2:])
    torch.testing.assert_close(got, want.detach()[0, 0], rtol=1e-10, atol=1e-10)
    dx, db = _transcribe_backward(x[0, 0], b[0], dy[0, 0], cu, cd, up, down, p0y, p0x)
    torch.testing.assert_close(dx, xi.grad[0, 0], rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(db, bi.grad[0], rtol=1e-10, atol=1e-10)


def _tiny_cell():
    cell = registry.cell("sg3t-ffhq1024-train-b4")
    cell.traffic = dict(cell.traffic, batch=4, ring=3)
    return cell


def _tcfg():
    from benchmark.harness.train import train_config

    return train_config(_tiny_cell().config, TINY)


def test_generator_forward_matches_the_reference():
    tcfg = _tcfg()
    with cpu_threads():
        g_w, _ = driver._weights(tcfg, 11, "cpu")
        _, state = driver.program_state(tcfg, g_w, driver._weights(tcfg, 11, "cpu")[1], "cpu")
        ref_g, _ = ref_sg3.Generator(32, 1024, 32, 2, tcfg["magnitude_ema_beta"]), None
        ref_g.load_state_dict(g_w)
        z = torch.randn((3, 512), generator=torch.Generator().manual_seed(2))
        with torch.no_grad():
            got = state.generator(z, update_emas=True)
            want = ref_g(z, update_emas=True)
    assert got.shape == (3, 3, 32, 32)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * want.abs().max().item())
    # The magnitude-EMA update: lerp of each layer's input mean square
    # toward the old value by beta.
    for a, r in zip(state.generator.magnitude_emas(), ref_g.magnitude_emas()):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=0)
        assert float(a) != 1.0


def test_magnitude_ema_update_rule():
    tcfg = _tcfg()
    layer = getattr(driver.program_state(tcfg, *driver._weights(tcfg, 5, "cpu"), "cpu")[1].generator.synthesis,
                    "L0_36_32")
    x = torch.randn((2, 32, 36, 36)) * 3
    w = torch.randn((2, 512))
    before = stylegan3.magnitude_ema_updates.count
    with torch.no_grad():
        layer(x, w, update_emas=True)
    beta = tcfg["magnitude_ema_beta"]
    assert stylegan3.magnitude_ema_updates.count == before + 1
    torch.testing.assert_close(layer.magnitude_ema, x.square().mean() * (1 - beta) + beta, rtol=1e-6, atol=0)


def test_first_three_unconditional_steps_match_the_reference():
    """The benchmark driver's own comparison at a tiny f32 size: losses and
    first gradients (G's, and D's of the R1 phase) within 1e-4 (float32 in
    both, summed in other orders: the grouped per-sample convolution of the
    reference, the batch-shared one of the port), and the change of G, D
    and the EMA after three steps within 1e-2 (Adam moves an element whose
    gradient is round-off by about the learning rate too)."""
    import time

    cell = _tiny_cell()
    with cpu_threads():
        out = driver.run(cell, 2**31 + 17, 0.0, False, time.perf_counter(), device="cpu", overrides=STEP_TINY)
    assert [m["r1"] > 0 for m in out["first_losses"]] == [True, False, True]
    for name, c in out["checks"].items():
        assert c["value"] <= (1e-2 if name.startswith("change") else 1e-4), (name, c)
    assert out["correct"]
    assert out["flops"]["mean"] > out["flops"]["plain"] > 0


def test_flops_count_the_programs_layers():
    """The yardstick's G count is the program's analytic count."""
    from benchmark.harness import flops_sg3
    from gif_tpu_torch.utils.flops import analytic_stylegan3_generator_forward_flops

    cfg = get_config("stylegan3-t-ffhq1024", batch_size=4)
    tcfg = {**_tcfg(), "max_size": 1024, "channel_base": 32768, "max_channels": 512}
    assert flops_sg3.generator_forward(tcfg, 4) == analytic_stylegan3_generator_forward_flops(cfg, 4)


def test_traced_step_records_its_phases_spans_and_counters():
    """Under a profiler one R1 step records ``train.step`` with the GIF
    step's phase names (G's forward twice: its own and the D phase's), the
    G spans ``sg3.input`` / ``sg3.synthesis`` inside them, and the step's
    counters: one magnitude-EMA update per synthesis layer (the D phase's
    G forward), no kernel launch on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    from gif_tpu_torch.train.state import create_train_state
    from gif_tpu_torch.train.step import make_train_step
    from gif_tpu_torch.utils import profiling

    cfg = get_config("stylegan3-t-ffhq1024", **dict(TINY, channel_base=256, max_channels=8))
    state = create_train_state(cfg, device="cpu")
    step = make_train_step(cfg, None, device="cpu")
    real = torch.rand((4, 32, 32, 3)) * 2 - 1
    profiling.clear_spans()
    with cpu_threads(), profile(activities=[ProfilerActivity.CPU]):
        step(state, {"real_image": real})
    spans = profiling.spans()
    names = [s.name for s in spans]
    assert names[0] == "train.step" and spans[0].attrs == {"step": 0, "r1": True}
    phases = [n for n in names if n.startswith("train.") and n != "train.step"]
    assert phases == ["train.g_forward", "train.g_grads", "train.g_adam", "train.g_forward", "train.d_grads",
                      "train.d_adam", "train.d_grads", "train.d_adam", "train.ema"]
    assert [(s.name, s.parent) for s in spans if s.name.startswith("sg3.")] == [
        ("sg3.input", "train.g_forward"), ("sg3.synthesis", "train.g_forward")] * 2
    counters = spans[0].counters
    assert counters["magnitude_ema_updates"] == len(state.generator.synthesis.layer_names) == 15
    assert counters["filtered_lrelu"] == counters["filtered_lrelu_backward"] == 0
    profiling.clear_spans()

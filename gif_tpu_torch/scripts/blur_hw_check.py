"""Kernel 4 (the separable 4-tap FIR blur, ``csrc/blur.cu``) against a
depthwise ``F.conv2d`` of the same FIR, at the blur shapes the 256 px
models emit, forward and VJP, on the card (port of
``scripts/blur_hw_check.py``).

Per case: the largest difference of the kernel from the depthwise conv
relative to the conv's largest value (bf16 in and out, so ~1e-2 is one
bf16 step; the kernel's own plain version is held bit for bit in
tests/test_torch_kernels.py), the same for the gradient of
``sum(y ** 2)``, and each side's time per call by CUDA events over
``--iters`` back-to-back calls.

    python -m gif_tpu_torch.scripts.blur_hw_check [--iters 50] [--batch 16]
"""

from __future__ import annotations

import argparse

import numpy as np

# (shape NCHW at batch 16, pads (p0y, p1y, p0x, p1x), gain) of the models'
# blur call sites at 256 px: the up-path blur on the odd transposed-conv
# output (legacy) and on the even one (``even`` resampling), and the
# discriminator's down-blurs (legacy, and ``even``'s extended pads).
CASES = [
    ((16, 128, 257, 257), (1, 1, 1, 1), 4.0),
    ((16, 256, 129, 129), (1, 1, 1, 1), 4.0),
    ((16, 512, 65, 65), (1, 1, 1, 1), 4.0),
    ((16, 128, 258, 258), (1, 0, 1, 0), 4.0),
    ((16, 128, 256, 256), (2, 2, 2, 2), 1.0),
    ((16, 256, 128, 128), (2, 2, 2, 2), 1.0),
    ((16, 512, 64, 64), (2, 2, 2, 2), 1.0),
    ((16, 128, 256, 256), (2, 3, 2, 3), 1.0),
    ((16, 128, 256, 256), (1, 1, 1, 1), 1.0),
]
TAPS = (1, 3, 3, 1)


def depthwise_blur(x, pads, gain):
    """The same blur as one depthwise ``F.conv2d`` of the 2-D FIR (a true
    convolution: the flipped kernel, correlated), in ``x``'s dtype."""
    import torch
    import torch.nn.functional as F

    k = np.outer(TAPS, TAPS).astype(np.float32)
    k = torch.as_tensor(k / k.sum() * gain, dtype=x.dtype, device=x.device).flip(0, 1)
    c = x.shape[1]
    xp = F.pad(x, (pads[2], pads[3], pads[0], pads[1]))
    return F.conv2d(xp, k[None, None].expand(c, 1, 4, 4), groups=c)


def event_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    a = ap.parse_args(argv)

    import torch

    from gif_tpu_torch.device import resolve_device
    from gif_tpu_torch.ops.blur_cuda import blur4, taps_1d

    dev = resolve_device("cuda")  # kernel 4 exists on the card only
    print("device:", torch.cuda.get_device_name(dev))
    rng = np.random.default_rng(0)
    rows = []
    for shape, pads, gain in CASES:
        shape = (a.batch,) + shape[1:]
        x = torch.as_tensor(rng.standard_normal(shape, dtype=np.float32), device=dev).to(torch.bfloat16)
        taps = taps_1d(TAPS, gain)

        def kern(x=x, p=pads, t=taps):
            return blur4(x, t, p)

        def conv(x=x, p=pads, g=gain):
            return depthwise_blur(x, p, g)

        ya, yb = conv().float(), kern().float()
        err = ((ya - yb).abs().max() / ya.abs().max().clamp_min(1e-6)).item()

        def grads(f, x=x):
            xr = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(f(xr).float().square().sum(), xr)
            return g

        ga = grads(lambda v, p=pads, g=gain: depthwise_blur(v, p, g)).float()
        gb = grads(lambda v, p=pads, t=taps: blur4(v, t, p)).float()
        gerr = ((ga - gb).abs().max() / ga.abs().max().clamp_min(1e-6)).item()
        ta, tb = event_ms(conv, a.iters), event_ms(kern, a.iters)
        moved = 2 * (x.numel() + yb.numel())  # bf16 in and out
        row = {"shape": list(shape), "pads": list(pads), "rel_err": err, "grad_rel_err": gerr, "conv_ms": ta,
               "kernel_ms": tb, "speedup": ta / tb, "kernel_gb_per_s": moved / (tb * 1e-3) / 1e9}
        rows.append(row)
        print(f"{tuple(shape)} pads={pads}: relerr={err:.2e} graderr={gerr:.2e} depthwise conv={ta:.3f} ms "
              f"kernel 4={tb:.3f} ms speedup={ta / tb:.2f}x ~{row['kernel_gb_per_s']:.0f} GB/s")
    return rows


if __name__ == "__main__":
    main()

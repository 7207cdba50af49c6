"""InceptionV3, the FID variant, inference only (port of
:mod:`gif_tpu.eval.inception`).

The architecture of the TF-compatible FID port (pytorch_fid's
``FIDInceptionA/C/E_1/E_2`` on torchvision's Inception v3 stem): every conv
is ``BasicConv2d`` (conv without bias, BatchNorm with eps 1e-3 in its
inference form, ReLU); the average pools of blocks A, C and E-1 exclude
the padding (``count_include_pad=False``) and block E-2 max-pools its pool
branch.  The output is the 2048-d pool3 feature.  Module names follow
pytorch_fid's (``Conv2d_1a_3x3.conv``, ``Mixed_5b.branch1x1.bn``, ...), so
a pt_inception-2015-12-05 ``state_dict`` loads as it is.  Convs, pools and
the resize are stock PyTorch: no Pallas kernel sat here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

FID_SIZE = 299


class BasicConv2d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, **kw):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, bias=False, **kw)
        self.bn = nn.BatchNorm2d(out_ch, eps=0.001)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_no_pad(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_no_pad(x))
        return torch.cat([b1, b5, bd, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        bd = self.branch7x7dbl_5(self.branch7x7dbl_4(self.branch7x7dbl_3(self.branch7x7dbl_2(bd))))
        bp = self.branch_pool(_avg_pool_no_pad(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """``pool_mode`` 'avg': FIDInceptionE_1; 'max': FIDInceptionE_2."""

    def __init__(self, in_ch: int, pool_mode: str):
        super().__init__()
        self.pool_mode = pool_mode
        self.branch1x1 = BasicConv2d(in_ch, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool_mode == "max":
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool_no_pad(x)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class InceptionV3FID(nn.Module):
    """Pool3 (2048-d) feature extractor.  Input: (B, 3, 299, 299) NCHW in
    [-1, 1]; output (B, 2048)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                      self.Mixed_6c, self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b,
                      self.Mixed_7c):
            x = block(x)
        return x.mean(dim=(2, 3))


def random_fid_params(seed: int = 0) -> dict:
    """He-initialised random weights for relative-FID mode, as a
    ``state_dict``: the numbers of ``gif_tpu.eval.inception.
    random_fid_params(seed)`` bit for bit.  Each conv kernel is drawn
    ``standard_normal`` in flax's HWIO shape from one
    ``np.random.default_rng(seed)``, in flax's leaf order (paths sorted),
    times ``sqrt(2 / fan_in)``; BatchNorm is the identity (gamma and
    variance 1, beta and mean 0).  Variance-preserving under ReLU, so the
    pool3 features stay live across ~90 layers (a LeCun init collapses them
    to a constant)."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in InceptionV3FID().state_dict().items()}
    prefixes = sorted(
        (k[: -len(".conv.weight")] for k in shapes if k.endswith(".conv.weight")),
        key=lambda p: p.split("."),
    )
    rng = np.random.default_rng(seed)
    sd = {}
    for p in prefixes:
        o, i, kh, kw = shapes[f"{p}.conv.weight"]
        hwio = rng.standard_normal((kh, kw, i, o)).astype(np.float32) * np.sqrt(2.0 / (kh * kw * i))
        sd[f"{p}.conv.weight"] = torch.from_numpy(
            np.ascontiguousarray(hwio.astype(np.float32).transpose(3, 2, 0, 1))
        )
        sd[f"{p}.bn.weight"] = torch.ones(o)
        sd[f"{p}.bn.bias"] = torch.zeros(o)
        sd[f"{p}.bn.running_mean"] = torch.zeros(o)
        sd[f"{p}.bn.running_var"] = torch.ones(o)
    return sd


def preprocess_for_fid(images01: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) NHWC images in [0, 1] -> (B, 299, 299, 3) in [-1, 1]:
    bilinear resize (``align_corners=False``, no antialiasing), then ``2x -
    1`` (pytorch_fid's resize and InceptionV3 input scaling)."""
    x = F.interpolate(
        images01.permute(0, 3, 1, 2), size=(FID_SIZE, FID_SIZE), mode="bilinear",
        align_corners=False, antialias=False,
    )
    return (x * 2.0 - 1.0).permute(0, 2, 3, 1)

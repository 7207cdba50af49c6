"""Convert reference GIF torch checkpoints (``.model``) to flax-layout trees
(the port's own copy of :mod:`gif_tpu.tools.convert_checkpoint`).

It writes the same pickle of numpy trees (``g_params``, ``g_ema_params``,
``d_params``, ``buffers``) as the JAX package's tool, so one file serves
``--converted_ckpt`` in both training CLIs; the port loads it through
:mod:`gif_tpu_torch.tools.convert_params`
(:func:`gif_tpu_torch.train.state.warm_start_from_converted`).

The reference checkpoint is a dict of five state_dicts (train.py:254-265):
``generator_running`` (EMA), ``generator``, ``g_optimizer``,
``discriminator_flm``, ``d_optimizer_flm``; module keys carry the
``module.`` DataParallel prefix.  This tool maps generator / EMA /
discriminator weights onto the flax trees (optimizer states are not
portable across frameworks and are re-initialized).

Layout notes:
- torch conv OIHW -> flax HWIO;
- ModulatedConv2d weight has a leading singleton (1, O, I, kh, kw);
- FusedLeakyReLU bias (1, C, 1, 1) -> (C,);
- ConstantInput (1, 512, 4, 4) -> NHWC (1, 4, 4, 512);
- the discriminator's first dense layer consumed a (C, H, W)-flattened
  vector; its columns are permuted to the NHWC (H, W, C) flatten order.
"""

from __future__ import annotations

import argparse
import math
import pickle

import numpy as np
import torch

from gif_tpu_torch.tools.manifest import check_manifest, require_keys


def _conv_w(w):  # OIHW -> HWIO
    return np.asarray(w).transpose(2, 3, 1, 0)


def _strip_module(sd: dict) -> dict:
    return {
        (k[len("module."):] if k.startswith("module.") else k): np.asarray(v)
        for k, v in sd.items()
    }


def _styled_conv(sd: dict, prefix: str) -> dict:
    """Reference StyledConv (conv + noise net + activate) -> flax StyledConv."""
    return {
        "conv": {
            "weight": _conv_w(sd[f"{prefix}.conv.weight"][0]),
            "modulation": {
                "weight": sd[f"{prefix}.conv.modulation.weight"],
                "bias": sd[f"{prefix}.conv.modulation.bias"],
            },
        },
        "noise": {
            "conv0": {
                "kernel": _conv_w(sd[f"{prefix}.noise.noise_conv.0.weight"]),
                "bias": sd[f"{prefix}.noise.noise_conv.0.bias"],
            },
            "conv1": {
                "kernel": _conv_w(sd[f"{prefix}.noise.noise_conv.2.weight"]),
                "bias": sd[f"{prefix}.noise.noise_conv.2.bias"],
            },
            "conv2": {
                "kernel": _conv_w(sd[f"{prefix}.noise.noise_conv.4.weight"]),
                "bias": sd[f"{prefix}.noise.noise_conv.4.bias"],
            },
        },
        "act_bias": sd[f"{prefix}.activate.bias"].reshape(-1),
    }


def _to_rgb(sd: dict, prefix: str) -> dict:
    return {
        "conv": {
            "weight": _conv_w(sd[f"{prefix}.conv.weight"][0]),
            "modulation": {
                "weight": sd[f"{prefix}.conv.modulation.weight"],
                "bias": sd[f"{prefix}.conv.modulation.bias"],
            },
        },
        "bias": sd[f"{prefix}.bias"].reshape(-1),
    }


def convert_generator(sd: dict, n_blocks: int = 9, n_mlp: int = 8):
    """torch StyledGenerator state_dict -> (params, buffers) flax trees."""
    sd = _strip_module(sd)
    # Fail loudly on the anchors before walking the blocks: a checkpoint from
    # the wrong model (or a truncated download) should name every problem at
    # once, not die on the first KeyError (reference ckpt layout:
    # train.py:254-265, stg2_generator.py:212-247).
    check_manifest(
        sd,
        {
            "image_embedding.embd_weight": (None, 512),
            "generator.const_input.input": (1, 512, 4, 4),
            "z_to_w.1.weight": (512, 512),
            f"z_to_w.{n_mlp}.weight": (512, 512),
            "generator.progression.0.st_cv1.conv.weight": (1, 512, 512, 3, 3),
            "generator.to_rgb.0.conv.weight": (1, 3, 512, 1, 1),
        },
        "generator state_dict",
    )
    synthesis: dict = {
        "const_input": sd["generator.const_input.input"].transpose(0, 2, 3, 1)
    }
    for i in range(n_blocks):
        if f"generator.progression.{i}.st_cv1.conv.weight" not in sd:
            break
        block = {"conv1": _styled_conv(sd, f"generator.progression.{i}.st_cv1")}
        if f"generator.progression.{i}.st_cv2.conv.weight" in sd:
            block["conv2"] = _styled_conv(sd, f"generator.progression.{i}.st_cv2")
        synthesis[f"block{i}"] = block
        synthesis[f"to_rgb{i}"] = _to_rgb(sd, f"generator.to_rgb.{i}")

    mapping = {}
    for i in range(n_mlp):
        # z_to_w Sequential: index 0 is PixelNorm (no params), 1..n are
        # EqualLinear (stylegan2_common_layers.py:514-524).
        mapping[f"dense{i}"] = {
            "weight": sd[f"z_to_w.{i + 1}.weight"],
            "bias": sd[f"z_to_w.{i + 1}.bias"],
        }

    params = {"synthesis": synthesis, "mapping": mapping}
    buffers = {"embedding": sd["image_embedding.embd_weight"]}
    return params, buffers


def _conv_layer(sd: dict, prefix: str, downsample: bool, activate: bool = True):
    conv_idx = 1 if downsample else 0  # Blur occupies slot 0 when downsampling
    out = {"conv": {"weight": _conv_w(sd[f"{prefix}.{conv_idx}.weight"])}}
    if activate:
        out["act_bias"] = sd[f"{prefix}.{conv_idx + 1}.bias"].reshape(-1)
    return out


def convert_discriminator(sd: dict, size: int = 256):
    sd = _strip_module(sd)
    check_manifest(
        sd,
        {
            # 1x1 fromRGB over image+condition channels (6 or 9 depending on
            # the run's condition set, train.py:350-353).
            "convs.0.0.weight": (None, None, 1, 1),
            "final_conv.0.weight": (512, 513, 3, 3),  # +1 stddev feature
            "final_linear.0.weight": (512, 512 * 4 * 4),
            "final_linear.1.weight": (1, 512),
        },
        "discriminator state_dict",
    )
    log_size = int(math.log2(size))
    params: dict = {"from_rgb": _conv_layer(sd, "convs.0", downsample=False)}
    for j, i in enumerate(range(log_size, 2, -1)):
        prefix = f"convs.{j + 1}"
        params[f"res{i}"] = {
            "conv1": _conv_layer(sd, f"{prefix}.conv1", downsample=False),
            "conv2": _conv_layer(sd, f"{prefix}.conv2", downsample=True),
            "skip": _conv_layer(sd, f"{prefix}.skip", downsample=True, activate=False),
        }
    params["final_conv"] = _conv_layer(sd, "final_conv", downsample=False)

    # Dense 1: permute the flatten order CHW -> HWC.
    w = np.asarray(sd["final_linear.0.weight"])  # (512, 512*4*4) over (C,H,W)
    w = w.reshape(512, 512, 4, 4).transpose(0, 2, 3, 1).reshape(512, 512 * 4 * 4)
    params["final_dense"] = {"weight": w, "bias": sd["final_linear.0.bias"]}
    params["out"] = {
        "weight": sd["final_linear.1.weight"],
        "bias": sd["final_linear.1.bias"],
    }
    return params


def convert_checkpoint(model_path: str, out_path: str, size: int = 256) -> str:
    ckpt = torch.load(model_path, map_location="cpu", weights_only=True)
    require_keys(
        ckpt,
        ["generator", "generator_running", "discriminator_flm"],
        f"{model_path} (reference .model checkpoint, train.py:254-265)",
    )
    to_np = lambda d: {k: v.numpy() for k, v in d.items()}

    g_params, g_buffers = convert_generator(to_np(ckpt["generator"]))
    ema_params, _ = convert_generator(to_np(ckpt["generator_running"]))
    d_params = convert_discriminator(to_np(ckpt["discriminator_flm"]), size=size)

    with open(out_path, "wb") as f:
        pickle.dump(
            {
                "g_params": g_params,
                "g_ema_params": ema_params,
                "d_params": d_params,
                "buffers": g_buffers,
            },
            f,
        )
    return out_path


def main():
    """``python -m gif_tpu_torch.tools.convert_checkpoint --model ref.model --out trees.pkl``"""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", required=True, help="reference .model checkpoint")
    p.add_argument("--out", required=True, help="output pickle of flax trees")
    p.add_argument("--size", type=int, default=256)
    a = p.parse_args()
    print(convert_checkpoint(a.model, a.out, a.size))


if __name__ == "__main__":
    main()

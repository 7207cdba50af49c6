"""Convert the FID InceptionV3 torch weights to the npz of flax params that
the JAX package's ``gif_tpu.tools.convert_inception`` writes (the port's
own copy: keys are the flax parameter paths joined by ``/``, convs HWIO).

The canonical weights are pt_inception-2015-12-05 (the TF-compatible FID
port, URL in reference my_utils/pytorch_fid/inception.py:14).  Run where the
file is available:

  python -m gif_tpu_torch.tools.convert_inception --torch_weights pt_inception.pth \\
      --out resources/inception_fid.npz

The port's own ``InceptionV3FID`` loads the ``.pth`` as it is (pytorch_fid's
module names); the npz is what ``python -m gif_tpu_torch.train
--inception_weights`` and the JAX package both read.
"""

from __future__ import annotations

import argparse

import numpy as np

# The convs of each Inception block and the network's blocks in order: the
# layout of pytorch_fid's state dict (gif_tpu.eval.inception's tables).
BLOCK_CONVS = {
    "InceptionA": ["branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1",
                   "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool"],
    "InceptionB": ["branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"],
    "InceptionC": ["branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
                   "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
                   "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"],
    "InceptionD": ["branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2",
                   "branch7x7x3_3", "branch7x7x3_4"],
    "InceptionE": ["branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
                   "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a",
                   "branch3x3dbl_3b", "branch_pool"],
}

LAYOUT = [
    ("Conv2d_1a_3x3", None),
    ("Conv2d_2a_3x3", None),
    ("Conv2d_2b_3x3", None),
    ("Conv2d_3b_1x1", None),
    ("Conv2d_4a_3x3", None),
    ("Mixed_5b", "InceptionA"),
    ("Mixed_5c", "InceptionA"),
    ("Mixed_5d", "InceptionA"),
    ("Mixed_6a", "InceptionB"),
    ("Mixed_6b", "InceptionC"),
    ("Mixed_6c", "InceptionC"),
    ("Mixed_6d", "InceptionC"),
    ("Mixed_6e", "InceptionC"),
    ("Mixed_7a", "InceptionD"),
    ("Mixed_7b", "InceptionE"),
    ("Mixed_7c", "InceptionE"),
]


def _conv_prefixes():
    for name, block in LAYOUT:
        if block is None:
            yield name, (name,)
        else:
            for conv in BLOCK_CONVS[block]:
                yield f"{name}.{conv}", (name, conv)


def _inception_manifest() -> dict:
    """Expected keys/shapes of the pt_inception-2015 FID state dict,
    derived from the same layout tables the converter consumes."""
    manifest = {}
    for prefix, _ in _conv_prefixes():
        manifest[f"{prefix}.conv.weight"] = (None, None, None, None)
        for stat in ("weight", "bias", "running_mean", "running_var"):
            manifest[f"{prefix}.bn.{stat}"] = (None,)
    # Anchor shapes: the FID port's stem and pool3 width.
    manifest["Conv2d_1a_3x3.conv.weight"] = (32, 3, 3, 3)
    manifest["Mixed_7c.branch_pool.conv.weight"] = (192, 2048, 1, 1)
    return manifest


def inception_flax_params(sd: dict) -> dict:
    """A pt_inception state_dict (numpy arrays, pytorch_fid's names, OIHW)
    -> the flax ``InceptionV3FID`` params tree (each ``BasicConv2d`` a
    ``conv/kernel`` HWIO and ``bn_gamma`` / ``bn_beta`` / ``bn_mean`` /
    ``bn_var``): the inverse of
    :func:`gif_tpu_torch.tools.convert_params.convert_inception_params`.
    Keys outside the layout (the classifier, BatchNorm step counts) are
    left out."""
    params: dict = {}
    for prefix, path in _conv_prefixes():
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node["conv"] = {"kernel": np.asarray(sd[f"{prefix}.conv.weight"]).transpose(2, 3, 1, 0)}
        for leaf, stat in (("bn_gamma", "weight"), ("bn_beta", "bias"), ("bn_mean", "running_mean"),
                           ("bn_var", "running_var")):
            node[leaf] = np.asarray(sd[f"{prefix}.bn.{stat}"])
    return params


def convert(torch_weights_path: str, out_path: str) -> str:
    import torch

    from gif_tpu_torch.tools.manifest import check_manifest

    sd = torch.load(torch_weights_path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}
    check_manifest(sd, _inception_manifest(), f"{torch_weights_path} (FID InceptionV3)")
    flat = {}

    def _flatten(prefix, tree):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                _flatten(key, v)
            else:
                flat[key] = np.asarray(v)

    _flatten("", inception_flax_params(sd))
    np.savez_compressed(out_path, **flat)
    return out_path


def load_converted_params(path: str) -> dict:
    """Load an npz produced by :func:`convert` back into a nested dict."""
    data = np.load(path)
    tree: dict = {}
    for key in data.files:
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]
    return tree


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--torch_weights", required=True)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    print(convert(a.torch_weights, a.out))


if __name__ == "__main__":
    main()

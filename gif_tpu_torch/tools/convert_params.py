"""Convert the JAX package's generator tree into the port's ``state_dict``.

Input: the flax ``g_params`` (or ``g_ema_params``) and ``buffers`` nested
dicts as numpy — the trees a ``gif_tpu`` train state holds and the pickles
``gif_tpu.tools.convert_checkpoint`` writes.  The module names of
:mod:`gif_tpu_torch.models` follow the flax tree, so the conversion is a
flatten (``a/b/c`` -> ``a.b.c``) plus layout changes:

- HWIO conv weights (EqualConv / ModulatedConv ``weight``, flax ``nn.Conv``
  ``kernel`` renamed ``weight``) -> OIHW;
- ``const_input`` NHWC -> NCHW;
- the identity-embedding buffer is copied as it is, never regenerated.

Run:

  python -m gif_tpu_torch.tools.convert_params trees.pkl out.pt [--params g_ema_params]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, name + ".")
        else:
            yield name, np.asarray(v)


def convert_generator_params(g_params: dict, buffers: dict) -> dict:
    """flax generator params + buffers -> ``StyledGenerator`` state_dict."""
    sd = {}
    for name, arr in _flatten(g_params):
        if name.endswith(".kernel"):
            name = name[: -len(".kernel")] + ".weight"
            arr = arr.transpose(3, 2, 0, 1)
        elif name.endswith(".weight") and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif name.endswith("const_input"):
            arr = arr.transpose(0, 3, 1, 2)
        sd[name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    for name, arr in _flatten(buffers):
        sd[name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return sd


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("trees", help="pickle of numpy flax trees (gif_tpu.tools.convert_checkpoint)")
    p.add_argument("out", help="output .pt state_dict")
    p.add_argument("--params", default="g_ema_params", help="which params tree to convert")
    a = p.parse_args(argv)
    import pickle

    # Only ever unpickle trees this project wrote.
    with open(a.trees, "rb") as f:
        trees = pickle.load(f)
    torch.save(convert_generator_params(trees[a.params], trees["buffers"]), a.out)
    print(a.out)


if __name__ == "__main__":
    main()

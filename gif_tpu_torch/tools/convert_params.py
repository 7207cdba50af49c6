"""Convert the JAX package's trees into the port's ``state_dict``s.

Input: flax ``g_params`` / ``g_ema_params`` / ``d_params`` and ``buffers``
nested dicts as numpy — the trees a ``gif_tpu`` train state holds and the
pickles ``gif_tpu.tools.convert_checkpoint`` writes — or a whole train
state (:func:`convert_train_state`); the FID InceptionV3's flax
params (:func:`convert_inception_params`, :func:`load_inception_npz`);
and the eye-camera regressor's variables
(:func:`convert_eye_regressor_variables`).
The module names of :mod:`gif_tpu_torch.models` follow the flax tree, so
the conversion is a flatten (``a/b/c`` -> ``a.b.c``) plus layout changes:

- HWIO conv weights (EqualConv / ModulatedConv ``weight``, flax ``nn.Conv``
  ``kernel`` renamed ``weight``) -> OIHW;
- ``const_input`` NHWC -> NCHW;
- the identity-embedding buffer is copied as it is, never regenerated.

Adam's moments are elementwise, so they take the same changes as the
parameters they belong to.  :func:`train_state_trees` goes the other way:
a port train state -> the trees pickle's four trees.

Run:

  python -m gif_tpu_torch.tools.convert_params trees.pkl out.pt [--params g_ema_params|g_params|d_params]
"""

from __future__ import annotations

import argparse
import re

import numpy as np
import torch


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, name + ".")
        else:
            yield name, np.asarray(v)


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


def convert_params(params: dict) -> dict:
    """A flax parameter tree (G or D, or an elementwise tree shaped like
    one) -> the port's parameter names and layouts."""
    sd = {}
    for name, arr in _flatten(params):
        if name.endswith(".kernel"):
            name = name[: -len(".kernel")] + ".weight"
            arr = arr.transpose(3, 2, 0, 1)
        elif name.endswith(".weight") and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif name.endswith("const_input"):
            arr = arr.transpose(0, 3, 1, 2)
        sd[name] = _tensor(arr)
    return sd


def convert_generator_params(g_params: dict, buffers: dict) -> dict:
    """flax generator params + buffers -> ``StyledGenerator`` state_dict."""
    sd = convert_params(g_params)
    for name, arr in _flatten(buffers):
        sd[name] = _tensor(arr)
    return sd


# The port's names of flax ``nn.Conv`` kernels (G's condition injection);
# every other 4-D ``weight`` is an EqualConv / ModulatedConv weight.
_FLAX_CONV = re.compile(r"\.noise\.conv\d+\.weight$")


def flax_layout(name: str, ndim: int) -> tuple[str, tuple | None]:
    """(flax path joined by ``.``, axis permutation into the flax layout
    or None) of the port parameter ``name`` of rank ``ndim``."""
    if _FLAX_CONV.search(name):
        return name[: -len(".weight")] + ".kernel", (2, 3, 1, 0)
    if name.endswith(".weight") and ndim == 4:
        return name, (2, 3, 1, 0)
    if name.endswith("const_input"):
        return name, (0, 2, 3, 1)
    return name, None


def _nest(flat: dict) -> dict:
    tree = {}
    for name, leaf_value in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = leaf_value
    return tree


def to_flax_params(sd: dict) -> dict:
    """The inverse of :func:`convert_params`: a port state_dict (without
    buffers) -> a nested flax-layout tree of float32 numpy arrays."""
    flat = {}
    for name, t in sd.items():
        arr = t.detach().cpu().float().numpy()
        name, perm = flax_layout(name, arr.ndim)
        flat[name] = np.ascontiguousarray(arr if perm is None else arr.transpose(perm))
    return _nest(flat)


def flax_shapes(module) -> dict:
    """The nested flax-layout tree of ``module``'s parameters (buffers left
    out), each leaf an object carrying only the flax ``shape``: the tree
    :func:`to_flax_params` would give, without the values.  Works on a
    module on the meta device."""
    flat = {}
    for name, p in module.named_parameters():
        name, perm = flax_layout(name, p.dim())
        shape = tuple(p.shape)
        flat[name] = _Shape(shape if perm is None else tuple(shape[i] for i in perm))
    return _nest(flat)


class _Shape:
    """A shape-only leaf of :func:`flax_shapes`."""

    def __init__(self, shape):
        self.shape = shape

    def __repr__(self):
        return f"Shape{self.shape}"


def train_state_trees(state) -> dict:
    """A port ``TrainState`` -> the four trees of the pickle the
    ``convert_checkpoint`` tools write (``g_params``, ``g_ema_params``,
    ``d_params``, ``buffers``), which ``--converted_ckpt`` loads in both
    packages."""

    def params(module):
        return to_flax_params({k: v for k, v in module.state_dict().items() if k != "embedding"})

    return {
        "g_params": params(state.generator),
        "g_ema_params": params(state.g_ema),
        "d_params": params(state.discriminator),
        "buffers": {"embedding": state.generator.embedding.detach().cpu().float().numpy()},
    }


def convert_discriminator_params(d_params: dict) -> dict:
    """flax discriminator params -> ``Discriminator`` state_dict."""
    return convert_params(d_params)


def _convert_adam(opt_state) -> dict:
    # optax.adam's state: (ScaleByAdamState(count, mu, nu), EmptyState()).
    count, mu, nu = opt_state[0]
    return {
        "step": int(np.asarray(count)),
        "exp_avg": convert_params(mu),
        "exp_avg_sq": convert_params(nu),
    }


def convert_train_state(state) -> dict:
    """A ``gif_tpu`` ``TrainState`` with numpy leaves (``jax.device_get``)
    -> the dict
    :func:`gif_tpu_torch.train.state.load_train_state` loads: G, EMA and D
    state_dicts, both Adam states (``mu`` / ``nu`` / ``count`` ->
    ``exp_avg`` / ``exp_avg_sq`` / ``step``, by parameter name), ``step``,
    ``pl_mean`` and ``used_samples``."""
    buffers = state.buffers
    return {
        "generator": convert_generator_params(state.g_params, buffers),
        "g_ema": convert_generator_params(state.g_ema_params, buffers),
        "discriminator": convert_discriminator_params(state.d_params),
        "g_opt": _convert_adam(state.g_opt_state),
        "d_opt": _convert_adam(state.d_opt_state),
        "step": int(np.asarray(state.step)),
        "pl_mean": float(np.asarray(state.pl_mean)),
        "used_samples": int(np.asarray(state.used_samples)),
    }


_BN_NAMES = {"bn_gamma": "bn.weight", "bn_beta": "bn.bias", "bn_mean": "bn.running_mean",
             "bn_var": "bn.running_var"}


def convert_inception_params(flax_tree: dict) -> dict:
    """flax ``InceptionV3FID`` params (``gif_tpu.eval.inception``: each
    ``BasicConv2d`` holds ``conv/kernel`` HWIO and ``bn_gamma`` /
    ``bn_beta`` / ``bn_mean`` / ``bn_var``) -> the state_dict of
    :class:`gif_tpu_torch.eval.inception.InceptionV3FID` (pytorch_fid's
    names, OIHW)."""
    sd = {}
    for name, arr in _flatten(flax_tree):
        prefix, leaf = name.rsplit(".", 1)
        if leaf == "kernel":
            sd[prefix + ".weight"] = _tensor(arr.transpose(3, 2, 0, 1))
        elif leaf in _BN_NAMES:
            sd[f"{prefix}.{_BN_NAMES[leaf]}"] = _tensor(arr)
        else:
            raise KeyError(f"unexpected InceptionV3 parameter {name}")
    return sd


def convert_eye_regressor_variables(variables: dict) -> dict:
    """flax ``CameraRegressor`` variables (``gif_tpu.flame.eye_regressor``:
    ``params`` with Dense ``kernel`` (in, out) / ``bias`` and BatchNorm
    ``scale`` / ``bias``; ``batch_stats`` with ``mean`` / ``var``) -> the
    state_dict of :class:`gif_tpu_torch.flame.eye_regressor.CameraRegressor`
    (Linear weights (out, in); ``FlaxBatchNorm`` ``weight`` / ``bias`` /
    ``running_mean`` / ``running_var``)."""
    names = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}
    sd = {}
    for tree in (variables["params"], variables.get("batch_stats", {})):
        for name, arr in _flatten(tree):
            prefix, leaf = name.rsplit(".", 1)
            arr = np.asarray(arr)
            sd[f"{prefix}.{names[leaf]}"] = _tensor(arr.T if leaf == "kernel" else arr)
    return sd


def load_inception_npz(path: str) -> dict:
    """The ``.npz`` that :mod:`gif_tpu_torch.tools.convert_inception` (and
    ``gif_tpu.tools.convert_inception``) writes (flax params, keys joined by
    ``/``) -> an ``InceptionV3FID`` state_dict."""
    from gif_tpu_torch.tools.convert_inception import load_converted_params

    return convert_inception_params(load_converted_params(path))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("trees", help="pickle of numpy flax trees (gif_tpu.tools.convert_checkpoint)")
    p.add_argument("out", help="output .pt state_dict")
    p.add_argument("--params", default="g_ema_params", choices=("g_ema_params", "g_params", "d_params"),
                   help="which params tree to convert")
    a = p.parse_args(argv)
    import pickle

    # Only ever unpickle trees this project wrote.
    with open(a.trees, "rb") as f:
        trees = pickle.load(f)
    if a.params == "d_params":
        sd = convert_discriminator_params(trees["d_params"])
    else:
        sd = convert_generator_params(trees[a.params], trees["buffers"])
    torch.save(sd, a.out)
    print(a.out)


if __name__ == "__main__":
    main()

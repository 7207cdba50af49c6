"""Fill a flax-layout parameter tree from a seed, leaf by leaf, by name.

The rule needs only each leaf's name and shape, so two packages that share
a parameter layout draw the same weights without exchanging any: every
leaf comes from ``np.random.default_rng([seed, zlib.crc32(name)])``, where
``name`` is its path in the tree joined by ``/`` (``synthesis/block3/conv1/
conv/weight``; the identity table is ``embedding``).  The JAX package's
``init`` tree and the port's ``to_flax_params(module.state_dict())`` name
the same leaves alike, so the same seed gives the same weights on either
side, on any machine, with numpy alone.

Each leaf follows its initializer's distribution, with the biases moved
off their constant starts so the fused bias + activation sees a real bias:

- equalized-linear, equalized-conv and modulated-conv ``weight``s,
  ``const_input`` and the identity ``embedding``: N(0, 1); the mapping
  net's (``mapping/...``, learning-rate multiplier 0.01) N(0, 100), its
  initializer's 1 / lr_mul;
- the condition-injection convs' ``kernel``s (flax ``nn.Conv``): N(0, 0.01);
- the modulation biases: 1 + N(0, 0.1) (their initializer's constant 1);
- every other ``bias`` / ``act_bias``: N(0, 0.1); the mapping net's
  N(0, 10), as its weights, 1 / lr_mul times.
"""

from __future__ import annotations

import zlib

import numpy as np

# The mapping net's learning-rate multiplier (``MappingNetwork.lr_mul``).
MAPPING_LR_MUL = 0.01
BIAS_STD = 0.1
INJECTION_STD = 0.01


def flat_shapes(tree: dict, prefix: str = "") -> dict:
    """``{"a/b/c": shape}`` of a nested tree whose leaves have a ``shape``."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flat_shapes(v, name + "/"))
        else:
            out[name] = tuple(int(d) for d in v.shape)
    return out


def leaf_distribution(name: str) -> tuple[float, float]:
    """(mean, std) of the normal the leaf ``name`` is drawn from."""
    leaf = name.rsplit("/", 1)[-1]
    scale = 1.0 / MAPPING_LR_MUL if name.startswith("mapping/") else 1.0
    if leaf == "kernel":
        return 0.0, INJECTION_STD
    if leaf in ("bias", "act_bias"):
        return (1.0 if "/modulation/" in name else 0.0), BIAS_STD * scale
    if leaf in ("weight", "const_input", "embedding"):
        return 0.0, scale
    raise KeyError(f"no seeding rule for parameter {name!r}")


def seeded_leaf(name: str, shape, seed: int) -> np.ndarray:
    """The float32 array the rule draws for leaf ``name`` of ``shape``."""
    mean, std = leaf_distribution(name)
    rng = np.random.default_rng([seed, zlib.crc32(name.encode())])
    arr = rng.standard_normal(tuple(shape), dtype=np.float32)
    arr *= np.float32(std)
    if mean:
        arr += np.float32(mean)
    return arr


def seeded_tree(template: dict, seed: int, prefix: str = "") -> dict:
    """A nested tree shaped like ``template`` (leaves with a ``shape``:
    arrays, ``jax.ShapeDtypeStruct``s, tensors) with every leaf drawn by
    :func:`seeded_leaf`."""
    out = {}
    for k, v in template.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = seeded_tree(v, seed, name + "/")
        else:
            out[k] = seeded_leaf(name, v.shape, seed)
    return out


def seeded_generator_trees(cfg, seed: int) -> tuple[dict, dict]:
    """(flax-layout G params, ``{"embedding": ...}``) for ``cfg`` by the rule."""
    import torch

    from gif_tpu_torch.models.generator import StyledGenerator
    from gif_tpu_torch.tools.convert_params import flax_shapes

    with torch.device("meta"):
        gen = StyledGenerator.from_config(cfg)
    return seeded_tree(flax_shapes(gen), seed), {"embedding": seeded_leaf("embedding", gen.embedding.shape, seed)}


def seeded_discriminator_tree(cfg, seed: int) -> dict:
    """The flax-layout D params for ``cfg`` by the rule."""
    import torch

    from gif_tpu_torch.models.discriminator import Discriminator
    from gif_tpu_torch.tools.convert_params import flax_shapes

    with torch.device("meta"):
        disc = Discriminator.from_config(cfg)
    return seeded_tree(flax_shapes(disc), seed)


def seeded_generator_state(cfg, seed: int) -> dict:
    """The port ``StyledGenerator``'s state_dict for ``cfg`` with every
    parameter and the identity table drawn by the rule."""
    from gif_tpu_torch.tools.convert_params import convert_generator_params

    return convert_generator_params(*seeded_generator_trees(cfg, seed))


def seeded_discriminator_state(cfg, seed: int) -> dict:
    """The port ``Discriminator``'s state_dict for ``cfg`` by the rule."""
    from gif_tpu_torch.tools.convert_params import convert_discriminator_params

    return convert_discriminator_params(seeded_discriminator_tree(cfg, seed))

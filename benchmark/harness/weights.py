"""Seeded weights, made on the device in one draw.

Every parameter and buffer of G and D, named as the reference's modules
name them, comes from one standard-normal draw of a ``torch.Generator`` on
the device seeded with the run's seed, sliced leaf by leaf in name order
and scaled by the leaf's initializer (the rule of the program's
``tools/seeded_params.py``, copied):

- equalized-linear / conv / modulated-conv weights, ``const_input`` and the
  identity ``embedding``: N(0, 1); the mapping net's (learning-rate
  multiplier 0.01) N(0, 100);
- the condition-injection convs' weights: N(0, 0.01);
- modulation biases 1 + N(0, 0.1); every other bias N(0, 0.1), the
  mapping net's N(0, 10).

The same seed gives the same weights to the program and to the reference.
"""

from __future__ import annotations

import re

import torch

MAPPING_LR_MUL = 0.01
BIAS_STD = 0.1
INJECTION_STD = 0.01
_INJECTION = re.compile(r"\.noise\.conv\d+\.weight$")


def leaf_distribution(name: str) -> tuple[float, float]:
    """(mean, std) of leaf ``name`` (a state_dict key)."""
    leaf = name.rsplit(".", 1)[-1]
    scale = 1.0 / MAPPING_LR_MUL if name.startswith("mapping.") else 1.0
    if _INJECTION.search(name):
        return 0.0, INJECTION_STD
    if leaf in ("bias", "act_bias"):
        return (1.0 if ".modulation." in name else 0.0), BIAS_STD * scale
    if leaf in ("weight", "const_input", "embedding"):
        return 0.0, scale
    raise KeyError(f"no seeding rule for {name!r}")


def seeded_state(shapes: dict, seed: int, device, offset: int = 0) -> dict:
    """``{name: tensor}`` for ``shapes`` (``{name: shape}``), float32 on
    ``device``, from one normal draw seeded with ``seed`` (``offset``
    skips that many leading numbers of the stream, so two networks drawn
    from one seed do not share numbers)."""
    total = sum(int(torch.Size(s).numel()) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat = torch.randn(offset + total, generator=gen, device=device, dtype=torch.float32)[offset:]
    out, at = {}, 0
    for name in sorted(shapes):
        shape = torch.Size(shapes[name])
        n = shape.numel()
        mean, std = leaf_distribution(name)
        leaf = flat[at:at + n].view(shape) * std
        out[name] = leaf + mean if mean else leaf
        at += n
    return out


def module_shapes(module: torch.nn.Module) -> dict:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def seeded_weights(gen_shapes: dict, disc_shapes: dict, seed: int, device) -> tuple[dict, dict]:
    """(G's state, D's state) for the run's ``seed``."""
    g = seeded_state(gen_shapes, seed, device)
    n_g = sum(int(torch.Size(s).numel()) for s in gen_shapes.values())
    return g, seeded_state(disc_shapes, seed, device, offset=n_g)

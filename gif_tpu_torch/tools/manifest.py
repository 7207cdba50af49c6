"""Fail-loudly manifest checks for the real-artifact converters (the
port's own copy of :mod:`gif_tpu.tools.manifest`).

The licensed GIF artifacts (FLAME model, PCA texture space, FID Inception
weights, reference checkpoints — reference constants.py:27-79) are not
redistributable, so the converters normally run against files we cannot
test with.  Each converter therefore validates its input against a
manifest of expected keys/shapes FIRST and reports *every* mismatch in one
error, so a wrong or truncated download fails immediately with a usable
message instead of producing a silently-broken resource file.

A manifest maps ``key -> spec`` where spec is:
  - a shape tuple: ints must match; ``None`` entries are free;
  - or ``(shapes, ...)`` alternatives: any matching shape passes.
Missing keys are always reported.  Extra keys are ignored (artifacts ship
with harmless extras, e.g. chumpy caches in generic_model.pkl).
"""

from __future__ import annotations

import numpy as np


class ManifestError(ValueError):
    """Input artifact does not match the expected manifest."""


def _shape_of(x):
    if hasattr(x, "shape"):
        try:
            return tuple(int(s) for s in x.shape)
        except TypeError:
            return None
    return None


def _matches(shape, spec) -> bool:
    if shape is None:
        return False
    if spec and isinstance(spec[0], tuple):  # alternatives
        return any(_matches(shape, alt) for alt in spec)
    if len(shape) != len(spec):
        return False
    return all(want is None or got == want for got, want in zip(shape, spec))


def check_manifest(data: dict, manifest: dict, what: str) -> None:
    """Raise :class:`ManifestError` listing every missing/mismatched key."""
    problems = []
    for key, spec in manifest.items():
        if key not in data:
            problems.append(f"  missing key {key!r} (expected shape {spec})")
            continue
        shape = _shape_of(data[key])
        if not _matches(shape, spec):
            problems.append(
                f"  key {key!r}: shape {shape} does not match expected {spec}"
            )
    if problems:
        raise ManifestError(
            f"{what} does not look like the expected artifact "
            f"({len(problems)} problem(s)):\n" + "\n".join(problems)
        )


def require_keys(data: dict, keys, what: str) -> None:
    """Raise :class:`ManifestError` listing every missing key (no shapes)."""
    missing = [k for k in keys if k not in data]
    if missing:
        raise ManifestError(
            f"{what} is missing expected key(s): {missing} — "
            f"present keys: {sorted(data)[:20]}{' ...' if len(data) > 20 else ''}"
        )


def as_np_dict(d: dict) -> dict:
    """Materialize a dict of array-likes as numpy (shape probing only)."""
    return {k: (np.asarray(v) if not hasattr(v, "shape") else v) for k, v in d.items()}

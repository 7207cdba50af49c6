"""The slices of the 236-dim DECA-style parameter vector (a frozen copy of
the measured program's constants)."""

from __future__ import annotations

DECA_IDX = {
    "cam": (156, 159),
    "tex": (159, 209),
    "lit": (209, 236),
}

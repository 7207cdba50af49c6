"""Checkpoints of the whole train state (port of
:mod:`gif_tpu.train.checkpoint`, over ``torch.save`` instead of Orbax).

One file per step, ``{step:09d}.pt`` under the directory, holds
:meth:`TrainState.state_dict`: G, the G EMA, D, both Adam states and the
loop counters, so a resumed run continues exactly.  A save writes a
temporary file and renames it into place (``os.replace``), so a crash
mid-write never leaves a truncated checkpoint under a step's name; the
oldest files beyond ``max_to_keep`` are removed.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from gif_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    """Saves every ``save_every`` steps (the reference's cadence: 1000),
    keeps the newest ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 5, save_every: int = 1000):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_every = save_every

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step:09d}.pt")

    def maybe_save(self, state: TrainState, step: Optional[int] = None) -> bool:
        """Save iff ``step`` (the loop's counter; default ``state.step``)
        hits the cadence."""
        step = state.step if step is None else step
        if step % self.save_every != 0:
            return False
        self.save(state)
        return True

    def save(self, state: TrainState) -> None:
        """Write ``state`` under its step, unless that step is saved
        already (as Orbax does), then drop the oldest beyond
        ``max_to_keep``."""
        final = self.path(state.step)
        if os.path.exists(final):
            return
        tmp = f"{final}.{os.getpid()}.tmp"
        try:
            torch.save(state.state_dict(), tmp)
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self.path(old))

    def all_steps(self) -> list:
        """Every retained checkpoint step, ascending."""
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load the checkpoint of ``step`` (default the latest) into
        ``state`` (from ``create_train_state``), in place, onto the
        devices its tensors live on; returns it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        sd = torch.load(self.path(step), map_location=state.pl_mean.device, weights_only=True)
        state.load_state_dict(sd)
        return state

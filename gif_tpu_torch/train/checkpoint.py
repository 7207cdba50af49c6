"""Checkpoints of the whole train state (port of
:mod:`gif_tpu.train.checkpoint`, over ``torch.save`` instead of Orbax).

One file per step, ``{step:09d}.pt`` under the directory, holds
:meth:`TrainState.state_dict`: G, the G EMA, D, both Adam states and the
loop counters, so a resumed run continues exactly.  A save writes a
temporary file and renames it into place (``os.replace``), so a crash
mid-write never leaves a truncated checkpoint under a step's name; the
oldest files beyond ``max_to_keep`` are removed.

Under data parallelism (a process ``group``) rank 0 writes, every rank
waits at a barrier until the file is in place, and every rank restores
the same file — the semantics the JAX package's loop gets from Orbax.
The ranks share the checkpoint directory's file system.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch
import torch.distributed as dist

from gif_tpu_torch.parallel.mesh import is_main_process
from gif_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^(\d+)\.pt$")


def _steps(directory: str) -> list:
    """The checkpoint steps under ``directory``, ascending."""
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


class CheckpointManager:
    """Saves every ``save_every`` steps (the reference's cadence: 1000),
    keeps the newest ``max_to_keep``; with a process ``group``, saves are
    collective (rank 0 writes, all ranks return once it is written)."""

    def __init__(self, directory: str, max_to_keep: int = 5, save_every: int = 1000, group=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_every = save_every
        self.group = group

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
        ``max_to_keep``.  With a group: on rank 0, then a barrier."""
        if is_main_process(self.group):
            self._write(state)
        if self.group is not None:
            dist.barrier(group=self.group)

    def _write(self, state: TrainState) -> None:
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
        return _steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load the checkpoint of ``step`` (default the latest) into
        ``state`` (from ``create_train_state``), in place, onto the
        devices its tensors live on; returns it."""
        state.load_state_dict(self.read(self.directory, step, map_location=state.pl_mean.device))
        return state

    @staticmethod
    def read(directory: str, step: Optional[int] = None, map_location="cpu") -> dict:
        """The saved :meth:`TrainState.state_dict` of ``step`` (default the
        latest) under ``directory``, without creating the directory."""
        if step is None:
            steps = _steps(directory) if os.path.isdir(directory) else []
            if not steps:
                raise FileNotFoundError(f"no checkpoint found under {directory}")
            step = steps[-1]
        path = os.path.join(directory, f"{step:09d}.pt")
        return torch.load(path, map_location=map_location, weights_only=True)

"""Profiling: ``torch.profiler`` trace capture and step timing (port of
:mod:`gif_tpu.utils.profiling`).

``trace`` records host and device activity for the profiler UI (a Chrome
trace, ``chrome://tracing`` or Perfetto).  ``StepTimer`` keeps the JAX
package's contract — the MEAN time per step of a chain of dependent steps
closed by ONE readback — and on a card times the chain with CUDA events,
so the number is the device's span from the first step's start to the
last step's end (host launch overhead included wherever the device waits
for it).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str, device: str = "cuda"):
    """Record a profiler trace of the block (CPU activity, plus CUDA
    activity when ``device`` is ``cuda``) and write it as
    ``log_dir/trace.json`` (Chrome trace format).  Yields the profiler,
    whose ``key_averages()`` / ``events()`` hold what it recorded."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, torch.nn.Module):
        return next(tree.parameters(), None)
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            t = _first_tensor(leaf)
            if t is not None:
                return t
        return None
    # A train state or another object: its attributes in order.
    return _first_tensor(list(vars(tree).values())) if hasattr(tree, "__dict__") else None


def force_ready(tree) -> float:
    """Force device completion via a scalar host readback; returns the sum
    of the first tensor leaf (cheap, dependency-carrying)."""
    leaf = _first_tensor(tree)
    if leaf is None:
        raise ValueError("force_ready: no tensor in the tree")
    return float(leaf.detach().float().sum())


class StepTimer:
    """MEAN time per step of a chained step function.

    ``fn(carry, i) -> carry`` is called ``iters`` times with the carry fed
    back (serializing execution); ONE readback closes the chain.  On a card
    the chain is timed by CUDA events recorded before its first step and
    after its last (``device="cuda"``); on the CPU by the host clock."""

    def __init__(self, warmup: int = 1, device: str = "cuda"):
        self.warmup = warmup
        self.device = torch.device(device)

    def time(self, fn, carry, iters: int = 10) -> float:
        for i in range(self.warmup):
            carry = fn(carry, i)
        force_ready(carry)
        if self.device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(iters):
                carry = fn(carry, i)
            end.record()
            force_ready(carry)
            return start.elapsed_time(end) / 1e3 / iters
        t0 = time.perf_counter()
        for i in range(iters):
            carry = fn(carry, i)
        force_ready(carry)
        return (time.perf_counter() - t0) / iters

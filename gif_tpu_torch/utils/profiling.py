"""Profiling: ``torch.profiler`` trace capture, spans inside the program
and step timing (port of :mod:`gif_tpu.utils.profiling`, plus the spans).

``trace`` records host and device activity for the profiler UI (a Chrome
trace, ``chrome://tracing`` or Perfetto).  ``StepTimer`` keeps the JAX
package's contract — the MEAN time per step of a chain of dependent steps
closed by ONE readback — and on a card times the chain with CUDA events,
so the number is the device's span from the first step's start to the
last step's end (host launch overhead included wherever the device waits
for it).

``span(name, **attrs)`` marks a phase of the program.  Tracing is on
exactly while a ``torch.profiler`` records (``trace``,
``scripts/profile_step.py``, the benchmark's traced cycle); there is no
other switch.  Off, ``span`` returns one shared null context and costs a
bool check.  On, each span is a ``record_function`` range (a
``user_annotation`` on the trace's clock, beside the device events), its
host ``perf_counter`` start and end, CUDA events on the current stream at
entry and exit where CUDA is initialized, with ``allocator=True`` the
caching allocator's ``cudaMalloc`` calls and alloc retries across it, and
with ``counts`` the change of the program's own counters across it.
The records stay in memory (:func:`spans`, the newest
:data:`SPAN_LIMIT`) until :func:`clear_spans`; each names its enclosing
span and shares a ``step_id`` with the other spans under one outermost
span.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass, field

import torch

SPAN_LIMIT = 1 << 16
_SPANS: collections.deque = collections.deque(maxlen=SPAN_LIMIT)
_OFF = contextlib.nullcontext()
_OPEN = threading.local()  # .stack: this thread's open spans, innermost last
_ROOTS = itertools.count()


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


@dataclass
class Span:
    """One span's record.  ``parent`` is the enclosing span's name (None
    for an outermost span), ``step_id`` the outermost span's number;
    ``events`` the CUDA events at entry and exit (None without CUDA);
    ``counters`` the allocator's counts and the program's counters across
    the span, where asked."""

    name: str
    attrs: dict
    parent: str | None
    step_id: int
    host_start: float = 0.0
    host_end: float = 0.0
    events: tuple | None = None
    counters: dict = field(default_factory=dict)

    @property
    def device_ms(self) -> float | None:
        """Device time between the entry and exit events (waits for the
        exit event); None without CUDA."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


def _allocator_counts() -> tuple[int, int]:
    stats = torch.cuda.memory_stats()
    return stats.get("segment.all.allocated", 0), stats.get("num_alloc_retries", 0)


class _Recording:
    """The live form of a span: see :func:`span`."""

    def __init__(self, name: str, attrs: dict, allocator: bool, counts: dict | None):
        self.name, self.attrs, self.allocator, self.counts_of = name, attrs, allocator, counts or {}

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        parent = stack[-1] if stack else None
        rec = Span(self.name, self.attrs, parent.name if parent else None,
                   parent.step_id if parent else next(_ROOTS))
        self.rec, self.cuda = rec, torch.cuda.is_initialized()
        self.before = {k: read() for k, read in self.counts_of.items()}
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        if self.cuda:
            if self.allocator:
                self.counts = _allocator_counts()
            rec.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        stack.append(rec)
        _SPANS.append(rec)
        rec.host_start = time.perf_counter()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.host_end = time.perf_counter()
        _OPEN.stack.pop()
        if self.cuda:
            rec.events[1].record()
            if self.allocator:
                mallocs, retries = _allocator_counts()
                rec.counters = {"cuda_mallocs": mallocs - self.counts[0],
                                "num_alloc_retries": retries - self.counts[1]}
        for k, read in self.counts_of.items():
            rec.counters[k] = read() - self.before[k]
        self.range.__exit__(*exc)
        return False


def span(name: str, allocator: bool = False, counts: dict | None = None, **attrs):
    """A context manager that marks the block as the span ``name`` with
    ``attrs`` while a profiler records, and does nothing otherwise (the
    shared null context).  ``allocator`` adds the caching allocator's
    ``cudaMalloc`` calls (``segment.all.allocated``) and alloc retries
    across the block to the record's ``counters``, on a card; ``counts``
    (name -> a function reading a counter of the program) adds each
    counter's change across the block, on any device."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Recording(name, attrs, allocator, counts)


def spans() -> list:
    """The recorded spans, oldest first, in the order they opened."""
    return list(_SPANS)


def clear_spans() -> None:
    _SPANS.clear()


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

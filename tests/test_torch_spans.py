"""The train step's phase spans (``gif_tpu_torch.utils.profiling.span``)
on the CPU, at the tiny width: off without a profiler, recorded in order
under one, and the step's arithmetic the same either way."""

from __future__ import annotations

import contextlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gif_tpu_torch.flame.resources import synthetic_flame_resources
from gif_tpu_torch.train.config import get_config
from gif_tpu_torch.train.state import create_train_state
from gif_tpu_torch.train.step import make_train_step
from gif_tpu_torch.utils import profiling
from torch_port_common import cpu_threads, tiny_overrides, train_batch

B = 4
RES_T = synthetic_flame_resources(seed=1, n_vertices=503)
PHASES = ["train.render", "train.g_forward", "train.d_grads", "train.d_adam",
          "train.g_grads", "train.g_adam", "train.ema"]


def _cfg(run_id: int):
    return get_config(run_id, **tiny_overrides(batch_size=B, r1_interval=2, render_in_step=False))


def _steps(run_id: int, n: int, traced: bool):
    """``n`` steps of a fresh tiny state (a profiler recording CPU activity
    around them when ``traced``): (state, metrics of each step, profiler)."""
    cfg = _cfg(run_id)
    batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg, B).items()}
    state = create_train_state(cfg, device="cpu")
    step = make_train_step(cfg, RES_T, device="cpu", max_tris_per_tile=RES_T.n_faces,
                           generator=torch.Generator().manual_seed(0))
    metrics = []
    with cpu_threads(), (profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext()) as prof:
        for _ in range(n):
            state, m = step(state, batch)
            metrics.append(m)
    return state, metrics, prof


def test_span_without_a_profiler_is_the_shared_null_context():
    profiling.clear_spans()
    s = profiling.span("train.step", allocator=True, step=0, r1=False)
    assert s is profiling.span("train.render") and isinstance(s, contextlib.nullcontext)
    with s:
        with profiling.span("train.g_forward"):
            pass
    assert profiling.spans() == []


@pytest.mark.parametrize("run_id, n", [(8, 2), (0, 1)])
def test_traced_steps_record_the_step_and_its_seven_phases_in_order(run_id, n, tmp_path):
    """run_id 8: a plain step (state.step 0) and an R1 step (1, as
    r1_interval is 2); run_id 0: one fused step."""
    profiling.clear_spans()
    _, _, prof = _steps(run_id, n, traced=True)
    got = profiling.spans()
    assert [s.name for s in got] == (["train.step"] + PHASES) * n
    for i in range(n):
        step, phases = got[8 * i], got[8 * i + 1:8 * i + 8]
        assert step.parent is None and step.attrs == {"step": i, "r1": i == 1}
        assert step.host_start <= step.host_end and step.events is None
        # The CPU's plain versions make no layout copies; no allocator counts without CUDA.
        assert step.counters == {"layout_copies": 0}
        assert all(p.parent == "train.step" and p.step_id == step.step_id for p in phases)
        assert all(step.host_start <= p.host_start <= p.host_end <= step.host_end for p in phases)
        assert all(a.host_end <= b.host_start for a, b in zip(phases, phases[1:]))
        assert [p.attrs for p in phases[4:]] == [{"it": 0}] * 3
    assert len({s.step_id for s in got}) == n
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in sorted(events, key=lambda e: float(e.get("ts", 0)))
             if e.get("cat") == "user_annotation" and e.get("name", "").startswith("train.")]
    assert names == (["train.step"] + PHASES) * n
    profiling.clear_spans()
    assert profiling.spans() == []


@pytest.mark.parametrize("run_id", [8, 0])
def test_a_traced_step_computes_what_an_untraced_one_does(run_id):
    """run_id 8 from step 1 (an R1 step) after a plain one, run_id 0 one
    fused step: metrics and the updated G, D and EMA bit for bit."""
    n = 2 if run_id == 8 else 1
    plain, m_plain, _ = _steps(run_id, n, traced=False)
    traced, m_traced, _ = _steps(run_id, n, traced=True)
    profiling.clear_spans()
    for a, b in zip(m_plain, m_traced):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for what in ("generator", "discriminator", "g_ema"):
        want = dict(getattr(plain, what).named_parameters())
        for name, p in getattr(traced, what).named_parameters():
            assert torch.equal(p, want[name]), (what, name)

"""The port's measurement scripts on the CPU at the 32 px smoke size:
``mfu_report`` counts the bench step and a bare G forward (the counted G
forward within 5% of the analytic conv count, which leaves out
demodulation, blur taps and biases); ``profile_step`` writes a trace and
parses it (the busy union on a fabricated trace, exactly); and
``blur_hw_check``'s depthwise reference equals kernel 4's plain version at
every case's pads (f32, 1e-6 of the largest value), and the script refuses
to run without a card."""

import json

import numpy as np
import pytest
import torch

from gif_tpu_torch.ops.blur_cuda import blur4, taps_1d
from gif_tpu_torch.scripts import blur_hw_check, mfu_report, profile_step
from torch_port_common import cpu_threads


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # Six test processes share the machine under tier-1: cap each one's
    # thread pools (torch_port_common.cpu_threads).
    with cpu_threads():
        yield


def test_mfu_report_on_the_tiny_step(capsys):
    out = mfu_report.main(["--tiny", "--device", "cpu", "--imgs_per_sec", "10"])
    assert out["device"] == "cpu" and out["peak_flops_bf16"] is None and "mfu" not in out
    assert out["step_flops"] > 3 * out["g_forward_flops"] > 0
    assert abs(out["g_counted_over_analytic"] - 1.0) < 0.05, out
    assert "generator fwd (analytic)" in capsys.readouterr().out


def test_profile_step_traces_and_parses(tmp_path):
    out = profile_step.main(["--tiny", "--device", "cpu", "--out_dir", str(tmp_path), "--n_steps", "2"])
    assert (tmp_path / "trace.json").stat().st_size > 0 and out["n_steps"] == 2 and out["wall_ms_per_step"] > 0
    # The parser on a fabricated trace: two overlapping kernels and a copy.
    fake = tmp_path / "fake"
    fake.mkdir()
    events = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 0.0, "dur": 1000.0},
              {"ph": "X", "cat": "kernel", "name": "b", "ts": 500.0, "dur": 1000.0},
              {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 3000.0, "dur": 500.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 9000.0}]
    (fake / "trace.json").write_text(json.dumps({"traceEvents": events}))
    (fake / "window.json").write_text(json.dumps({"wall_ms": 4.0, "n_steps": 1, "run_id": 8}))
    got = profile_step.main(["--parse_only", str(fake), "--n_steps", "1"])
    assert got["busy_ms_per_step"] == 2.0 and got["busy_share"] == 0.5 and got["device_ops_per_step"] == 3
    assert got["device_ms_per_step"] == 2.5 and got["top_ops"][0] == ("a", 1.0)


@pytest.mark.parametrize("shape,pads,gain", blur_hw_check.CASES)
def test_blur_hw_check_reference_is_kernel_4s_function(shape, pads, gain):
    small = (1, 2) + tuple(min(s, 19 + s % 2) for s in shape[2:])
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(small).astype(np.float32))
    want = blur4(x, taps_1d(blur_hw_check.TAPS, gain), pads)  # a CPU tensor: the plain version
    got = blur_hw_check.depthwise_blur(x, pads, gain)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


def test_blur_hw_check_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        blur_hw_check.main(["--iters", "1"])

"""The port's FLOP accounting, profiling helpers and bench program on the
CPU: ``analytic_generator_forward_flops`` equal to the JAX package's on
every preset and a cut one (exact: the same integer arithmetic);
``compiled_flops`` of one convolution equal to ``2 N Cout Cin k^2 H W``
(exact); ``device_peak_flops`` None on the CPU and the H100's data-sheet
figure by name; ``StepTimer``'s chain contract; and ``gif_tpu_torch.bench``'s
JSON line at the 32 px smoke size."""

import json

import pytest
import torch

from gif_tpu.train.config import get_config as j_get_config
from gif_tpu.utils.flops import analytic_generator_forward_flops as j_analytic
from gif_tpu_torch import bench
from gif_tpu_torch.train.config import TINY_OVERRIDES, get_config
from gif_tpu_torch.utils import flops, profiling
from torch_port_common import cpu_threads


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # Six test processes share the machine under tier-1: cap each one's
    # thread pools (torch_port_common.cpu_threads).
    with cpu_threads():
        yield


@pytest.mark.parametrize("run_id", [0, 3, 7, 8, 29])
@pytest.mark.parametrize("overrides", [{}, TINY_OVERRIDES, {"max_size": 128, "channel_multiplier": 1}])
def test_analytic_generator_flops_match_jax(run_id, overrides):
    for batch in (1, 16):
        got = flops.analytic_generator_forward_flops(get_config(run_id, **overrides), batch)
        assert got == j_analytic(j_get_config(run_id, **overrides), batch) > 0


def test_compiled_flops_of_one_conv():
    n, cin, cout, k, h, w = 2, 3, 5, 3, 8, 6
    x, wt = torch.randn(n, cin, h, w), torch.randn(cout, cin, k, k)
    got = flops.compiled_flops(torch.nn.functional.conv2d, x, wt, padding=1)
    assert got == 2 * n * cout * cin * k * k * h * w
    assert flops.compiled_flops(torch.add, x, x) is None  # no dense product


def test_compiled_flops_counts_a_second_order_gradient():
    """R1's input gradient taken with create_graph, then its parameter
    gradient: the counter follows autograd.grad over a leaf input."""
    conv = torch.nn.Conv2d(2, 3, 3, padding=1)
    x = torch.randn(1, 2, 5, 5, requires_grad=True)

    def r1():
        (g,) = torch.autograd.grad(conv(x).square().sum(), x, create_graph=True)
        g.square().sum().backward()

    assert flops.compiled_flops(r1) > 2 * flops.compiled_flops(conv, x)


def test_device_peak_flops(monkeypatch):
    assert flops.device_peak_flops("cpu") is None
    assert flops.mfu(1e12, 1.0, "cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert flops.device_peak_flops("cuda:0") == 989.4e12
    assert flops.mfu(989.4e12, 0.5, "cuda:0") == 0.5
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "Some Other Card")
    assert flops.device_peak_flops("cuda:0") is None


def test_step_timer_times_the_chain_with_one_readback(monkeypatch):
    calls, reads = [], []
    real = profiling.force_ready
    monkeypatch.setattr(profiling, "force_ready", lambda t: reads.append(len(calls)) or real(t))

    def step(carry, i):
        calls.append(i)
        return {"x": carry["x"] + 1}

    sec = profiling.StepTimer(warmup=2, device="cpu").time(step, {"x": torch.zeros(3)}, iters=5)
    assert calls == [0, 1, 0, 1, 2, 3, 4] and reads == [2, 7] and sec > 0
    assert profiling.force_ready({"a": [torch.ones(2, 2)]}) == 4.0
    lin = torch.nn.Linear(2, 2)
    assert profiling.force_ready((None, lin)) == float(lin.weight.sum())  # a module: its first parameter
    with pytest.raises(ValueError):
        profiling.force_ready({"a": None})


@pytest.mark.parametrize("run_id", [8, 0])
def test_bench_line_on_the_tiny_config(run_id, capsys, monkeypatch):
    monkeypatch.setattr(bench, "run", lambda r, d, t, _run=bench.run: _run(r, d, t, n_iters=2))
    bench.main(["--tiny", "--device", "cpu", "--run_id", str(run_id)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = ["metric", "value", "unit", "vs_baseline", "spread", "chains", "flops_per_step"]
    assert list(line) == keys + (["render_overflow"] if run_id != 8 else [])
    assert line["metric"] == "ffhq256_train_imgs_per_sec_per_chip" + ("" if run_id == 8 else "_run0")
    assert len(line["chains"]) == 3 and line["value"] > 0 and line["flops_per_step"] > 0
    assert "mfu" not in line  # no peak on the CPU

"""The yardstick's analytic FLOP count of the train step against
PyTorch's FLOP counter on the program's step, at a small width on the
CPU.  At 256 px / 512 channels on the H100 the two agreed within 0.05%
(PERF.md).  Here, at 32 channels, the plain step reads 0.96-0.97 (the
demodulation's small matrix products, which the count leaves out, weigh
more at this width) and R1's extra 1.003: the ratio is held in [0.95,
1.01], so the count never runs high (a share of the peak may not read
above what the step does)."""

import pytest
import torch

from benchmark.harness import flops, registry, traffic, train
from benchmark.harness.weights import module_shapes, seeded_weights
from benchmark.reference.train import build_models

SMALL = dict(max_size=32, init_size=32, render_image_size=32, max_channels=32, nmlp_for_z_to_w=2,
             compute_dtype="float32", embedding_vocab_size=16)


@pytest.mark.parametrize("workload", ["r0-train-b16", "r8-train-b16"])
def test_analytic_count_matches_the_counter(workload):
    from gif_tpu_torch.train.step import make_train_step
    from gif_tpu_torch.utils.flops import compiled_flops

    torch.set_num_threads(2)
    cell = registry.cell(workload)
    tcfg = train.train_config(cell.config, SMALL)
    _, res = train.resources({"mesh": {"seed": 1, "n_vertices": 503}})
    g, d = seeded_weights(*(module_shapes(m) for m in build_models(tcfg)), 3, "cpu")
    pcfg, state = train.program_state(tcfg, g, d, "cpu")
    spec = dict(cell.traffic, batch=4, ring=2)
    ring = traffic.train_ring(spec, 3, "cpu", 32, 16, tcfg["apply_texture_space_interpolation_loss"])
    step = make_train_step(pcfg, res, device="cpu")
    state.step = tcfg["r1_interval"] - 1
    r1 = compiled_flops(step, state, ring[0]["batch"], ring[0]["draws"])
    plain = compiled_flops(step, state, ring[1]["batch"], ring[1]["draws"])
    want = flops.train_step(tcfg, 4)
    ratio_plain, ratio_r1 = want["plain"] / plain, want["r1"] / (r1 - plain)
    print(f"{workload}: analytic / counted = {ratio_plain:.4f} (plain step), {ratio_r1:.4f} (R1's extra)")
    assert 0.95 <= ratio_plain <= 1.01
    assert 0.95 <= ratio_r1 <= 1.01

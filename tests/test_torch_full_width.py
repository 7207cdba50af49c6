"""Port parity at full width on the CPU: 256 px, 512 channels, channel
multiplier 2, the 8-layer mapping net, 69158 identities, the FLAME-sized
synthetic mesh (5023 vertices, 10042 faces, 20000 texels), raster
capacity equal to the face count, batch 2.

The same numpy-seeded inputs and the same weights — drawn leaf by leaf
from the name-keyed rule of :mod:`gif_tpu_torch.tools.seeded_params`,
which the card applies without JAX — go through ``gif_tpu`` and
``gif_tpu_torch`` (``device="cpu"``: the plain versions of the kernels),
case by case (:mod:`gif_tpu_torch.tools.full_width_goldens`, whose
``BARS`` state each bar and its reason), live: FLAME decode and
projection, ``render_condition_maps`` (JAX's XLA raster), G in f32 for
run_id 8 and 0 and under the bf16 policy on JAX's conditions, and the
texture steal with ``sample_at_points``.  D's scores and parameter
gradient and the serving path (``FlameSampler.sample``) are held here to
``gif_tpu``'s golden (``tests/golden/torch_full_width.npz``) and live in
``tests/test_torch_full_width_steps.py`` (``slow``), beside the train
steps: live they do not fit this file's time budget.  Every forward case
of the port is held to the golden too, which ties the card's check
(``chip_smoke.py`` phase 23) to the live comparison.  Every measured
error is printed."""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import full_width_jax as fj
from gif_tpu.flame.resources import synthetic_flame_resources as j_synth
from gif_tpu_torch.flame.resources import synthetic_flame_resources
from gif_tpu_torch.models.discriminator import Discriminator
from gif_tpu_torch.models.generator import StyledGenerator
from gif_tpu_torch.tools import full_width_goldens as fw
from gif_tpu_torch.tools.convert_params import (
    convert_discriminator_params,
    convert_generator_params,
    flax_shapes,
)
from gif_tpu_torch.tools.seeded_params import (
    flat_shapes,
    seeded_discriminator_state,
    seeded_generator_state,
)
from torch_port_common import cpu_threads

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "torch_full_width.npz")
LIVE = ("flame", "render", "g8", "g0", "g8_bf16", "steal")


@pytest.fixture(scope="module")
def outputs():
    """{case: (gif_tpu's outputs, or None where only the golden holds the
    case here, the port's outputs)}, each case run once; the G and D cases
    take JAX's condition maps.  Once JAX has rendered them, the port's
    cases run in a second thread beside JAX's (both release the GIL in
    their kernels), which halves the file's time on an idle machine."""
    res_j, res_t = j_synth(), synthetic_flame_resources()
    n_texels = len(res_t.texture_x_coords)
    inp = {case: fw.inputs(case, n_texels) for case in fw.CASES}
    want = {"render": fj.jax_outputs("render", res_j, inp["render"])}
    cond = want["render"]["cond"]
    got = {}

    def port():
        with cpu_threads(2):
            for case in fw.CASES:
                got[case] = fw.port_outputs(case, res_t, "cpu", inp[case], cond)

    with ThreadPoolExecutor(1) as pool:
        port_done = pool.submit(port)
        for case in LIVE:
            if case != "render":
                want[case] = fj.jax_outputs(case, res_j, inp[case], cond)
        port_done.result()
    return {case: (want.get(case), got[case]) for case in fw.CASES}


@pytest.fixture(scope="module")
def golden():
    return fw.Golden(GOLDEN)


def _report(case, out_name, err, bar) -> str:
    return f"{case}/{out_name}: max abs {err[0]:.3g}, rel L2 / flips {err[1]:.3g} (bar {bar.text()})"


@pytest.mark.parametrize("what", ["g8", "g0", "d"])
def test_rule_templates_name_the_same_leaves(what):
    """The port's flax-layout parameter names and shapes equal the JAX
    package's ``init`` tree's, so the rule draws the same weights."""
    g8, _, d = fj.templates(8)
    g0, _, _ = fj.templates(0)
    cfg = fw.full_config(0 if what == "g0" else 8)
    with torch.device("meta"):
        module = Discriminator.from_config(cfg) if what == "d" else StyledGenerator.from_config(cfg)
    want = flat_shapes({"g8": g8, "g0": g0, "d": d}[what])
    assert flat_shapes(flax_shapes(module)) == want
    assert len(want) == (38 if what == "d" else 175)


def test_card_rebuilds_the_jax_weights():
    """The state_dicts the card builds from the rule alone equal the JAX
    trees drawn by the rule and converted, tensor for tensor."""
    cfg = fw.full_config(8)
    g_params, buffers = fj.generator_trees(8)
    want = convert_generator_params(g_params, buffers)
    got = seeded_generator_state(cfg, fw.WEIGHT_SEEDS["g8"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    want_d = convert_discriminator_params(fj.discriminator_tree())
    got_d = seeded_discriminator_state(cfg, fw.WEIGHT_SEEDS["d"])
    assert all(torch.equal(got_d[k], want_d[k]) for k in want_d) and sorted(got_d) == sorted(want_d)
    # Biases off their initializers' constants, mapping weights at 1 / lr_mul.
    assert abs(got["synthesis.block2.conv1.conv.modulation.bias"].mean().item() - 1.0) < 0.05
    assert got["synthesis.block2.conv1.act_bias"].abs().min().item() > 0
    assert abs(got["mapping.dense0.weight"].std().item() - 100.0) < 1.0


@pytest.mark.parametrize("case", LIVE)
def test_full_width_case_matches_jax(outputs, case):
    want, got = outputs[case]
    assert sorted(got) == sorted(want)
    failed = []
    for out_name in sorted(want):
        bar = fw.BARS[(case, out_name)]
        a, r, ok = fw.check(got[out_name], want[out_name], bar)
        print(_report(case, out_name, (a, r), bar))
        if not ok:
            failed.append(out_name)
    assert not failed, failed
    if case == "render":
        assert 0.2 < want["mask"].mean() < 0.95 and not want["overflow"].any()
    if case == "steal":
        assert want["vis"].any() and not want["vis"].all()


@pytest.mark.parametrize("case", fw.CASES)
def test_port_reproduces_the_golden(outputs, golden, case):
    """The port's outputs against ``gif_tpu``'s golden summaries, as phase
    23 holds the card's (relative L2 from the count sketches, values at
    the stored positions)."""
    _, got = outputs[case]
    assert golden.outputs(case) == sorted(got)
    failed = []
    for out_name in sorted(got):
        bar = fw.BARS[(case, out_name)]
        a, r, ok, worst = golden.check(case, out_name, got[out_name])
        print(_report(case, out_name, (a, r), bar) + (f", worst tensor {worst}" if worst else "") + " [golden]")
        if not ok:
            failed.append(out_name)
    assert not failed, failed


def test_golden_file_is_small_and_its_conditions_are_jax_s(outputs, golden):
    assert os.path.getsize(GOLDEN) <= 2 * 2**20
    np.testing.assert_array_equal(golden.whole("render", "cond"), outputs["render"][0]["cond"])

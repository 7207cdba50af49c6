"""Port parity of the train step's branches that render or sample on the
CPU, tiny config (f32, max_channels 16, 32 px, batch 4): one whole step of
``make_train_step`` per case against the JAX package's jitted step, from
one converted state (step 1, so R1 fires; ``pl_mean`` 0.5), with JAX's
random draws handed to the port — crop, flip and crop+flip batches whose
conditions render from ``flame_render``, the path-length penalty beside the
fused interpolation loss, and the direct gradient penalty beside the
unfused one (both adaptive: the scale includes the regularizers).  The
other branches are in tests/test_torch_train_branches.py; the harness and
its bars (metrics rtol 1e-4, or 2e-3 where both packages render the
conditions; the delta rule of tests/test_torch_train.py) are in
tests/torch_port_common.py."""

import pytest

from gif_tpu_torch.flame.resources import synthetic_flame_resources
from torch_port_common import JaxBranchSteps, check_branch_step

RES_T = synthetic_flame_resources(seed=1, n_vertices=503)

# name: (run id, overrides, augmentation keys, fuse_interp)
CASES = {
    "crop": (8, dict(render_in_step=True), ("crop",), True),
    "flip": (8, dict(render_in_step=True), ("flip",), True),
    "crop_flip": (8, dict(render_in_step=True), ("crop", "flip"), True),
    "path_len_fused_interp_adaptive": (
        0, dict(gen_reg_type="path_len_reg", adaptive_interp_loss=True), (), True),
    "direct_grad_unfused_interp_adaptive": (
        0, dict(gen_reg_type="direct_grad_reg", adaptive_interp_loss=True), (), False),
}


@pytest.fixture(scope="module")
def jax_step():
    return JaxBranchSteps(CASES)


@pytest.mark.parametrize("case", list(CASES))
def test_branch_step_matches_jax(jax_step, case):
    check_branch_step(jax_step, case, RES_T)

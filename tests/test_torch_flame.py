"""Port parity: constants, configs, FLAME resources, decode, normals and the
eye-centring camera, held to the JAX package at rtol 1e-5 (f32, CPU)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_tpu import constants as jc
from gif_tpu.flame import camera as jcam
from gif_tpu.flame import decoder as jdec
from gif_tpu.flame import mesh as jmesh
from gif_tpu.flame.resources import synthetic_flame_resources as j_synth
from gif_tpu.train import config as jcfg
from gif_tpu_torch import constants as tc
from gif_tpu_torch.flame import camera as tcam
from gif_tpu_torch.flame import decoder as tdec
from gif_tpu_torch.flame import mesh as tmesh
from gif_tpu_torch.flame.resources import load_flame_resources, synthetic_flame_resources
from gif_tpu_torch.train import config as tcfg

RTOL, ATOL = 1e-5, 1e-6  # atol for the near-zero coordinates


def _flame(rng, b):
    from gif_tpu.eval.sampling import random_flame_params

    return random_flame_params(rng, b)


def test_constants_match():
    assert tc.INDICES == jc.INDICES
    assert tc.DECA_IDX == jc.DECA_IDX
    assert dataclasses.asdict(tc.DEFAULT_FLAME_CONFIG) == dataclasses.asdict(
        jc.DEFAULT_FLAME_CONFIG
    )
    assert (tc.DEFAULT_FLAME_CONFIG.eye_left_vertex, tc.DEFAULT_FLAME_CONFIG.eye_right_vertex) == (
        4051,
        4597,
    )


@pytest.mark.parametrize("run_id", sorted(jcfg._PRESETS))
def test_config_presets_match(run_id):
    assert tcfg._PRESETS == jcfg._PRESETS
    assert tcfg.TINY_OVERRIDES == jcfg.TINY_OVERRIDES
    for over in ({}, tcfg.TINY_OVERRIDES):
        t = tcfg.get_config(run_id, **over)
        j = jcfg.get_config(run_id, **over)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.cond_channels, t.max_step, t.g_lr, t.d_betas) == (
            j.cond_channels, j.max_step, j.g_lr, j.d_betas,
        )


def test_synthetic_resources_match():
    t = synthetic_flame_resources(seed=1, n_vertices=503)
    j = j_synth(seed=1, n_vertices=503)
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert t.fingerprint() == j.fingerprint()
    assert load_flame_resources("synthetic_small") is t
    with pytest.raises(FileNotFoundError):
        load_flame_resources("/nonexistent/flame.npz")


def test_flame_decode_and_normals_match():
    res_t = synthetic_flame_resources(seed=1, n_vertices=503)
    res_j = j_synth(seed=1, n_vertices=503)
    fl = _flame(np.random.default_rng(0), 3)
    fl[:, 150:156] = np.random.default_rng(1).standard_normal((3, 6)) * 0.3
    want = np.array(jdec.flame_decode(res_j, jnp.asarray(fl[:, :100]),
                                        jnp.asarray(fl[:, 100:150]), jnp.asarray(fl[:, 150:156])))
    tfl = torch.from_numpy(fl)
    got = tdec.flame_decode(res_t, tfl[:, :100], tfl[:, 100:150], tfl[:, 150:156]).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    n_want = np.asarray(jmesh.vertex_normals(jnp.asarray(want), res_j.faces))
    n_got = tmesh.vertex_normals(torch.from_numpy(want), res_t.faces).numpy()
    np.testing.assert_allclose(n_got, n_want, rtol=RTOL, atol=ATOL)
    fv = tmesh.face_vertices(torch.from_numpy(want), res_t.faces).numpy()
    np.testing.assert_array_equal(fv, np.asarray(jmesh.face_vertices(jnp.asarray(want), res_j.faces)))


def test_position_to_given_location_matches():
    # The full-size synthetic mesh carries FLAME's eye vertices (4051, 4597),
    # so the eye-centring solve is well posed.
    res_t = synthetic_flame_resources()
    res_j = j_synth()
    fl = _flame(np.random.default_rng(2), 3)
    want = np.array(jcam.position_to_given_location(res_j, jnp.asarray(fl)))
    got = tcam.position_to_given_location(res_t, torch.from_numpy(fl)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[:, :156], fl[:, :156])
    proj_j = np.asarray(jcam.batch_orth_proj(jnp.asarray(res_j.v_template[None]), jnp.asarray(want[:1, 156:159])))
    proj_t = tcam.batch_orth_proj(torch.from_numpy(res_t.v_template[None]), torch.from_numpy(want[:1, 156:159]))
    np.testing.assert_allclose(proj_t.numpy(), proj_j, rtol=RTOL, atol=ATOL)

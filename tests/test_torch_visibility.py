"""Port parity of per-vertex visibility: ``get_visibility`` (faces that win
a pixel -> their vertices) and ``get_visibility_z`` (the bilinear
depth-buffer test) equal JAX's, vertex for vertex.  The rasterizers' tri_id
maps are equal, so any difference is a fault.  Cases: the normalized
template of tests/test_raster.py's mesh-sized-capacity test, and a batch
of posed heads through the renderer's camera and flips."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_tpu.render.raster import get_visibility as j_vis
from gif_tpu.render.raster import get_visibility_z as j_vis_z
from gif_tpu_torch.flame.camera import batch_orth_proj
from gif_tpu_torch.flame.decoder import flame_decode
from gif_tpu_torch.flame.resources import synthetic_flame_resources
from gif_tpu_torch.render.raster import get_visibility, get_visibility_z


def _template_case():
    """tests/test_raster.py's case: the 203-vertex template NDC-normalized
    to fill the screen, 64 x 64."""
    res = synthetic_flame_resources(seed=3, n_vertices=203)
    v = res.v_template[None]
    c = v - v.mean(axis=1, keepdims=True)
    return (c / (np.abs(c).max() + 1e-6)).astype(np.float32), res.faces, 64


def _posed_case():
    """Three posed heads of the 503-vertex mesh through the renderer's
    orthographic camera and y / z flips, 32 x 32."""
    res = synthetic_flame_resources(seed=1, n_vertices=503)
    rng = np.random.default_rng(3)
    b = 3
    shape = torch.as_tensor(rng.standard_normal((b, 100)).astype(np.float32) * 0.5)
    exp = torch.as_tensor(rng.standard_normal((b, 50)).astype(np.float32) * 0.5)
    pose = torch.as_tensor(rng.standard_normal((b, 6)).astype(np.float32) * 0.3)
    cam = torch.tensor([[8.0, 0.0, 0.0], [6.0, 0.02, -0.03], [9.0, -0.01, 0.01]])
    trans = batch_orth_proj(flame_decode(res, shape, exp, pose), cam)
    trans = torch.cat([trans[:, :, :1], -trans[:, :, 1:]], dim=2)
    return trans.numpy(), res.faces, 32


@pytest.mark.parametrize("case", ["template", "posed"])
@pytest.mark.parametrize("which", ["faces", "depth"])
def test_visibility_equals_jax(case, which):
    verts, faces, size = _template_case() if case == "template" else _posed_case()
    jfn, tfn = (j_vis, get_visibility) if which == "faces" else (j_vis_z, get_visibility_z)
    want = np.asarray(jfn(jnp.asarray(verts), jnp.asarray(faces), size, size))
    got = tfn(torch.from_numpy(verts), faces, size, size)
    assert got.shape == (verts.shape[0], verts.shape[1]) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # Some vertices are visible and some hidden in every sample.
    assert ((want > 0).any(1) & (want == 0).any(1)).all()


def test_visibility_takes_faces_as_a_tensor():
    verts, faces, size = _template_case()
    a = get_visibility(torch.from_numpy(verts), faces, size, size)
    b = get_visibility(torch.from_numpy(verts), torch.as_tensor(faces), size, size)
    torch.testing.assert_close(a, b, rtol=0, atol=0)

"""Port parity of the full FLAME decode and the mesh / camera extras:
``flame_decode_full`` (verts, lmk2d with the dynamic contour, lmk3d) and
``flame_decode_landmarks`` at zero pose and at yaws that move the contour
bucket (rtol 1e-5, atol 1e-6), the contour bucket itself (equal),
``face_normals`` (rtol 1e-5, atol 1e-6), OBJ files written by one package
and read by the other (equal), and the legacy camera dicts (equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gif_tpu.flame import camera as jcam
from gif_tpu.flame import decoder as jdec
from gif_tpu.flame import mesh as jmesh
from gif_tpu.flame.resources import synthetic_flame_resources as j_synth
from gif_tpu_torch.flame import camera as tcam
from gif_tpu_torch.flame import decoder as tdec
from gif_tpu_torch.flame import mesh as tmesh
from gif_tpu_torch.flame.resources import synthetic_flame_resources

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def resources():
    return j_synth(seed=2, n_vertices=503), synthetic_flame_resources(seed=2, n_vertices=503)


def _params(yaws, seed=0):
    rng = np.random.default_rng(seed)
    b = len(yaws)
    shape = (rng.standard_normal((b, 100)) * 0.5).astype(np.float32)
    exp = (rng.standard_normal((b, 50)) * 0.5).astype(np.float32)
    pose = (rng.standard_normal((b, 6)) * 0.05).astype(np.float32)
    pose[:, 1] = yaws  # global rotation about y: the head's yaw
    pose[:, 0] = 0.0
    pose[:, 2] = 0.0
    return shape, exp, pose


@pytest.mark.parametrize("yaws", [[0.0, 0.0], [0.3, -0.3, 0.05, -0.9, 0.9]])
def test_flame_decode_full_matches_jax(resources, yaws):
    jres, tres = resources
    shape, exp, pose = _params(yaws)
    want = jdec.flame_decode_full(jres, jnp.asarray(shape), jnp.asarray(exp), jnp.asarray(pose))
    got = tdec.flame_decode_full(tres, torch.from_numpy(shape), torch.from_numpy(exp), torch.from_numpy(pose))
    for name, g, w in zip(("verts", "lmk2d", "lmk3d"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=name)
    assert got[1].shape == got[2].shape == (len(yaws), 68, 3)

    neck = np.zeros((len(yaws), 3), np.float32)
    j_bucket = np.asarray(jdec._dynamic_contour_bucket(jnp.asarray(pose), jnp.asarray(neck), jnp.float32))
    t_bucket = tdec._dynamic_contour_bucket(torch.from_numpy(pose), torch.from_numpy(neck)).numpy()
    np.testing.assert_array_equal(t_bucket, j_bucket)
    if any(yaws):
        # The yaws reach other buckets (both signs) and the jawline moves.
        assert len(set(t_bucket.tolist())) > 2 and t_bucket.max() > 39
        assert (got[1][:, :17] - got[2][:, :17]).abs().max() > 1e-3
    else:
        assert (t_bucket == 0).all()
        np.testing.assert_array_equal(got[1].numpy(), got[2].numpy())

    lmk = tdec.flame_decode_landmarks(tres, got[0])
    np.testing.assert_allclose(lmk.numpy(), np.asarray(jdec.flame_decode_landmarks(jres, want[0])),
                               rtol=RTOL, atol=ATOL)


def test_flame_decode_full_without_dynamic_contour(resources):
    import dataclasses

    jres, tres = resources
    jres = dataclasses.replace(jres, dynamic_lmk_faces=None, dynamic_lmk_bary=None)
    tres = dataclasses.replace(tres, dynamic_lmk_faces=None, dynamic_lmk_bary=None)
    shape, exp, pose = _params([0.4])
    _, j2, j3 = jdec.flame_decode_full(jres, jnp.asarray(shape), jnp.asarray(exp), jnp.asarray(pose))
    _, t2, t3 = tdec.flame_decode_full(tres, torch.from_numpy(shape), torch.from_numpy(exp), torch.from_numpy(pose))
    assert t2 is t3
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("normalize", [True, False])
def test_face_normals_match_jax(resources, normalize):
    _, tres = resources
    rng = np.random.default_rng(1)
    verts = (tres.v_template[None] + rng.standard_normal((2,) + tres.v_template.shape) * 0.01).astype(np.float32)
    want = jmesh.face_normals(jnp.asarray(verts), jnp.asarray(tres.faces), normalize=normalize)
    got = tmesh.face_normals(torch.from_numpy(verts), tres.faces, normalize=normalize)
    assert got.shape == (2, tres.n_faces, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["plain", "colors", "textured"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_obj_written_by_one_package_reads_the_same_in_the_other(tmp_path, resources, kind, writer):
    _, tres = resources
    rng = np.random.default_rng(5)
    v, f = tres.v_template, tres.faces
    kw = {}
    if kind == "colors":
        kw["vertex_colors"] = rng.uniform(0, 1, v.shape).astype(np.float32)
    if kind == "textured":
        kw = {"texture": rng.uniform(0, 1, (16, 16, 3)), "uvcoords": tres.uv_coords, "uvfaces": f}
    save = {"jax": jmesh.save_obj, "port": tmesh.save_obj}
    paths = {}
    for name, fn in save.items():
        paths[name] = str(tmp_path / f"{name}.obj")
        fn(paths[name], v, f, **kw)
    assert open(paths["jax"]).read().replace("jax.", "X.") == open(paths["port"]).read().replace("port.", "X.")
    path = paths[writer]
    got, want = tmesh.load_obj(path), jmesh.load_obj(path)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], f)
    np.testing.assert_allclose(got[0], v, atol=1e-6)
    if kind == "textured":
        np.testing.assert_array_equal(got[3], f)
        assert open(str(tmp_path / "jax.png"), "rb").read() == open(str(tmp_path / "port.png"), "rb").read()
    with pytest.raises(ValueError, match="uvcoords"):
        tmesh.save_obj(str(tmp_path / "bad.obj"), v, f, texture=np.zeros((4, 4, 3)))


@pytest.mark.parametrize(
    "name,args",
    [
        ("camera_ringnet", (np.array([5000.0, 112.0, 128.0]),)),
        ("camera_dynamic", ((512, 384), np.array([0.0, 0.1, 2.0]))),
        ("camera_ringnetpp", ((256, 256), np.array([0.02, -0.01, 1.5]), 1500.0)),
    ],
)
def test_legacy_camera_dicts_match_jax(name, args):
    want = getattr(jcam, name)(*args)
    got = getattr(tcam, name)(*args)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)

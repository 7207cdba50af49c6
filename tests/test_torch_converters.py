"""The port's artifact converters against the JAX package's: both FLAME
converters fed one fabricated FLAME 2020 set (the generic model at its real
shapes — 5023 vertices, 400 shape + expression dirs, 36 pose columns —, a
512 px texture space with 4 PCA dirs, landmark embedding, texture
precompute, a seamed OBJ and a face mask) write npz files equal array for
array; both Inception converters fed one fabricated ``pt_inception.pth``
(pytorch_fid's names) write equal npz files, which the port's loader reads
back to the state_dict it came from.  Tolerance: equality (the same numpy
arithmetic in both)."""

import pickle

import numpy as np
import pytest
import torch

from gif_tpu.tools import convert_flame as j_convert_flame
from gif_tpu.tools import convert_inception as j_convert_inception
from gif_tpu_torch.eval.inception import InceptionV3FID
from gif_tpu_torch.flame.resources import load_flame_resources
from gif_tpu_torch.tools import convert_flame, convert_inception
from gif_tpu_torch.tools.convert_params import load_inception_npz
from gif_tpu_torch.tools.manifest import ManifestError
from torch_port_common import cpu_threads


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # Six test processes share the machine under tier-1: cap each one's
    # thread pools (torch_port_common.cpu_threads).
    with cpu_threads():
        yield


N_V, N_F, N_TEX_DIRS, N_TEXELS = 5023, 9976, 4, 3000


def _write_obj(path, rng, faces):
    """A template OBJ with UV seams: more vt entries than vertices, uv faces
    out of vertex order."""
    verts = rng.standard_normal((N_V, 3)).astype(np.float32)
    n_vt = N_V + 200
    uvs = rng.uniform(0, 1, (n_vt, 2)).astype(np.float32)
    uv_faces = rng.integers(0, n_vt, faces.shape)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for u in uvs:
            f.write(f"vt {u[0]:.6f} {u[1]:.6f}\n")
        for fa, fu in zip(faces, uv_faces):
            f.write("f " + " ".join(f"{a + 1}/{b + 1}" for a, b in zip(fa, fu)) + "\n")


@pytest.fixture(scope="module")
def flame_inputs(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("flame_in")
    rng = np.random.default_rng(0)
    faces = rng.integers(0, N_V, (N_F, 3)).astype(np.uint32)
    model = {
        "v_template": rng.standard_normal((N_V, 3)),
        "shapedirs": rng.standard_normal((N_V, 3, 400)).astype(np.float32),
        "posedirs": rng.standard_normal((N_V, 3, 36)).astype(np.float32),
        "J_regressor": rng.uniform(0, 1e-3, (5, N_V)),
        "weights": rng.uniform(0, 1, (N_V, 5)),
        "f": faces,
        "kintree_table": np.array([[4294967295, 0, 1, 1, 1], [0, 1, 2, 3, 4]], np.int64),
    }
    with open(d / "generic_model.pkl", "wb") as f:
        pickle.dump(model, f)
    np.savez(d / "FLAME_texture.npz", mean=rng.uniform(0, 255, (1, 512 * 512 * 3)).astype(np.float32),
             tex_dir=rng.standard_normal((1, 512 * 512 * 3, N_TEX_DIRS)).astype(np.float32))
    np.save(d / "landmark_embedding.npy", {
        "static_lmk_faces_idx": rng.integers(0, N_F, 51), "static_lmk_bary_coords": rng.dirichlet(np.ones(3), 51),
        "dynamic_lmk_faces_idx": rng.integers(0, N_F, (79, 17)),
        "dynamic_lmk_bary_coords": rng.dirichlet(np.ones(3), (79, 17)),
    }, allow_pickle=True)
    np.save(d / "texture_data_256.npy", {
        "x_coords": rng.integers(0, 256, N_TEXELS), "y_coords": rng.integers(0, 256, N_TEXELS),
        "valid_pixel_ids": rng.integers(0, 256 * 256, N_TEXELS),
        "valid_pixel_3d_faces": rng.integers(0, N_V, (N_TEXELS, 3)),
        "valid_pixel_b_coords": rng.dirichlet(np.ones(3), N_TEXELS),
    }, allow_pickle=True)
    _write_obj(d / "head_template_mesh.obj", rng, faces)
    mask = np.zeros((256, 256, 3), np.uint8)
    mask[64:192, 80:176] = 255
    Image.fromarray(mask).save(d / "mask.png")
    return d


def _flame_args(d, out):
    return (str(d / "generic_model.pkl"), str(d / "FLAME_texture.npz"), str(d / "landmark_embedding.npy"),
            str(d / "texture_data_256.npy"), str(d / "head_template_mesh.obj"), str(out))


def test_flame_converter_writes_the_jax_converters_npz(flame_inputs, tmp_path):
    d = flame_inputs
    j_convert_flame.convert(*_flame_args(d, tmp_path / "jax.npz"), face_mask_file=str(d / "mask.png"))
    convert_flame.main(["--flame", str(d / "generic_model.pkl"), "--texture", str(d / "FLAME_texture.npz"),
                        "--lmk", str(d / "landmark_embedding.npy"), "--texdata", str(d / "texture_data_256.npy"),
                        "--obj", str(d / "head_template_mesh.obj"), "--face_mask", str(d / "mask.png"),
                        "--out", str(tmp_path / "port.npz")])
    with np.load(tmp_path / "jax.npz") as want, np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        assert "face_region_mask" in got.files and "dynamic_lmk_faces" in got.files
        for k in want.files:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    res = load_flame_resources(str(tmp_path / "port.npz"))
    assert res.v_template.shape == (N_V, 3) and res.shapedirs.shape == (N_V, 3, 100)
    assert res.expdirs.shape == (N_V, 3, 50) and res.posedirs.shape == (36, 3 * N_V)
    assert res.tex_dirs.shape == (256, 256, 3, N_TEX_DIRS) and not res.is_synthetic


def test_flame_converter_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    a = rng.standard_normal((8, 6, 3, 2)).astype(np.float32)
    assert np.array_equal(convert_flame._box_down2(a), j_convert_flame._box_down2(a))
    uvs = rng.uniform(0, 1, (9, 2)).astype(np.float32)
    faces = rng.integers(0, 6, (5, 3))
    uv_faces = rng.integers(0, 9, (5, 3))
    for uf in (uv_faces, None):
        assert np.array_equal(convert_flame._per_vertex_uv(uvs, uf, faces, 6),
                              j_convert_flame._per_vertex_uv(uvs, uf, faces, 6))
    with pytest.raises(ValueError):
        convert_flame._per_vertex_uv(uvs[:4], None, faces, 6)
    from PIL import Image

    Image.fromarray(rng.integers(0, 256, (8, 8), dtype=np.uint8)).save(tmp_path / "m.png")
    assert np.array_equal(convert_flame.load_face_region_mask(tmp_path / "m.png"),
                          j_convert_flame.load_face_region_mask(tmp_path / "m.png"))


def test_flame_converter_rejects_a_wrong_model(flame_inputs, tmp_path):
    d = flame_inputs
    with open(d / "generic_model.pkl", "rb") as f:
        model = pickle.load(f)
    model["shapedirs"] = model["shapedirs"][:, :, :300]
    with open(tmp_path / "bad.pkl", "wb") as f:
        pickle.dump(model, f)
    args = list(_flame_args(d, tmp_path / "out.npz"))
    args[0] = str(tmp_path / "bad.pkl")
    with pytest.raises(ManifestError, match="shapedirs"):
        convert_flame.convert(*args)


@pytest.fixture(scope="module")
def inception_pth(tmp_path_factory):
    """Every key of pytorch_fid's state dict; the manifest's two anchor
    convs at their real shapes, the other convs 2-wide (their shapes are
    free in the manifest), so the compressed npz stays small."""
    rng = np.random.default_rng(2)
    anchors = {"Conv2d_1a_3x3.conv.weight": (32, 3, 3, 3), "Mixed_7c.branch_pool.conv.weight": (192, 2048, 1, 1)}
    sd = {}
    with torch.device("meta"):
        keys = list(InceptionV3FID().state_dict())
    for k in keys:
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(0)
            continue
        shape = anchors.get(k, (2, 2, 3, 1) if k.endswith(".conv.weight") else (2,))
        sd[k] = torch.from_numpy((rng.standard_normal(shape) * 0.05).astype(np.float32))
    path = tmp_path_factory.mktemp("inc") / "pt_inception.pth"
    torch.save(sd, path)
    return path, sd


def test_inception_converter_writes_the_jax_converters_npz(inception_pth, tmp_path):
    path, sd = inception_pth
    j_convert_inception.convert(str(path), str(tmp_path / "jax.npz"))
    convert_inception.main(["--torch_weights", str(path), "--out", str(tmp_path / "port.npz")])
    with np.load(tmp_path / "jax.npz") as want, np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    tree, j_tree = (m.load_converted_params(str(tmp_path / "port.npz"))
                    for m in (convert_inception, j_convert_inception))
    assert tree.keys() == j_tree.keys()
    back = load_inception_npz(str(tmp_path / "port.npz"))
    want_sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    assert sorted(back) == sorted(want_sd)
    assert all(torch.equal(back[k], want_sd[k]) for k in want_sd)


def test_inception_manifest_matches_jax():
    assert convert_inception._inception_manifest() == j_convert_inception._inception_manifest()

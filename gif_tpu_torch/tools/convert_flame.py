"""Convert official FLAME artifacts into the consolidated resource npz (the
port's own copy of ``gif_tpu.tools.convert_flame``).

Inputs (licensed, obtain from the FLAME/DECA project pages — reference
constants.py:63-79):
  generic_model.pkl        FLAME 2020 model (chumpy arrays inside)
  FLAME_texture.npz        PCA texture space ('mean', 'tex_dir')
  landmark_embedding.npy   static+dynamic landmark embedding
  texture_data_256.npy     FlameTextureSpace precompute
  head_template_mesh.obj   template with UV coordinates
  texture_map_256X256_face_only_mask.png  face-region mask for the texture
                           interpolation loss (reference constants.py:48,
                           losses.py:132-134); optional

Output: one ``.npz`` loadable by
gif_tpu_torch.flame.resources.load_flame_resources (the same file the JAX
package's converter writes, array for array).

Usage:
  python -m gif_tpu_torch.tools.convert_flame --flame generic_model.pkl \
      --texture FLAME_texture.npz --lmk landmark_embedding.npy \
      --texdata texture_data_256.npy --obj head_template_mesh.obj \
      --out resources/flame/flame2020_generic.npz
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np


def _to_np(x):
    """chumpy/scipy-sparse/np -> dense float32 numpy."""
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray(), np.float32)
    if hasattr(x, "r"):  # chumpy
        return np.asarray(x.r, np.float32)
    return np.asarray(x, np.float32)


def _box_down2(a: np.ndarray) -> np.ndarray:
    """2x2 box-average downsample of an (H, W, ...) image/basis stack."""
    h, w = a.shape[:2]
    return a.reshape((h // 2, 2, w // 2, 2) + a.shape[2:]).mean(axis=(1, 3))


def _per_vertex_uv(uvs, uv_faces, faces, n_verts) -> np.ndarray:
    """Per-vertex UV from an OBJ's seamed (vt list + uv-face indices) layout.

    FLAME's head_template_mesh.obj has MORE vt entries than vertices (UV
    seams) and its vt order is NOT vertex order — ``uvs[:n_verts]`` would
    assign nearly every vertex another vertex's UV.  The renderer samples
    per-vertex (renderer.py: ``uv[faces]``), so collapse seams by taking
    each vertex's first-occurring corner UV (seam vertices keep one of
    their charts; FLAME's face region is seam-free).

    The v axis is flipped here to the renderer's image convention
    (v=0 = top texture row): OBJ vt is bottom-origin, and the DECA
    renderer this mirrors applies the same flip before grid_sample.
    """
    uvs = uvs.copy()
    uvs[:, 1] = 1.0 - uvs[:, 1]
    if uv_faces is None:
        if len(uvs) < n_verts:
            raise ValueError(
                f"OBJ has {len(uvs)} vt entries for {n_verts} vertices and "
                "no uv-face indices"
            )
        return uvs[:n_verts]
    flat_v = np.asarray(faces, np.int64).reshape(-1)
    flat_uv = uvs[np.asarray(uv_faces, np.int64).reshape(-1)]
    order = np.argsort(flat_v, kind="stable")
    vv, uu = flat_v[order], flat_uv[order]
    first = np.concatenate([[True], vv[1:] != vv[:-1]])
    out = np.zeros((n_verts, 2), np.float32)
    out[vv[first]] = uu[first]
    return out


def load_face_region_mask(path) -> np.ndarray:
    """Face-region mask PNG -> (H, W) float32 in [0, 1]: first channel
    scaled by 255 (reference losses.py:132-134)."""
    from PIL import Image

    mask = np.array(Image.open(path))
    if mask.ndim == 3:
        mask = mask[:, :, 0]
    return mask.astype(np.float32) / 255.0


def convert(
    flame_pkl,
    texture_npz,
    lmk_file,
    texdata_file,
    obj_file,
    out_path,
    face_mask_file=None,
):
    from gif_tpu_torch.flame.mesh import load_obj
    from gif_tpu_torch.flame.resources import FlameResources, save_flame_resources
    from gif_tpu_torch.tools.manifest import check_manifest, require_keys

    with open(flame_pkl, "rb") as f:
        model = pickle.load(f, encoding="latin1")

    # FLAME 2020 'generic_model.pkl' manifest: 5023 vertices, 300 shape +
    # 100 expression PCA dirs packed as shapedirs[..., :400], 36 pose
    # blendshape columns, 5 joints (reference constants.py:63-79 and the
    # FLAME topology facts in SURVEY.md SS2.9).
    check_manifest(
        {k: _to_np(v) if k != "f" else np.asarray(v) for k, v in model.items()
         if k in ("v_template", "shapedirs", "posedirs", "J_regressor",
                   "weights", "f")},
        {
            "v_template": (5023, 3),
            "shapedirs": (5023, 3, 400),
            "posedirs": ((5023, 3, 36), (36, 15069)),
            "J_regressor": (5, 5023),
            "weights": (5023, 5),
            "f": (9976, 3),
        },
        f"{flame_pkl} (FLAME 2020 generic model)",
    )

    shapedirs_full = _to_np(model["shapedirs"])  # (V, 3, 400)
    res_kwargs = dict(
        v_template=_to_np(model["v_template"]),
        shapedirs=shapedirs_full[:, :, :100],
        expdirs=shapedirs_full[:, :, 300:350],
        posedirs=_to_np(model["posedirs"]).reshape(-1, 36).T
        if _to_np(model["posedirs"]).ndim == 3
        else _to_np(model["posedirs"]),
        j_regressor=_to_np(model["J_regressor"]),
        lbs_weights=_to_np(model["weights"]),
        faces=np.asarray(model["f"], np.int32),
        parents=np.asarray(model["kintree_table"][0], np.int32)
        if "kintree_table" in model
        else np.array([-1, 0, 1, 1, 1], np.int32),
    )
    # posedirs in FLAME pkl: (V, 3, 36) -> (36, V*3)
    pd = _to_np(model["posedirs"])
    if pd.ndim == 3:
        res_kwargs["posedirs"] = pd.reshape(-1, pd.shape[-1]).T

    tex = np.load(texture_npz)
    require_keys(tex, ["mean", "tex_dir"], f"{texture_npz} (FLAME texture space)")
    n_tex = 50
    if np.asarray(tex["mean"]).size != 512 * 512 * 3:
        raise ValueError(
            f"{texture_npz}: 'mean' has {np.asarray(tex['mean']).size} elements, "
            "expected 512*512*3 (the FLAME_texture.npz PCA space ships at 512px)"
        )
    tex_mean = np.asarray(tex["mean"], np.float32).reshape(512, 512, 3)
    tex_dirs = np.asarray(tex["tex_dir"], np.float32).reshape(512, 512, 3, -1)[
        ..., :n_tex
    ]
    # The PCA space ships at 512; the resource schema (and the
    # texture_data_256 precompute it must stay texel-aligned with —
    # FlameResources TEX_RES, models/texture_space.py) is 256.  The
    # reference renders at 512 and callers bilinear-downsample to 256
    # (losses.py:215-216); a 2x2 box average of the PCA basis commutes
    # with the linear texture model, so downsampling the basis here is
    # the same image downsample folded into the resources.
    res_kwargs["tex_mean"] = _box_down2(tex_mean)
    res_kwargs["tex_dirs"] = _box_down2(tex_dirs)

    lmk = np.load(lmk_file, allow_pickle=True, encoding="latin1")
    if hasattr(lmk, "item"):
        lmk = lmk.item()
    require_keys(
        lmk,
        ["static_lmk_faces_idx", "static_lmk_bary_coords"],
        f"{lmk_file} (FLAME landmark embedding)",
    )
    res_kwargs["lmk_faces"] = np.asarray(
        lmk["static_lmk_faces_idx"], np.int32
    ).reshape(-1)
    res_kwargs["lmk_bary"] = np.asarray(
        lmk["static_lmk_bary_coords"], np.float32
    ).reshape(-1, 3)
    if "dynamic_lmk_faces_idx" in lmk:
        res_kwargs["dynamic_lmk_faces"] = np.asarray(
            lmk["dynamic_lmk_faces_idx"], np.int32
        )
        res_kwargs["dynamic_lmk_bary"] = np.asarray(
            lmk["dynamic_lmk_bary_coords"], np.float32
        )
    if "full_lmk_faces_idx" in lmk:
        # Prefer the full 68-point embedding when the file carries one.
        res_kwargs["lmk_faces"] = np.asarray(
            lmk["full_lmk_faces_idx"], np.int32
        ).reshape(-1)
        res_kwargs["lmk_bary"] = np.asarray(
            lmk["full_lmk_bary_coords"], np.float32
        ).reshape(-1, 3)

    td = np.load(texdata_file, allow_pickle=True, encoding="latin1").item()
    require_keys(
        td,
        ["x_coords", "y_coords", "valid_pixel_ids", "valid_pixel_3d_faces",
         "valid_pixel_b_coords"],
        f"{texdata_file} (texture_data_256 precompute)",
    )
    res_kwargs["texture_x_coords"] = np.asarray(td["x_coords"], np.int64)
    res_kwargs["texture_y_coords"] = np.asarray(td["y_coords"], np.int64)
    res_kwargs["texture_valid_pixel_ids"] = np.asarray(
        td["valid_pixel_ids"], np.int64
    )
    res_kwargs["texture_valid_faces"] = np.asarray(
        td["valid_pixel_3d_faces"], np.int32
    )
    res_kwargs["texture_valid_bary"] = np.asarray(
        td["valid_pixel_b_coords"], np.float32
    )

    _, obj_faces, uvs, uv_faces = load_obj(obj_file)
    if uvs is None:
        raise ValueError("template OBJ carries no UV coordinates")
    res_kwargs["uv_coords"] = _per_vertex_uv(
        np.asarray(uvs, np.float32),
        uv_faces,
        obj_faces,
        len(res_kwargs["v_template"]),
    )

    if face_mask_file is not None:
        res_kwargs["face_region_mask"] = load_face_region_mask(face_mask_file)

    res = FlameResources(**res_kwargs)
    save_flame_resources(res, out_path)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--flame", required=True)
    p.add_argument("--texture", required=True)
    p.add_argument("--lmk", required=True)
    p.add_argument("--texdata", required=True)
    p.add_argument("--obj", required=True)
    p.add_argument("--face_mask", default=None,
                   help="texture_map_256X256_face_only_mask.png")
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    print(convert(a.flame, a.texture, a.lmk, a.texdata, a.obj, a.out,
                  face_mask_file=a.face_mask))


if __name__ == "__main__":
    main()

"""FLAME resource loading (the port's own copy of ``gif_tpu.flame.resources``).

The real FLAME 2020 artifacts (``generic_model.pkl``, ``FLAME_texture.npz``,
``landmark_embedding.npy``, ``texture_data_256.npy``) are licensed by MPI and
not shipped (the reference points at cluster paths, constants.py:27-79, and
its in-tree copies are git-LFS stubs).  This module defines:

- a single consolidated ``.npz`` schema holding everything the pipeline needs
  (produced from the official artifacts by the JAX package's
  ``gif_tpu.tools.convert_flame``; the port reads the same files);
- a deterministic *synthetic* resource generator with identical shapes and
  plausible geometry (a triangulated head-sized ellipsoid) so every code
  path — decode, render, texture steal, training — runs and is testable
  without the licensed files.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np

N_VERTICES = 5023
N_SHAPE = 100
N_EXP = 50
N_JOINTS = 5  # root(global), neck, jaw, eye_l, eye_r
PARENTS = np.array([-1, 0, 1, 1, 1], dtype=np.int32)
TEX_RES = 256
N_TEX = 50


@dataclasses.dataclass(frozen=True)
class FlameResources:
    """All FLAME model arrays, as numpy (moved to the device by the callers).

    Shapes (v = n_vertices, f = n_faces):
      v_template:    (v, 3)
      shapedirs:     (v, 3, 100)   shape PCA basis
      expdirs:       (v, 3, 50)    expression PCA basis
      posedirs:      (36, v*3)     pose-corrective basis, (R_j - I) features
      j_regressor:   (5, v)
      lbs_weights:   (v, 5)
      faces:         (f, 3) int32
      uv_coords:     (v, 2) in [0, 1]  (per-vertex UV)
      lmk_faces:     (51 or 68,) int32   static landmark embedding
      lmk_bary:      (51 or 68, 3)
      dynamic_lmk_faces / dynamic_lmk_bary: (79, 17) / (79, 17, 3) —
        yaw-bucketed jawline contour (see field comment)
      tex_mean:      (tex_res, tex_res, 3)   0..255 scale
      tex_dirs:      (tex_res, tex_res, 3, 50)
      texture_x_coords / texture_y_coords / texture_valid_pixel_ids /
      texture_valid_faces (P, 3) / texture_valid_bary (P, 3):
        the FlameTextureSpace precompute (reference stg2_generator.py:348-353).
      face_region_mask: (tex_res, tex_res) float32 in [0, 1] — the
        texture-space face-only mask multiplied into the texture
        interpolation loss (reference losses.py:132-134 loads
        texture_map_256X256_face_only_mask.png, constants.py:48).
    """

    v_template: np.ndarray
    shapedirs: np.ndarray
    expdirs: np.ndarray
    posedirs: np.ndarray
    j_regressor: np.ndarray
    lbs_weights: np.ndarray
    faces: np.ndarray
    uv_coords: np.ndarray
    lmk_faces: np.ndarray
    lmk_bary: np.ndarray
    tex_mean: np.ndarray
    tex_dirs: np.ndarray
    texture_x_coords: np.ndarray
    texture_y_coords: np.ndarray
    texture_valid_pixel_ids: np.ndarray
    texture_valid_faces: np.ndarray
    texture_valid_bary: np.ndarray
    face_region_mask: np.ndarray | None = None  # None -> treated as all-ones
    # Dynamic-contour landmark embedding (FLAME landmark_embedding.npy):
    # the 17 jawline points of the 68-landmark set are re-selected by head
    # yaw in 1-degree buckets over [-39, 39] (79 rows).  None -> the
    # dynamic set degrades to the static jawline (synthetic resources ship
    # plausible tables).  Reference contract: FLAME() returns
    # (verts, lmk2d, lmk3d) (my_utils/eye_centering.py:38-39).
    dynamic_lmk_faces: np.ndarray | None = None  # (79, 17) int32
    dynamic_lmk_bary: np.ndarray | None = None  # (79, 17, 3)
    parents: np.ndarray = dataclasses.field(default_factory=lambda: PARENTS.copy())
    is_synthetic: bool = False

    def tensor(self, name: str, device, dtype=None):
        """Field ``name`` as a tensor on ``device`` (optionally cast),
        memoized on the instance so the ~45 MB of bases and texture PCA
        cross to the card once per resource set, not once per batch.  The
        tensor is made outside inference mode, so a resource set first used
        by the server can later be differentiated through (the render's
        gradient)."""
        import torch

        cache = self.__dict__.get("_tensors")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_tensors", cache)
        key = (name, str(torch.device(device)), dtype)
        t = cache.get(key)
        if t is None:
            with torch.inference_mode(False):
                t = torch.as_tensor(np.asarray(getattr(self, name))).to(device)
                if dtype is not None:
                    t = t.to(dtype)
            cache[key] = t
        return t

    @property
    def n_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def n_faces(self) -> int:
        return self.faces.shape[0]

    def fingerprint(self) -> str:
        """Cheap stable content hash for cache keys.

        Never key caches on ``id(res)``: after GC the id can be reused by a
        different resources object (ADVICE r4).  Hashes every field's shape,
        dtype, total size, and head/tail bytes — O(KB) work regardless of
        array size — computed once and memoized on the instance.
        """
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            import hashlib

            h = hashlib.sha1()
            for f in dataclasses.fields(self):
                v = getattr(self, f.name)
                h.update(f.name.encode())
                if isinstance(v, np.ndarray):
                    buf = np.ascontiguousarray(v).view(np.uint8).reshape(-1)
                    h.update(f"{v.shape}{v.dtype}{v.nbytes}".encode())
                    h.update(buf[:4096].tobytes())
                    h.update(buf[-4096:].tobytes())
                else:
                    h.update(repr(v).encode())
            fp = h.hexdigest()
            object.__setattr__(self, "_fingerprint", fp)
        return fp


def _fibonacci_sphere(n: int) -> np.ndarray:
    """n deterministic, well-spread unit vectors."""
    i = np.arange(n, dtype=np.float64)
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    z = 1.0 - 2.0 * (i + 0.5) / n
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    theta = 2.0 * np.pi * i / phi
    return np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=1)


def _smooth_basis(rng, points: np.ndarray, n_basis: int, scale: float) -> np.ndarray:
    """(v, 3, n_basis) spatially-smooth random deformation basis."""
    v = points.shape[0]
    n_freq = 6
    # Random low-frequency functions of position: sin(k·x + b) mixtures.
    k = rng.standard_normal((n_freq, 3)) * 3.0
    b = rng.uniform(0, 2 * np.pi, size=n_freq)
    feats = np.sin(points @ k.T + b)  # (v, n_freq)
    mix = rng.standard_normal((n_freq, 3, n_basis))
    basis = np.einsum("vf,fcb->vcb", feats, mix)
    basis *= scale / (np.abs(basis).max() + 1e-9)
    return basis.astype(np.float32)


@functools.lru_cache(maxsize=2)
def synthetic_flame_resources(seed: int = 0, n_vertices: int = N_VERTICES) -> FlameResources:
    """Deterministic FLAME-shaped synthetic model.

    Geometry: head-sized ellipsoid (FLAME's head spans roughly ±0.1 m)
    triangulated via the convex hull of a Fibonacci point set, giving
    ~2·v faces — the same order as FLAME's 9976 triangles.
    """
    from scipy.spatial import ConvexHull

    rng = np.random.default_rng(seed)
    sphere = _fibonacci_sphere(n_vertices)
    radii = np.array([0.085, 0.115, 0.10])  # x, y, z half-extents (metres)
    v_template = (sphere * radii).astype(np.float32)

    hull = ConvexHull(sphere)
    faces = hull.simplices.astype(np.int32)
    # Orient all faces outward (consistent winding).
    tri = sphere[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    centroid = tri.mean(axis=1)
    flip = (n * centroid).sum(-1) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]

    shapedirs = _smooth_basis(rng, sphere, N_SHAPE, scale=0.012)
    expdirs = _smooth_basis(rng, sphere, N_EXP, scale=0.008)
    posedirs = (rng.standard_normal((36, n_vertices * 3)) * 1e-4).astype(np.float32)

    # Joints: root at centroid, neck below, jaw low-front, eyes upper-front.
    joint_targets = np.array(
        [
            [0.0, 0.0, 0.0],
            [0.0, -0.09, -0.02],
            [0.0, -0.06, 0.07],
            [-0.03, 0.03, 0.08],
            [0.03, 0.03, 0.08],
        ]
    )
    j_regressor = np.zeros((N_JOINTS, n_vertices), dtype=np.float32)
    for j, t in enumerate(joint_targets):
        d = np.linalg.norm(v_template - t, axis=1)
        w = np.exp(-(d**2) / (2 * 0.02**2))
        j_regressor[j] = w / w.sum()

    d_j = np.linalg.norm(
        v_template[:, None, :] - joint_targets[None, :, :], axis=-1
    )  # (v, 5)
    lbs = np.exp(-(d_j**2) / (2 * 0.05**2))
    # Root dominates except near the articulated joints.
    lbs[:, 0] += 0.3
    lbs_weights = (lbs / lbs.sum(axis=1, keepdims=True)).astype(np.float32)

    # Per-vertex UV from spherical coords.
    theta = np.arctan2(sphere[:, 0], sphere[:, 2])  # [-pi, pi]
    phi = np.arccos(np.clip(sphere[:, 1], -1, 1))  # [0, pi]
    uv = np.stack([(theta / np.pi + 1) / 2, phi / np.pi], axis=1).astype(np.float32)
    uv = np.clip(uv, 1e-3, 1 - 1e-3)

    n_lmk = 68
    lmk_faces = rng.integers(0, faces.shape[0], size=n_lmk).astype(np.int32)
    lb = rng.dirichlet(np.ones(3), size=n_lmk).astype(np.float32)
    dyn_faces = rng.integers(0, faces.shape[0], size=(79, 17)).astype(np.int32)
    # Bucket 0 (yaw 0 under the FLAME convention) equals the static
    # jawline so the frontal case is consistent between the 2d and 3d
    # landmark sets.
    dyn_faces[0] = lmk_faces[:17]
    dyn_bary = rng.dirichlet(np.ones(3), size=(79, 17)).astype(np.float32)
    dyn_bary[0] = lb[:17]

    # Texture PCA, 0..255 scale like FLAME_texture.npz.
    yy, xx = np.meshgrid(
        np.linspace(0, 1, TEX_RES), np.linspace(0, 1, TEX_RES), indexing="ij"
    )
    base = 150 + 40 * np.sin(4 * np.pi * xx) * np.cos(3 * np.pi * yy)
    tex_mean = np.stack([base, base * 0.85, base * 0.75], axis=-1).astype(np.float32)
    tex_dirs = (rng.standard_normal((TEX_RES, TEX_RES, 3, N_TEX)) * 2.0).astype(
        np.float32
    )

    # Texture-space face-region mask: a soft ellipse covering the central
    # face area of the UV map (stand-in for the reference's
    # texture_map_256X256_face_only_mask.png, constants.py:48).
    eyy = (yy - 0.45) / 0.35
    exx = (xx - 0.5) / 0.30
    face_region_mask = (eyy**2 + exx**2 <= 1.0).astype(np.float32)

    # FlameTextureSpace precompute: valid texels mapped to (face, bary).
    n_valid = 20000
    vx = rng.integers(0, TEX_RES, size=n_valid).astype(np.int64)
    vy = rng.integers(0, TEX_RES, size=n_valid).astype(np.int64)
    pix_ids = (vy * TEX_RES + vx).astype(np.int64)
    tex_face_ids = rng.integers(0, faces.shape[0], size=n_valid)
    valid_faces = faces[tex_face_ids].astype(np.int32)
    valid_bary = rng.dirichlet(np.ones(3), size=n_valid).astype(np.float32)

    return FlameResources(
        v_template=v_template,
        shapedirs=shapedirs,
        expdirs=expdirs,
        posedirs=posedirs,
        j_regressor=j_regressor,
        lbs_weights=lbs_weights,
        faces=faces,
        uv_coords=uv,
        lmk_faces=lmk_faces,
        lmk_bary=lb,
        dynamic_lmk_faces=dyn_faces,
        dynamic_lmk_bary=dyn_bary,
        tex_mean=tex_mean,
        tex_dirs=tex_dirs,
        texture_x_coords=vx,
        texture_y_coords=vy,
        texture_valid_pixel_ids=pix_ids,
        texture_valid_faces=valid_faces,
        texture_valid_bary=valid_bary,
        face_region_mask=face_region_mask,
        is_synthetic=True,
    )


_FIELDS = [f.name for f in dataclasses.fields(FlameResources) if f.name != "is_synthetic"]


def save_flame_resources(res: FlameResources, path: str) -> None:
    np.savez_compressed(
        path,
        **{k: getattr(res, k) for k in _FIELDS if getattr(res, k) is not None},
    )


def load_flame_resources(path: str | None = None, allow_synthetic: bool = True) -> FlameResources:
    """Load the consolidated resource npz, else the synthetic fallback.

    ``path`` may also be the sentinel ``"synthetic"`` (full-size synthetic
    model) or ``"synthetic_small"`` (503-vertex mesh — CPU smoke runs,
    e2e script tests).  An explicit file path that does NOT exist raises —
    a typo'd path must not silently train/sample against synthetic
    geometry."""
    if path == "synthetic":
        return synthetic_flame_resources()
    if path == "synthetic_small":
        return synthetic_flame_resources(seed=1, n_vertices=503)
    if path is not None:
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"FLAME resources not found at {path!r}; run "
                "gif_tpu.tools.convert_flame on the official FLAME "
                "artifacts (docs/REAL_ARTIFACTS.md), or pass "
                "'synthetic'/'synthetic_small'."
            )
        data = np.load(path)
        kwargs = {k: data[k] for k in _FIELDS if k in data}
        return FlameResources(**kwargs, is_synthetic=False)
    if not allow_synthetic:
        raise FileNotFoundError(
            "no FLAME resource path given; run gif_tpu.tools.convert_flame "
            "on the official FLAME artifacts, or pass allow_synthetic=True."
        )
    return synthetic_flame_resources()

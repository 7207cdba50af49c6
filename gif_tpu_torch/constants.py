"""Parameter-vector index maps and FLAME configuration.

The port's own copy of :mod:`gif_tpu.constants`: a GIF conditioning vector
is the concatenation

    [shape(100) | exp(50) | pose(6) | cam(3) | tex(50) | light(27)]  -> 236 dims
"""

from __future__ import annotations

import dataclasses

# Slices into the 159-dim FLAME parameter vector.
INDICES = {
    "SHAPE": (0, 100),
    "EXP": (100, 150),
    "POSE": (150, 156),
    "TRANS": (156, 159),
    "JAW_ROT": (153, 156),
    "GLOBAL_ROT": (150, 153),
    "ROT_JAW_TRANS": (150, 159),
    "CAM": (156, 159),
    "ALL": (0, 159),
}

# Slices into the 236-dim DECA-style parameter vector.
DECA_IDX = {
    "cam": (156, 159),
    "tex": (159, 209),
    "lit": (209, 236),
}

TOTAL_FLAME_PARAMS = 159
TOTAL_DECA_PARAMS = 236


@dataclasses.dataclass(frozen=True)
class FlameConfig:
    """FLAME decoder + renderer configuration."""

    flame_model_path: str = "resources/flame/flame2020_generic.npz"
    flame_lmk_embedding_path: str = "resources/flame/landmark_embedding.npz"
    tex_space_path: str = "resources/flame/flame_texture.npz"
    texture_data_path: str = "resources/flame/texture_data_256.npz"
    shape_params: int = 100
    expression_params: int = 50
    pose_params: int = 6
    tex_params: int = 50
    camera_params: int = 3
    use_face_contour: bool = True
    image_size: int = 256
    n_vertices: int = 5023
    # Eye-centre vertex ids used by the camera solver.
    eye_left_vertex: int = 4051
    eye_right_vertex: int = 4597


DEFAULT_FLAME_CONFIG = FlameConfig()

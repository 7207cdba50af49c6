"""FLAME 2020 morphable head model in PyTorch (port of ``gif_tpu.flame``)."""

from gif_tpu_torch.flame.resources import (
    FlameResources,
    load_flame_resources,
    synthetic_flame_resources,
)
from gif_tpu_torch.flame.decoder import flame_decode, flame_decode_full, flame_decode_landmarks
from gif_tpu_torch.flame.camera import batch_orth_proj, position_to_given_location
from gif_tpu_torch.flame.mesh import vertex_normals, face_vertices, face_normals

__all__ = [
    "FlameResources",
    "load_flame_resources",
    "synthetic_flame_resources",
    "flame_decode",
    "flame_decode_full",
    "flame_decode_landmarks",
    "batch_orth_proj",
    "position_to_given_location",
    "vertex_normals",
    "face_vertices",
    "face_normals",
]

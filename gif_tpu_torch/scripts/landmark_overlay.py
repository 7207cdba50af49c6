"""Project FLAME landmarks onto rendered and generated images.

Decode each FLAME vector with the full ``(verts, lmk2d, lmk3d)`` contract,
project the dynamic-contour landmarks with the orthographic camera and
draw them over the condition render and the generated image.  With
``--reinferred`` (FLAME fits re-inferred from the images) it also prints
the mean landmark pixel error, the paper's re-inference metric:

  python -m gif_tpu_torch.scripts.landmark_overlay --n 8 --out_dir lmk_out
  python -m gif_tpu_torch.scripts.landmark_overlay --converted_ckpt trees.pkl \
      --reinferred fits.npy --out_dir lmk_out
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from gif_tpu_torch.scripts.generate_random_samples import add_common_args, load_params, setup


def project_landmarks(res, flame: np.ndarray, image_size: int, device=None) -> np.ndarray:
    """(N, 236) FLAME params -> (N, 68, 2) pixel-space dynamic-contour
    landmarks (the lmk2d set), with the renderer's camera and y flip,
    computed on ``device`` (CUDA unless the caller passes another)."""
    import torch

    from gif_tpu_torch.device import resolve_device
    from gif_tpu_torch.flame.camera import batch_orth_proj
    from gif_tpu_torch.flame.decoder import flame_decode_full

    device = resolve_device(device)
    with torch.inference_mode():
        f = torch.as_tensor(np.asarray(flame, np.float32), device=device)
        _, lmk2d, _ = flame_decode_full(res, f[:, 0:100], f[:, 100:150], f[:, 150:156])
        proj = batch_orth_proj(lmk2d, f[:, 156:159])
        xy = torch.stack([proj[:, :, 0], -proj[:, :, 1]], dim=-1).cpu().numpy()
    return (xy + 1.0) * (image_size / 2.0)


def draw_points(img_u8: np.ndarray, pts: np.ndarray, radius: int = 1) -> np.ndarray:
    """Stamp green squares at pixel points."""
    out = img_u8.copy()
    h, w = out.shape[:2]
    for x, y in pts:
        xi, yi = int(round(x)), int(round(y))
        if 0 <= xi < w and 0 <= yi < h:
            out[max(0, yi - radius) : min(h, yi + radius + 1), max(0, xi - radius) : min(w, xi + radius + 1)] = (
                0, 255, 0
            )
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_common_args(p)
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--reinferred", type=str, default=None,
                   help="npy of (N, 236) re-inferred FLAME fits to score against (mean landmark pixel error)")
    p.add_argument("--out_dir", type=str, default="lmk_out")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch
    from PIL import Image

    from gif_tpu_torch.eval.sampling import FlameSampler, random_flame_params
    from gif_tpu_torch.flame.camera import position_to_given_location
    from gif_tpu_torch.utils import viz

    device, cfg, res = setup(args)
    rng = np.random.default_rng(args.seed)
    flame = random_flame_params(rng, args.n)
    flame = position_to_given_location(res, torch.as_tensor(flame, device=device)).cpu().numpy()

    sampler = FlameSampler(cfg, res, load_params(args, cfg), eye_center=False, device=device)
    indices = rng.integers(0, args.vocab, args.n).astype(np.int32)
    images, conds = sampler.sample(flame, indices)

    pts = project_landmarks(res, flame, cfg.max_size, device)
    os.makedirs(args.out_dir, exist_ok=True)
    imgs_u8 = viz.to_uint8(images)
    conds_u8 = viz.to_uint8(conds[..., :3])
    for i in range(args.n):
        Image.fromarray(draw_points(imgs_u8[i], pts[i])).save(os.path.join(args.out_dir, f"lmk_face_{i}.png"))
        Image.fromarray(draw_points(conds_u8[i], pts[i])).save(os.path.join(args.out_dir, f"lmk_render_{i}.png"))

    if args.reinferred:
        other = np.load(args.reinferred).astype(np.float32)[: args.n]
        pts_other = project_landmarks(res, other, cfg.max_size, device)
        err = np.linalg.norm(pts - pts_other, axis=-1).mean()
        print(f"mean landmark re-inference error: {err:.2f} px")
    print(f"wrote {args.n} overlays to {args.out_dir}")


if __name__ == "__main__":
    main()

"""VOCA speech-driven face animation: per-identity frame sequences and a grid.

- ``frames``: drive the generator with a VOCA FLAME sequence (shape fixed
  per sequence with components 3+ zeroed, per-frame expression and
  [global | jaw] pose, zero translation) for a list of identities, each
  with its own fixed light and texture codes; writes the generated
  ``{i}.png``, ``mesh_textured_{i}.png`` and ``mesh_normal_{i}.png`` (the
  display render with a constant albedo of 0.6) under
  ``<out_dir>/selected_ids_<id>/``.  Without ``--voca_seq`` a synthetic
  talking-head sequence drives it.
- ``--gt`` writes the mesh frames only.
- ``grid``: tile the identities' animations into a padded 5-column grid
  with the textured mesh in the centre cell, written as a GIF.

  python -m gif_tpu_torch.scripts.voca_animation frames --converted_ckpt trees.pkl \
      --identities 3 7 --out_dir voca_out
  python -m gif_tpu_torch.scripts.voca_animation grid --out_dir voca_out
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from gif_tpu_torch.scripts.generate_random_samples import add_common_args, load_params, setup


def load_voca_sequence(path: str | None, n_frames: int, seed: int) -> np.ndarray:
    """(T, 236) FLAME parameter sequence from a VOCA npz
    (``frame_exp_params``, ``frame_pose_params``, ``seq_shape_params``), or
    a synthetic talking-head stand-in (a smooth jaw and expression
    oscillation over ``n_frames``)."""
    if path:
        seqs = np.load(path)
        pose = np.hstack([seqs["frame_pose_params"][:, 0:3], seqs["frame_pose_params"][:, 6:9]])
        shape = np.asarray(seqs["seq_shape_params"], np.float32).copy()
        shape[3:] = 0
        t = seqs["frame_exp_params"].shape[0]
        flame = np.zeros((t, 236), np.float32)
        flame[:, 0:100] = shape[None, :100]
        flame[:, 100:150] = seqs["frame_exp_params"][:, :50]
        flame[:, 150:156] = pose
        return flame
    rng = np.random.default_rng(seed)
    t = n_frames
    flame = np.zeros((t, 236), np.float32)
    flame[:, 0:3] = rng.standard_normal(3)[None] * 0.5
    phase = np.linspace(0, 6 * np.pi, t)
    flame[:, 100] = 0.8 * np.sin(phase)  # first expression component
    flame[:, 153] = 0.12 * np.abs(np.sin(phase * 1.7))  # jaw open / close
    return flame


def assemble_grid_frame(cell_images, n_col: int = 5, pad: int = 4) -> np.ndarray:
    """Tile cells row-major with black padding."""
    from gif_tpu_torch.scripts.make_image_grid import stitch

    n_row = int(np.ceil(len(cell_images) / n_col))
    return stitch(cell_images, n_row, n_col, pad)


def write_grid(out_dir: str, fps: int) -> None:
    """The ``grid`` mode: one GIF of every identity's generated frames."""
    from PIL import Image

    from gif_tpu_torch.utils.viz import save_animation

    dirs = sorted(glob.glob(os.path.join(out_dir, "selected_ids_*")))
    if not dirs:
        raise SystemExit(f"no selected_ids_* dirs under {out_dir}")
    n_frames = len(glob.glob(os.path.join(dirs[0], "[0-9]*.png")))
    if n_frames == 0:
        raise SystemExit(f"no generated frames under {dirs[0]} — run the 'frames' mode without --gt first "
                         "(mesh_* files alone cannot grid)")
    frames = []
    for fi in range(n_frames):
        cells = [np.array(Image.open(os.path.join(d, f"{fi}.png")))[..., :3] for d in dirs]
        # The centre cell shows the driving mesh.
        mesh = os.path.join(dirs[0], f"mesh_textured_{fi}.png")
        if os.path.exists(mesh):
            cells.insert(len(cells) // 2, np.array(Image.open(mesh))[..., :3])
        frames.append(Image.fromarray(assemble_grid_frame(cells)))
    out = os.path.join(out_dir, "voca_selected_ids.gif")
    save_animation(frames, out, fps=fps)
    print(f"wrote {n_frames}-frame grid animation to {out}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("mode", choices=["frames", "grid"])
    add_common_args(p)
    p.set_defaults(run_id=29)
    p.add_argument("--voca_seq", type=str, default=None,
                   help="VOCA npz (frame_exp_params / frame_pose_params / seq_shape_params); default: a "
                        "synthetic sequence")
    p.add_argument("--identities", type=int, nargs="+", default=[0, 1, 2, 3])
    p.add_argument("--n_frames", type=int, default=60)
    p.add_argument("--gt", action="store_true", help="mesh renders only")
    p.add_argument("--out_dir", type=str, default="voca_out")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.mode == "grid":
        write_grid(args.out_dir, args.fps)
        return

    import torch

    from gif_tpu_torch import constants as cnst
    from gif_tpu_torch.eval.sampling import FlameSampler
    from gif_tpu_torch.flame.camera import position_to_given_location
    from gif_tpu_torch.render import renderer
    from gif_tpu_torch.utils import viz

    device, cfg, res = setup(args)
    flame = load_voca_sequence(args.voca_seq, args.n_frames, args.seed)
    flame = position_to_given_location(res, torch.as_tensor(flame, device=device)).cpu().numpy()

    sampler = None
    if not args.gt:
        sampler = FlameSampler(cfg, res, load_params(args, cfg), eye_center=False, device=device)

    (t0, t1), (l0, l1), (c0, c1) = cnst.DECA_IDX["tex"], cnst.DECA_IDX["lit"], cnst.DECA_IDX["cam"]
    for ident in args.identities:
        out = os.path.join(args.out_dir, f"selected_ids_{ident}")
        # Fixed light and texture codes per identity, drawn from its own seed.
        id_rng = np.random.default_rng(1000 + ident)
        flm = flame.copy()
        flm[:, t0:t1] = id_rng.standard_normal(50)[None] * 0.5
        lit = np.zeros((9, 3), np.float32)
        lit[0] = 3.0 + 0.3 * id_rng.standard_normal(3)
        flm[:, l0:l1] = lit.reshape(-1)[None]

        # The display render: a constant albedo of 0.6 (no texture lookup).
        f = torch.as_tensor(flm, device=device)
        with torch.inference_mode():
            maps = renderer.render_tex_and_normal(
                res, f[:, 0:100], f[:, 100:150], f[:, 150:156], f[:, t0:t1], f[:, l0:l1], f[:, c0:c1],
                image_size=cfg.max_size, constant_albedo=0.6,
            )
        viz.save_set_of_images(out, "mesh_textured_", maps.textured.cpu().numpy())
        viz.save_set_of_images(out, "mesh_normal_", maps.normal.cpu().numpy())

        if sampler is not None:
            indices = np.full(len(flm), ident, np.int32)
            images, _ = sampler.sample(flm, indices)
            viz.save_set_of_images(out, "", (images + 1) / 2)
        print(f"identity {ident}: {len(flm)} frames -> {out}")


if __name__ == "__main__":
    main()

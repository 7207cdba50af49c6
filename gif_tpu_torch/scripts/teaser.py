"""Teaser figure: per identity, sweep each control axis to +/-3 sigma.

For each identity, build a row of FLAME variations — shape and expression
+/-3 sigma on the top components, jaw and head yaw, albedo component 0,
the dominant light band — eye-centre the camera, render, generate, and
optionally steal the textures back into UV space (``--steal_textures``,
the texture-consistency visual).  ``--flame_npz_dir`` replaces the sweeps
with externally fit variations:

  python -m gif_tpu_torch.scripts.teaser --converted_ckpt trees.pkl --out_dir teaser_out
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from gif_tpu_torch.scripts.generate_random_samples import add_common_args, load_params, setup


def build_variation_rows(base: np.ndarray, sigma: float = 3.0):
    """(236,) base params -> list of (name, (236,) params) axis sweeps."""
    rows = [("mean", base.copy())]
    for comp in range(2):  # top shape components
        for s in (-sigma, sigma):
            v = base.copy()
            v[comp] = s
            rows.append((f"shape{comp}_{s:+.0f}", v))
    for comp in range(2):  # top expression components
        for s in (-sigma, sigma):
            v = base.copy()
            v[100 + comp] = s
            rows.append((f"exp{comp}_{s:+.0f}", v))
    for s in (-0.3, 0.3):  # jaw open / closed, head yaw
        v = base.copy()
        v[153] = abs(s) if s > 0 else 0.0
        v[150 + 1] = s
        rows.append((f"pose_{s:+.1f}", v))
    for s in (-sigma, sigma):  # albedo PCA component 0
        v = base.copy()
        v[159] = s
        rows.append((f"albedo_{s:+.0f}", v))
    for s in (-sigma, sigma):  # the highest-variance SH component
        v = base.copy()
        v[209 + 2] += s
        rows.append((f"light_{s:+.0f}", v))
    return rows


def load_flame_variation_dir(directory: str):
    """Externally fit FLAME variations from npz files under the ``exp/``,
    ``pose/`` and ``shape/`` subdirectories (each holds shape_params /
    exp_params / pose_params); the camera is appended as zeros and
    re-solved by the eye centring."""
    rows = []
    for child in ("exp", "pose", "shape"):
        for f in sorted(glob.glob(os.path.join(directory, child, "*.npz"))):
            vals = np.load(f, allow_pickle=True)
            p159 = np.hstack([
                np.asarray(vals["shape_params"]).reshape(-1)[:100],
                np.asarray(vals["exp_params"]).reshape(-1)[:50],
                np.asarray(vals["pose_params"]).reshape(-1)[:6],
                np.zeros(3),
            ]).astype(np.float32)
            rows.append((os.path.basename(f).split(".")[0] + "_" + child, p159))
    if not rows:
        raise SystemExit(f"no npz variations under {directory}")
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_common_args(p)
    p.add_argument("--n_identities", type=int, default=4)
    p.add_argument("--flame_npz_dir", type=str, default=None,
                   help="directory of shape/ exp/ pose/ subdirs of npz FLAME fit variations; "
                        "replaces the synthetic axis sweeps")
    p.add_argument("--out_dir", type=str, default="teaser_out")
    p.add_argument("--steal_textures", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    from gif_tpu_torch.eval.sampling import FlameSampler, random_flame_params
    from gif_tpu_torch.flame.camera import position_to_given_location
    from gif_tpu_torch.models.texture_space import flame_texture_space
    from gif_tpu_torch.utils import viz

    device, cfg, res = setup(args)
    # Eye centring runs HERE rather than inside the sampler, so the rows
    # carry the camera the images were generated under: the texture steal
    # projects with it.
    sampler = FlameSampler(cfg, res, load_params(args, cfg), batch_size=8, eye_center=False, device=device)
    ext_rows = load_flame_variation_dir(args.flame_npz_dir) if args.flame_npz_dir else None

    rng = np.random.default_rng(args.seed)
    for ident in range(args.n_identities):
        base = random_flame_params(rng, 1)[0]
        if ext_rows is not None:
            rows = []
            for name, p159 in ext_rows:
                v = base.copy()
                v[:159] = p159[:159]
                rows.append((name, v))
        else:
            rows = build_variation_rows(base)
        flame = torch.as_tensor(np.stack([r[1] for r in rows]), device=device)
        flame = position_to_given_location(res, flame).cpu().numpy()
        idx = np.full(len(rows), rng.integers(0, args.vocab), np.int32)
        images, conds = sampler.sample(flame, idx)
        d = os.path.join(args.out_dir, f"identity_{ident}")
        viz.save_set_of_images(d, "img_", (images + 1) / 2)
        viz.save_set_of_images(d, "cond_", (conds[..., :3] + 1) / 2)
        with open(os.path.join(d, "rows.txt"), "w") as f:
            f.write("\n".join(name for name, _ in rows))

        if args.steal_textures:
            with torch.inference_mode():
                tex, vis = flame_texture_space(
                    res, torch.as_tensor(images, device=device), torch.as_tensor(flame[:, :159], device=device)
                )
                stolen = ((tex + 1) / 2 * vis).cpu().numpy()
            viz.save_set_of_images(d, "texture_", stolen)
    print(f"wrote {args.n_identities} teaser rows to {args.out_dir}")


if __name__ == "__main__":
    main()

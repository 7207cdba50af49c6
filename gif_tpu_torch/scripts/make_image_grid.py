"""Stitch a directory of images into one grid PNG.

Glob a pattern, take the first ``n_row * n_col`` files (sorted) and tile
them row-major (the reference's make_a_large_grid_of_images.py):

  python -m gif_tpu_torch.scripts.make_image_grid --pattern 'out/mesh*.png' \
      --n_row 12 --n_col 6 --out stitched.png
"""

from __future__ import annotations

import argparse
import glob

import numpy as np


def stitch(images, n_row: int, n_col: int, pad: int = 0) -> np.ndarray:
    """Row-major grid of equally-sized HxWx3 uint8 images, ``pad`` black
    pixels between cells; unused cells stay black."""
    h, w = images[0].shape[:2]
    out = np.zeros((n_row * h + (n_row - 1) * pad, n_col * w + (n_col - 1) * pad, 3), np.uint8)
    for i, img in enumerate(images[: n_row * n_col]):
        r, c = (i // n_col) * (h + pad), (i % n_col) * (w + pad)
        out[r : r + h, c : c + w] = img[..., :3]
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pattern", required=True)
    p.add_argument("--n_row", type=int, default=12)
    p.add_argument("--n_col", type=int, default=6)
    p.add_argument("--pad", type=int, default=0)
    p.add_argument("--out", type=str, default="stitched.png")
    args = p.parse_args(argv)

    from PIL import Image

    files = sorted(glob.glob(args.pattern))
    if len(files) < args.n_row * args.n_col:
        raise SystemExit(f"need {args.n_row * args.n_col} images, found {len(files)}")
    imgs = [np.array(Image.open(f)) for f in files[: args.n_row * args.n_col]]
    Image.fromarray(stitch(imgs, args.n_row, args.n_col, args.pad)).save(args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()

"""Convert the reference's LMDB datasets into packed arrays (the port's own
copy of :mod:`gif_tpu.data.lmdb_import`).

The reference stores FFHQ frames JPEG-encoded in a multiscale LMDB keyed
``f'{res}-{idx:05d}'`` (prepare_lmdb/prepare_ffhq_multiscale_dataset.py) and
FLAME parameters in one ``.npy`` dict of 70k entries (dataset_loaders.py:
365-367).  This tool reads both and writes:

  out_dir/images.npy        (N, S, S, 3) uint8, mem-mappable
  out_dir/dataset.npz       flame_params (N, 236), bad_images, images_path

Pre-rendered DECA condition LMDBs are deliberately NOT imported: the train
step renders conditions on the device.

Uses the C ``lmdb`` package when installed, else the pure-Python read-only
parser in ``gif_tpu_torch.data.lmdb_reader`` (zero extra deps).
"""

from __future__ import annotations

import io
import os

import numpy as np


def _assemble_flame_vector(entry: dict) -> np.ndarray:
    """DECA per-image dict -> 236-d vector [shape|exp|pose|cam|tex|lit]
    (dataset_loaders.py:306-310)."""
    parts = [
        np.asarray(entry["shape"]).reshape(-1)[:100],
        np.asarray(entry["exp"]).reshape(-1)[:50],
        np.asarray(entry["pose"]).reshape(-1)[:6],
        np.asarray(entry["cam"]).reshape(-1)[:3],
        np.asarray(entry["tex"]).reshape(-1)[:50],
        np.asarray(entry["lit"]).reshape(-1)[:27],
    ]
    return np.concatenate(parts).astype(np.float32)


def import_ffhq_lmdb(
    lmdb_path: str,
    flame_params_file: str,
    out_dir: str,
    resolution: int = 256,
    bad_images_file: str | None = None,
    limit: int | None = None,
) -> str:
    from PIL import Image

    try:
        import lmdb
    except ImportError:
        # Zero-dep fallback: a pure-Python read-only parser of the LMDB
        # on-disk format — the import is a one-shot readonly scan, exactly
        # its supported scope.
        from gif_tpu_torch.data import lmdb_reader as lmdb

    os.makedirs(out_dir, exist_ok=True)
    params_raw = np.load(flame_params_file, allow_pickle=True)
    if params_raw.dtype == object and params_raw.ndim == 0:
        params_raw = params_raw.item()

    env = lmdb.open(
        lmdb_path, max_readers=32, readonly=True, lock=False, readahead=False
    )
    with env.begin(write=False) as txn:
        n = int(txn.get("length".encode("utf-8")).decode("utf-8"))
        if limit:
            n = min(n, limit)
        images = np.lib.format.open_memmap(
            os.path.join(out_dir, "images.npy"),
            mode="w+",
            dtype=np.uint8,
            shape=(n, resolution, resolution, 3),
        )
        flame = np.zeros((n, 236), np.float32)
        for i in range(n):
            key = f"{resolution}-{str(i).zfill(5)}".encode("utf-8")
            img = Image.open(io.BytesIO(txn.get(key))).convert("RGB")
            images[i] = np.asarray(img, np.uint8)
            # The reference .npy is an object array of per-image dicts; a
            # top-level dict variant keys entries by dense int or by the
            # zero-padded image stem.
            if isinstance(params_raw, dict):
                entry = params_raw.get(i, params_raw.get(str(i).zfill(5)))
                if entry is None:
                    raise KeyError(
                        f"flame-params dict has neither key {i} nor "
                        f"'{str(i).zfill(5)}'"
                    )
            else:
                entry = params_raw[i]
            flame[i] = _assemble_flame_vector(entry)
    images.flush()

    bad = np.zeros((0,), np.int64)
    if bad_images_file and os.path.exists(bad_images_file):
        bad = np.load(bad_images_file)["bad_images"].astype(np.int64)

    out = os.path.join(out_dir, "dataset.npz")
    np.savez(
        out,
        flame_params=flame,
        bad_images=bad,
        images_path=os.path.join(out_dir, "images.npy"),
    )
    return out


def import_image_dir(
    image_dir: str,
    flame_params_file: str,
    out_dir: str,
    resolution: int | tuple[int, ...] = 256,
    bad_images_file: str | None = None,
    limit: int | None = None,
) -> str:
    """Pack a raw FFHQ-style image folder directly (no LMDB stage).

    The reference pipeline is raw images -> multiscale LMDB
    (prepare_lmdb/prepare_ffhq_multiscale_dataset.py:18-75, scales 8..1024)
    -> loader; users coming from a plain image folder skip the LMDB
    entirely.  ``resolution`` may be a tuple of sizes — the multiscale
    equivalent: each size *s* gets ``images_{s}.npy`` + ``dataset_{s}.npz``
    (a single size keeps the canonical ``images.npy``/``dataset.npz``
    names), so any preset resolution can train from one import pass.
    Files are taken in sorted name order (FFHQ's zero-padded stems make
    that the dataset order the FLAME .npy is indexed by); non-target sizes
    are resized like the reference prep (PIL ANTIALIAS semantics).

    Returns the dataset path of the LAST size (the largest, when sorted).
    """
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError(f"PIL is required for importing images: {e}") from e

    sizes = (resolution,) if isinstance(resolution, int) else tuple(
        sorted(set(resolution))
    )
    if not sizes:
        raise ValueError("resolution must name at least one size")
    multi = len(sizes) > 1

    os.makedirs(out_dir, exist_ok=True)
    params_raw = np.load(flame_params_file, allow_pickle=True)
    if params_raw.dtype == object and params_raw.ndim == 0:
        params_raw = params_raw.item()

    exts = (".png", ".jpg", ".jpeg")
    names = sorted(
        f for f in os.listdir(image_dir) if f.lower().endswith(exts)
    )
    if limit:
        names = names[:limit]
    if not names:
        raise FileNotFoundError(f"no {exts} files under {image_dir}")
    n = len(names)

    def _img_name(s):
        return f"images_{s}.npy" if multi else "images.npy"

    images = {
        s: np.lib.format.open_memmap(
            os.path.join(out_dir, _img_name(s)),
            mode="w+",
            dtype=np.uint8,
            shape=(n, s, s, 3),
        )
        for s in sizes
    }
    flame = np.zeros((n, 236), np.float32)
    for i, name in enumerate(names):
        img = Image.open(os.path.join(image_dir, name)).convert("RGB")
        for s in sizes:
            scaled = (
                img if img.size == (s, s) else img.resize((s, s), Image.LANCZOS)
            )
            images[s][i] = np.asarray(scaled, np.uint8)
        if isinstance(params_raw, dict):
            stem = os.path.splitext(name)[0]
            entry = params_raw.get(i, params_raw.get(stem))
            if entry is None:
                raise KeyError(
                    f"flame-params dict has neither key {i} nor '{stem}'"
                )
        else:
            entry = params_raw[i]
        flame[i] = _assemble_flame_vector(entry)
    for arr in images.values():
        arr.flush()

    bad = np.zeros((0,), np.int64)
    if bad_images_file and os.path.exists(bad_images_file):
        bad = np.load(bad_images_file)["bad_images"].astype(np.int64)

    out = None
    for s in sizes:
        out = os.path.join(
            out_dir, f"dataset_{s}.npz" if multi else "dataset.npz"
        )
        np.savez(
            out,
            flame_params=flame,
            bad_images=bad,
            images_path=os.path.join(out_dir, _img_name(s)),
        )
    return out


def main():  # pragma: no cover
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--lmdb", help="reference multiscale LMDB")
    src.add_argument(
        "--image_dir", help="raw FFHQ-style image folder (skips the LMDB stage)"
    )
    p.add_argument("--flame_params", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument(
        "--resolution",
        default="256",
        help="target size, or a comma list (e.g. 64,128,256) for the "
        "multiscale equivalent of the reference LMDB builder "
        "(image-dir mode only)",
    )
    p.add_argument("--bad_images", default=None)
    p.add_argument("--limit", type=int, default=None)
    a = p.parse_args()
    sizes = tuple(int(s) for s in str(a.resolution).split(","))
    if a.lmdb:
        if len(sizes) > 1:
            # The reference LMDB already holds every scale keyed
            # f"{res}-{idx}"; import each requested one separately.
            raise SystemExit(
                "--lmdb mode imports one scale per call; rerun per size"
            )
        out = import_ffhq_lmdb(
            a.lmdb, a.flame_params, a.out_dir, sizes[0], a.bad_images, a.limit
        )
    else:
        out = import_image_dir(
            a.image_dir,
            a.flame_params,
            a.out_dir,
            sizes if len(sizes) > 1 else sizes[0],
            a.bad_images,
            a.limit,
        )
    print(out)


if __name__ == "__main__":
    main()

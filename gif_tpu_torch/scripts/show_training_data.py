"""Training batches next to the FLAME renders that condition them.

Pulls batches through the training input path (dataset, batch assembly,
the condition render on the device) and writes one side-by-side grid a
batch, ``batch_{b}.png``: real image | textured render | normal map per
row.  The quickest way to eyeball data / label alignment:

  python -m gif_tpu_torch.scripts.show_training_data --data data/ffhq256/dataset.npz
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from gif_tpu_torch.scripts.generate_random_samples import TINY_HELP


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--run_id", type=int, default=0)
    p.add_argument("--data", type=str, default=None)
    p.add_argument("--flame_resources", type=str, default=None)
    p.add_argument("--n_batches", type=int, default=2)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--out_dir", type=str, default="data_viz")
    p.add_argument("--tiny", action="store_true", help=TINY_HELP)
    p.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from gif_tpu_torch.data.pipeline import SyntheticFlameDataset, data_iterator, load_packed_dataset
    from gif_tpu_torch.device import resolve_device
    from gif_tpu_torch.flame.resources import load_flame_resources
    from gif_tpu_torch.train.config import TINY_OVERRIDES, get_config
    from gif_tpu_torch.train.step import render_condition_maps
    from gif_tpu_torch.utils.viz import make_grid, save_png, to_uint8

    device = resolve_device(args.device)
    tiny = TINY_OVERRIDES if args.tiny else {}
    res = load_flame_resources(args.flame_resources)
    if args.data:
        ds = load_packed_dataset(args.data)
    else:
        print("no --data; showing the synthetic dataset")
        ds = SyntheticFlameDataset(n=64, size=tiny.get("max_size", 256))
    cfg = get_config(args.run_id, embedding_vocab_size=len(ds), batch_size=args.batch, **tiny)

    it = data_iterator(ds, args.batch)
    os.makedirs(args.out_dir, exist_ok=True)
    try:
        for b in range(args.n_batches):
            batch = next(it)
            with torch.inference_mode():
                cond = render_condition_maps(res, torch.as_tensor(batch["flame"], device=device), cfg)
            cond = cond.cpu().numpy()
            row = np.concatenate(
                [batch["real_image"], cond[..., :3]] + ([cond[..., 3:6]] if cond.shape[-1] > 3 else []), axis=2
            )  # side by side per sample
            grid = make_grid(to_uint8(row), rows=args.batch, cols=1)
            save_png(os.path.join(args.out_dir, f"batch_{b}.png"), grid)
    finally:
        it.close()
    print(f"wrote {args.n_batches} grids to {args.out_dir}")


if __name__ == "__main__":
    main()

"""``python -m gif_tpu_torch.train``: the training CLI
(:mod:`gif_tpu_torch.train.cli`)."""

from gif_tpu_torch.train.cli import main

if __name__ == "__main__":
    main()

"""Training: configuration, condition rendering, losses, the train state
and the run_id-8 train step (port of ``gif_tpu.train``)."""

from gif_tpu_torch.train.config import TINY_OVERRIDES, TrainConfig, get_config

__all__ = ["TrainConfig", "get_config", "TINY_OVERRIDES"]

"""Training: configuration, condition rendering, losses, the train state
and the GAN train step of run ids 0, 3, 7, 8 and 29 (port of
``gif_tpu.train``)."""

from gif_tpu_torch.train.config import TINY_OVERRIDES, TrainConfig, get_config

__all__ = ["TrainConfig", "get_config", "TINY_OVERRIDES"]

"""The conditional StyleGAN2 generator (port of ``gif_tpu.models``)."""

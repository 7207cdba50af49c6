"""The conditional StyleGAN2 generator and discriminator (port of
``gif_tpu.models``)."""

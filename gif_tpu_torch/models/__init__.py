"""The conditional StyleGAN2 generator and discriminator, and the FLAME
texture steal (port of ``gif_tpu.models``)."""

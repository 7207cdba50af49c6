"""Image utilities and the parameter EMA (port of ``gif_tpu.utils``)."""

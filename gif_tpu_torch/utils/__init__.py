"""Image utilities, the parameter EMA and sample grids (port of
``gif_tpu.utils``)."""

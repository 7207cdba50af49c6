"""Image utilities (port of ``gif_tpu.utils``)."""

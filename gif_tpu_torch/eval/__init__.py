"""Sampling entry points (port of ``gif_tpu.eval``)."""

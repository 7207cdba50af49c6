"""Evaluation (port of ``gif_tpu.eval``): the FID InceptionV3, FID with
cached real statistics, and batched sampling from FLAME parameters."""

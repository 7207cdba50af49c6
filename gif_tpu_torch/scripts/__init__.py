"""The paper's figure, animation, study and analysis scripts, run through
the port.

Each is ``python -m gif_tpu_torch.scripts.<name>`` with the flags of its
counterpart under ``scripts/`` plus ``--device`` (CUDA unless
``--device cpu``; the host-only ``make_image_grid``, ``plot_fid`` and
``mturk_results`` take none) and, where it builds a model, ``--tiny``;
``--ckpt`` names a port training run's checkpoint directory,
``--converted_ckpt`` a trees pickle of the ``convert_checkpoint`` tools.
``FlameSampler`` renders and generates for the scripts that sample.  The
shell scripts beside them launch hours-long runs of the training CLI.
"""

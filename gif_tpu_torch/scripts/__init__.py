"""The paper's figure and animation scripts, run through the port.

Each is ``python -m gif_tpu_torch.scripts.<name>`` with the flags of its
counterpart under ``scripts/`` plus ``--device`` (CUDA unless
``--device cpu``); ``--ckpt`` names a port training run's checkpoint
directory, ``--converted_ckpt`` a trees pickle of the ``convert_checkpoint``
tools.  ``FlameSampler`` renders and generates for every one of them.
"""

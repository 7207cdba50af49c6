"""The plain reference of GIF in PyTorch: FLAME decode, the render, the
generator, the discriminator, the losses, Adam and the EMA, with no
kernel, cache or batching of the measured program, and nothing imported
from it.  The modules are frozen copies of the plain versions of the
program's arithmetic, cut to the paths the benchmark's cells run."""

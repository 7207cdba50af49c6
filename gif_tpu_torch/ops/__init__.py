"""The StyleGAN2 op set of the generator and the discriminator (port of
``gif_tpu.ops``), on NCHW-shaped maps: NCHW-contiguous in the generator,
channels-last in the discriminator (``ops.layout``).

Kernels: ``activations.fused_leaky_relu`` (kernel 3 forward, kernel 5
backward, Triton) and ``blur_cuda.blur4`` (kernel 4 and its VJP, CUDA
C++), each twice differentiable through an autograd Function.
"""

from gif_tpu_torch.ops.activations import fused_leaky_relu
from gif_tpu_torch.ops.conv import equal_conv2d, even_extended_pad, modulated_conv2d, resample_mode
from gif_tpu_torch.ops.linear import equal_linear, pixel_norm
from gif_tpu_torch.ops.stddev import minibatch_stddev
from gif_tpu_torch.ops.upfirdn import blur, upfirdn2d, upsample_2x

__all__ = [
    "fused_leaky_relu",
    "equal_conv2d",
    "modulated_conv2d",
    "even_extended_pad",
    "resample_mode",
    "equal_linear",
    "pixel_norm",
    "minibatch_stddev",
    "blur",
    "upfirdn2d",
    "upsample_2x",
]

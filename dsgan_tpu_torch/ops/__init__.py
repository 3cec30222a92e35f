"""Plain tensor ops of the port (the JAX package's ``dsgan_tpu.ops`` subset
that the serving path and the train steps run; ``fid``, ``flow``, ``resize``
and the 5-D SSIM forms are imported by module)."""

from dsgan_tpu_torch.ops.conv import (
    adaptive_avg_pool,
    adaptive_max_pool,
    avg_pool2d,
    conv2d,
    conv_transpose2d,
    max_pool2d,
    upsample_bilinear2x,
)
from dsgan_tpu_torch.ops.losses import (
    TV_DIVISOR,
    gan_loss,
    l1_loss,
    perceptual_loss,
    ssim_loss,
    tv_loss,
)
from dsgan_tpu_torch.ops.metrics import (
    mse_uint8,
    normalize_u8,
    psnr_ref,
    psnr_uint8,
    quantize_uint8,
    ssim_ref,
    ssim_uint8,
)
from dsgan_tpu_torch.ops.norm import instance_norm, instance_stats
from dsgan_tpu_torch.ops.ssim import ms_ssim, ssim

__all__ = [
    "TV_DIVISOR", "adaptive_avg_pool", "adaptive_max_pool", "avg_pool2d", "conv2d",
    "conv_transpose2d", "gan_loss", "instance_norm", "instance_stats", "l1_loss", "max_pool2d",
    "ms_ssim", "mse_uint8", "normalize_u8", "perceptual_loss", "psnr_ref", "psnr_uint8",
    "quantize_uint8", "ssim", "ssim_loss", "ssim_ref", "ssim_uint8", "tv_loss",
    "upsample_bilinear2x",
]

"""InstanceNorm (torch ``InstanceNorm2d(affine=False)`` semantics) on NCHW
tensors of any memory format.

The value conventions follow the JAX package: f32 statistics from one
pass, E[x^2] - E[x]^2 clamped at 0 (biased variance), eps 1e-5 inside
the root, ``1 / sqrt`` rather than ``rsqrt``; the apply subtracts in f32
and rounds the unit-scale result once to the input dtype. On a strip of
the spatial axis the sums of x and x^2 are summed over the row group (one
all-reduce, with its gradient) and divided by the image's H * W.
"""

import torch

from dsgan_tpu_torch.parallel import spatial


def global_moments(xf):
    """E[x] and E[x^2] over H, W of the image ``xf`` is (a strip of)."""
    rows = spatial.active()
    if rows is None:
        return xf.mean(dim=(2, 3)), xf.square().mean(dim=(2, 3))
    sums = spatial.sum_rows(torch.stack([xf.sum(dim=(2, 3)), xf.square().sum(dim=(2, 3))]), rows)
    n = xf.shape[2] * rows.size * xf.shape[3]
    return sums[0] / n, sums[1] / n


def instance_stats(x, eps=1e-5):
    """Per-(image, channel) f32 mean and 1/sigma over H, W: two (B, C) tensors."""
    mean, mean_sq = global_moments(x.float())
    var = torch.clamp(mean_sq - mean.square(), min=0.0)
    return mean, 1.0 / torch.sqrt(var + eps)


def instance_norm(x, eps=1e-5):
    """``(x - mean) * rsig`` in f32, rounded once to ``x.dtype``."""
    mean, rsig = instance_stats(x, eps)
    return ((x.float() - mean[:, :, None, None]) * rsig[:, :, None, None]).to(x.dtype)

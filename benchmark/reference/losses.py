"""The recipes' loss terms in plain PyTorch, float32.

Each term takes ``n``, the number of images of the whole batch, and returns
this slice's part of the whole batch's value: a mean over the batch is the
slice's sum over ``n`` times the per-image count, so the parts of a batch
run in slices add up to the value of the batch run whole.

Semantics (yglbgyx/DS-GAN ``pix2pix_model.py``, ``cycle_gan_model.py``):
GAN loss BCE-with-logits (pix2pix) or least squares (CycleGAN) against all
ones or zeros; L1 means; total variation summed over W and H differences,
over a fixed divisor; perceptual loss the L1 means of the four VGG taps,
summed; SSIM loss 1 - SSIM of the images mapped to [0, 1] (11-tap Gaussian
window, sigma 1.5, data range 1, the map's mean per image and channel).
"""

import math

import torch
import torch.nn.functional as F


def _per_image(t):
    return t[0].numel()


def bce_logits(pred, real, n):
    """BCE with logits against all ones (``real``) or zeros."""
    target = 1.0 if real else 0.0
    return F.binary_cross_entropy_with_logits(
        pred, torch.full_like(pred, target), reduction="sum") / (n * _per_image(pred))


def least_squares(pred, real, n):
    target = 1.0 if real else 0.0
    return (pred - target).square().sum() / (n * _per_image(pred))


def l1(a, b, n):
    return (a - b).abs().sum() / (n * _per_image(a))


def total_variation(x, divisor):
    return ((x[:, :, :, 1:] - x[:, :, :, :-1]).abs().sum()
            + (x[:, :, 1:, :] - x[:, :, :-1, :]).abs().sum()) / divisor


def perceptual(taps_fake, taps_real, n):
    return sum(l1(a, b, n) for a, b in zip(taps_fake, taps_real))


def gaussian(size=11, sigma=1.5):
    g = torch.tensor([math.exp(-((i - size // 2) ** 2) / (2 * sigma ** 2)) for i in range(size)])
    return g / g.sum()


def _filter(x, win):
    c = x.shape[1]
    k = win.to(x.device, x.dtype)
    x = F.conv2d(x, k.reshape(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    return F.conv2d(x, k.reshape(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)


def ssim_per_channel(x, y, data_range=1.0, k1=0.01, k2=0.03):
    """(N, C) means of the SSIM map over the valid window positions."""
    win = gaussian()
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    mx, my = _filter(x, win), _filter(y, win)
    vx = _filter(x * x, win) - mx * mx
    vy = _filter(y * y, win) - my * my
    vxy = _filter(x * y, win) - mx * my
    s = ((2 * mx * my + c1) * (2 * vxy + c2)) / ((mx * mx + my * my + c1) * (vx + vy + c2))
    return s.mean(dim=(2, 3))


def ssim_loss(real, fake, n):
    """1 - SSIM((real + 1) / 2, (fake + 1) / 2)."""
    s = ssim_per_channel((real + 1) / 2, (fake + 1) / 2)
    return (1.0 - s).sum() / (n * s.shape[1])

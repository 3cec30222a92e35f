"""The pix2pix composite loss terms (port of ``dsgan_tpu/ops/losses.py``).

Semantics of the reference recipe, as the JAX package pins them:
  * GAN loss: BCE-with-logits by default (the reference wires
    ``GANLoss(use_lsgan=opt.no_lsgan)`` with ``no_lsgan=False``,
    pix2pix_model.py:112-114); LSGAN (MSE) or plain BCE on request;
  * TV loss divided by 320 * 256 whatever the image size
    (pix2pix_model.py:189-191);
  * perceptual loss: L1 over the VGG16 taps relu1_2 .. relu4_3
    (pix2pix_model.py:180-186);
  * SSIM loss: 1 - ssim((real + 1) / 2, (fake + 1) / 2, data_range=1)
    (pix2pix_model.py:193-195).
Every reduction accumulates in f32. Images are NCHW. On a strip of the
spatial axis (``parallel.spatial``) each term is this rank's share of the
image's: a mean's share its mean over the row group's size, TV's the sum
of its strip's differences and of the one across its lower edge, SSIM's
the global value over the size.
"""

import torch

from dsgan_tpu_torch.ops.ssim import ssim
from dsgan_tpu_torch.parallel import spatial


def gan_loss(pred, target_is_real, mode="vanilla"):
    """GAN criterion on raw logits: ``vanilla`` BCE-with-logits (stable
    form), ``lsgan`` MSE against 0/1, ``bce`` BCE on probabilities. A list
    (multiscale D) sums the last tensor of each scale."""
    if isinstance(pred, (list, tuple)):
        if isinstance(pred[0], (list, tuple)):
            return sum(gan_loss(p[-1], target_is_real, mode) for p in pred)
        return gan_loss(pred[-1], target_is_real, mode)
    pred = pred.float()
    target = torch.full_like(pred, 1.0 if target_is_real else 0.0)
    if mode == "lsgan":
        return spatial.mean((pred - target).square())
    if mode == "vanilla":
        return spatial.mean(pred.clamp(min=0.0) - pred * target
                            + torch.log1p(torch.exp(-pred.abs())))
    if mode == "bce":
        p = pred.clamp(1e-12, 1.0 - 1e-12)
        return spatial.mean(-(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p)))
    raise ValueError(f"unknown gan loss mode: {mode}")


def l1_loss(a, b):
    return spatial.mean((a.float() - b.float()).abs())


TV_DIVISOR = 320 * 256


def tv_loss(x, divisor=TV_DIVISOR):
    """Total variation over W and H, summed, over the fixed divisor."""
    xf = x.float()
    diff_w = (xf[:, :, :, 1:] - xf[:, :, :, :-1]).abs().sum()
    rows = spatial.active()
    if rows is not None:  # the strip and the row below it (none below the image)
        n = xf.shape[2] + (0 if rows.last else 1)
        xf = spatial.halo(xf, 0, 1, rows=rows).narrow(2, 0, n)
    diff_h = (xf[:, :, 1:, :] - xf[:, :, :-1, :]).abs().sum()
    return (diff_w + diff_h) / divisor


def perceptual_loss(feats_fake, feats_real, num_taps=4):
    """Sum over the first ``num_taps`` feature levels of mean |a - b|: the
    difference in the features' dtype (so the backward through VGG stays
    in it), the mean in f32."""
    total = 0.0
    for i in range(num_taps):
        diff = (feats_fake[i] - feats_real[i].to(feats_fake[i].dtype)).abs()
        total = total + spatial.mean(diff.float())
    return total


def ssim_loss(real, fake):
    """1 - SSIM on [-1, 1] images mapped to [0, 1], data_range 1."""
    x = (real.float() + 1.0) / 2.0
    y = (fake.float() + 1.0) / 2.0
    return spatial.share(1.0 - ssim(x, y, data_range=1, size_average=True))

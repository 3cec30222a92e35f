"""SSIM and MS-SSIM on NCHW images (port of ``dsgan_tpu/ops/ssim.py::
ssim`` and ``::ms_ssim``, reference DSGAN/MS_SSIM.py:95-225): a separable
1-D window applied with VALID padding along each spatial dim, per-channel
statistics, the SSIM map averaged over space per channel.

The JAX package filters with banded matmuls (a TPU layout choice); here
the filter is a grouped convolution with the same taps, which gives the
same sums. The 5-D (video) form is not ported yet.
"""

import functools
import warnings

import numpy as np
import torch
import torch.nn.functional as F

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def gauss_window(size=11, sigma=1.5):
    """The normalized 1-D Gaussian window (MS_SSIM.py:9-23), f32 numpy."""
    coords = np.arange(size, dtype=np.float32) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return g / g.sum()


@functools.cache
def _window_on(taps, dtype, device):
    """The window ``taps`` (a tuple) as a tensor, made once per dtype and
    device and kept: a step captured in a CUDA graph reads it at every
    replay, and no host-to-device copy may run inside the capture."""
    return torch.tensor(taps, dtype=dtype, device=device)


def separable_filter_valid(x, win):
    """The 1-D window ``win`` (numpy) along H, then W, per channel, VALID.
    A dim shorter than the window is skipped with a warning, as the
    reference's gaussian_filter does (MS_SSIM.py:44-50)."""
    size, c = len(win), x.shape[1]
    w = _window_on(tuple(np.asarray(win, np.float32).tolist()), x.dtype, x.device)
    out = x
    for axis, shape in ((2, (c, 1, size, 1)), (3, (c, 1, 1, size))):
        if x.shape[axis] >= size:
            out = F.conv2d(out, w.reshape(1, 1, *shape[2:]).expand(shape), groups=c)
        else:
            warnings.warn(f"Skipping Gaussian Smoothing at spatial dim {axis - 2} for input: "
                          f"{tuple(x.shape)} and win size: {size}")
    return out


def _ssim_maps(x, y, data_range, win, k=(0.01, 0.03)):
    """(N, C) means of the SSIM map and of the CS map (MS_SSIM.py:55-92)."""
    c1, c2 = (k[0] * data_range) ** 2, (k[1] * data_range) ** 2
    mu1, mu2 = separable_filter_valid(x, win), separable_filter_valid(y, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = separable_filter_valid(x * x, win) - mu1_sq
    sigma2_sq = separable_filter_valid(y * y, win) - mu2_sq
    sigma12 = separable_filter_valid(x * y, win) - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map.mean(dim=(2, 3)), cs_map.mean(dim=(2, 3))


def _check(x, y, win_size):
    if x.shape != y.shape:
        raise ValueError(f"Input images should have the same dimensions, got {x.shape} vs {y.shape}.")
    if x.dim() != 4:
        raise ValueError(f"Input images should be 4-d tensors, but got {tuple(x.shape)}")
    if win_size % 2 != 1:
        raise ValueError("Window size should be odd.")


def ssim(x, y, data_range=255, size_average=True, win_size=11, win_sigma=1.5, k=(0.01, 0.03),
         nonnegative_ssim=False):
    """SSIM of two (N, C, H, W) batches: a scalar with ``size_average``,
    else one value per image."""
    _check(x, y, win_size)
    per_channel, _ = _ssim_maps(x, y, data_range, gauss_window(win_size, win_sigma), k)
    if nonnegative_ssim:
        per_channel = torch.relu(per_channel)
    return per_channel.mean() if size_average else per_channel.mean(dim=1)


def ms_ssim(x, y, data_range=255, size_average=True, win_size=11, win_sigma=1.5, weights=None,
            k=(0.01, 0.03)):
    """Multi-scale SSIM of two (N, C, H, W) batches (MS_SSIM.py:153-225):
    the CS means of the first levels and the SSIM mean of the last, each
    clamped at 0, raised to the level weights and multiplied; between
    levels a 2x2 average pool with ``s % 2`` padding per side that counts
    the padding, as torch's ``avg_pool2d`` in the reference."""
    _check(x, y, win_size)
    if min(x.shape[-2:]) <= (win_size - 1) * 16:
        raise ValueError("Image size should be larger than %d due to the 4 downsamplings "
                         "in ms-ssim" % ((win_size - 1) * 16))
    w = torch.as_tensor(MS_SSIM_WEIGHTS if weights is None else weights, dtype=x.dtype,
                        device=x.device)
    win = gauss_window(win_size, win_sigma)
    mcs = []
    for i in range(w.shape[0]):
        per_channel, cs = _ssim_maps(x, y, data_range, win, k)
        if i < w.shape[0] - 1:
            mcs.append(torch.relu(cs))
            pad = [s % 2 for s in x.shape[-2:]]
            x = F.avg_pool2d(x, 2, padding=pad, count_include_pad=True)
            y = F.avg_pool2d(y, 2, padding=pad, count_include_pad=True)
    levels = torch.stack(mcs + [torch.relu(per_channel)], dim=0)  # (L, N, C)
    val = torch.prod(levels ** w.reshape(-1, 1, 1), dim=0)
    return val.mean() if size_average else val.mean(dim=1)

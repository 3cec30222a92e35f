"""The uint8 pixel contract and the evaluation-protocol metrics (port of
``dsgan_tpu/ops/metrics.py``).

The reference's quality protocol (DSGAN/train.py:33-44,110-120): map
outputs from [-1, 1] to [0, 255], clip, truncate to uint8, then PSNR and
skimage's ``structural_similarity`` (7x7 uniform window, sample
covariance). ``psnr_uint8`` / ``ssim_uint8`` compute them in f32 on the
device, so a train step needs no host sync for them. The uniform-filter
SSIM with its edges cropped equals a VALID-window mean. ``psnr_ref`` /
``ssim_ref`` are the same protocol on host numpy arrays in float64, as
skimage computes it: the eval harness's per-image numbers. On a strip of
the spatial axis ``mse_uint8`` and ``ssim_uint8`` give this rank's share
of the image's value (the shares of a row group sum to it).
"""

import numpy as np
import torch

from dsgan_tpu_torch.ops.ssim import separable_filter_valid
from dsgan_tpu_torch.parallel import spatial


def normalize_u8(x):
    """Raw uint8 pixels -> [-1, 1] float32 (same ops and order as the
    training pipeline); float inputs pass through."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0 * 2.0 - 1.0
    return x


def quantize_uint8(x):
    """[-1, 1] float -> [0, 255] pixel values, still float: clip, then floor
    (``np.clip(((x + 1) / 2) * 255, 0, 255).astype(np.uint8)``)."""
    v = torch.clamp((x.float() + 1.0) / 2.0 * 255.0, 0.0, 255.0)
    return torch.floor(v)


def mse_uint8(label, result):
    """Mean squared error of quantized [0, 255] tensors, f32."""
    return spatial.mean((label.float() - result.float()).square())


def psnr_from_mse(mse, data_range=255.0):
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp(min=1e-12))


def psnr_uint8(label, result, data_range=255.0):
    """PSNR between quantized [0, 255] tensors, f32."""
    return psnr_from_mse(mse_uint8(label, result), data_range)


def ssim_uint8(label, result, data_range=255.0, win_size=7, k1=0.01, k2=0.03):
    """skimage-protocol SSIM of quantized [0, 255] NCHW tensors: uniform
    window, sample covariance (NP / (NP - 1)), the mean over channels and
    positions."""
    x, y = label.float(), result.float()
    rows = spatial.active()
    if rows is not None:  # the map rows whose window starts in this strip
        c, hg = x.shape[1], x.shape[2] * rows.size
        xy, keep = spatial.valid_rows(torch.cat([x, y], 1), win_size)
        x, y = xy.split(c, 1)
    n = win_size * win_size
    cov_norm = n / (n - 1.0)
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    win = np.full((win_size,), 1.0 / win_size, np.float32)

    def mean(v):
        return separable_filter_valid(v, win)

    ux, uy = mean(x), mean(y)
    vx = cov_norm * (mean(x * x) - ux * ux)
    vy = cov_norm * (mean(y * y) - uy * uy)
    vxy = cov_norm * (mean(x * y) - ux * uy)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    if rows is not None:
        count = s.shape[0] * s.shape[1] * (hg - (win_size - 1) if hg >= win_size else hg) \
            * s.shape[3]
        return s.narrow(2, 0, keep).sum() / count
    return s.mean()


def psnr_ref(img1, img2):
    """Reference cal_psnr (DSGAN/train.py:33-41) on host numpy arrays."""
    img1 = np.asarray(img1)
    img2 = np.asarray(img2)
    mse_norm = np.mean((img1 / 255.0 - img2 / 255.0) ** 2)
    if mse_norm < 1.0e-10:
        return 100.0
    data_range = 255 if img1.dtype == np.uint8 else 1.0
    mse = np.mean((img1.astype(np.float64) - img2.astype(np.float64)) ** 2)
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _uniform_valid_np(x, win):
    """VALID uniform filter on a 2-D float64 array via cumulative sums."""
    cs = np.pad(np.cumsum(np.cumsum(x, axis=0), axis=1), ((1, 0), (1, 0)))
    s = cs[win:, win:] - cs[:-win, win:] - cs[win:, :-win] + cs[:-win, :-win]
    return s / (win * win)


def ssim_ref(img1, img2, data_range=None, win_size=7, k1=0.01, k2=0.03):
    """Reference cal_ssim protocol (skimage ``structural_similarity``
    defaults) on host numpy arrays; HWC multichannel or HW grayscale."""
    img1 = np.asarray(img1)
    img2 = np.asarray(img2)
    if data_range is None:
        data_range = 255 if img1.dtype == np.uint8 else 1.0
    if img1.ndim == 3:
        return float(np.mean([ssim_ref(img1[..., c], img2[..., c], data_range, win_size, k1, k2)
                              for c in range(img1.shape[-1])]))
    x = img1.astype(np.float64)
    y = img2.astype(np.float64)
    n = win_size * win_size
    cov_norm = n / (n - 1.0)
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    ux, uy = _uniform_valid_np(x, win_size), _uniform_valid_np(y, win_size)
    vx = cov_norm * (_uniform_valid_np(x * x, win_size) - ux * ux)
    vy = cov_norm * (_uniform_valid_np(y * y, win_size) - uy * uy)
    vxy = cov_norm * (_uniform_valid_np(x * y, win_size) - ux * uy)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    return float(np.mean(s))

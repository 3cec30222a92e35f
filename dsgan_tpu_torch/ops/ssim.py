"""SSIM and MS-SSIM on NCHW images and NCDHW volumes (port of
``dsgan_tpu/ops/ssim.py``, reference DSGAN/MS_SSIM.py:95-311): a separable
1-D window applied with VALID padding along each spatial dim (H, W; and D
for a volume, the reference's conv3d path), per-channel statistics, the
SSIM map averaged over space per channel; ``SSIM`` / ``MS_SSIM`` are the
configured-callable forms.

The JAX package filters with banded matmuls (a TPU layout choice); here
the filter is a grouped convolution with the same taps, which gives the
same sums. On a strip of the spatial axis a rank computes the map rows
whose window starts in its strip, from the strip and the win - 1 rows
below it, and the per-channel means sum over the row group: every rank
gets the image's value.
"""

import functools
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from dsgan_tpu_torch.parallel import spatial

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
    """The 1-D window ``win`` (numpy) along each spatial dim of ``x``
    ((N, C, H, W) or (N, C, D, H, W)), per channel, VALID. A dim shorter
    than the window is skipped with a warning, as the reference's
    gaussian_filter does (MS_SSIM.py:44-50)."""
    size, c, spatial = len(win), x.shape[1], x.dim() - 2
    conv = F.conv2d if spatial == 2 else F.conv3d
    w = _window_on(tuple(np.asarray(win, np.float32).tolist()), x.dtype, x.device)
    out = x
    for axis in range(2, x.dim()):
        if x.shape[axis] >= size:
            shape = [1] * spatial
            shape[axis - 2] = size
            out = conv(out, w.reshape(1, 1, *shape).expand(c, 1, *shape), groups=c)
        else:
            warnings.warn(f"Skipping Gaussian Smoothing at spatial dim {axis - 2} for input: "
                          f"{tuple(x.shape)} and win size: {size}")
    return out


def _ssim_maps(x, y, data_range, win, k=(0.01, 0.03)):
    """(N, C) means of the SSIM map and of the CS map (MS_SSIM.py:55-92)."""
    c1, c2 = (k[0] * data_range) ** 2, (k[1] * data_range) ** 2
    rows = spatial.active()
    if rows is not None:
        return _ssim_maps_rows(x, y, win, c1, c2, rows)
    mu1, mu2 = separable_filter_valid(x, win), separable_filter_valid(y, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = separable_filter_valid(x * x, win) - mu1_sq
    sigma2_sq = separable_filter_valid(y * y, win) - mu2_sq
    sigma12 = separable_filter_valid(x * y, win) - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    dims = tuple(range(2, x.dim()))
    return ssim_map.mean(dim=dims), cs_map.mean(dim=dims)


def _ssim_maps_rows(x, y, win, c1, c2, rows):
    """``_ssim_maps`` on a strip of a 4-D batch: the map rows this rank
    owns, their sums over the row group over the image's count."""
    if x.dim() != 4:
        raise NotImplementedError("SSIM of volumes on the spatial axis")
    c, hg = x.shape[1], x.shape[2] * rows.size
    xy, keep = spatial.valid_rows(torch.cat([x, y], 1), len(win))
    x, y = xy.split(c, 1)
    mu1, mu2 = separable_filter_valid(x, win), separable_filter_valid(y, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = separable_filter_valid(x * x, win) - mu1_sq
    sigma2_sq = separable_filter_valid(y * y, win) - mu2_sq
    sigma12 = separable_filter_valid(x * y, win) - mu1_mu2
    cs_map = ((2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)).narrow(2, 0, keep)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)).narrow(2, 0, keep) * cs_map
    count = (hg - (len(win) - 1) if hg >= len(win) else hg) * cs_map.shape[3]
    sums = spatial.sum_rows(torch.stack([ssim_map.sum(dim=(2, 3)), cs_map.sum(dim=(2, 3))]), rows)
    return sums[0] / count, sums[1] / count


def _check(x, y, win_size):
    """The inputs with trailing size-1 spatial dims dropped while more than
    two remain (the reference's squeeze, MS_SSIM.py:123-125), checked."""
    if x.shape != y.shape:
        raise ValueError(f"Input images should have the same dimensions, got {x.shape} vs {y.shape}.")
    while x.dim() > 4 and x.shape[-1] == 1:
        x, y = x.squeeze(-1), y.squeeze(-1)
    if x.dim() not in (4, 5):
        raise ValueError(f"Input images should be 4-d or 5-d tensors, but got {tuple(x.shape)}")
    if win_size % 2 != 1:
        raise ValueError("Window size should be odd.")
    return x, y


def _pool(x):
    """The 2x2 (2x2x2) average pool between MS-SSIM levels: ``s % 2`` zero
    padding on each side of each spatial dim, counted in the average, as
    torch's ``avg_pool2d`` / ``avg_pool3d(count_include_pad=True)`` in the
    reference. The zeros are padded first, so that a dim of 1 (a short
    depth, four levels down) pools as the JAX package's reduce_window does,
    where torch's pool refuses an input smaller than its window."""
    pad = [p for s in reversed(x.shape[2:]) for p in (s % 2, s % 2)]
    pool = F.avg_pool2d if x.dim() == 4 else F.avg_pool3d
    return pool(F.pad(x, pad), 2)


def ssim(x, y, data_range=255, size_average=True, win_size=11, win_sigma=1.5, k=(0.01, 0.03),
         nonnegative_ssim=False):
    """SSIM of two (N, C, H, W) batches or (N, C, D, H, W) volumes: a
    scalar with ``size_average``, else one value per image."""
    x, y = _check(x, y, win_size)
    per_channel, _ = _ssim_maps(x, y, data_range, gauss_window(win_size, win_sigma), k)
    if nonnegative_ssim:
        per_channel = torch.relu(per_channel)
    return per_channel.mean() if size_average else per_channel.mean(dim=1)


def ms_ssim(x, y, data_range=255, size_average=True, win_size=11, win_sigma=1.5, weights=None,
            k=(0.01, 0.03)):
    """Multi-scale SSIM of two (N, C, H, W) batches or (N, C, D, H, W)
    volumes (MS_SSIM.py:153-225): the CS means of the first levels and the
    SSIM mean of the last, each clamped at 0, raised to the level weights
    and multiplied; between levels ``_pool``. H and W must exceed
    (win_size - 1) * 16."""
    x, y = _check(x, y, win_size)
    if spatial.active() is not None:
        raise NotImplementedError("MS-SSIM on a strip: gather the images first")
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
            x, y = _pool(x), _pool(y)
    levels = torch.stack(mcs + [torch.relu(per_channel)], dim=0)  # (L, N, C)
    val = torch.prod(levels ** w.reshape(-1, 1, 1), dim=0)
    return val.mean() if size_average else val.mean(dim=1)


class SSIM:
    """``ssim`` with its settings bound (reference SSIM module, MS_SSIM.py:
    228-269). The window is made from (win_size, win_sigma) at each call;
    ``channel`` and ``spatial_dims`` are taken for the reference's signature
    and need no buffer."""

    def __init__(self, data_range=255, size_average=True, win_size=11, win_sigma=1.5,
                 channel=3, spatial_dims=2, K=(0.01, 0.03), nonnegative_ssim=False):
        del channel, spatial_dims
        self.kw = dict(data_range=data_range, size_average=size_average, win_size=win_size,
                       win_sigma=win_sigma, k=K, nonnegative_ssim=nonnegative_ssim)

    def __call__(self, x, y):
        return ssim(x, y, **self.kw)


class MS_SSIM:
    """``ms_ssim`` with its settings bound (reference MS_SSIM module,
    MS_SSIM.py:271-311)."""

    def __init__(self, data_range=255, size_average=True, win_size=11, win_sigma=1.5,
                 channel=3, spatial_dims=2, weights=None, K=(0.01, 0.03)):
        del channel, spatial_dims
        self.kw = dict(data_range=data_range, size_average=size_average, win_size=win_size,
                       win_sigma=win_sigma, weights=weights, k=K)

    def __call__(self, x, y):
        return ms_ssim(x, y, **self.kw)

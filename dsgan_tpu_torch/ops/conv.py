"""Convolution and pooling with torch geometry, on NCHW tensors (the
generator keeps them in ``torch.channels_last`` memory order).

Weights are in torch's layouts: Conv2d OIHW ``(O, I/groups, kh, kw)``,
ConvTranspose2d IOHW ``(I, O, kh, kw)``. The JAX package keeps HWIO and
flips the transposed kernel inside its op; torch's transposed conv is the
same operator on the IOHW weight, so the values agree with no flip here.
These are plain cuDNN calls: the JAX package leaves them to XLA. On a
strip of the spatial axis (``parallel.spatial``) each runs on the rows its
output strip reads, the halo fetched from the row group, and the global
pools reduce over the group.
"""

import torch
import torch.nn.functional as F

from dsgan_tpu_torch.parallel import spatial

CL = torch.channels_last


def conv2d(x, w, b=None, *, stride=1, padding=0, groups=1):
    """Conv2d (cross-correlation, zero padding); ``groups=C`` is depthwise."""
    rows = spatial.active()
    if rows is not None and (w.shape[2] > 1 or stride != 1 or padding != 0):
        return spatial.conv2d(x, w, b, stride, padding, groups, rows)
    return F.conv2d(x, w, b, stride=stride, padding=padding, groups=groups)


def conv_transpose2d(x, w, b=None, *, stride=2, padding=1, output_padding=1):
    """ConvTranspose2d; the defaults are the generator's k3 s2 p1 op1 upsample."""
    rows = spatial.active()
    if rows is not None:
        return spatial.conv_transpose2d(x, w, b, stride, padding, output_padding, rows)
    return F.conv_transpose2d(x, w, b, stride=stride, padding=padding,
                              output_padding=output_padding)


def max_pool2d(x, window=2, stride=None, padding=0):
    stride = stride if stride is not None else window
    rows = spatial.active()
    if rows is not None:
        return spatial.max_pool2d(x, window, stride, padding, rows)
    return F.max_pool2d(x, window, stride, padding)


def avg_pool2d(x, window=2, stride=None, padding=0, count_include_pad=True):
    stride = stride if stride is not None else window
    rows = spatial.active()
    if rows is not None:
        return spatial.avg_pool2d(x, window, stride, padding, count_include_pad, rows)
    return pool_avg(x, window, stride, padding, count_include_pad)


def pool_avg(x, window, stride, padding, count_include_pad):
    """``F.avg_pool2d``; a pool whose windows overlap (stride below the
    window) runs on contiguous memory and returns ``x``'s memory format:
    on a channels_last CUDA tensor torch's backward of such a pool returns
    wrong input gradients (torch 2.11 + CUDA 12.8 on the H100: rel-L2 ~1
    against the CPU, ``tests/test_torch_cuda.py``), on a contiguous one
    the right ones."""
    if stride >= window:
        return F.avg_pool2d(x, window, stride, padding, count_include_pad=count_include_pad)
    cl = x.dim() == 4 and x.is_contiguous(memory_format=CL) and not x.is_contiguous()
    y = F.avg_pool2d(x.contiguous(), window, stride, padding, count_include_pad=count_include_pad)
    return y.contiguous(memory_format=CL) if cl else y


def upsample_bilinear2x(x):
    """Bilinear upsampling to twice the height and width
    (``align_corners=False``)."""
    rows = spatial.active()
    if rows is not None:
        return spatial.upsample_bilinear2x(x, rows)
    return F.interpolate(x, size=(2 * x.shape[2], 2 * x.shape[3]), mode="bilinear",
                         align_corners=False)


def adaptive_avg_pool(x):
    """AdaptiveAvgPool2d(1): (B, C, 1, 1) spatial mean."""
    rows = spatial.active()
    if rows is not None:
        return spatial.sum_rows(x.sum(dim=(2, 3), keepdim=True), rows) / (
            x.shape[2] * rows.size * x.shape[3])
    return x.mean(dim=(2, 3), keepdim=True)


def adaptive_max_pool(x):
    """AdaptiveMaxPool2d(1): (B, C, 1, 1) spatial max."""
    rows = spatial.active()
    if rows is not None:
        return spatial.max_rows(x, rows)
    return x.amax(dim=(2, 3), keepdim=True)

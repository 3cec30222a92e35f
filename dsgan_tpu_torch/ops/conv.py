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

import torch.nn.functional as F

from dsgan_tpu_torch.parallel import spatial


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

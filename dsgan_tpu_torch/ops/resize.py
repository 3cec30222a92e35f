"""``jax.image.resize``'s linear ("bilinear") method, as the JAX package's
FID preprocessing (``models/inception.py::prepare_images``) and optical
flow pyramid (``ops/flow.py::estimate_flow``) use it: along each resized
axis a triangle filter at half-pixel centres, widened by in / out where
the axis shrinks (antialiased), each output's weights normalized. It
equals ``F.interpolate(mode="bilinear", align_corners=False)`` only where
the axis grows. Computed as one (in, out) weight matrix per axis
(``jax/_src/image/scale.py::compute_weight_mat``, in f32 as JAX computes
it), contracted with the input in f32.
"""

import numpy as np
import torch


def resize_matrix(in_size, out_size):
    """(in_size, out_size) f32 weights of the resize along one axis: the
    triangle kernel, widened where the axis shrinks; each output's weights
    normalized; an output whose sample falls outside the input zeroed."""
    f32 = np.float32
    inv = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(x, size, dims):
    """``x`` resized to ``size`` along the axes ``dims`` (one size each);
    an axis already at its size is left as it is, as in JAX."""
    for d, n in zip(dims, size):
        m = x.shape[d]
        if m == n:
            continue
        w = torch.from_numpy(resize_matrix(m, n)).to(device=x.device, dtype=x.dtype)
        x = torch.tensordot(x, w, dims=([d], [0])).movedim(-1, d)
    return x

"""Weights-only int8 quantization for the serving artifact (port of
``dsgan_tpu/quant.py``).

"w8": every eligible weight becomes int8 with one f32 scale per output
channel, dequantized at each use inside the artifact; activations keep
their dtype. What it buys is the artifact's size, not speed: int8 payloads
in place of float ones.

The scheme is the JAX package's, value for value. A leaf is eligible when
it is a floating parameter of at least 2 dimensions and ``MIN_QUANT_SIZE``
elements (biases, norm affines and small kernels stay float; BatchNorm
running statistics are buffers, never parameters, and stay float). Its
scale is ``s_c = max|w[c]| / 127`` in f32 over each output channel c,
clamped at 1e-12, and ``q = round(w / s)`` (half to even) clipped to
[-127, 127]. The output channel is the JAX leaf's last axis: axis 0 of a
``Conv2d`` (OIHW) or ``Linear`` (out, in) weight, axis 1 of a
``ConvTranspose2d`` weight (IOHW). Dequantization is ``q.float() * s`` in
f32; the layer casts the result to its compute dtype at use, as the JAX
package casts at apply. The largest error a weight takes is ``s_c / 2``.
"""

from typing import NamedTuple

import torch
from torch import nn

#: leaves smaller than this stay float (biases, norm affines: quantizing
#: them saves next to nothing and they are the most sensitive parameters)
MIN_QUANT_SIZE = 4096


class Quantized(NamedTuple):
    q: torch.Tensor      # int8, the weight's shape
    scale: torch.Tensor  # f32, the weight's shape with 1 on every axis but the output channel's


def transposed_weights(net):
    """Names of the ``ConvTranspose2d`` weights of ``net``: their output
    channel is axis 1."""
    return {f"{name}.weight" if name else "weight" for name, m in net.named_modules()
            if isinstance(m, nn.ConvTranspose2d)}


def eligible(w, min_size=MIN_QUANT_SIZE):
    return w.is_floating_point() and w.dim() >= 2 and w.numel() >= min_size


def quantize(w, out_axis=0):
    """One weight -> ``Quantized``, per output channel along ``out_axis``."""
    wf = w.detach().float()
    axes = tuple(a for a in range(wf.dim()) if a != out_axis)
    s = torch.clamp(wf.abs().amax(dim=axes, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return Quantized(q, s)


def dequantize(leaf):
    """``Quantized`` -> the f32 weight."""
    return leaf.q.float() * leaf.scale


def quantize_params(params, min_size=MIN_QUANT_SIZE, transposed=()):
    """{name: tensor} (a module's parameters or a ``state_dict``'s) ->
    {name: ``Quantized``} for the eligible leaves, the tensor itself for
    the rest. ``transposed``: the names whose output channel is axis 1
    (``transposed_weights``)."""
    return {name: quantize(w, 1 if name in transposed else 0) if eligible(w, min_size) else w
            for name, w in params.items()}


def dequantize_params(qparams, dtype=None):
    """Inverse of ``quantize_params`` up to the rounding: the quantized
    leaves in f32 (or cast to ``dtype``), the rest as they are."""
    out = {}
    for name, leaf in qparams.items():
        if isinstance(leaf, Quantized):
            w = dequantize(leaf)
            out[name] = w if dtype is None else w.to(dtype)
        else:
            out[name] = leaf
    return out


def quant_report(qparams):
    """Bytes accounting: {quantized_leaves, float_leaves, bytes_q8,
    bytes_f32}, the payloads of the quantized leaves in each form (scales
    included in bytes_q8)."""
    n_q = n_f = b_q = b_f = 0
    for leaf in qparams.values():
        if isinstance(leaf, Quantized):
            n_q += 1
            b_q += leaf.q.numel() + leaf.scale.numel() * 4
            b_f += leaf.q.numel() * 4
        else:
            n_f += 1
    return {"quantized_leaves": n_q, "float_leaves": n_f, "bytes_q8": int(b_q),
            "bytes_f32": int(b_f)}

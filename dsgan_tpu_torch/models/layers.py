"""Shared building blocks: the GELU flavours and the shared-slope PReLU."""

import torch
import torch.nn.functional as F
from torch import nn

GELU_MODES = ("auto", "exact", "tanh")


def gelu_is_tanh(mode, dtype):
    """``auto`` is the tanh approximation for bf16 tensors and erf otherwise
    (in bf16 the two differ by at most one rounding); ``exact`` is erf
    everywhere, ``tanh`` the approximation everywhere."""
    if mode not in GELU_MODES:
        raise ValueError(f"unknown gelu mode [{mode}]")
    return mode == "tanh" or (mode == "auto" and dtype == torch.bfloat16)


def gelu(x, mode="auto"):
    return F.gelu(x, approximate="tanh" if gelu_is_tanh(mode, x.dtype) else "none")


def PReLU():
    """torch ``nn.PReLU()``: one learnable slope shared by all channels, 0.25."""
    return nn.PReLU(num_parameters=1, init=0.25)


def prelu(x, module):
    """``module`` (an ``nn.PReLU``) applied with its slope cast to x's dtype."""
    return F.prelu(x, module.weight.to(x.dtype))

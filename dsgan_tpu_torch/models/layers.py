"""Shared building blocks (port of ``dsgan_tpu/models/layers.py``): the
GELU flavours, the shared-slope PReLU, the ``--norm`` layers, and the
torch layers the zoo builds from, each computing in its input's dtype with
its weights cast at use, as the JAX package's layers do (f32 parameters,
a bf16 compute dtype). On a strip of the spatial axis
(``parallel.spatial``) the convs fetch their halo rows from the row group,
a ``Pad`` hands its rows and mode to the conv after it, which fetches
them (reflected only at the image's top and bottom), the transposed convs
and ``MaxPool2d`` run on the strip's rows (``parallel.spatial``), ``Dropout``
draws the whole image's mask and keeps its strip's rows, so that a strip
sees the mask one process would, and ``BatchNorm2d`` sums its statistics
over the ranks that hold the global batch's rows.
"""

import torch
import torch.nn.functional as F
from torch import nn

from dsgan_tpu_torch.ops.conv import max_pool2d
from dsgan_tpu_torch.parallel import spatial

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


def cast(t, dtype):
    """``t`` in ``dtype``: itself where it already is (no op to run or to
    trace), else its cast; None stays None."""
    return t if t is None or t.dtype == dtype else t.to(dtype)


def prelu(x, module):
    """``module`` (an ``nn.PReLU``) applied with its slope cast to x's dtype."""
    return F.prelu(x, cast(module.weight, x.dtype))


class PReLU(nn.PReLU):
    """torch ``nn.PReLU()``: one learnable slope shared by all channels,
    0.25, cast to the input's dtype at use."""

    def __init__(self):
        super().__init__(num_parameters=1, init=0.25)

    def forward(self, x):
        return prelu(x, self)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with its weight and bias cast to the input's dtype."""

    def forward(self, x, pad=None):
        """``pad``: on a strip, the (rows, mode) of the ``Pad`` before this
        conv, which padded W alone (``spatial.sequential``)."""
        rows = spatial.active()
        if rows is not None:
            padding, mode = (self.padding, "zero") if pad is None else (
                (pad[0], self.padding[1]), pad[1])
            return spatial.conv2d(x, cast(self.weight, x.dtype), cast(self.bias, x.dtype),
                                  self.stride, padding, self.groups, rows, mode)
        return self._conv_forward(x, cast(self.weight, x.dtype), cast(self.bias, x.dtype))


class Linear(nn.Linear):
    """``nn.Linear`` (weight (out, in)) with its weight and bias cast to the
    input's dtype."""

    def forward(self, x):
        return F.linear(x, cast(self.weight, x.dtype), cast(self.bias, x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (IOHW weight, torch geometry) with its weight
    and bias cast to the input's dtype."""

    def forward(self, x):
        rows = spatial.active()
        if rows is not None:
            return spatial.conv_transpose2d(x, cast(self.weight, x.dtype),
                                            cast(self.bias, x.dtype), self.stride, self.padding,
                                            self.output_padding, rows)
        return F.conv_transpose2d(x, cast(self.weight, x.dtype), cast(self.bias, x.dtype), self.stride,
                                  self.padding, self.output_padding, self.groups, self.dilation)


class MaxPool2d(nn.MaxPool2d):
    """``nn.MaxPool2d`` through ``ops.max_pool2d``: on a strip, whole
    windows of its rows."""

    def forward(self, x):
        return max_pool2d(x, self.kernel_size, self.stride, self.padding)


class InstanceNorm(nn.Module):
    """Parameter-free InstanceNorm with the JAX package's statistics."""

    def forward(self, x):
        from dsgan_tpu_torch.ops.norm import instance_norm

        return instance_norm(x)


class BatchNorm2d(nn.Module):
    """``--norm batch`` as the JAX package's ``Norm("batch")`` computes it
    (torch ``BatchNorm2d`` semantics): in train mode the batch statistics
    in f32, mean over (B, H, W) and the biased variance mean((x - mean)^2),
    and the running averages updated in place with momentum 0.1 and the
    variance unbiased by n / (n - 1); in eval mode the running averages.
    y = (x - mean) * rsqrt(var + 1e-5) * weight + bias in f32, rounded once
    to x's dtype. Parameters and buffers stay f32. On a data-parallel mesh
    (``set_batchnorm_mesh``) the statistics are the global batch's, as
    GSPMD gives them in JAX: the per-channel sums of x and then of
    (x - mean)^2 summed over the ranks, with their gradients, and the
    count and its unbiasing the global batch's B * H * W (``_stats``).
    Every rank then holds the same running averages, bit for bit."""

    def __init__(self, num_features, momentum=0.1, eps=1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.mesh = None
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _stats(self, xf):
        """(mean, biased variance, count) over (B, H, W), of the global batch
        on a mesh: on a strip (``spatial.active()``) the sums over every rank
        and the count the strip's times data x spatial; in a level every rank
        of a row group holds whole, over the data group alone."""
        n = xf.numel() // xf.shape[1]
        mesh = self.mesh
        if mesh is None:
            mean = xf.mean(dim=(0, 2, 3))
            return mean, (xf - mean[:, None, None]).square().mean(dim=(0, 2, 3)), n
        from dsgan_tpu_torch.parallel.comms import SumOverRanks

        if mesh.spatial == 1:
            group, ranks = mesh.group, mesh.data
        elif spatial.active() is not None:  # a strip
            group, ranks = mesh.group, mesh.data * mesh.spatial
        else:  # the whole image on every rank of the row group
            group, ranks = mesh.data_group, mesh.data
        n *= ranks

        def total(t):
            return SumOverRanks.apply(t, mesh, group) if ranks > 1 else t

        mean = total(xf.sum(dim=(0, 2, 3))) / n
        sq = (xf - mean[:, None, None]).square().sum(dim=(0, 2, 3))
        return mean, total(sq) / n, n

    def forward(self, x):
        xf = x.float()
        if self.training:
            mean, var, n = self._stats(xf)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1.0 - m) * self.running_var
                                       + m * (var * (n / max(n - 1, 1))))
        else:
            mean, var = self.running_mean, self.running_var
        y = ((xf - mean[:, None, None]) * torch.rsqrt(var + self.eps)[:, None, None]
             * self.weight.float()[:, None, None] + self.bias.float()[:, None, None])
        return y.to(x.dtype)


def Norm(kind, num_features):
    """The ``--norm`` layer: ``instance`` (parameter-free), ``batch``, ``none``."""
    if kind == "instance":
        return InstanceNorm()
    if kind == "batch":
        return BatchNorm2d(num_features)
    if kind == "none":
        return nn.Identity()
    raise NotImplementedError(f"normalization layer [{kind}] is not found")


def norm_uses_bias(kind):
    """Conv bias policy: a bias unless BatchNorm follows (reference
    networks.py:85-88)."""
    return kind != "batch"


class Dropout(nn.Module):
    """Dropout(0.5) in train mode: keep with probability 1 - p, scaled by
    1 / (1 - p), as flax's ``nn.Dropout`` does; the keep mask drawn from
    ``generator`` (``set_dropout_generator``; the global one while none is
    set). The identity in eval mode."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        rows = spatial.active()
        if rows is None:
            mask = torch.rand(x.shape, generator=self.generator, device=x.device) < keep
        else:
            b, c, h, w = x.shape
            mask = (torch.rand((b, c, h * rows.size, w), generator=self.generator,
                               device=x.device) < keep).narrow(2, rows.index * h, h)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def set_batchnorm_mesh(net, mesh):
    """Take every ``BatchNorm2d`` of ``net``'s statistics over ``mesh``'s
    global batch (None: this rank's batch); returns how many."""
    n = 0
    for m in net.modules():
        if isinstance(m, BatchNorm2d):
            m.mesh = mesh
            n += 1
    return n


def set_dropout_generator(net, generator):
    """Draw every ``Dropout`` of ``net`` from ``generator``; returns how many."""
    n = 0
    for m in net.modules():
        if isinstance(m, Dropout):
            m.generator = generator
            n += 1
    return n


def _sides(t, p, mode, dim):
    """``t`` padded by ``p`` along ``dim`` on both sides."""
    if mode not in ("reflect", "replicate"):
        raise NotImplementedError(f"padding [{mode}] is not implemented")
    n = t.shape[dim]
    if mode == "reflect":
        lo, hi = t.narrow(dim, 1, p).flip(dim), t.narrow(dim, n - 1 - p, p).flip(dim)
    else:
        size = list(t.shape)
        size[dim] = p
        lo, hi = t.narrow(dim, 0, 1).expand(size), t.narrow(dim, n - 1, 1).expand(size)
    return torch.cat([lo, t, hi], dim)


def pad2d(x, p, mode="reflect"):
    """``ReflectionPad2d`` (``reflect``) or ``ReplicationPad2d`` (``replicate``)
    of W, then of H, built from slices, flips and a concat: the same values
    as ``F.pad``, but a backward without atomic adds. ``F.pad``'s reflect and
    replicate backward on CUDA adds the border's gradients atomically, in an
    order that changes from run to run, so a train step would not repeat
    bit for bit. A strip has no rows of its own to pad H with: there the
    ``Pad`` and the conv after it run through ``spatial.sequential``, which
    hands the conv the pad's rows and mode to fetch."""
    if spatial.active() is not None:
        raise ValueError("pad2d on a strip: run the Pad and its conv through spatial.sequential")
    return _sides(_sides(x, p, mode, 3), p, mode, 2)


class Pad(nn.Module):
    """A padding layer of the reference's Sequentials (no parameters)."""

    def __init__(self, p, mode="reflect"):
        super().__init__()
        self.p, self.mode = p, mode

    def forward(self, x):
        return pad2d(x, self.p, self.mode)

    def pad_w(self, x):
        """W alone padded; on a strip the conv after this pad fetches the
        rows (``spatial.sequential``)."""
        return _sides(x, self.p, self.mode, 3)

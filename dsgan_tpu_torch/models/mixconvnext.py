"""MixConvNeXtML, the DS-GAN dual-stream generator.

Port of ``dsgan_tpu/models/mixconvnext.py`` (reference
DSGAN/models/model/MixConvNeXtML.py). Tensors are NCHW in
``torch.channels_last`` memory order, so cuDNN's convolutions and the
block-core kernels share one layout with no permute copies. Module names
follow the reference's torch ``state_dict`` keys (``c1.pwconv1.weight``,
``down64.to2.1.weight``, ``u1.model.0.weight``,
``local.upc1.1.attn.relu1.weight``), which ``utils.convert`` maps to and
from the JAX package's parameter tree.

Streams:
  * Global: ConvNeXt U-Net, encoder 64 -> 1024 channels over full to 1/16
    resolution, with dense cross-scale projections of every encoder level
    summed into each deeper decoder input.
  * Local: OriginMLKA, a mini U-Net of multi-kernel (3/5/7/9) depthwise
    blocks with CBAM channel attention.
  * Fusion: a 3x3 conv over (global + local). The output is unbounded:
    the reference has no final tanh.

Every ConvNeXt block's core after its depthwise conv runs
``kernels.block_core``: K1 forward and K2 backward at c1-c5, K3 forward
and K4 backward (the two-input form, reading the decoder's (upsampled,
skip) pair unconcatenated) at uc1-uc4. A forward that autograd does not
record (serving, eval, an exported graph) reaches K1 / K3 through the
registered ops ``dsgan::block_core`` / ``dsgan::block_core2``. On a CPU
tensor the same calls run their plain PyTorch versions.

``remat`` (``--remat``) rematerializes every ConvNeXt block in training,
as the JAX package's ``nn.remat`` does: ``True`` keeps only each block's
inputs and re-runs its depthwise conv, statistics and K1 / K3 in the
backward (``torch.utils.checkpoint``), ``"dots"`` keeps the outputs of
its convolutions and matrix products and recomputes the rest (JAX's
``dots_saveable``: ``_DOTS``). A forward that autograd does not record
rematerializes nothing.

Precision follows the JAX package (``models/layers.py``): every layer
computes in its input's dtype and casts its weights to it at use, so a
training build keeps f32 parameters (Adam updates them in f32) and
computes in bf16, while a serving build that stores bf16 parameters
casts nothing. ``compute_dtype`` (default: the parameters' dtype) is the
dtype the input is cast to.
"""

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

from dsgan_tpu_torch import ops
from dsgan_tpu_torch.kernels.block_core import block_core2_in, block_core_in, pack_weights
from dsgan_tpu_torch.models.layers import PReLU, cast, gelu, gelu_is_tanh, prelu
from dsgan_tpu_torch.parallel import spatial

CL = torch.channels_last
REMAT = (False, True, "dots")
# the ops whose outputs ``remat="dots"`` keeps: convolutions and matrix
# products, as ``jax.checkpoint_policies.dots_saveable`` keeps
# ``conv_general_dilated`` and ``dot_general``; on the card K1 / K3 are no
# such op and re-run
_DOTS = {torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.bmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return checkpoint.CheckpointPolicy.MUST_SAVE
    return checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _w(t, x):
    """A weight cast to the dtype ``x`` computes in (itself if it is already)."""
    return cast(t, x.dtype)


class ChannelAttention(nn.Module):
    """CBAM channel gate (reference CA, MixConvNeXtML.py:5-22)."""

    def __init__(self, dim, ratio=8):
        super().__init__()
        self.fc1 = nn.Conv2d(dim, dim // ratio, 1, bias=False)
        self.fc2 = nn.Conv2d(dim // ratio, dim, 1, bias=False)
        self.relu1 = PReLU()

    def forward(self, x):
        def mlp(v):
            return ops.conv2d(prelu(ops.conv2d(v, _w(self.fc1.weight, v)), self.relu1),
                              _w(self.fc2.weight, v))

        return torch.sigmoid(mlp(ops.adaptive_avg_pool(x)) + mlp(ops.adaptive_max_pool(x)))


class ConvNeXtBlock(nn.Module):
    """Reference Block (MixConvNeXtML.py:203-243): 1x1 shortcut +
    [dw7x7 -> IN -> Linear(4d) -> GELU -> Linear(plans)].

    ``forward(x, x2)`` is the block on ``concat(x, x2)`` (same parameters):
    the depthwise conv runs per part on the sliced kernel, and K3 takes
    the parts unconcatenated. ``remat``: see the module's docstring."""

    def __init__(self, dim, plans, gelu_mode="auto", remat=False):
        super().__init__()
        if remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, not {remat!r}")
        self.gelu_mode = gelu_mode
        self.remat = remat
        self.shortcut = nn.Conv2d(dim, plans, 1, bias=False)
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, plans)
        self._pack_key = None
        self._pack = None

    def _weights(self, dtype):
        """(w1, b1, w2, b2, ws) in the JAX orientation, cast to ``dtype``:
        differentiable, so the kernels' weight gradients reach the
        parameters."""
        return tuple(cast(t, dtype) for t in (
            self.pwconv1.weight.t(), self.pwconv1.bias, self.pwconv2.weight.t(),
            self.pwconv2.bias, self.shortcut.weight[:, :, 0, 0].t()))

    def _packed(self, x, c1):
        """Kernel-layout weights for a CUDA input, packed outside autograd
        and kept while the parameters stay put (an optimizer step bumps
        their version). None where no pack may be kept: on the CPU, while
        ``torch.export`` traces (fake tensors have no address), and where the
        weights are not this module's parameters (an int8 serving module
        hands in dequantized tensors made anew at each call) or are inference
        tensors, which keep no version; the block core then packs them with
        plain, traceable ops."""
        params = (self.pwconv1.weight, self.pwconv1.bias, self.pwconv2.weight,
                  self.pwconv2.bias, self.shortcut.weight)
        if (not x.is_cuda or torch.compiler.is_compiling()
                or not all(isinstance(p, nn.Parameter) and not p.is_inference() for p in params)):
            return None
        dtype = x.dtype
        key = (dtype, c1) + tuple((p.data_ptr(), p._version) for p in params)
        if key != self._pack_key:
            with torch.no_grad():
                self._pack = pack_weights(*self._weights(dtype), dtype, c1=c1)
            self._pack_key = key
        return self._pack

    def forward(self, x, x2=None):
        """With ``remat`` where autograd records: the block under
        non-reentrant checkpointing, recomputed in the split context
        (``parallel.spatial``) it first ran in, so that a strip's recompute
        repeats its halo exchanges and its statistics' sums in the order
        every rank of the row group runs them. The block draws no random
        numbers: no RNG state is kept (reading the card's while a CUDA
        graph captures the step fails)."""
        if not (self.remat and torch.is_grad_enabled()):
            return self._forward(x, x2)
        context_fn = checkpoint.noop_context_fn
        if self.remat == "dots":
            context_fn = functools.partial(checkpoint.create_selective_checkpoint_contexts,
                                           _dots_policy)
        return checkpoint.checkpoint(self._recompute, spatial.context(), x, x2,
                                     use_reentrant=False, preserve_rng_state=False,
                                     context_fn=context_fn)

    def _recompute(self, ctx, x, x2):
        with spatial.entered(ctx):
            return self._forward(x, x2)

    def _forward(self, x, x2=None):
        x = x.contiguous(memory_format=CL)
        c1 = x.shape[1]
        gelu_flavour = "tanh" if gelu_is_tanh(self.gelu_mode, x.dtype) else "erf"
        wd, bd = _w(self.dwconv.weight, x), _w(self.dwconv.bias, x)
        weights = self._weights(x.dtype)
        packed = self._packed(x, c1)
        if x2 is None:
            h = ops.conv2d(x, wd, bd, padding=3, groups=c1).contiguous(memory_format=CL)
            return block_core_in(h, x, *weights, gelu=gelu_flavour, packed=packed)
        x2 = x2.contiguous(memory_format=CL)
        c2 = x2.shape[1]
        h = ops.conv2d(x, wd[:c1], bd[:c1], padding=3, groups=c1).contiguous(memory_format=CL)
        h2 = ops.conv2d(x2, wd[c1:], bd[c1:], padding=3, groups=c2).contiguous(memory_format=CL)
        return block_core2_in(h, h2, x, x2, *weights, gelu=gelu_flavour, packed=packed)


class UpBlock(nn.Module):
    """Reference upSample (MixConvNeXtML.py:48-66): ConvT(3, 2, 1, 1) + IN +
    GELU, then the encoder skip: concatenated, or handed on as a pair
    (``split=True``) to a two-input ConvNeXtBlock."""

    def __init__(self, cin, features, split=False, gelu_mode="auto"):
        super().__init__()
        self.split = split
        self.gelu_mode = gelu_mode
        self.model = nn.Sequential(nn.ConvTranspose2d(cin, features, 3, 2, 1, 1))

    def core(self, x):
        """The upsample alone: ConvT + IN + GELU."""
        deconv = self.model[0]
        h = ops.conv_transpose2d(x, _w(deconv.weight, x), _w(deconv.bias, x))
        return gelu(ops.instance_norm(h), self.gelu_mode)

    def forward(self, x, skip):
        h = self.core(x)
        if self.split:
            return h, skip
        return torch.cat([h, skip], dim=1)


class DownProject(nn.Sequential):
    """One cross-scale projection (MixConvNeXtML.py:328-426): maxpool(scale)
    -> 1x1 conv (no bias) -> IN -> GELU. ``forward`` takes the input already
    pooled: the generator shares one cascaded pool pyramid per encoder
    level. Index 0 is the pool, so the conv's key is ``<name>.1.weight``."""

    def __init__(self, cin, cout, scale, gelu_mode="auto"):
        super().__init__(nn.MaxPool2d(scale), nn.Conv2d(cin, cout, 1, bias=False))
        self.gelu_mode = gelu_mode

    def forward(self, pooled):
        return gelu(ops.instance_norm(ops.conv2d(pooled, _w(self[1].weight, pooled))),
                    self.gelu_mode)


def _pool_pyramid(x, max_scale, level=0, lv=None):
    """{s: max_pool2d(x, s)} for s = 1, 2, 4, .. max_scale, each level pooled
    from the one before: disjoint-window maxima compose exactly. ``lv``:
    the generator's levels on a strip (``parallel.spatial.Levels``), ``x``
    at its ``level``."""
    pyr = {1: x}
    s = 1
    while s < max_scale:
        pyr[2 * s] = ops.max_pool2d(pyr[s], 2) if lv is None else lv.pool(pyr[s], level)
        s *= 2
        level += 1
    return pyr


class MidMLKA(nn.Module):
    """Reference MidMLKA (MixConvNeXtML.py:76-117): channel-split into 4
    groups -> depthwise k3/5/7/9 -> concat -> 1x1 -> channel-attention gate
    -> IN -> + input -> GELU. The four group convs run as one 9x9 depthwise
    conv whose per-channel kernel is the group's, zero-padded: the same
    sums."""

    def __init__(self, dim, gelu_mode="auto"):
        super().__init__()
        q = dim // 4
        self.gelu_mode = gelu_mode
        self.X3 = nn.Conv2d(q, q, 3, padding=1, groups=q)
        self.X5 = nn.Conv2d(q, q, 5, padding=2, groups=q)
        self.X7 = nn.Conv2d(q, q, 7, padding=3, groups=q)
        self.X9 = nn.Conv2d(q, q, 9, padding=4, groups=q)
        self.conv = nn.Conv2d(dim, dim, 1)
        self.attn = ChannelAttention(dim)

    def forward(self, x):
        bank = (self.X3, self.X5, self.X7, self.X9)
        wk = torch.cat([F.pad(m.weight, [(9 - m.kernel_size[0]) // 2] * 4) for m in bank])
        bk = torch.cat([m.bias for m in bank])
        out = ops.conv2d(x, _w(wk, x), _w(bk, x), padding=4, groups=x.shape[1])
        out = ops.conv2d(out, _w(self.conv.weight, x), _w(self.conv.bias, x))
        gate = self.attn(out)
        return gelu(ops.instance_norm(out * gate) + x, self.gelu_mode)


class OriginMLKA(nn.Module):
    """The local stream (reference OriginMLKA, MixConvNeXtML.py:119-189)."""

    def __init__(self, gelu_mode="auto"):
        super().__init__()
        g = gelu_mode
        self.gelu_mode = g
        self.to32 = nn.Conv2d(3, 32, 1, bias=False)
        self.mid32 = MidMLKA(32, g)
        self.to64 = nn.Conv2d(32, 64, 1, bias=False)
        self.mid64 = MidMLKA(64, g)
        self.to128 = nn.Conv2d(64, 128, 1, bias=False)
        self.mid128 = MidMLKA(128, g)
        self.to256 = nn.Conv2d(128, 256, 1, bias=False)
        self.mid256 = MidMLKA(256, g)
        self.up1 = UpBlock(256, 128, gelu_mode=g)
        self.upc1 = nn.Sequential(nn.Conv2d(256, 128, 1, bias=False), MidMLKA(128, g))
        self.up2 = UpBlock(128, 64, gelu_mode=g)
        self.upc2 = MidMLKA(128, g)
        self.up3 = UpBlock(128, 64, gelu_mode=g)
        self.upc3 = MidMLKA(128, g)
        self.up4 = nn.Sequential(nn.ConvTranspose2d(128, 64, 3, 2, 1, 1))
        self.shortcut = nn.Sequential(nn.Conv2d(3, 64, 1, bias=False))

    def forward(self, x):
        lv = spatial.Levels(x.shape[2], 5)  # levels 0 (x) .. 4 (d8)
        d1 = ops.conv2d(x, _w(self.to32.weight, x))
        with lv.at(1):
            d2 = self.mid32(lv.pool(d1, 0))
            d3 = ops.conv2d(d2, _w(self.to64.weight, x))
        with lv.at(2):
            d4 = self.mid64(lv.pool(d3, 1))
            d5 = ops.conv2d(d4, _w(self.to128.weight, x))
        with lv.at(3):
            d6 = self.mid128(lv.pool(d5, 2))
            d7 = ops.conv2d(d6, _w(self.to256.weight, x))
        with lv.at(4):
            d8 = self.mid256(lv.pool(d7, 3))

        with lv.at(3):
            u1 = ops.conv2d(torch.cat([lv.up(self.up1.core, d8, 4), d6], 1),
                            _w(self.upc1[0].weight, x))
            u1 = self.upc1[1](u1)
        with lv.at(2):
            u2 = self.upc2(torch.cat([lv.up(self.up2.core, u1, 3), d4], 1))
        with lv.at(1):
            u3 = self.upc3(torch.cat([lv.up(self.up3.core, u2, 2), d3], 1))
        up4 = self.up4[0]
        u4 = lv.up(lambda t: ops.instance_norm(ops.conv_transpose2d(t, _w(up4.weight, x),
                                                                    _w(up4.bias, x))), u3, 1)
        sc = ops.instance_norm(ops.conv2d(x, _w(self.shortcut[0].weight, x)))
        return gelu(u4 + sc, self.gelu_mode)


# (scale, out channels) of each encoder level's cross-scale projections
_SKIPS = {
    "down64": (64, ((2, 128), (4, 256), (8, 512), (16, 1024))),
    "down128": (128, ((2, 256), (4, 512), (8, 1024))),
    "down256": (256, ((2, 512), (4, 1024))),
    "down512": (512, ((2, 1024),)),
}


class MixConvNeXtML(nn.Module):
    """The full dual-stream generator (reference MixConvNeXtML.py:428-494).

    ``forward``: (B, 3, H, W) in [-1, 1], H and W divisible by 16 -> (B, 3,
    H, W), unbounded, in the input's dtype; computes in ``compute_dtype``
    (None: the parameters' dtype); ``remat`` rematerializes the ConvNeXt
    blocks c1-c5 and uc1-uc4 in training (``REMAT``)."""

    def __init__(self, gelu_mode="auto", compute_dtype=None, remat=False):
        super().__init__()
        g = gelu_mode
        self.compute_dtype = compute_dtype
        self.remat = remat
        widths = (3, 64, 128, 256, 512, 1024)
        for i in range(1, 6):
            self.add_module(f"c{i}", ConvNeXtBlock(widths[i - 1], widths[i], g, remat))
        for name, (cin, specs) in _SKIPS.items():
            self.add_module(name, nn.ModuleDict({
                f"to{cout // 64}": DownProject(cin, cout, s, g) for s, cout in specs
            }))
        for i, (cin, feat) in enumerate(((1024, 512), (512, 256), (256, 128), (128, 64)), 1):
            self.add_module(f"u{i}", UpBlock(cin, feat, split=True, gelu_mode=g))
            self.add_module(f"uc{i}", ConvNeXtBlock(2 * feat, feat, g, remat))
        self.local = OriginMLKA(g)
        self.res = nn.Conv2d(64, 3, 3, padding=1)

    def _skips(self, name, r, level, lv):
        """The level's projections and its stride-2 pool, from one pyramid
        (``r`` at ``level`` of the levels ``lv``)."""
        specs = _SKIPS[name][1]
        pyr = _pool_pyramid(r, specs[-1][0], level, lv)
        mods = getattr(self, name)
        out = []
        for j, (s, cout) in enumerate(specs, 1):
            with lv.at(level + j):
                out.append(mods[f"to{cout // 64}"](pyr[s]))
        return out, pyr[2]

    def forward(self, x):
        """On a strip of the spatial axis, a level whose height does not
        split over the row group (``spatial.Levels``) runs whole on every
        rank: gathered where it is pooled into, its rows taken back where it
        is upsampled out of."""
        in_dtype = x.dtype
        x = x.to(self.compute_dtype or self.res.weight.dtype).contiguous(memory_format=CL)
        lv = spatial.Levels(x.shape[2], 5)

        r1 = self.c1(x)
        d64, p1 = self._skips("down64", r1, 0, lv)
        with lv.at(1):
            r2 = self.c2(p1)
        d128, p2 = self._skips("down128", r2, 1, lv)
        with lv.at(2):
            r3 = self.c3(p2)
        d256, p3 = self._skips("down256", r3, 2, lv)
        with lv.at(3):
            r4 = self.c4(p3)
        d512, p4 = self._skips("down512", r4, 3, lv)
        with lv.at(4):
            r5 = self.c5(p4)
            a1 = r5 + d64[3] + d128[2] + d256[1] + d512[0]

        with lv.at(3):
            o1 = self.uc1(lv.up(self.u1.core, a1, 4), r4)
            a2 = o1 + d64[2] + d128[1] + d256[0]
        with lv.at(2):
            o2 = self.uc2(lv.up(self.u2.core, a2, 3), r3)
            a3 = o2 + d64[1] + d128[0]
        with lv.at(1):
            o3 = self.uc3(lv.up(self.u3.core, a3, 2), r2)
            a4 = o3 + d64[0]
        o4 = self.uc4(lv.up(self.u4.core, a4, 1), r1)

        loc = self.local(x)
        out = ops.conv2d(o4 + loc, _w(self.res.weight, x), _w(self.res.bias, x), padding=1)
        return out.to(in_dtype)

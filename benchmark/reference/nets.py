"""Plain PyTorch networks of the DS-GAN recipes, written from the published
models and kept apart from the program under test.

- ``MixConvNeXtML``: the dual-stream generator of yglbgyx/DS-GAN
  (``DSGAN/models/model/MixConvNeXtML.py``): a ConvNeXt U-Net (widths 64 ->
  1024, dense cross-scale projections into the decoder) beside the OriginMLKA
  local stream (multi-kernel depthwise blocks with CBAM channel gates), fused
  by one 3x3 conv. Every ConvNeXt block is computed plainly: depthwise 7x7,
  InstanceNorm, Linear(4C), exact GELU, Linear(P), plus a 1x1 shortcut of the
  block input.
- ``PatchGAN``: the 70x70 PatchGAN of pix2pix (``networks.py``
  ``NLayerDiscriminator``, n_layers 3, InstanceNorm, LeakyReLU 0.2).
- ``Vgg16Taps``: torchvision's VGG16 ``features`` up to relu4_3, returning
  relu1_2, relu2_2, relu3_3 and relu4_3.

Parameter names follow the published modules' ``state_dict`` keys, so the
harness loads one set of seeded weights into these networks and into the
program's. Everything computes in float32 (the caller turns TF32 off).

``precision``: every convolution and linear layer computes its products in
``Net.precision``. The reference keeps ``Exact`` (float32); the
correctness control sets ``Float8``, a precision below the recipes'
bfloat16.
"""

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0  # the largest finite float8_e4m3fn: values and weights
E5M2_MAX = 57344.0  # the largest finite float8_e5m2: gradients


def _scaled_round(t, dtype, largest):
    """``t`` through ``dtype`` with one per-tensor scale (its largest
    magnitude onto the format's largest finite value), back in ``t``'s
    dtype."""
    scale = largest / t.abs().amax().clamp(min=1e-30)
    return (t * scale).to(dtype).to(t.dtype) / scale


class Exact:
    """Every layer computes in float32: the reference."""

    @staticmethod
    def operand(t):
        return t

    @staticmethod
    def result(t):
        return t


class _RoundGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _scaled_round(g, torch.float8_e5m2, E5M2_MAX)


class Float8:
    """Every layer's products in 8-bit floats, as fp8 training computes
    them with per-tensor scaling: the forward operands (inputs, weights)
    rounded through e4m3, the output's gradient through e5m2 before the
    backward's products read it; the rest of the arithmetic in float32."""

    @staticmethod
    def operand(t):
        q = _scaled_round(t.detach(), torch.float8_e4m3fn, E4M3_MAX)
        return t + (q - t).detach()

    @staticmethod
    def result(t):
        return _RoundGradient.apply(t)


class Net(nn.Module):
    """A module whose convolutions and linears compute in ``precision``."""

    precision = Exact

    def _conv(self, x, w, b=None, **kw):
        p = self.precision
        return p.result(F.conv2d(p.operand(x), p.operand(w), b, **kw))

    def _convt(self, x, w, b=None):
        p = self.precision
        return p.result(F.conv_transpose2d(p.operand(x), p.operand(w), b, stride=2, padding=1,
                                           output_padding=1))

    def _linear(self, x, w, b=None):
        p = self.precision
        return p.result(F.linear(p.operand(x), p.operand(w), b))


def set_precision(net, precision):
    """Give every ``Net`` inside ``net`` the ``precision``."""
    for m in net.modules():
        if isinstance(m, Net):
            m.precision = precision
    return net


def instance_norm(x, eps=1e-5):
    """InstanceNorm2d(affine=False): biased variance over H, W."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps)


gelu = F.gelu  # exact (erf) GELU, nn.GELU()'s default


class Block(Net):
    """ConvNeXt block (MixConvNeXtML.py ``Block``): shortcut(x) +
    pwconv2(gelu(pwconv1(IN(dwconv(x)))))."""

    def __init__(self, dim, plans):
        super().__init__()
        self.shortcut = nn.Conv2d(dim, plans, 1, bias=False)
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, plans)

    def forward(self, x):
        h = self._conv(x, self.dwconv.weight, self.dwconv.bias, padding=3, groups=x.shape[1])
        h = instance_norm(h).permute(0, 2, 3, 1)
        h = self._linear(gelu(self._linear(h, self.pwconv1.weight, self.pwconv1.bias)),
                        self.pwconv2.weight, self.pwconv2.bias)
        return h.permute(0, 3, 1, 2) + self._conv(x, self.shortcut.weight)


class Up(Net):
    """upSample: ConvTranspose2d(3, 2, 1, 1) -> IN -> GELU."""

    def __init__(self, cin, cout):
        super().__init__()
        self.model = nn.Sequential(nn.ConvTranspose2d(cin, cout, 3, 2, 1, 1))

    def forward(self, x):
        return gelu(instance_norm(self._convt(x, self.model[0].weight, self.model[0].bias)))


class Project(Net):
    """A cross-scale projection: maxpool(scale) -> 1x1 conv -> IN -> GELU
    (index 0 is the pool, so the conv is ``<name>.1``)."""

    def __init__(self, cin, cout, scale):
        super().__init__()
        self.scale = scale
        self.add_module("0", nn.MaxPool2d(scale))
        self.add_module("1", nn.Conv2d(cin, cout, 1, bias=False))

    def forward(self, x):
        w = self._modules["1"].weight
        return gelu(instance_norm(self._conv(F.max_pool2d(x, self.scale), w)))


class ChannelGate(Net):
    """CBAM channel attention: sigmoid(mlp(avgpool) + mlp(maxpool)), the MLP
    1x1 convs without bias around one shared PReLU slope."""

    def __init__(self, dim, ratio=8):
        super().__init__()
        self.fc1 = nn.Conv2d(dim, dim // ratio, 1, bias=False)
        self.fc2 = nn.Conv2d(dim // ratio, dim, 1, bias=False)
        self.relu1 = nn.PReLU()

    def forward(self, x):
        def mlp(v):
            return self._conv(F.prelu(self._conv(v, self.fc1.weight), self.relu1.weight),
                             self.fc2.weight)

        return torch.sigmoid(mlp(x.mean(dim=(2, 3), keepdim=True))
                             + mlp(x.amax(dim=(2, 3), keepdim=True)))


class MidMLKA(Net):
    """Channels in four groups through depthwise 3/5/7/9 convs -> concat ->
    1x1 conv -> channel gate -> IN -> + input -> GELU."""

    def __init__(self, dim):
        super().__init__()
        q = dim // 4
        self.X3 = nn.Conv2d(q, q, 3, padding=1, groups=q)
        self.X5 = nn.Conv2d(q, q, 5, padding=2, groups=q)
        self.X7 = nn.Conv2d(q, q, 7, padding=3, groups=q)
        self.X9 = nn.Conv2d(q, q, 9, padding=4, groups=q)
        self.conv = nn.Conv2d(dim, dim, 1)
        self.attn = ChannelGate(dim)

    def forward(self, x):
        parts = torch.chunk(x, 4, dim=1)
        out = torch.cat([self._conv(p, m.weight, m.bias, padding=m.padding, groups=p.shape[1])
                         for p, m in zip(parts, (self.X3, self.X5, self.X7, self.X9))], 1)
        out = self._conv(out, self.conv.weight, self.conv.bias)
        return gelu(instance_norm(out * self.attn(out)) + x)


class LocalStream(Net):
    """OriginMLKA: a four-level mini U-Net of MidMLKA blocks, its output
    GELU(IN(up4) + IN(shortcut(x)))."""

    def __init__(self):
        super().__init__()
        self.to32 = nn.Conv2d(3, 32, 1, bias=False)
        self.mid32 = MidMLKA(32)
        self.to64 = nn.Conv2d(32, 64, 1, bias=False)
        self.mid64 = MidMLKA(64)
        self.to128 = nn.Conv2d(64, 128, 1, bias=False)
        self.mid128 = MidMLKA(128)
        self.to256 = nn.Conv2d(128, 256, 1, bias=False)
        self.mid256 = MidMLKA(256)
        self.up1 = Up(256, 128)
        self.upc1 = nn.Sequential(nn.Conv2d(256, 128, 1, bias=False), MidMLKA(128))
        self.up2 = Up(128, 64)
        self.upc2 = MidMLKA(128)
        self.up3 = Up(128, 64)
        self.upc3 = MidMLKA(128)
        self.up4 = nn.Sequential(nn.ConvTranspose2d(128, 64, 3, 2, 1, 1))
        self.shortcut = nn.Sequential(nn.Conv2d(3, 64, 1, bias=False))

    def forward(self, x):
        pool = F.max_pool2d
        d1 = self._conv(x, self.to32.weight)
        d2 = self.mid32(pool(d1, 2))
        d3 = self._conv(d2, self.to64.weight)
        d4 = self.mid64(pool(d3, 2))
        d5 = self._conv(d4, self.to128.weight)
        d6 = self.mid128(pool(d5, 2))
        d7 = self._conv(d6, self.to256.weight)
        d8 = self.mid256(pool(d7, 2))
        u1 = self.upc1[1](self._conv(torch.cat([self.up1(d8), d6], 1), self.upc1[0].weight))
        u2 = self.upc2(torch.cat([self.up2(u1), d4], 1))
        u3 = self.upc3(torch.cat([self.up3(u2), d3], 1))
        u4 = instance_norm(self._convt(u3, self.up4[0].weight, self.up4[0].bias))
        return gelu(u4 + instance_norm(self._conv(x, self.shortcut[0].weight)))


# encoder level -> (its channels, the (scale, channels) of its projections)
SKIPS = {
    "down64": (64, ((2, 128), (4, 256), (8, 512), (16, 1024))),
    "down128": (128, ((2, 256), (4, 512), (8, 1024))),
    "down256": (256, ((2, 512), (4, 1024))),
    "down512": (512, ((2, 1024),)),
}


class MixConvNeXtML(Net):
    """(B, 3, H, W) in [-1, 1], H and W divisible by 16 -> (B, 3, H, W),
    unbounded (no final tanh)."""

    def __init__(self):
        super().__init__()
        widths = (3, 64, 128, 256, 512, 1024)
        for i in range(1, 6):
            self.add_module(f"c{i}", Block(widths[i - 1], widths[i]))
        for name, (cin, specs) in SKIPS.items():
            self.add_module(name, nn.ModuleDict(
                {f"to{cout // 64}": Project(cin, cout, s) for s, cout in specs}))
        for i, (cin, feat) in enumerate(((1024, 512), (512, 256), (256, 128), (128, 64)), 1):
            self.add_module(f"u{i}", Up(cin, feat))
            self.add_module(f"uc{i}", Block(2 * feat, feat))
        self.local = LocalStream()
        self.res = nn.Conv2d(64, 3, 3, padding=1)

    def _proj(self, name, r):
        mods = getattr(self, name)
        return [mods[f"to{cout // 64}"](r) for _, cout in SKIPS[name][1]]

    def forward(self, x):
        r1 = self.c1(x)
        d64 = self._proj("down64", r1)
        r2 = self.c2(F.max_pool2d(r1, 2))
        d128 = self._proj("down128", r2)
        r3 = self.c3(F.max_pool2d(r2, 2))
        d256 = self._proj("down256", r3)
        r4 = self.c4(F.max_pool2d(r3, 2))
        d512 = self._proj("down512", r4)
        r5 = self.c5(F.max_pool2d(r4, 2))
        a1 = r5 + d64[3] + d128[2] + d256[1] + d512[0]
        a2 = self.uc1(torch.cat([self.u1(a1), r4], 1)) + d64[2] + d128[1] + d256[0]
        a3 = self.uc2(torch.cat([self.u2(a2), r3], 1)) + d64[1] + d128[0]
        a4 = self.uc3(torch.cat([self.u3(a3), r2], 1)) + d64[0]
        o4 = self.uc4(torch.cat([self.u4(a4), r1], 1))
        return self._conv(o4 + self.local(x), self.res.weight, self.res.bias, padding=1)


class PatchGAN(Net):
    """NLayerDiscriminator(n_layers=3, InstanceNorm): 4x4 convs at strides
    2, 2, 2, 1, 1 with padding 1, a norm after each but the first and the
    last, LeakyReLU 0.2; raw logits."""

    def __init__(self, input_nc, ndf=32, n_layers=3):
        super().__init__()
        layers, mult = [nn.Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)], 1
        for n in range(1, n_layers):
            prev, mult = mult, min(2 ** n, 8)
            layers += [nn.Conv2d(ndf * prev, ndf * mult, 4, 2, 1), nn.Identity(),
                       nn.LeakyReLU(0.2)]
        prev, mult = mult, min(2 ** n_layers, 8)
        layers += [nn.Conv2d(ndf * prev, ndf * mult, 4, 1, 1), nn.Identity(), nn.LeakyReLU(0.2),
                   nn.Conv2d(ndf * mult, 1, 4, 1, 1)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        convs = [m for m in self.model if isinstance(m, nn.Conv2d)]
        for i, m in enumerate(convs):
            x = self._conv(x, m.weight, m.bias, stride=m.stride, padding=m.padding)
            if 0 < i < len(convs) - 1:
                x = instance_norm(x)
            if i < len(convs) - 1:
                x = F.leaky_relu(x, 0.2)
        return x


# torchvision vgg16().features: conv indices, and the relus tapped (after
# conv 1, 3, 6, 9: relu1_2, relu2_2, relu3_3, relu4_3)
VGG_CONV_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)
VGG_WIDTHS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512)
VGG_TAPS = (1, 3, 6, 9)


class Vgg16Taps(Net):
    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for idx, width in zip(VGG_CONV_INDEX, VGG_WIDTHS):
            while len(layers) < idx:
                layers.append(nn.MaxPool2d(2))
            layers += [nn.Conv2d(cin, width, 3, 1, 1), nn.ReLU()]
            cin = width
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        taps = []
        for i, idx in enumerate(VGG_CONV_INDEX):
            if i and VGG_CONV_INDEX[i - 1] + 2 != idx:
                x = F.max_pool2d(x, 2)
            m = self.features[idx]
            x = F.relu(self._conv(x, m.weight, m.bias, padding=1))
            if i in VGG_TAPS:
                taps.append(x)
        return taps

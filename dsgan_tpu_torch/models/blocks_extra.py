"""The reference's orphaned building blocks as working modules (port of
``dsgan_tpu/models/blocks_extra.py``; reference networks.py:883-1130 and
networks_wnet.py, which its ``define_G`` never reaches): CBAM, the
ConvD / ConvN / ConvU / ConvC blocks, ``UnetPlusPlus``,
``ResDecoderBlockCBAM``, ``WNet`` and ``FENNet``. ``define_G`` builds two
of them under the JAX package's extension names ``unetpp`` and ``wnet``.

Module names are the reference's ``state_dict`` keys where the JAX package
has a converter for them (``convert_unetpp``, ``convert_wnet``) and its
own names otherwise (``ResDecoderBlockCBAM``, ``ConvCBlock``, ``FENNet``).

The JAX package's choices stand:
* ``ConvCBlock`` pads each branch by k // 2 ('same'), the repair of the
  reference's padding=1, whose four branches cannot be concatenated;
* UnetPlusPlus applies conv1_2 / att1_2 twice and has no conv1_4 /
  att1_4 (networks.py:1066-1067);
* WNet shares one PReLU (one slope) across all its stages
  (networks_wnet.py:9);
* these blocks' LeakyReLUs take torch's default slope, 0.01;
* FENNet runs stage 1 -> AvgPool(3, 2, 1) -> WNet(128), the evident
  pipeline of a class the reference leaves without a forward.
Layers cast their weights to the input's dtype at use. On a strip of the
spatial axis (``parallel.spatial``) CBAM's global mean and max reduce over
the row group (``ops.adaptive_avg_pool`` / ``adaptive_max_pool``), the
pools run through ``ops``, a reflect pad hands its rows to the conv after
it (``spatial.sequential``) and WNet's levels through ``spatial.Levels``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from dsgan_tpu_torch import ops
from dsgan_tpu_torch.models.generators_zoo import _Generator
from dsgan_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    MaxPool2d,
    Norm,
    Pad,
    PReLU,
)
from dsgan_tpu_torch.parallel import spatial


class ChannelAttentionCBAM(nn.Module):
    """CBAM channel gate (networks.py:948-965): a shared 1x1 MLP with a PReLU
    over the global average and max, sigmoid of their sum."""

    def __init__(self, channels, ratio=8):
        super().__init__()
        self.fc1 = Conv2d(channels, channels // ratio, 1, bias=False)
        self.fc2 = Conv2d(channels // ratio, channels, 1, bias=False)
        self.relu1 = PReLU()

    def forward(self, x):
        def mlp(v):
            return self.fc2(self.relu1(self.fc1(v)))

        return torch.sigmoid(mlp(ops.adaptive_avg_pool(x)) + mlp(ops.adaptive_max_pool(x)))


class SpatialAttentionCBAM(nn.Module):
    """CBAM spatial gate (networks.py:967-981): a conv over the channel mean
    and max maps, sigmoid."""

    def __init__(self, kernel_size=7):
        super().__init__()
        if kernel_size not in (3, 7):
            raise ValueError("kernel size must be 3 or 7")
        self.conv1 = Conv2d(2, 1, kernel_size, padding=kernel_size // 2, bias=False)

    def forward(self, x):
        h = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], 1)
        return torch.sigmoid(self.conv1(h))


class CBAMBlock(nn.Module):
    """cbam_block (networks.py:983-992): the channel gate, then the spatial gate."""

    def __init__(self, channels, ratio=8, kernel_size=7):
        super().__init__()
        self.channelattention = ChannelAttentionCBAM(channels, ratio)
        self.spatialattention = SpatialAttentionCBAM(kernel_size)

    def forward(self, x):
        x = x * self.channelattention(x)
        return x * self.spatialattention(x)


class ConvDBlock(nn.Module):
    """ConvD_Block (networks.py:883-898): conv + norm + LeakyReLU, MaxPool 2,
    conv3 + norm + LeakyReLU."""

    def __init__(self, in_channels, out_channels, kernel=3, pad=1, norm="instance"):
        super().__init__()
        self.ConvD = nn.Sequential(
            Conv2d(in_channels, out_channels, kernel, padding=pad), Norm(norm, out_channels),
            nn.LeakyReLU(), MaxPool2d(2), Conv2d(out_channels, out_channels, 3, padding=1),
            Norm(norm, out_channels), nn.LeakyReLU())

    def forward(self, x):
        return self.ConvD(x)


class ConvNBlock(nn.Module):
    """ConvN_Block (networks.py:900-911): conv3 + norm + LeakyReLU."""

    def __init__(self, in_channels, out_channels, norm="instance"):
        super().__init__()
        self.ConvN = nn.Sequential(Conv2d(in_channels, out_channels, 3, padding=1),
                                   Norm(norm, out_channels), nn.LeakyReLU())

    def forward(self, x):
        return self.ConvN(x)


class ConvUBlock(nn.Module):
    """ConvU_Block (networks.py:913-924): transposed conv4 s2 p1 + norm +
    LeakyReLU."""

    def __init__(self, in_channels, out_channels, norm="instance"):
        super().__init__()
        self.ConvU = nn.Sequential(ConvTranspose2d(in_channels, out_channels, 4, 2, 1),
                                   Norm(norm, out_channels), nn.LeakyReLU())

    def forward(self, x):
        return self.ConvU(x)


class ConvCBlock(nn.Module):
    """ConvC_Block (networks.py:926-946), repaired: convs k1/k3/k5/k7, each
    padded k // 2, concatenated (4 * out channels) -> norm -> LeakyReLU."""

    def __init__(self, in_channels, out_channels, norm="instance"):
        super().__init__()
        for k in (1, 3, 5, 7):
            self.add_module(f"conv{k}", Conv2d(in_channels, out_channels, k, padding=k // 2))
        self.norm1 = Norm(norm, 4 * out_channels)

    def forward(self, x):
        h = torch.cat([getattr(self, f"conv{k}")(x) for k in (1, 3, 5, 7)], 1)
        return F.leaky_relu(self.norm1(h), 0.01)


class UnetPlusPlus(_Generator):
    """UnetPlusPlus (networks.py:995-1071): a CBAM-gated 3-level encoder and
    decoder with a full-resolution branch; widths ngf, 2 ngf, 4 ngf (ngf 64
    is the reference's layout). Maps ``input_nc`` channels to ``output_nc``;
    its full-resolution branch applies conv1_2 twice, so the two must agree."""

    def __init__(self, input_nc=3, output_nc=3, ngf=64, norm="instance"):
        super().__init__()
        w = ngf
        self.conv2_1, self.att2_1 = ConvDBlock(input_nc, w, 7, 0, norm), CBAMBlock(w)
        self.conv3_1, self.att3_1 = ConvDBlock(w, w * 2, 3, 1, norm), CBAMBlock(w * 2)
        self.conv4_1, self.att4_1 = ConvDBlock(w * 2, w * 4, 3, 1, norm), CBAMBlock(w * 4)
        self.conv4_2, self.att4_2 = ConvNBlock(w * 4, w * 4, norm), CBAMBlock(w * 4)
        self.conv4_3, self.att4_3 = ConvUBlock(w * 4, w * 2, norm), CBAMBlock(w * 2)
        self.conv3_2, self.att3_2 = ConvNBlock(w * 2, w * 2, norm), CBAMBlock(w * 2)
        self.conv3_3, self.att3_3 = ConvUBlock(w * 2, w, norm), CBAMBlock(w)
        self.conv2_2, self.att2_2 = ConvNBlock(w, w, norm), CBAMBlock(w)
        self.conv2_3, self.att2_3 = ConvUBlock(w, output_nc, norm), CBAMBlock(output_nc, 1)
        self.conv1_2, self.att1_2 = ConvNBlock(input_nc, output_nc, norm), CBAMBlock(output_nc, 1)
        self.conv = Conv2d(output_nc, output_nc, 3, padding=1)
        self.pad = Pad(3)

    def _forward(self, x):
        c21 = self.att2_1(spatial.sequential([self.pad, *self.conv2_1.ConvD], x))
        c31 = self.att3_1(self.conv3_1(c21))
        c41 = self.att4_1(self.conv4_1(c31))
        c42 = self.att4_2(self.conv4_2(c41))
        c43 = self.att4_3(self.conv4_3(c42))
        c32 = self.att3_2(self.conv3_2(c31))
        c33 = self.att3_3(self.conv3_3(c32 + c43))
        c22 = self.att2_2(self.conv2_2(c21))
        c23 = self.att2_3(self.conv2_3(c22 + c33))
        c12 = self.att1_2(self.conv1_2(x))
        c14 = self.att1_2(self.conv1_2(c12))
        return self.conv(c23 + c14)


class ResDecoderBlockCBAM(nn.Module):
    """ResDecoderBlockCBAM (networks.py:1103-1130): two reflect-padded
    conv3 + norm + LeakyReLU + CBAM stages, plus a 1x1 shortcut + norm +
    LeakyReLU."""

    def __init__(self, inplanes, planes, norm="instance"):
        super().__init__()
        self.conv1, self.norm1 = Conv2d(inplanes, inplanes, 3), Norm(norm, inplanes)
        self.cbam1 = CBAMBlock(inplanes)
        self.conv2, self.norm2 = Conv2d(inplanes, planes, 3), Norm(norm, planes)
        self.cbam2 = CBAMBlock(planes)
        self.shortcut, self.norm_s = Conv2d(inplanes, planes, 1), Norm(norm, planes)
        self.pad = Pad(1)

    def forward(self, x):
        h = self.cbam1(F.leaky_relu(self.norm1(spatial.sequential([self.pad, self.conv1], x)),
                                    0.01))
        r = self.cbam2(F.leaky_relu(self.norm2(spatial.sequential([self.pad, self.conv2], h)),
                                    0.01))
        s = F.leaky_relu(self.norm_s(self.shortcut(x)), 0.01)
        return r + s


# (stage, transposed, input width, output width) in units of ``width``; 0 = the input's channels
WNET_STAGES = (("en_down_1_1", False, 0, 1), ("en_down_2_1", False, 1, 2),
               ("en_down_3_1", False, 2, 4), ("en_up_2_2", True, 4, 2),
               ("en_up_1_2", True, 2, 1), ("de_down_1_1", False, 1, 1),
               ("de_down_2_1", False, 1, 2), ("de_down_3_1", False, 2, 4),
               ("de_up_2_2", True, 4, 2), ("de_up_1_2", True, 2, 1),
               ("de_up_1_3", False, 1, 0))


class WNet(_Generator):
    """wnet (networks_wnet.py:4-51): a 3-level encoder-decoder pass, then a
    second with dense additive skips into the first's maps; maps the
    input's C channels back to C. Each stage is conv3 (or transposed conv4
    s2) + norm + the one shared PReLU. ``norm``: the reference's default is
    BatchNorm."""

    def __init__(self, input_nc=3, width=64, norm="batch"):
        super().__init__()
        self.activate = PReLU()
        for name, transposed, cin, cout in WNET_STAGES:
            cin, cout = cin * width or input_nc, cout * width or input_nc
            conv = (ConvTranspose2d(cin, cout, 4, 2, 1) if transposed
                    else Conv2d(cin, cout, 3, padding=1))
            self.add_module(name, nn.Sequential(conv, Norm(norm, cout), self.activate))

    def _forward(self, x):
        """On a strip, a level whose height does not split over the row
        group runs whole (``spatial.Levels``)."""
        lv = spatial.Levels(x.shape[2], 3)
        e11 = self.en_down_1_1(x)
        with lv.at(1):
            e21 = self.en_down_2_1(lv.pool(e11, 0))
        with lv.at(2):
            e31 = self.en_down_3_1(lv.pool(e21, 1))
        eu22 = lv.up(self.en_up_2_2, e31, 2) + e21
        eu12 = lv.up(self.en_up_1_2, eu22, 1) + e11
        d11 = self.de_down_1_1(eu12) + e11
        with lv.at(1):
            d21 = self.de_down_2_1(lv.pool(d11, 0)) + e21 + eu22
        with lv.at(2):
            d31 = self.de_down_3_1(lv.pool(d21, 1)) + e31
        du22 = lv.up(self.de_up_2_2, d31, 2) + d21 + e21 + eu22
        du12 = lv.up(self.de_up_1_2, du22, 1) + e11 + eu12 + d11
        return self.de_up_1_3(du12)


class FENNet(_Generator):
    """FENNet (networks_wnet.py:53-66): a 7x7 stem and a conv3 (norm +
    PReLU each) from 3 to 64 channels, AvgPool(3, 2, 1,
    count_include_pad=False), then WNet(64 -> 64, width 128): 64 channels
    at half resolution, a feature front end."""

    def __init__(self, norm="batch"):
        super().__init__()
        self.stage1_pad = Pad(3)
        self.stage1_conv1, self.stage1_norm1 = Conv2d(3, 64, 7), Norm(norm, 64)
        self.stage1_prelu1 = PReLU()
        self.stage1_conv2, self.stage1_norm2 = Conv2d(64, 64, 3, padding=1), Norm(norm, 64)
        self.stage1_prelu2 = PReLU()
        self.wnet = WNet(64, 128, norm)

    def _forward(self, x):
        h = spatial.sequential([self.stage1_pad, self.stage1_conv1], x)
        h = self.stage1_prelu1(self.stage1_norm1(h))
        h = self.stage1_prelu2(self.stage1_norm2(self.stage1_conv2(h)))
        h = ops.avg_pool2d(h, 3, 2, 1, count_include_pad=False)
        return self.wnet._forward(h)

"""The discriminators (port of ``dsgan_tpu/models/discriminators.py``,
reference networks.py:533-699): the PatchGAN ``NLayerDiscriminator``
(``basic`` / ``n_layers``), the per-pixel ``PixelDiscriminator``
(``pixel``) and the three-scale ``MultiscaleDiscriminator`` (``multi``).

The PatchGAN's module names are the reference's ``nn.Sequential``
indices: convs at ``model.0, 2, 5, 8, 11`` with a norm after each but the
first and the last, so ``dsgan_tpu/utils/pth_convert.py::
convert_nlayer_discriminator`` reads a port ``state_dict`` (instance
norm) and ``utils.convert.d_state_dict_from_jax`` is its inverse. The
pixel and multiscale discriminators have no converter: their names are the
JAX package's. Parameters stay in f32; each forward computes in
``compute_dtype`` (None: the input's dtype) with the weights cast at use
and returns raw logits in the input's dtype (their sigmoid with
``use_sigmoid``, the reference's ``--no_lsgan`` discriminator); the
multiscale one a list of [logits] a scale.
"""

import torch
import torch.nn.functional as F
from torch import nn

from dsgan_tpu_torch import ops
from dsgan_tpu_torch.models.layers import Conv2d, Norm, norm_uses_bias
from dsgan_tpu_torch.parallel import spatial


class _Discriminator(nn.Module):
    compute_dtype = None
    use_sigmoid = False

    def _out(self, h, in_dtype):
        if self.use_sigmoid:
            h = torch.sigmoid(h)
        return h.to(in_dtype)


class NLayerDiscriminator(_Discriminator):
    """4x4 convs with padding 1 at strides 2, 2, 2 (for n_layers = 3), 1, 1;
    a norm after every conv but the first and the last, whose convs then
    carry no bias under BatchNorm; LeakyReLU 0.2. With ndf = 32 and a
    conditional 6-channel 256x256 input it gives 30x30 patch logits."""

    def __init__(self, input_nc, ndf=32, n_layers=3, compute_dtype=None, use_sigmoid=False,
                 norm="instance"):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.use_sigmoid = use_sigmoid
        bias = norm_uses_bias(norm)
        layers = [Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers):
            prev, mult = mult, min(2 ** n, 8)
            layers += [Conv2d(ndf * prev, ndf * mult, 4, 2, 1, bias=bias), Norm(norm, ndf * mult),
                       nn.LeakyReLU(0.2)]
        prev, mult = mult, min(2 ** n_layers, 8)
        layers += [Conv2d(ndf * prev, ndf * mult, 4, 1, 1, bias=bias), Norm(norm, ndf * mult),
                   nn.LeakyReLU(0.2), Conv2d(ndf * mult, 1, 4, 1, 1)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        """On a strip of the spatial axis the stride-2 levels run split, and
        from the first conv whose output height does not split over the row
        group (at the latest the stride-1 tail, H / 8 - 1 rows) on the image
        is gathered and the rest runs whole on every rank
        (``spatial.sequential``): the logits are the whole image's."""
        in_dtype = x.dtype
        h = x.to(self.compute_dtype or in_dtype)
        if spatial.active() is not None:
            return self._out(spatial.sequential(self.model, h), in_dtype)
        return self._out(self.model(h), in_dtype)


class PixelDiscriminator(_Discriminator):
    """1x1 convs (networks.py:634-656): ndf, 2 ndf + norm, 1; LeakyReLU 0.2."""

    def __init__(self, input_nc, ndf=32, norm="instance", use_sigmoid=False):
        super().__init__()
        self.use_sigmoid = use_sigmoid
        bias = norm_uses_bias(norm)
        self.conv0 = Conv2d(input_nc, ndf, 1)
        self.conv1 = Conv2d(ndf, ndf * 2, 1, bias=bias)
        self.norm1 = Norm(norm, ndf * 2)
        self.conv2 = Conv2d(ndf * 2, 1, 1, bias=bias)

    def forward(self, x):
        """On a strip every layer runs on its rows (1x1 convs; the norm's
        statistics over the row group): the logits are a strip."""
        in_dtype = x.dtype
        h = F.leaky_relu(self.conv0(x.to(self.compute_dtype or in_dtype)), 0.2)
        h = F.leaky_relu(self.norm1(self.conv1(h)), 0.2)
        return self._out(self.conv2(h), in_dtype)


class NLayerMulti(nn.Module):
    """One scale of the multiscale D (networks.py:582-631): the PatchGAN
    with padding ceil(3 / 2) = 2, widths doubling up to 512, conv biases
    whatever the norm."""

    def __init__(self, input_nc, ndf=32, n_layers=3, norm="instance"):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = Conv2d(input_nc, ndf, 4, 2, 2)
        nf = ndf
        for n in range(1, n_layers + 1):
            prev, nf = nf, min(nf * 2, 512)
            self.add_module(f"conv{n}", Conv2d(prev, nf, 4, 2 if n < n_layers else 1, 2))
            self.add_module(f"norm{n}", Norm(norm, nf))
        self.conv_out = Conv2d(nf, 1, 4, 1, 2)

    def forward(self, x):
        h = F.leaky_relu(self.conv0(x), 0.2)
        for n in range(1, self.n_layers + 1):
            h = F.leaky_relu(getattr(self, f"norm{n}")(getattr(self, f"conv{n}")(h)), 0.2)
        return self.conv_out(h)


class MultiscaleDiscriminator(_Discriminator):
    """``num_d`` PatchGANs over a pyramid of AvgPool(3, 2, 1,
    count_include_pad=False) downsampled inputs (networks.py:659-699). The
    finest input goes to the highest-index scale (``scale{num_d - 1}``), as
    in the reference; returns [[logits] of each scale], finest first."""

    def __init__(self, input_nc, ndf=32, n_layers=3, norm="instance", use_sigmoid=False,
                 num_d=3):
        super().__init__()
        self.use_sigmoid = use_sigmoid
        self.num_d = num_d
        for i in range(num_d):
            self.add_module(f"scale{i}", NLayerMulti(input_nc, ndf, n_layers, norm))

    def forward(self, x):
        """On a strip of the spatial axis the input is gathered once and
        every scale runs whole on every rank: its k4 p2 convs give heights
        H / 2 + 1 that never split. The loss takes each rank's share of the
        whole logits (``spatial.mean``)."""
        in_dtype = x.dtype
        h = x.to(self.compute_dtype or in_dtype)
        if spatial.active() is None:
            return self._scales(h, in_dtype)
        h = spatial.gather(h)
        with spatial.replicated():
            return self._scales(h, in_dtype)

    def _scales(self, h, in_dtype):
        out = []
        for i in range(self.num_d):
            out.append([self._out(getattr(self, f"scale{self.num_d - 1 - i}")(h), in_dtype)])
            if i != self.num_d - 1:
                h = ops.avg_pool2d(h, 3, 2, 1, count_include_pad=False)
        return out

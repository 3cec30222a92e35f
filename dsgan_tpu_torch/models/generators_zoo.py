"""The generator zoo of ``--which_model_netG`` (port of
``dsgan_tpu/models/generators_zoo.py``; reference networks.py:215-881):
``resnet_9blocks`` / ``resnet_6blocks``, ``unet_128`` / ``unet_256``,
``gll`` (pix2pixHD's global generator plus one local enhancer) and
``cascaded`` (CRN).

Module names are the reference's ``state_dict`` keys, so the JAX package's
converters (``dsgan_tpu/utils/pth_convert.py``: ``convert_resnet_generator``,
``convert_unet_generator``, ``convert_gll_generator``) read a port
``state_dict`` as they read a reference checkpoint; ``utils.convert`` holds
their inverses. ``cascaded`` has no converter: its names are the JAX
package's. None of these networks runs a block-core kernel: their
convolutions are cuDNN's.

Each network keeps f32 parameters and computes in ``compute_dtype`` (None:
the input's dtype), its layers casting their weights at use, and returns
the input's dtype, as the JAX modules do. The reference's ``cascaded``
forward has no return statement (networks.py:881); here, as in the JAX
package, it returns its final conv.

On a strip of the spatial axis (``parallel.spatial``) each network runs
its Sequentials through ``spatial.sequential`` (a pad handed to its conv,
a level whose height does not split computed whole and its rows taken
back after the transposed conv that splits again), its pools and resizes
through ``ops``, and ``cascaded`` its pyramid through ``spatial.Levels``
and its LayerNorm's two sums over the row group.
"""

import torch
import torch.nn.functional as F
from torch import nn

from dsgan_tpu_torch import ops
from dsgan_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    Dropout,
    Norm,
    Pad,
    PReLU,
    norm_uses_bias,
)
from dsgan_tpu_torch.parallel import spatial


class _Generator(nn.Module):
    """The dtype contract: cast the input to ``compute_dtype``, run
    ``_forward``, return the input's dtype."""

    compute_dtype = None

    def forward(self, x):
        in_dtype = x.dtype
        return self._forward(x.to(self.compute_dtype or in_dtype)).to(in_dtype)


class ResnetBlock(nn.Module):
    """Johnson-style residual block, PReLU variant (networks.py:403-442):
    pad, conv3, norm, PReLU, [dropout], pad, conv3, norm; plus the input."""

    def __init__(self, dim, norm="instance", use_dropout=False, padding_type="reflect",
                 bias=None):
        super().__init__()
        bias = norm_uses_bias(norm) if bias is None else bias
        layers = [Pad(1, padding_type), Conv2d(dim, dim, 3, bias=bias), Norm(norm, dim), PReLU()]
        if use_dropout:
            layers.append(Dropout(0.5))
        layers += [Pad(1, padding_type), Conv2d(dim, dim, 3, bias=bias), Norm(norm, dim)]
        self.conv_block = nn.Sequential(*layers)

    def forward(self, x):
        """On a strip each pad runs with its conv (``spatial.sequential``)."""
        if spatial.active() is not None:
            return x + spatial.sequential(self.conv_block, x)
        return x + self.conv_block(x)


class ResnetGenerator(_Generator):
    """resnet_6blocks / resnet_9blocks (networks.py:215-262): 7x7 stem, two
    stride-2 downsamples, ``n_blocks`` residual blocks at 4 * ngf, two
    transposed upsamples, 7x7 head, tanh; one ``nn.Sequential`` ``model``."""

    def __init__(self, input_nc=3, output_nc=3, ngf=32, n_blocks=9, norm="instance",
                 use_dropout=False, padding_type="reflect"):
        super().__init__()
        bias = norm_uses_bias(norm)
        layers = [Pad(3), Conv2d(input_nc, ngf, 7, bias=bias), Norm(norm, ngf), PReLU()]
        for i in range(2):
            m = 2 ** i
            layers += [Conv2d(ngf * m, ngf * m * 2, 3, 2, 1, bias=bias), Norm(norm, ngf * m * 2),
                       PReLU()]
        layers += [ResnetBlock(ngf * 4, norm, use_dropout, padding_type) for _ in range(n_blocks)]
        for i in range(2):
            m = 2 ** (2 - i)
            layers += [ConvTranspose2d(ngf * m, ngf * m // 2, 3, 2, 1, output_padding=1, bias=bias),
                       Norm(norm, ngf * m // 2), PReLU()]
        layers += [Pad(3), Conv2d(ngf, output_nc, 7), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def _forward(self, x):
        """On a strip of the spatial axis a level whose height does not
        split over the row group runs whole (``spatial.sequential``)."""
        if spatial.active() is not None:
            return spatial.sequential(self.model, x)
        return self.model(x)


class UnetSkipConnectionBlock(nn.Module):
    """One level of the U-Net (networks.py:475-530): down conv4 s2, the
    inner levels, PReLU, transposed conv4 s2, norm; the input concatenated
    ahead of the result. The reference's down LeakyReLU is in place, so the
    skip carries the input after it (``dsgan_tpu`` keeps this too)."""

    def __init__(self, outer_nc, inner_nc, input_nc=None, submodule=None, outermost=False,
                 innermost=False, norm="instance", use_dropout=False):
        super().__init__()
        self.outermost = outermost
        bias = norm_uses_bias(norm)
        down = Conv2d(input_nc or outer_nc, inner_nc, 4, 2, 1, bias=bias)
        if outermost:
            layers = [down, submodule, PReLU(), ConvTranspose2d(inner_nc * 2, outer_nc, 4, 2, 1),
                      nn.Tanh()]
        elif innermost:
            layers = [nn.LeakyReLU(0.2), down, PReLU(),
                      ConvTranspose2d(inner_nc, outer_nc, 4, 2, 1, bias=bias), Norm(norm, outer_nc)]
        else:
            layers = [nn.LeakyReLU(0.2), down, Norm(norm, inner_nc), submodule, PReLU(),
                      ConvTranspose2d(inner_nc * 2, outer_nc, 4, 2, 1, bias=bias),
                      Norm(norm, outer_nc)]
            if use_dropout:
                layers.append(Dropout(0.5))
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        """On a strip, where a down conv's output height does not split
        (the innermost levels) the level and those inside it run whole and
        the transposed conv's output, which splits again, is taken back:
        the skip's concat joins two strips."""
        if self.outermost:
            return spatial.sequential(self.model, x)
        h = self.model[0](x)
        return torch.cat([h, spatial.sequential(self.model[1:], h)], 1)


class UnetGenerator(_Generator):
    """unet_128 (``num_downs`` 7) / unet_256 (8) (networks.py:449-472):
    encoder widths ngf, 2, 4, 8, 8 .. 8 ngf; dropout (with ``use_dropout``)
    on the 8 ngf levels between the innermost and the 4 ngf one."""

    def __init__(self, input_nc=3, output_nc=3, num_downs=8, ngf=32, norm="instance",
                 use_dropout=False):
        super().__init__()
        block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, innermost=True, norm=norm)
        for _ in range(num_downs - 5):
            block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, submodule=block, norm=norm,
                                            use_dropout=use_dropout)
        for outer in (4, 2, 1):
            block = UnetSkipConnectionBlock(ngf * outer, ngf * outer * 2, submodule=block,
                                            norm=norm)
        self.model = UnetSkipConnectionBlock(output_nc, ngf, input_nc=input_nc, submodule=block,
                                             outermost=True, norm=norm)

    def _forward(self, x):
        return self.model(x)


def _global_trunk(input_nc, ngf, n_down, n_blocks, norm):
    """pix2pixHD's global generator (networks.py:327-357) without its head
    [pad, conv7, tanh]: the layers the local enhancer consumes."""
    layers = [Pad(3), Conv2d(input_nc, ngf, 7), Norm(norm, ngf), PReLU()]
    for i in range(n_down):
        m = 2 ** i
        layers += [Conv2d(ngf * m, ngf * m * 2, 3, 2, 1), Norm(norm, ngf * m * 2), PReLU()]
    layers += [ResnetBlock(ngf * 2 ** n_down, norm, bias=True) for _ in range(n_blocks)]
    for i in range(n_down):
        m = 2 ** (n_down - i)
        layers += [ConvTranspose2d(ngf * m, ngf * m // 2, 3, 2, 1, output_padding=1),
                   Norm(norm, ngf * m // 2), PReLU()]
    return layers


class LocalEnhancer(_Generator):
    """The ``gll`` generator (networks.py:265-324): the global trunk at
    ``ngf * 2^n_local_enhancers`` on the input downsampled by
    AvgPool(3, 2, 1, count_include_pad=False), then each local enhancer:
    stem and stride-2 conv on its pyramid level, plus the coarser output,
    residual blocks, a transposed upsample, and at the finest the 7x7 head
    and tanh. Its residual blocks carry conv biases whatever the norm."""

    def __init__(self, input_nc=3, output_nc=3, ngf=32, n_downsample_global=3,
                 n_blocks_global=9, n_local_enhancers=1, n_blocks_local=3, norm="instance"):
        super().__init__()
        self.n_le = n_local_enhancers
        self.model = nn.Sequential(*_global_trunk(input_nc, ngf * 2 ** n_local_enhancers,
                                                  n_downsample_global, n_blocks_global, norm))
        for n in range(1, n_local_enhancers + 1):
            f = ngf * 2 ** (n_local_enhancers - n)
            down = [Pad(3), Conv2d(input_nc, f, 7), Norm(norm, f), PReLU(),
                    Conv2d(f, f * 2, 3, 2, 1), Norm(norm, f * 2), PReLU()]
            up = [ResnetBlock(f * 2, norm, bias=True) for _ in range(n_blocks_local)]
            up += [ConvTranspose2d(f * 2, f, 3, 2, 1, output_padding=1), Norm(norm, f), PReLU()]
            if n == n_local_enhancers:
                up += [Pad(3), Conv2d(ngf, output_nc, 7), nn.Tanh()]
            self.add_module(f"model{n}_1", nn.Sequential(*down))
            self.add_module(f"model{n}_2", nn.Sequential(*up))

    def _forward(self, x):
        pyramid = [x]
        for _ in range(self.n_le):
            pyramid.append(ops.avg_pool2d(pyramid[-1], 3, 2, 1, count_include_pad=False))
        out = spatial.sequential(self.model, pyramid[-1])
        for n in range(1, self.n_le + 1):
            h = spatial.sequential(getattr(self, f"model{n}_1"), pyramid[self.n_le - n])
            out = spatial.sequential(getattr(self, f"model{n}_2"), h + out)
        return out


class CascadeLayerNorm(nn.Module):
    """The cascaded net's whole-sample LayerNorm (networks.py:703-725): mean
    and std over all of a sample's C, H, W (std with Bessel's correction,
    eps added to the std), then a per-channel affine; in f32. On a strip
    the sum of x and then that of the centred squares are summed over the
    row group, and the count is the image's C * H * W."""

    def __init__(self, num_features, eps=1e-12):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(num_features))
        self.beta = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        xf = x.float()
        rows = spatial.active()
        n = x.shape[1] * x.shape[2] * (rows.size if rows else 1) * x.shape[3]
        if rows is None:
            mean = xf.mean(dim=(1, 2, 3), keepdim=True)
        else:
            mean = spatial.sum_rows(xf.sum(dim=(1, 2, 3), keepdim=True), rows) / n
        var = spatial.sum_rows((xf - mean).square().sum(dim=(1, 2, 3), keepdim=True), rows) / (
            n - 1)
        y = (xf - mean) / (torch.sqrt(var) + self.eps)
        return (self.gamma[:, None, None] * y + self.beta[:, None, None]).to(x.dtype)


CASCADE_WIDTHS = (16, 16, 8, 4, 2, 1)


class CascadedGenerator(_Generator):
    """CRN-style cascaded refinement (networks.py:728-881): a 2x average-pool
    pyramid of 6 levels; from the coarsest up, each stage takes [the
    previous stage's output, the level] through two conv3 + LayerNorm +
    nn.LeakyReLU(0.2) and upsamples it bilinearly (align_corners=False) to the
    next level; a conv3 over [output, input] ends it (no tanh). Needs H and
    W divisible by 64."""

    def __init__(self, input_nc=3, output_nc=3, ngf=32):
        super().__init__()
        prev = 0
        for li, w in enumerate(CASCADE_WIDTHS):
            self.add_module(f"conv{li}a", Conv2d(prev + input_nc, ngf * w, 3, 1, 1))
            self.add_module(f"ln{li}a", CascadeLayerNorm(ngf * w))
            self.add_module(f"conv{li}b", Conv2d(ngf * w, ngf * w, 3, 1, 1))
            self.add_module(f"ln{li}b", CascadeLayerNorm(ngf * w))
            prev = ngf * w
        self.conv_out = Conv2d(prev + input_nc, output_nc, 3, 1, 1)

    def _forward(self, x):
        lv = spatial.Levels(x.shape[2], 7)  # level k at 1 / 2^k
        pyramid = [x]
        for k in range(6):
            pyramid.append(lv.pool(pyramid[-1], k, lambda t: ops.avg_pool2d(t, 2)))
        h = None
        for li in range(len(CASCADE_WIDTHS)):
            with lv.at(6 - li):
                level = pyramid[6 - li]
                h = level if h is None else torch.cat([h, level], 1)
                for part in "ab":
                    h = getattr(self, f"ln{li}{part}")(getattr(self, f"conv{li}{part}")(h))
                    h = F.leaky_relu(h, 0.2)
            h = lv.up(ops.upsample_bilinear2x, h, 6 - li)
        return self.conv_out(torch.cat([h, x], 1))

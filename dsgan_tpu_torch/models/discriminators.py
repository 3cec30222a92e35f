"""The PatchGAN discriminator (port of ``dsgan_tpu/models/discriminators.py``
``NLayerDiscriminator``, reference networks.py:533-579).

Module names are the reference's ``nn.Sequential`` indices: with the
parameter-free InstanceNorm the convs sit at ``model.0, 2, 5, 8, 11``, so
``dsgan_tpu/utils/pth_convert.py::convert_nlayer_discriminator`` reads a
port ``state_dict`` and ``utils.convert.d_state_dict_from_jax`` is its
inverse. Parameters stay in f32; the forward computes in
``compute_dtype`` (None: the input's dtype) with the weights cast at use,
and returns raw logits in the input's dtype (their sigmoid with
``use_sigmoid``, the reference's ``--no_lsgan`` discriminator).
"""

import torch
import torch.nn.functional as F
from torch import nn

from dsgan_tpu_torch import ops


class InstanceNorm(nn.Module):
    """Parameter-free InstanceNorm with the JAX package's statistics."""

    def forward(self, x):
        return ops.instance_norm(x)


class NLayerDiscriminator(nn.Module):
    """4x4 convs with padding 1 at strides 2, 2, 2 (for n_layers = 3), 1, 1;
    conv biases on; InstanceNorm after every conv but the first and the
    last; LeakyReLU 0.2. With ndf = 32 and a conditional 6-channel 256x256
    input it gives 30x30 patch logits."""

    def __init__(self, input_nc, ndf=32, n_layers=3, compute_dtype=None, use_sigmoid=False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.use_sigmoid = use_sigmoid
        layers = [nn.Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers):
            prev, mult = mult, min(2 ** n, 8)
            layers += [nn.Conv2d(ndf * prev, ndf * mult, 4, 2, 1), InstanceNorm(),
                       nn.LeakyReLU(0.2)]
        prev, mult = mult, min(2 ** n_layers, 8)
        layers += [nn.Conv2d(ndf * prev, ndf * mult, 4, 1, 1), InstanceNorm(), nn.LeakyReLU(0.2),
                   nn.Conv2d(ndf * mult, 1, 4, 1, 1)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        in_dtype = x.dtype
        h = x.to(self.compute_dtype or in_dtype)
        for m in self.model:
            if isinstance(m, nn.Conv2d):
                h = F.conv2d(h, m.weight.to(h.dtype), m.bias.to(h.dtype), m.stride, m.padding)
            else:
                h = m(h)
        if self.use_sigmoid:
            h = torch.sigmoid(h)
        return h.to(in_dtype)

"""VGG16 perceptual features (port of ``dsgan_tpu/models/vgg.py``,
reference DSGAN/models/vgg.py:5-42).

Module names are torchvision's ``vgg16().features`` indices
(``features.0.weight`` ..), the names ``dsgan_tpu/models/vgg.py::
load_torchvision_npz`` reads. The pretrained weights are not in the repo:
the extractor takes converted weights (``utils.convert.
vgg_state_dict_from_jax``) or numpy-seeded random ones. As in the
reference, inputs are fed in the generator's [-1, 1] range with no
ImageNet re-normalization.
"""

import torch.nn.functional as F
from torch import nn

from dsgan_tpu_torch import ops
from dsgan_tpu_torch.utils.convert import VGG16_FEATURE_INDEX

# (output channels) of each conv; the relu after conv 1, 3, 6, 9, 12 is a tap
_WIDTHS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
_TAP_AFTER = (1, 3, 6, 9, 12)


def num_convs(num_taps):
    """Convs the first ``num_taps`` taps need."""
    return _TAP_AFTER[num_taps - 1] + 1


class Vgg16Features(nn.Module):
    """The relu1_2 .. relu5_3 taps, truncated to the first ``num_taps``
    (the pix2pix perceptual loss uses 4, and the block-5 convs are then
    never built). NCHW in; a list of NCHW taps in the input's dtype out.
    Computes in ``compute_dtype`` (None: the input's dtype) with f32
    parameters cast at use."""

    def __init__(self, num_taps=5, compute_dtype=None):
        super().__init__()
        self.num_taps = num_taps
        self.compute_dtype = compute_dtype
        layers, cin = [], 3
        for i in range(num_convs(num_taps)):
            while len(layers) < VGG16_FEATURE_INDEX[i]:
                layers.append(nn.MaxPool2d(2))  # torchvision's pool slots
            layers += [nn.Conv2d(cin, _WIDTHS[i], 3, 1, 1), nn.ReLU()]
            cin = _WIDTHS[i]
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        in_dtype = x.dtype
        h = x.to(self.compute_dtype or in_dtype)
        taps = []
        for i, idx in enumerate(VGG16_FEATURE_INDEX[:num_convs(self.num_taps)]):
            conv = self.features[idx]
            if i and VGG16_FEATURE_INDEX[i - 1] + 2 != idx:
                h = ops.max_pool2d(h, 2)
            h = F.relu(ops.conv2d(h, conv.weight.to(h.dtype), conv.bias.to(h.dtype), padding=1))
            if i in _TAP_AFTER:
                taps.append(h.to(in_dtype))
        return taps

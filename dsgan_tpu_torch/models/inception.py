"""Inception-v3 pool3 features for FID/KID (port of
``dsgan_tpu/models/inception.py``).

torchvision's ``Inception3`` (eval mode, no aux logits, no
``transform_input``) truncated at the 2048-d global average of Mixed_7c
("pool3"). Module names are torchvision's (``Mixed_5b.branch1x1.conv.
weight``, ``.bn.running_var``), so a torchvision or pytorch-fid Inception
``state_dict`` saved as an npz loads by dropping the classifier
(``utils.convert.load_inception_npz``), and a JAX ``InceptionPool3`` tree
carries over through ``utils.convert.inception_state_dict_from_jax``.

Two graphs, as in the JAX package:
  * ``fid_variant=True`` (default), the pytorch-fid / TF-FID graph: the
    in-block 3x3 average pools leave the padding out of the count
    (``count_include_pad=False``) and Mixed_7c's pool branch is a max
    pool;
  * ``fid_variant=False``, the literal torchvision graph.
Each BasicConv2d is a bias-free conv and an eval-mode BatchNorm (eps 1e-3)
folded into one scale and shift, then ReLU, in the JAX package's
arithmetic order.

Precision: the extractor runs in f32 with TF32 off on the card
(``full_f32``), in convolutions and in the resize's matmuls, so its
features are f32 features on either device; the FID / KID on top are
float64 numpy (``ops/fid.py``). Random weights (``"random"``) are He
normal from a numpy seed (a 0.02 normal would fade to a constant over the
17 conv layers): pipeline tests only, any FID from them is meaningless.

Inputs are NCHW in [-1, 1]; ``prepare_images`` resizes to 299x299 as the
JAX package's ``jax.image.resize(..., "bilinear")`` does
(``ops/resize.py``: antialiased where it shrinks).
"""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dsgan_tpu_torch.device import resolve_device
from dsgan_tpu_torch.ops.resize import resize_bilinear

BN_EPS = 1e-3  # torchvision BasicConv2d: BatchNorm2d(eps=0.001)
SIZE = 299


class BasicConv2d(nn.Module):
    """Conv (no bias) + eval-mode BatchNorm, folded + ReLU."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        bn = self.bn
        g = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
        y = self.conv(x)
        return F.relu(y * g[:, None, None] + (bn.bias - bn.running_mean * g)[:, None, None])


def _avg_pool(x, fid_variant):
    # pytorch-fid leaves the padding out of the count (the TF graph's pools)
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=not fid_variant)


class InceptionA(nn.Module):
    def __init__(self, cin, pool_features, fid_variant=True):
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool(x, self.fid_variant))
        return torch.cat([self.branch1x1(x), b5, bd, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin, c7, fid_variant=True):
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool(x, self.fid_variant))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """``pool_mode="max"``: pytorch-fid's FIDInceptionE_2 (Mixed_7c)."""

    def __init__(self, cin, pool_mode="avg", fid_variant=True):
        super().__init__()
        self.pool_mode, self.fid_variant = pool_mode, fid_variant
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool_mode == "max":
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool(x, self.fid_variant)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionPool3(nn.Module):
    """Stem + Mixed_5b .. Mixed_7c + global average pool: (N, 3, 299, 299)
    in [-1, 1] -> (N, 2048) f32 features."""

    def __init__(self, fid_variant=True):
        super().__init__()
        fv = fid_variant
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fv)
        self.Mixed_5c = InceptionA(256, 64, fv)
        self.Mixed_5d = InceptionA(288, 64, fv)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fv)
        self.Mixed_6c = InceptionC(768, 160, fv)
        self.Mixed_6d = InceptionC(768, 160, fv)
        self.Mixed_6e = InceptionC(768, 192, fv)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg", fv)
        self.Mixed_7c = InceptionE(2048, "max" if fv else "avg", fv)

    def forward(self, x):
        h = x.float().contiguous(memory_format=torch.channels_last)
        h = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(h)))
        h = F.max_pool2d(h, 3, stride=2)
        h = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(h))
        h = F.max_pool2d(h, 3, stride=2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            h = getattr(self, "Mixed_" + name)(h)
        return h.mean(dim=(2, 3))


def random_state_dict(net, seed=0):
    """He-normal conv kernels (truncated at 2 std, as ``jax.nn.initializers.
    he_normal``), BatchNorm at its identity (scale 1, shift 0, mean 0, var
    1), drawn with numpy from ``seed`` in ``state_dict`` order."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in net.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("conv.weight"):
            fan_in = int(np.prod(shape[1:]))
            z = rng.standard_normal(shape)
            while (bad := np.abs(z) > 2.0).any():
                z[bad] = rng.standard_normal(int(bad.sum()))
            # the std of N(0, 1) truncated at +-2
            w = z * np.sqrt(2.0 / fan_in) / 0.87962566103423978
        elif k.endswith(("bn.weight", "bn.running_var")):
            w = np.ones(shape)
        elif k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.long)
            continue
        else:
            w = np.zeros(shape)
        sd[k] = torch.from_numpy(w.astype(np.float32))
    return sd


def define_inception(weights="random", fid_variant=True, device=None, seed=0):
    """The extractor on ``device`` (None: the CUDA card), in eval mode:
    ``weights`` a torchvision-key npz (``utils.convert.load_inception_npz``),
    a ``state_dict``, or ``"random"`` (``random_state_dict(seed)``)."""
    from dsgan_tpu_torch.utils.convert import load_inception_npz

    dev = resolve_device(device)
    with torch.device("meta"):
        net = InceptionPool3(fid_variant)
    net = net.to_empty(device=dev)
    if isinstance(weights, str):
        weights = random_state_dict(net, seed) if weights == "random" else \
            load_inception_npz(weights)
    net.load_state_dict(weights)
    return net.eval().requires_grad_(False)


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuDNN convolutions and matmuls inside the block (the
    extractor's precision on the card), restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def prepare_images(x):
    """(N, C, H, W) [-1, 1] of any size -> (N, C, 299, 299) f32 in [-1, 1]:
    the JAX package's bilinear resize (``ops.resize.resize_bilinear``),
    then a clip."""
    return resize_bilinear(x.float(), (SIZE, SIZE), dims=(2, 3)).clamp(-1.0, 1.0)


class FeatureAccumulator:
    """Streaming pool3 features: ``add()`` images one at a time (HWC uint8
    or [-1, 1] float, gray or RGB; an image of another size than the first
    is resized on the host to the first one's, bilinear, as the JAX
    package does), extracted ``batch`` at a time; ``result()`` flushes and
    returns the (N, 2048) f32 feature matrix."""

    def __init__(self, apply, batch):
        self._apply = apply
        self._batch = max(1, int(batch))
        self._buf = []
        self._feats = []
        self._shape = None

    def add(self, im):
        im = np.asarray(im)
        if im.dtype == np.uint8:
            im = im.astype(np.float32) / 127.5 - 1.0
        if im.ndim == 2:
            im = im[..., None]
        if im.shape[-1] == 1:
            im = np.repeat(im, 3, axis=-1)
        im = im.astype(np.float32)
        if self._shape is None:
            self._shape = im.shape
        elif im.shape != self._shape:
            from PIL import Image

            th, tw = self._shape[:2]
            u8 = np.clip((im + 1.0) * 127.5, 0, 255).astype(np.uint8)
            im = np.asarray(Image.fromarray(u8).resize((tw, th), Image.BILINEAR),
                            np.float32) / 127.5 - 1.0
        self._buf.append(im)
        if len(self._buf) == self._batch:
            self._flush()

    def _flush(self):
        if self._buf:
            self._feats.append(self._apply(np.stack(self._buf)))
            self._buf.clear()

    def result(self):
        self._flush()
        if not self._feats:
            return np.zeros((0, 2048), np.float32)
        return np.concatenate(self._feats, axis=0)


def make_feature_accumulators(weights, fid_variant=True, batch=8, device=None):
    """Build the extractor once; a zero-argument factory of
    ``FeatureAccumulator``s sharing it. ``weights``: a torchvision-key npz,
    or ``"random"`` (pipeline tests only, and said so)."""
    if weights == "random":
        print("WARNING: FID/KID over RANDOM-INIT inception features — numbers are meaningless; "
              "supply --inception_weights (a torchvision Inception3 state_dict as an npz)")
    net = define_inception(weights, fid_variant, device)
    dev = next(net.parameters()).device

    def apply(chunk):
        """NHWC [-1, 1] numpy -> (N, 2048) numpy: on the device, resized,
        through the extractor in f32."""
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(dev).permute(0, 3, 1, 2)
        with torch.inference_mode(), full_f32():
            return net(prepare_images(x)).cpu().numpy()

    return lambda: FeatureAccumulator(apply, batch)


def make_feature_fn(weights, fid_variant=True, batch=8, device=None):
    """``extract(images) -> (N, 2048) numpy`` over an iterable of images
    (``FeatureAccumulator``'s formats)."""
    new_acc = make_feature_accumulators(weights, fid_variant, batch, device)

    def extract(images):
        acc = new_acc()
        for im in images:
            acc.add(im)
        return acc.result()

    return extract

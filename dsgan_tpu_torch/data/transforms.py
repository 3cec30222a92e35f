"""Image transforms (port of ``dsgan_tpu/data/transforms.py``, reference
DSGAN/data/base_dataset.py ``get_transform`` and the aligned dataset's
inline pipeline), PIL and numpy on the host.

Float outputs are HWC float32 in [-1, 1]; the uint8 path keeps raw HWC
pixels and leaves the normalize to the device.
"""

import numpy as np
from PIL import Image


def to_array(img):
    """PIL -> HWC float32 in [0, 1] (ToTensor semantics)."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def normalize(arr):
    """[0, 1] -> [-1, 1] (Normalize(0.5, 0.5, 0.5))."""
    return arr * 2.0 - 1.0


def resize(img, w, h):
    return img.resize((w, h), Image.BICUBIC)


def scale_width(img, target_width):
    ow, oh = img.size
    if ow == target_width:
        return img
    h = int(target_width * oh / ow)
    return img.resize((target_width, h), Image.BICUBIC)


def crop(arr, y, x, th, tw):
    return arr[y:y + th, x:x + tw, :]


def hflip(arr):
    return arr[:, ::-1, :]


def rgb_to_gray(arr):
    """Luma projection with the reference's 0.299 / 0.587 / 0.114 mix
    (aligned_dataset.py:78-84), on [-1, 1] arrays."""
    tmp = arr[..., 0] * 0.299 + arr[..., 1] * 0.587 + arr[..., 2] * 0.114
    return tmp[..., None]


def get_transform(opt, rng, uint8=False):
    """The ``--resize_or_crop`` pipeline of the single dataset (reference
    base_dataset.py:17-39): fn(PIL, rng) -> HWC [-1, 1] float32, or with
    ``uint8`` raw HWC uint8 through the same spatial steps (crop and flip
    do not care about the dtype), normalized on the device."""
    mode = opt.resize_or_crop
    fw, fh = opt.fineSize_w, opt.fineSize_h
    lw, lh = opt.loadSize_w, opt.loadSize_h
    do_flip = not opt.no_flip

    def apply(img, rng=rng):
        if mode == "resize_and_crop":
            img = resize(img, lw, lh)
        elif mode in ("scale_width", "scale_width_and_crop"):
            img = scale_width(img, fw if mode == "scale_width" else lw)
        elif mode != "crop":
            raise ValueError(f"unknown resize_or_crop mode: {mode}")
        if uint8:
            arr = np.asarray(img, dtype=np.uint8)
            if arr.ndim == 2:
                arr = arr[:, :, None]
        else:
            arr = to_array(img)
        if mode in ("resize_and_crop", "crop", "scale_width_and_crop"):
            h, w = arr.shape[:2]
            y = int(rng.integers(0, max(h - fh, 0) + 1))
            x = int(rng.integers(0, max(w - fw, 0) + 1))
            arr = crop(arr, y, x, fh, fw)
        if do_flip and rng.random() < 0.5:
            arr = hflip(arr)
        return arr if uint8 else normalize(arr)

    return apply

"""Small host-side helpers (port of ``dsgan_tpu/utils/util.py``, reference
DSGAN/util/util.py)."""

import os

import numpy as np
import torch


def tensor2im(x):
    """The first batch element of an NHWC [-1, 1] batch -> uint8 HWC RGB
    (reference util.py:10-19). ``x`` is a CPU tensor or a numpy array;
    uint8 input (the loader's raw pixels) passes through unchanged."""
    arr = x.detach().float().numpy() if isinstance(x, torch.Tensor) and x.dtype != torch.uint8 \
        else np.asarray(x)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.dtype == np.uint8:
        return arr
    arr = (arr + 1.0) / 2.0 * 255.0
    return np.clip(arr, 0, 255).astype(np.uint8)


def save_image(image_numpy, image_path):
    from PIL import Image

    Image.fromarray(image_numpy).save(image_path)


def diagnose_network(net, name="network"):
    """Mean over the gradient tensors of their mean absolute value
    (reference util.py:22-32). ``net``: a module, whose parameters'
    ``.grad`` are read, or an iterable of gradient tensors."""
    grads = [p.grad for p in net.parameters()] if isinstance(net, torch.nn.Module) else list(net)
    grads = [g for g in grads if g is not None]
    mean = float(sum(g.detach().abs().float().mean() for g in grads) / len(grads)) if grads else 0.0
    print(name)
    print(mean)
    return mean


def print_numpy(x, val=True, shp=False):
    x = np.asarray(x).astype(np.float64)
    if shp:
        print("shape,", x.shape)
    if val:
        x = x.flatten()
        print("mean = %3.3f, min = %3.3f, max = %3.3f, median = %3.3f, std=%3.3f"
              % (np.mean(x), np.min(x), np.max(x), np.median(x), np.std(x)))


def mkdirs(paths):
    if isinstance(paths, list):
        for path in paths:
            mkdir(path)
    else:
        mkdir(paths)


def mkdir(path):
    os.makedirs(path, exist_ok=True)

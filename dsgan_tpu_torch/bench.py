"""Training throughput of the port: the full pix2pix step, default DS-GAN
recipe (MixConvNeXtML + conditional PatchGAN ndf 32 + L1/VGG/TV/SSIM,
bf16 compute, pool 50), the counterpart of the JAX package's ``bench.py``.

    python -m dsgan_tpu_torch.bench [--device cuda|cpu]

Env knobs as ``bench.py``: BENCH_BATCH (default 16), BENCH_STEPS (20),
BENCH_SIZE (256), BENCH_VGG=0 to drop the perceptual term. Weights are
random, seeded with numpy; inputs are uniform [-1, 1] floats from a
seeded numpy generator, as in ``bench.py``. Three untimed steps, then
the timed ones, ended by a device sync. Prints one JSON line:

  {"metric": "train_images_per_sec", "value": N, "unit": "img/s", ...}

with the device and, on a card, its name and power limit as nvidia-smi
reports them. On the CPU (``--device cpu``) the step computes in f32:
the number is then the CPU's, not a device metric.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from dsgan_tpu_torch.device import card_info, resolve_device

WARMUP = 3


def build(dev, size, use_vgg, dtype, seed=0, remat=False):
    """The default recipe on ``dev``: (train state, step, config); ``remat``
    as ``define_G``'s (``--remat``)."""
    from dsgan_tpu_torch.models import define_D, define_G, define_vgg
    from dsgan_tpu_torch.models.pix2pix import Pix2PixConfig, init_state, make_train_step

    cfg = Pix2PixConfig(pool_size=50, use_vgg=use_vgg, compute_dtype=dtype)
    netG = define_G(3, 3, 32, "MixConvNeXtML", dtype=dtype, device=dev, seed=seed, train=True,
                    remat=remat)
    netD = define_D(6, 32, "basic", dtype=dtype, device=dev, seed=seed + 1)
    vgg = define_vgg(4, dtype=dtype, device=dev, seed=seed + 2) if use_vgg else None
    return init_state(netG, netD, vgg, cfg, (size, size), seed=seed), make_train_step(cfg), cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    batch = int(os.environ.get("BENCH_BATCH", "16"))
    steps = int(os.environ.get("BENCH_STEPS", "20"))
    size = int(os.environ.get("BENCH_SIZE", "256"))
    use_vgg = os.environ.get("BENCH_VGG", "1") == "1"
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32

    state, step, _ = build(dev, size, use_vgg, dtype)
    rng = np.random.default_rng(0)
    real_A, real_B = (torch.from_numpy(rng.uniform(-1, 1, (batch, size, size, 3))
                                       .astype(np.float32)).to(dev) for _ in range(2))
    lr = 2e-4

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(WARMUP):
        metrics, _ = step(state, real_A, real_B, lr)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics, _ = step(state, real_A, real_B, lr)
    sync()
    dt = time.perf_counter() - t0
    print(json.dumps({
        "metric": "train_images_per_sec",
        "value": batch * steps / dt,
        "unit": "img/s",
        "step_ms": dt / steps * 1e3,
        "batch": batch,
        "size": size,
        "steps": steps,
        "vgg": use_vgg,
        "dtype": str(dtype).split(".")[-1],
        "loss_G": float(metrics["loss_G"]),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "card": card_info() if dev.type == "cuda" else None,
    }))


if __name__ == "__main__":
    main()

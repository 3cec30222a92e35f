"""The pix2pix train step, the DS-GAN trainer (port of
``dsgan_tpu/models/pix2pix.py``: ``Pix2PixConfig``, the train state and
``make_train_step``; reference DSGAN/models/pix2pix_model.py:138-217).

One step of the default recipe (conditional D, vanilla GAN loss), in the
JAX package's order:
  1. normalize the uint8 inputs; one G forward, its graph kept;
  2. the replay-pool query on the conditional [A, fake] pairs;
  3. the D update on the stacked [fake; real] batch (one D application;
     valid for D's per-sample norms):
     0.5 * (GAN(D(fake), 0) + GAN(D(real), 1)), one Adam step;
  4. the G loss against the *updated* D: GAN * w_gan + L1 + VGG * w_vgg +
     TV * w_tv + w_ss * (1 - SSIM), with the target's VGG features under
     ``no_grad``; its gradient with respect to the fake image only, so
     nothing of this pass reaches D's parameters or D's next Adam step;
  5. one G backward from that gradient (K2 / K4 at every ConvNeXt block
     on the card), one Adam step;
  6. uint8 PSNR / SSIM on the device.

Adam is ``optax.scale_by_adam(b1, 0.999, eps 1e-8)`` with the learning
rate applied after, which ``torch.optim.Adam(betas=(b1, 0.999), eps=1e-8)``
computes. Every metric stays a device tensor: a step never syncs.
"""

import dataclasses
from typing import Any, Optional

import torch

from dsgan_tpu_torch import ops
from dsgan_tpu_torch.utils.image_pool import ImagePool

CL = torch.channels_last


@dataclasses.dataclass(frozen=True)
class Pix2PixConfig:
    pool_size: int = 50
    w_gan: float = 0.01
    w_vgg: float = 1.0
    w_tv: float = 1.0
    w_ss: float = 1.25
    use_vgg: bool = True
    beta1: float = 0.5
    # dtype of the image path (None: keep the normalized inputs' f32)
    compute_dtype: Any = None


@dataclasses.dataclass
class Pix2PixState:
    """The networks, their optimizers and the replay pool; a step updates
    them in place."""
    netG: torch.nn.Module
    netD: torch.nn.Module
    vgg: Optional[torch.nn.Module]
    opt_G: torch.optim.Optimizer
    opt_D: torch.optim.Optimizer
    pool: ImagePool
    step: int = 0


def make_adam(params, beta1):
    """torch.optim.Adam with the learning rate set per step (``set_lr``)."""
    return torch.optim.Adam(params, lr=0.0, betas=(beta1, 0.999), eps=1e-8)


def set_lr(opt, lr):
    for group in opt.param_groups:
        group["lr"] = lr


def init_state(netG, netD, vgg, cfg, size, d_input_nc=6, seed=0):
    """Adam on G and D, and the pool of (d_input_nc, *size) images in the
    compute dtype on G's device, its draws seeded from ``seed``."""
    dev = next(netG.parameters()).device
    pool = ImagePool(cfg.pool_size, (d_input_nc, *size), cfg.compute_dtype or torch.float32,
                     dev, seed)
    return Pix2PixState(netG, netD, vgg, make_adam(netG.parameters(), cfg.beta1),
                        make_adam(netD.parameters(), cfg.beta1), pool)


def images(x, dtype):
    """(B, H, W, C) uint8 or [-1, 1] float -> (B, C, H, W) channels_last."""
    x = ops.normalize_u8(x).permute(0, 3, 1, 2)
    return x.to(dtype or x.dtype).contiguous(memory_format=CL)


def _target_levels(raw, real_B):
    """The target's pixel levels for the metrics: a uint8 target's own
    levels, else ``quantize_uint8`` of the image the step trained on."""
    if raw.dtype == torch.uint8:
        return raw.permute(0, 3, 1, 2).float()
    return ops.quantize_uint8(real_B)


def generator_loss(cfg, state, real_A, real_B, fake, feats_real):
    """The G loss terms (reference backward_G, pix2pix_model.py:164-199) of
    ``fake`` against the current D, under the JAX step's names;
    ``feats_real``: the target's VGG taps, or None without the VGG term."""
    aux = {"loss_vgg": torch.zeros((), device=fake.device)}
    aux["loss_G_GAN"] = ops.gan_loss(state.netD(torch.cat([real_A, fake], 1)), True, "vanilla")
    aux["loss_G_L1"] = ops.l1_loss(fake, real_B)
    if feats_real is not None:
        aux["loss_vgg"] = ops.perceptual_loss(state.vgg(fake), feats_real, num_taps=4)
    aux["loss_tv"] = ops.tv_loss(fake)
    aux["loss_ssim"] = ops.ssim_loss(real_B, fake)
    aux["loss_G"] = (aux["loss_G_GAN"] * cfg.w_gan + aux["loss_G_L1"] + aux["loss_vgg"] * cfg.w_vgg
                     + aux["loss_tv"] * cfg.w_tv + cfg.w_ss * aux["loss_ssim"])
    return aux


def make_train_step(cfg: Pix2PixConfig):
    """The step: (state, real_A, real_B, lr) -> (metrics, fake_B). Inputs
    are (B, H, W, 3) on the networks' device, uint8 or [-1, 1] float;
    ``metrics`` holds 0-d f32 device tensors under the JAX step's names;
    ``fake_B`` is the generator's output, (B, H, W, 3) f32, detached."""

    def step(state, real_A, real_B, lr):
        raw_B = real_B
        real_A = images(real_A, cfg.compute_dtype)
        real_B = images(real_B, cfg.compute_dtype)
        fake = state.netG(real_A)
        fake_sg = fake.detach()

        fake_AB = state.pool.query(torch.cat([real_A, fake_sg], 1))
        real_AB = torch.cat([real_A, real_B], 1)
        both = state.netD(torch.cat([fake_AB, real_AB], 0))
        loss_fake = ops.gan_loss(both[:fake_AB.shape[0]], False, "vanilla")
        loss_real = ops.gan_loss(both[fake_AB.shape[0]:], True, "vanilla")
        loss_D = 0.5 * (loss_fake + loss_real)
        state.opt_D.zero_grad(set_to_none=True)
        loss_D.backward()
        set_lr(state.opt_D, lr)
        state.opt_D.step()
        metrics = dict(loss_D=loss_D, loss_D_fake=loss_fake, loss_D_real=loss_real)

        feats_real = None
        if cfg.use_vgg and state.vgg is not None:
            with torch.no_grad():
                feats_real = state.vgg(real_B)
        # the G loss as a function of the fake image alone: D's parameters
        # get no gradient from it
        fake_in = fake_sg.requires_grad_(True)
        aux = generator_loss(cfg, state, real_A, real_B, fake_in, feats_real)
        (dfake,) = torch.autograd.grad(aux["loss_G"], fake_in)
        state.opt_G.zero_grad(set_to_none=True)
        fake.backward(dfake)
        set_lr(state.opt_G, lr)
        state.opt_G.step()
        metrics.update(aux)

        with torch.no_grad():
            fake_q = ops.quantize_uint8(fake_sg)
            real_q = _target_levels(raw_B, real_B)
            metrics["psnr"] = ops.psnr_uint8(real_q, fake_q)
            metrics["ssim"] = ops.ssim_uint8(real_q, fake_q)
        state.step += 1
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        return metrics, fake_sg.detach().permute(0, 2, 3, 1).float()

    return step

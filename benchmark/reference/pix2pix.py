"""DS-GAN's pix2pix recipe in plain PyTorch (yglbgyx/DS-GAN
``pix2pix_model.py``): a MixConvNeXtML generator (ngf 32), the
conditional PatchGAN ``basic`` discriminator and a VGG16 perceptual loss.

A step: G forward; the conditional pairs [A, fake] through the replay
pool; the D update 0.5 * (BCE(D(pooled), 0) + BCE(D([A, B]), 1)) and one
Adam step; the G loss against the updated D, w_gan * GAN + L1 + w_vgg *
VGG + w_tv * TV + w_ss * (1 - SSIM), and one Adam step.
"""

import torch

from benchmark.reference import losses as L
from benchmark.reference import steps
from benchmark.reference.nets import MixConvNeXtML, PatchGAN, Vgg16Taps

TV_DIVISOR = 320 * 256
TRAINED = ("G", "D")
LOSSES = ("loss_G", "loss_D")
# the weights of the block core's matrix products (K1-K4) and of the
# discriminators: the kernel_ numbers' worst leaf (``correct.py``)
KERNEL_LEAVES = r"^(G\.(c[1-5]|uc[1-4])\.(pwconv1|pwconv2|shortcut)|D\..*)\.weight$"
SERVED = "G"


def build_nets(opts, device):
    """The networks on ``device`` (uninitialised), by the program's names."""
    steps.require(opts, which_model_netG="MixConvNeXtML", ngf=32, which_model_netD="basic",
                  norm="instance")
    with torch.device(device):
        return {"G": MixConvNeXtML(), "D": PatchGAN(6, opts["ndf"], opts["n_layers_D"]),
                "vgg": Vgg16Taps()}


class Trainer(steps.Trainer):
    TRAINED = TRAINED
    POOLS = 1

    def optimizers(self):
        self.nets["vgg"].requires_grad_(False)
        return (steps.adam(self.nets["G"].parameters(), self.opts),
                steps.adam(self.nets["D"].parameters(), self.opts))

    def run(self, a, b):
        G, D, vgg, o = self.nets["G"], self.nets["D"], self.nets["vgg"], self.opts
        n, parts = a.shape[0], steps.slices(a.shape[0], self.micro)
        with torch.no_grad():
            fake = torch.cat([G(a[s]) for s in parts])
        pooled = self.pools[0].query(torch.cat([a, fake], 1))
        real_ab = torch.cat([a, b], 1)
        self.opt_D.zero_grad(set_to_none=True)
        loss_D = 0.0
        for s in parts:
            part = 0.5 * (L.bce_logits(D(pooled[s]), False, n)
                          + L.bce_logits(D(real_ab[s]), True, n))
            part.backward()
            loss_D += part.item()
        self.opt_D.step()

        D.requires_grad_(False)
        self.opt_G.zero_grad(set_to_none=True)
        loss_G = 0.0
        for s in parts:
            f = G(a[s])
            with torch.no_grad():
                taps_real = vgg(b[s])
            part = (o["w_gan"] * L.bce_logits(D(torch.cat([a[s], f], 1)), True, n)
                    + L.l1(f, b[s], n) + o["w_vgg"] * L.perceptual(vgg(f), taps_real, n)
                    + o["w_tv"] * L.total_variation(f, TV_DIVISOR)
                    + o["w_ss"] * L.ssim_loss(b[s], f, n))
            part.backward()
            loss_G += part.item()
        D.requires_grad_(True)
        self.keep_first_grads()
        self.opt_G.step()
        return {"loss_G": loss_G, "loss_D": loss_D}


def counted_step(nets, opts, a, b):
    """One step's forward and backward passes, each once, with no
    optimizer: the work the step needs, for counting on the meta device.
    ``a``, ``b``: normalized (B, 3, H, W) batches."""
    n = a.shape[0]
    G, D, vgg, o = nets["G"], nets["D"], nets["vgg"], opts
    fake = G(a)
    both = D(torch.cat([torch.cat([a, fake.detach()], 1), torch.cat([a, b], 1)]))
    (L.bce_logits(both[:n], False, n) + L.bce_logits(both[n:], True, n)).backward()
    D.requires_grad_(False)
    with torch.no_grad():
        taps_real = vgg(b)
    loss = (o["w_gan"] * L.bce_logits(D(torch.cat([a, fake], 1)), True, n)
            + L.l1(fake, b, n) + o["w_vgg"] * L.perceptual(vgg(fake), taps_real, n)
            + o["w_tv"] * L.total_variation(fake, TV_DIVISOR)
            + o["w_ss"] * L.ssim_loss(b, fake, n))
    loss.backward()
    D.requires_grad_(True)

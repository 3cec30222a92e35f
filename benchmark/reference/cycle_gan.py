"""DS-GAN's CycleGAN recipe in plain PyTorch (yglbgyx/DS-GAN
``cycle_gan_model.py``; Zhu et al. 2017): two MixConvNeXtML generators
(ngf 32) and two PatchGAN ``basic`` discriminators.

A step: fake_B = G_A(A), rec_A = G_B(fake_B), fake_A = G_B(B), rec_B =
G_A(fake_A), idt_A = G_A(B), idt_B = G_B(A); the G loss against the
current Ds (least squares), the cycle and identity L1s and TV(fake_B) /
256^2, one joint Adam step on G_A + G_B; then each D on its real side and
its pooled fakes (``pool_B`` holds fake_B for D_A, ``pool_A`` fake_A for
D_B), one joint Adam step on D_A + D_B.
"""

import itertools

import torch

from benchmark.reference import losses as L
from benchmark.reference import steps
from benchmark.reference.nets import MixConvNeXtML, PatchGAN

TV_DIVISOR = 256 * 256
TRAINED = ("G_A", "G_B", "D_A", "D_B")
LOSSES = ("loss_G", "loss_D_A", "loss_D_B")
# the weights of the block core's matrix products (K1-K4) and of the
# discriminators: the kernel_ numbers' worst leaf (``correct.py``)
KERNEL_LEAVES = r"^(G_[AB]\.(c[1-5]|uc[1-4])\.(pwconv1|pwconv2|shortcut)|D_[AB]\..*)\.weight$"
SERVED = "G_A"


def build_nets(opts, device):
    """The networks on ``device`` (uninitialised), by the program's names."""
    steps.require(opts, which_model_netG="MixConvNeXtML", ngf=32, which_model_netD="basic",
                  norm="instance")
    with torch.device(device):
        return {"G_A": MixConvNeXtML(), "G_B": MixConvNeXtML(),
                "D_A": PatchGAN(3, opts["ndf"], opts["n_layers_D"]),
                "D_B": PatchGAN(3, opts["ndf"], opts["n_layers_D"])}


class Trainer(steps.Trainer):
    TRAINED = TRAINED
    POOLS = 2  # pool_A (fake_A, for D_B), pool_B (fake_B, for D_A)

    def optimizers(self):
        n = self.nets
        return (steps.adam(itertools.chain(n["G_A"].parameters(), n["G_B"].parameters()),
                           self.opts),
                steps.adam(itertools.chain(n["D_A"].parameters(), n["D_B"].parameters()),
                           self.opts))

    def run(self, a, b):
        G_A, G_B, D_A, D_B = (self.nets[k] for k in TRAINED)
        o = self.opts
        la, lb, li = o["lambda_A"], o["lambda_B"], o["lambda_identity"]
        n, parts = a.shape[0], steps.slices(a.shape[0], self.micro)
        for d in (D_A, D_B):
            d.requires_grad_(False)
        self.opt_G.zero_grad(set_to_none=True)
        loss_G, fakes_B, fakes_A = 0.0, [], []
        for s in parts:
            fake_B, fake_A = G_A(a[s]), G_B(b[s])
            part = (L.least_squares(D_A(fake_B), True, n) + L.least_squares(D_B(fake_A), True, n)
                    + la * L.l1(G_B(fake_B), a[s], n) + lb * L.l1(G_A(fake_A), b[s], n)
                    + lb * li * L.l1(G_A(b[s]), b[s], n) + la * li * L.l1(G_B(a[s]), a[s], n)
                    + L.total_variation(fake_B, TV_DIVISOR))
            part.backward()
            loss_G += part.item()
            fakes_B.append(fake_B.detach())
            fakes_A.append(fake_A.detach())
        for d in (D_A, D_B):
            d.requires_grad_(True)
        self.keep_first_grads(("G_A", "G_B"))
        self.opt_G.step()

        pooled_B = self.pools[1].query(torch.cat(fakes_B))
        pooled_A = self.pools[0].query(torch.cat(fakes_A))
        self.opt_D.zero_grad(set_to_none=True)
        loss_D_A = loss_D_B = 0.0
        for s in parts:
            part_a = 0.5 * (L.least_squares(D_A(b[s]), True, n)
                            + L.least_squares(D_A(pooled_B[s]), False, n))
            part_b = 0.5 * (L.least_squares(D_B(a[s]), True, n)
                            + L.least_squares(D_B(pooled_A[s]), False, n))
            (part_a + part_b).backward()
            loss_D_A += part_a.item()
            loss_D_B += part_b.item()
        self.keep_first_grads(("D_A", "D_B"))
        self.opt_D.step()
        return {"loss_G": loss_G, "loss_D_A": loss_D_A, "loss_D_B": loss_D_B}


def counted_step(nets, opts, a, b):
    """One step's forward and backward passes, each once, with no
    optimizer: the work the step needs, for counting on the meta device.
    ``a``, ``b``: normalized (B, 3, H, W) batches."""
    n = a.shape[0]
    G_A, G_B, D_A, D_B = (nets[k] for k in TRAINED)
    for d in (D_A, D_B):
        d.requires_grad_(False)
    fake_B, fake_A = G_A(a), G_B(b)
    loss = (L.least_squares(D_A(fake_B), True, n) + L.least_squares(D_B(fake_A), True, n)
            + L.l1(G_B(fake_B), a, n) + L.l1(G_A(fake_A), b, n) + L.l1(G_A(b), b, n)
            + L.l1(G_B(a), a, n) + L.total_variation(fake_B, TV_DIVISOR))
    loss.backward()
    for d in (D_A, D_B):
        d.requires_grad_(True)
    loss_D = (L.least_squares(D_A(b), True, n) + L.least_squares(D_A(fake_B.detach()), False, n)
              + L.least_squares(D_B(a), True, n)
              + L.least_squares(D_B(fake_A.detach()), False, n))
    loss_D.backward()

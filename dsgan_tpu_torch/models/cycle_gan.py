"""The CycleGAN trainer (port of ``dsgan_tpu/models/cycle_gan.py``:
``CycleGANConfig``, the train state, ``make_cyclegan_step`` and the
``CycleGANModel`` shell the CLIs drive; reference DSGAN/models/
cycle_gan_model.py:84-159).

One step, in the JAX package's order, which is the opposite of pix2pix's:
  1. normalize the uint8 inputs (f32: each network casts its input to its
     compute dtype, as the JAX networks do);
  2. the six generator applications, in program order: fake_B = G_A(A),
     rec_A = G_B(fake_B), fake_A = G_B(B), rec_B = G_A(fake_A), and with
     ``lambda_identity > 0`` idt_A = G_A(B), idt_B = G_B(A);
  3. the G loss against the *current* Ds: GAN(D_A(fake_B), 1) +
     GAN(D_B(fake_A), 1) + the cycle L1s * lambda_A / lambda_B + the
     identity L1s * lambda * lambda_identity + TV(fake_B) / (256 * 256); its
     gradient with respect to the generators' parameters alone, so that
     nothing of this pass reaches D_A or D_B (``backward(inputs=...)``),
     one joint Adam step on G_A + G_B;
  4. the two replay pools: ``pool_B`` takes fake_B for D_A, ``pool_A``
     fake_A for D_B, each with its own generator;
  5. the D update: 0.5 * (GAN(D(real), 1) + GAN(D(pooled fake), 0)) for
     each D, one joint Adam step on D_A + D_B;
  6. uint8 PSNR / SSIM of quantize(fake_B) against real_B's levels: a
     uint8 target keeps its own, as JAX's jitted step gives them (XLA folds
     normalize -> quantize; quantizing the normalized f32 target in eager
     arithmetic would put 63 of the 256 levels one below their own), a
     float target is quantized (``pix2pix._target_levels``: real_B here is
     f32 in either compute dtype).

The GAN criterion is LSGAN unless ``--no_lsgan`` (then vanilla, with a
sigmoid D), the reverse of pix2pix's default, as the JAX package wires it.
Under ``--norm batch`` each application updates its network's running
statistics once, in program order: the G pass moves D_A's and D_B's (on
the fakes) before their own update. Dropout draws from the state's one
generator, shared by both generators.

A joint Adam over two networks is one Adam per parameter (it is
elementwise), so ``pix2pix.make_adam`` over the chained parameters is the
JAX package's joint ``sgd_apply`` step. With MixConvNeXtML generators,
every ConvNeXt block of the six applications runs K1 / K3 forward and
K2 / K4 backward on the card: 30 K1 + 24 K3 + 30 K2 + 24 K4 a step with
the identity terms. rec_A and rec_B send the input gradient of one
generator (c1's K2 ``dx`` and its folded ``dn``) into the other's backward.

On a spatial axis (``parallel.spatial``) the step and the eval forward
run on this rank's strip of the image rows: every loss term is a rank's
share, the pools hold strips of (H / S)-row images and draw per image,
alike on every rank, and the checkpoint joins both pools' strips into
whole images (``CycleGANModel.POOLS``).
"""

import dataclasses
import itertools

import torch

from dsgan_tpu_torch import ops
from dsgan_tpu_torch.models.base_model import BaseModel, ChainedStep
from dsgan_tpu_torch.models.layers import set_dropout_generator
from dsgan_tpu_torch.models.pix2pix import (
    Pix2PixModel,
    _target_levels,
    images,
    load_adam,
    make_adam,
    set_lr,
)
from dsgan_tpu_torch.models.registry import define_D, define_G
from dsgan_tpu_torch.parallel import (
    data_size,
    query_pool,
    reduce_gradients,
    reduce_metrics,
    spatial,
)
from dsgan_tpu_torch.utils import checkpoint as ckpt
from dsgan_tpu_torch.utils.image_pool import ImagePool

# the TV term's divisor (cycle_gan.py:105); pix2pix divides by 320 * 256
TV_DIVISOR = 256 * 256
NETS = ("netG_A", "netG_B", "netD_A", "netD_B")


@dataclasses.dataclass(frozen=True)
class CycleGANConfig:
    gan_mode: str = "lsgan"         # 'lsgan' | 'vanilla'
    pool_size: int = 50
    lambda_A: float = 10.0
    lambda_B: float = 10.0
    lambda_identity: float = 0.5
    beta1: float = 0.5


@dataclasses.dataclass
class CycleGANState:
    """The four networks (BatchNorm running statistics are their buffers),
    the two joint optimizers, the two pools, the step counter (a 0-d int64
    device tensor) and the generators' dropout generator; a step updates
    them in place."""
    netG_A: torch.nn.Module
    netG_B: torch.nn.Module
    netD_A: torch.nn.Module
    netD_B: torch.nn.Module
    opt_G: torch.optim.Optimizer
    opt_D: torch.optim.Optimizer
    pool_A: ImagePool
    pool_B: ImagePool
    step: torch.Tensor
    dropout: torch.Generator

    def g_parameters(self):
        return list(itertools.chain(self.netG_A.parameters(), self.netG_B.parameters()))

    def state_dict(self):
        """Everything a step reads and writes, for an exact resume."""
        out = {name: getattr(self, name).state_dict() for name in NETS}
        for side, pool in (("A", self.pool_A), ("B", self.pool_B)):
            out.update({f"pool_{side}_images": pool.images, f"pool_{side}_count": pool.count,
                        f"pool_{side}_generator": pool.generator.get_state()})
        out.update(opt_G=self.opt_G.state_dict(), opt_D=self.opt_D.state_dict(), step=self.step,
                   dropout_generator=self.dropout.get_state())
        return out

    def load_state_dict(self, st):
        """Load a ``state_dict`` written in either mode (card or CPU)."""
        for name in NETS:
            getattr(self, name).load_state_dict(st[name])
        load_adam(self.opt_G, st["opt_G"])
        load_adam(self.opt_D, st["opt_D"])
        for side, pool in (("A", self.pool_A), ("B", self.pool_B)):
            pool.images.copy_(st[f"pool_{side}_images"])
            pool.count = int(st[f"pool_{side}_count"])
            pool.generator.set_state(st[f"pool_{side}_generator"])
        self.step.fill_(int(st["step"]))
        self.dropout.set_state(st["dropout_generator"])


def init_state(G_A, G_B, D_A, D_B, cfg, size, input_nc=3, output_nc=3, seed=0):
    """The joint Adams, the pools of (input_nc, *size) fake_A and
    (output_nc, *size) fake_B images in f32 on G_A's device (on a spatial
    axis ``size`` is a strip's: (H / S, W)), their draws seeded from
    ``seed`` (pool_A) and ``seed + 2`` (pool_B), the step counter at 0, and
    the dropout generator, seeded from ``seed + 1``."""
    dev = next(G_A.parameters()).device
    dropout = torch.Generator(device=dev).manual_seed(seed + 1)
    for g in (G_A, G_B):
        set_dropout_generator(g, dropout)
    return CycleGANState(
        G_A, G_B, D_A, D_B,
        make_adam(itertools.chain(G_A.parameters(), G_B.parameters()), cfg.beta1),
        make_adam(itertools.chain(D_A.parameters(), D_B.parameters()), cfg.beta1),
        ImagePool(cfg.pool_size, (input_nc, *size), torch.float32, dev, seed),
        ImagePool(cfg.pool_size, (output_nc, *size), torch.float32, dev, seed + 2),
        torch.zeros((), dtype=torch.int64, device=dev), dropout)


def chained_cyclegan_step(step, cfg, warmup=1):
    """``step`` k steps a chunk (``ChainedStep``): captured once both pools
    are full, with both pools' and the dropout's generators registered."""
    return ChainedStep(step, ready=lambda s: s.pool_A.full and s.pool_B.full,
                       generators=lambda s: (s.pool_A.generator, s.pool_B.generator, s.dropout),
                       warmup=warmup)


def nhwc(x):
    return x.detach().permute(0, 2, 3, 1).float()


def generator_loss(cfg, state, real_A, real_B, mesh=None):
    """The six generator applications and the G loss terms (cycle_gan.py:
    80-119) against the current Ds, under the JAX step's names, and the
    images: (losses, fake_B, rec_A, fake_A, rec_B). ``real_A`` / ``real_B``
    are normalized (B, C, H, W) f32 batches. On a mesh the TV sum is this
    rank's part times the data size (``pix2pix.generator_loss``)."""
    G_A, G_B, D_A, D_B = state.netG_A, state.netG_B, state.netD_A, state.netD_B
    mode = cfg.gan_mode
    fake_B = G_A(real_A)
    rec_A = G_B(fake_B)
    fake_A = G_B(real_B)
    rec_B = G_A(fake_A)
    m = {}
    if cfg.lambda_identity > 0:
        m["loss_idt_A"] = ops.l1_loss(G_A(real_B), real_B) * cfg.lambda_B * cfg.lambda_identity
        m["loss_idt_B"] = ops.l1_loss(G_B(real_A), real_A) * cfg.lambda_A * cfg.lambda_identity
    else:
        m["loss_idt_A"] = m["loss_idt_B"] = torch.zeros((), device=real_A.device)
    m["loss_G_A"] = ops.gan_loss(D_A(fake_B), True, mode)
    m["loss_G_B"] = ops.gan_loss(D_B(fake_A), True, mode)
    m["loss_cycle_A"] = ops.l1_loss(rec_A, real_A) * cfg.lambda_A
    m["loss_cycle_B"] = ops.l1_loss(rec_B, real_B) * cfg.lambda_B
    m["loss_tv"] = ops.tv_loss(fake_B, divisor=TV_DIVISOR / data_size(mesh))
    m["loss_G"] = (m["loss_G_A"] + m["loss_G_B"] + m["loss_cycle_A"] + m["loss_cycle_B"]
                   + m["loss_idt_A"] + m["loss_idt_B"] + m["loss_tv"])
    return m, fake_B, rec_A, fake_A, rec_B


def make_cyclegan_step(cfg: CycleGANConfig, mesh=None):
    """The step: (state, real_A, real_B, lr) -> (metrics, visuals). Inputs
    are (B, H, W, C) on the networks' device, uint8 or [-1, 1] float;
    ``lr`` a float or a 0-d device tensor; ``metrics`` holds 0-d f32 device
    tensors under the JAX step's names; ``visuals`` is one (B, H, W,
    2 * (output_nc + input_nc)) f32 tensor, the channel concat of fake_B,
    rec_A, fake_A and rec_B (``split_visuals``), detached. On a ``mesh``
    the inputs are this rank's rows (and on a spatial axis its strip of
    their image rows, the step running under ``spatial.rows(mesh)``, every
    loss term a rank's share); the two pools are queried on the global
    batch, per image, with the same draws on every rank
    (``parallel.mesh``). On a strip the G-only backward still carries the
    halo cotangents through D_A and D_B: every rank of a row group builds
    the same graph, so its exchanges run in the same order on each."""

    def step(state, real_A, real_B, lr):
        with spatial.rows(mesh):
            return _step(state, real_A, real_B, lr)

    def _step(state, real_A, real_B, lr):
        D_A, D_B = state.netD_A, state.netD_B
        raw_B = real_B
        real_A, real_B = images(real_A, None), images(real_B, None)
        mode = cfg.gan_mode
        m, fake_B, rec_A, fake_A, rec_B = generator_loss(cfg, state, real_A, real_B, mesh)
        # the G parameters' gradient only: D_A and D_B get none from this pass
        # (``inputs``), and each gradient takes its parameter's layout, which
        # Adam's multi-tensor kernels need to stay fast
        state.opt_G.zero_grad(set_to_none=True)
        m["loss_G"].backward(inputs=state.g_parameters())
        reduce_gradients(state.opt_G, mesh)
        set_lr(state.opt_G, lr)
        state.opt_G.step()

        fake_B, fake_A = fake_B.detach(), fake_A.detach()
        pooled_B = query_pool(state.pool_B, fake_B, mesh)
        pooled_A = query_pool(state.pool_A, fake_A, mesh)
        m["loss_D_A"] = 0.5 * (ops.gan_loss(D_A(real_B), True, mode)
                               + ops.gan_loss(D_A(pooled_B), False, mode))
        m["loss_D_B"] = 0.5 * (ops.gan_loss(D_B(real_A), True, mode)
                               + ops.gan_loss(D_B(pooled_A), False, mode))
        state.opt_D.zero_grad(set_to_none=True)
        (m["loss_D_A"] + m["loss_D_B"]).backward()
        reduce_gradients(state.opt_D, mesh)
        set_lr(state.opt_D, lr)
        state.opt_D.step()

        with torch.no_grad():
            fake_q, real_q = ops.quantize_uint8(fake_B), _target_levels(raw_B, real_B)
            m["ssim"] = ops.ssim_uint8(real_q, fake_q)
            m = reduce_metrics(m, mesh, ops.mse_uint8(real_q, fake_q))
        state.step += 1
        visuals = torch.cat([nhwc(t) for t in (fake_B, rec_A, fake_A, rec_B)], -1)
        return m, visuals

    return step


def split_visuals(out, input_nc, output_nc):
    """The step's visuals tensor -> {fake_B, rec_A, fake_A, rec_B}."""
    widths = (output_nc, input_nc, input_nc, output_nc)
    return dict(zip(("fake_B", "rec_A", "fake_A", "rec_B"), torch.split(out, widths, -1)))


class CycleGANModel(Pix2PixModel):
    """The shell over the step (``dsgan_tpu/models/cycle_gan.py:184-416``):
    options -> four networks -> state -> step. The data side (set_input,
    chunks), the getters and the checkpoint's join of the pools' strips
    are pix2pix's."""

    POOLS = ("pool_A_images", "pool_B_images")

    def name(self):
        return "CycleGANModel"

    @staticmethod
    def modify_commandline_options(parser, is_train=True):
        if is_train:
            parser.add_argument("--lambda_A", type=float, default=10.0,
                                help="weight for cycle loss (A -> B -> A)")
            parser.add_argument("--lambda_B", type=float, default=10.0,
                                help="weight for cycle loss (B -> A -> B)")
            parser.add_argument("--lambda_identity", type=float, default=0.5,
                                help="identity mapping loss weight scale")
        return parser

    def initialize(self, opt):
        BaseModel.initialize(self, opt)
        self.loss_names = ["D_A", "G_A", "cycle_A", "idt_A", "D_B", "G_B", "cycle_B", "idt_B"]
        self.visual_names = ["real_A", "fake_B", "rec_A", "real_B", "fake_A", "rec_B"]
        dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
        self.dtype = dtype
        self.compute_dtype = dtype if dtype == torch.bfloat16 else None
        dev = self.device
        common = dict(norm=opt.norm, use_dropout=not opt.no_dropout, init_type=opt.init_type,
                      dtype=dtype, device=dev, gelu_mode=opt.gelu, train=self.isTrain)
        self.netG_A = define_G(opt.input_nc, opt.output_nc, opt.ngf, opt.which_model_netG,
                               seed=opt.seed, **common)
        self.netG_B = define_G(opt.output_nc, opt.input_nc, opt.ngf, opt.which_model_netG,
                               seed=opt.seed + 1, **common)
        self.state = None
        if not self.isTrain:
            return
        # use_lsgan = not no_lsgan (cycle_gan_model.py:63); --no_lsgan also
        # gives each D a sigmoid, as the JAX package wires it
        d = dict(norm=opt.norm, init_type=opt.init_type, dtype=dtype, device=dev,
                 use_sigmoid=opt.no_lsgan)
        self.netD_A = define_D(opt.output_nc, opt.ndf, opt.which_model_netD, opt.n_layers_D,
                               seed=opt.seed + 2, **d)
        self.netD_B = define_D(opt.input_nc, opt.ndf, opt.which_model_netD, opt.n_layers_D,
                               seed=opt.seed + 3, **d)
        self.cfg = CycleGANConfig(gan_mode="vanilla" if opt.no_lsgan else "lsgan",
                                  pool_size=opt.pool_size, lambda_A=opt.lambda_A,
                                  lambda_B=opt.lambda_B, lambda_identity=opt.lambda_identity,
                                  beta1=opt.beta1)
        rows = opt.fineSize_h // (self.mesh.spatial if self.mesh is not None else 1)
        self.state = init_state(self.netG_A, self.netG_B, self.netD_A, self.netD_B, self.cfg,
                                (rows, opt.fineSize_w), opt.input_nc, opt.output_nc,
                                seed=opt.seed)
        self._on_mesh(self.netG_A, self.netG_B, self.netD_A, self.netD_B)
        self._step_fn = make_cyclegan_step(self.cfg, self.mesh)
        self._chained = chained_cyclegan_step(self._step_fn, self.cfg)

    def _networks(self):
        nets = {"G_A": self.netG_A, "G_B": self.netG_B}
        if self.isTrain:
            nets.update(D_A=self.netD_A, D_B=self.netD_B)
        return nets

    def _set_visuals(self, out):
        for k, v in split_visuals(out, self.opt.input_nc, self.opt.output_nc).items():
            setattr(self, k, v)

    # -- step --------------------------------------------------------------
    def optimize_parameters(self):
        self._metrics, out = self._step_fn(self.state, self.real_A, self.real_B, self.lr)
        self._set_visuals(out)
        self._host_metrics = None

    def optimize_parameters_chunk(self):
        """The staged chunk's steps, as ``Pix2PixModel``'s: a CUDA graph
        replayed once both pools are full."""
        Pix2PixModel.optimize_parameters_chunk(self)
        self._set_visuals(self.fake_B)

    def forward(self):
        """fake_B, rec_A, fake_A and rec_B in eval mode and inference mode,
        (B, H, W, C) f32 on the device: no autograd records, so every
        ConvNeXt block takes the registered ops (K1 / K3 on the card). On a
        spatial axis each is this rank's strip; the visuals and getters join
        them."""
        nets = (self.netG_A, self.netG_B)
        was = [n.training for n in nets]
        for n in nets:
            n.eval()
        with torch.inference_mode(), spatial.rows(self.mesh):
            fake_B = self.netG_A(images(self.real_A, self.compute_dtype))
            rec_A = self.netG_B(fake_B)
            fake_A = self.netG_B(images(self.real_B, self.compute_dtype))
            rec_B = self.netG_A(fake_A)
            for k, v in (("fake_B", fake_B), ("rec_A", rec_A), ("fake_A", fake_A),
                         ("rec_B", rec_B)):
                setattr(self, k, nhwc(v))
        for n, w in zip(nets, was):
            n.train(w)
        return self.fake_B

    # -- persistence -------------------------------------------------------
    def load_networks(self, which_epoch):
        if self.isTrain:
            return BaseModel.load_networks(self, which_epoch)
        # inference: the two generators, their BatchNorm buffers included
        which_epoch = self._resolve_epoch(which_epoch)
        st = ckpt.restore_state(self.save_dir, which_epoch)
        self.netG_A.load_state_dict(st["netG_A"])
        self.netG_B.load_state_dict(st["netG_B"])
        print(f"loaded generators from epoch {which_epoch} checkpoint")

    def load_generator_npz(self, path):
        raise NotImplementedError("--load_npz carries one generator: CycleGAN evaluates the "
                                  "G_A / G_B pair of a train checkpoint")


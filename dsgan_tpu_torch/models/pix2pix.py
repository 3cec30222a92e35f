"""The pix2pix trainer, DS-GAN's (port of ``dsgan_tpu/models/pix2pix.py``:
``Pix2PixConfig``, the train state, ``make_train_step`` and the
``Pix2PixModel`` shell the CLIs drive; reference DSGAN/models/
pix2pix_model.py:138-217).

One step, in the JAX package's order (the default recipe: conditional D,
vanilla GAN loss):
  1. normalize the uint8 inputs; one G forward, its graph kept;
  2. the replay-pool query on the conditional [A, fake] pairs (the fake
     alone with ``use_condition`` off);
  3. the D update: 0.5 * (GAN(D(fake), 0) + GAN(D(real), 1)), one Adam
     step; D runs once on the stacked [fake; real] batch where its norms
     are per sample (``fuse_d_batch``), else on the fake batch and then the
     real one, the reference's order, so that BatchNorm's batch statistics
     and running averages are those of each batch; with ``use_gan`` off,
     no D update and the D losses are 0;
  4. the G loss against the *updated* D: GAN * w_gan + L1 + VGG * w_vgg +
     TV * w_tv + w_ss * (1 - SSIM), with the target's VGG features under
     ``no_grad``; its gradient with respect to the fake image only, so
     nothing of this pass reaches D's parameters or D's next Adam step;
  5. one G backward from that gradient (K2 / K4 at every ConvNeXt block
     on the card), one Adam step;
  6. uint8 PSNR / SSIM on the device.

Under ``--norm batch`` a step updates G's running statistics once (its
forward) and D's three times (fake, real, and the G loss's forward), as
the JAX step does (``dsgan_tpu/models/pix2pix.py:142-144,213-218``): the
pool, the metrics and the visuals run no train-mode forward. Dropout
(the resnet and unet generators without ``--no_dropout``) draws its masks
from the state's own generator.

Adam is ``optax.scale_by_adam(b1, 0.999, eps 1e-8)`` with the learning
rate applied after, which ``torch.optim.Adam(betas=(b1, 0.999), eps=1e-8)``
computes; on the card it is capturable, with its rate a 0-d device
tensor, so that the step can be captured in a CUDA graph (``Pix2PixModel.
optimize_parameters_chunk``). Every metric, and the step counter, stays a
device tensor: a step never syncs.
"""

import dataclasses
import warnings
from typing import Any, Optional

import numpy as np
import torch

from dsgan_tpu_torch import ops
from dsgan_tpu_torch.models.base_model import BaseModel, ChainedStep
from dsgan_tpu_torch.models.layers import set_dropout_generator
from dsgan_tpu_torch.models.registry import define_D, define_G, define_vgg, generator_entries
from dsgan_tpu_torch.parallel import (
    data_size,
    gather_image_rows,
    query_pool,
    reduce_gradients,
    reduce_metrics,
    spatial,
)
from dsgan_tpu_torch.utils import checkpoint as ckpt
from dsgan_tpu_torch.utils.convert import (
    load_params_npz,
    load_torchvision_npz,
    state_dict_from_jax,
)
from dsgan_tpu_torch.utils.image_pool import ImagePool

CL = torch.channels_last


@dataclasses.dataclass(frozen=True)
class Pix2PixConfig:
    gan_mode: str = "vanilla"       # 'vanilla' | 'lsgan' | 'bce'
    use_gan: bool = True
    use_condition: bool = True
    pool_size: int = 50
    w_gan: float = 0.01
    w_vgg: float = 1.0
    w_tv: float = 1.0
    w_ss: float = 1.25
    use_vgg: bool = True
    beta1: float = 0.5
    # dtype of the image path (None: keep the normalized inputs' f32)
    compute_dtype: Any = None
    # one D application on [fake; real]: valid for per-sample norms
    # (instance / none), not for BatchNorm, whose batch statistics differ
    fuse_d_batch: bool = True


@dataclasses.dataclass
class Pix2PixState:
    """The networks (BatchNorm running statistics are their buffers), their
    optimizers, the replay pool, the step counter (a 0-d int64 tensor on
    the networks' device, so that a replayed step advances it) and the
    generator G's dropout draws from; a step updates them in place."""
    netG: torch.nn.Module
    netD: torch.nn.Module
    vgg: Optional[torch.nn.Module]
    opt_G: torch.optim.Optimizer
    opt_D: torch.optim.Optimizer
    pool: ImagePool
    step: torch.Tensor
    dropout: torch.Generator

    def state_dict(self):
        """Everything a step reads and writes, for an exact resume. The
        tensors are the state's own: copy them to keep them apart."""
        pool = self.pool
        return {"netG": self.netG.state_dict(), "netD": self.netD.state_dict(),
                "opt_G": self.opt_G.state_dict(), "opt_D": self.opt_D.state_dict(),
                "pool_images": pool.images, "pool_count": pool.count,
                "pool_generator": pool.generator.get_state(), "step": self.step,
                "dropout_generator": self.dropout.get_state()}

    def load_state_dict(self, st):
        """Load a ``state_dict`` written in either mode (card or CPU)."""
        self.netG.load_state_dict(st["netG"])
        self.netD.load_state_dict(st["netD"])
        load_adam(self.opt_G, st["opt_G"])
        load_adam(self.opt_D, st["opt_D"])
        self.pool.images.copy_(st["pool_images"])
        self.pool.count = int(st["pool_count"])
        self.pool.generator.set_state(st["pool_generator"])
        self.step.fill_(int(st["step"]))
        if "dropout_generator" in st:  # checkpoints before the zoo lack it
            self.dropout.set_state(st["dropout_generator"])


def make_adam(params, beta1):
    """torch.optim.Adam with the learning rate set per step (``set_lr``).
    On the card it is capturable and holds its rate as a 0-d f32 device
    tensor, which ``set_lr`` fills in place: a step captured in a CUDA
    graph reads at each replay the rate written before it, and the eager
    steps on the card run the same arithmetic. On the CPU the rate is a
    float, as before."""
    params = list(params)
    cuda = params[0].is_cuda
    lr = torch.zeros((), dtype=torch.float32, device=params[0].device) if cuda else 0.0
    return torch.optim.Adam(params, lr=lr, betas=(beta1, 0.999), eps=1e-8, capturable=cuda)


def set_lr(opt, lr):
    """Set every group's rate to ``lr`` (a float, or a 0-d device tensor that
    a captured step reads)."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def load_adam(opt, sd):
    """``opt.load_state_dict(sd)`` whatever mode wrote ``sd``: the groups
    keep this optimizer's ``capturable`` flag and rate holder, and the step
    counts land where its mode keeps them (the card's capturable Adam on
    the device, the CPU's on the CPU)."""
    own = [(g["lr"], g["capturable"]) for g in opt.param_groups]
    groups = [dict(g, capturable=cap) for g, (_, cap) in zip(sd["param_groups"], own)]
    opt.load_state_dict(dict(sd, param_groups=groups))
    for g, (lr, _) in zip(opt.param_groups, own):
        g["lr"] = lr
    if not own[0][1]:
        for st in opt.state.values():
            st["step"] = st["step"].cpu()


def init_state(netG, netD, vgg, cfg, size, d_input_nc=6, seed=0):
    """Adam on G and D, the pool of (d_input_nc, *size) images in the
    compute dtype on G's device, its draws seeded from ``seed``, the step
    counter at 0, and G's dropout generator, seeded from ``seed + 1``."""
    dev = next(netG.parameters()).device
    pool = ImagePool(cfg.pool_size, (d_input_nc, *size), cfg.compute_dtype or torch.float32,
                     dev, seed)
    dropout = torch.Generator(device=dev).manual_seed(seed + 1)
    set_dropout_generator(netG, dropout)
    return Pix2PixState(netG, netD, vgg, make_adam(netG.parameters(), cfg.beta1),
                        make_adam(netD.parameters(), cfg.beta1), pool,
                        torch.zeros((), dtype=torch.int64, device=dev), dropout)


def chained_train_step(step, cfg, warmup=1):
    """``step`` k steps a chunk (``ChainedStep``): captured once the
    replay pool is full (its host-side insert-or-replay branch then stays
    put), with the pool's and the dropout's generators registered with the
    graph."""
    return ChainedStep(step, ready=lambda s: not cfg.use_gan or s.pool.full,
                       generators=lambda s: (s.pool.generator, s.dropout), warmup=warmup)


def images(x, dtype):
    """(B, H, W, C) uint8 or [-1, 1] float -> (B, C, H, W) channels_last."""
    x = ops.normalize_u8(x).permute(0, 3, 1, 2)
    return x.to(dtype or x.dtype).contiguous(memory_format=CL)


def _target_levels(raw, real_B):
    """The target's pixel levels for the metrics, as JAX's jitted step
    gives them: in f32 XLA fuses normalize -> quantize and a uint8 target
    keeps its own levels; in a narrower compute dtype it quantizes the
    target the step trained on (bf16 puts 127 of the 256 levels one
    below their own)."""
    if raw.dtype == torch.uint8 and real_B.dtype == torch.float32:
        return raw.permute(0, 3, 1, 2).float()
    return ops.quantize_uint8(real_B)


def d_input(cfg, real_A, img):
    """What D sees of an image: the [A, image] pair, or the image alone."""
    return torch.cat([real_A, img], 1) if cfg.use_condition else img


def _split_scales(pred, n):
    """A D output on the stacked [fake; real] batch (a tensor, or a
    multiscale D's nested lists) -> (fake part, real part)."""
    if isinstance(pred, (list, tuple)):
        pairs = [_split_scales(p, n) for p in pred]
        return [p[0] for p in pairs], [p[1] for p in pairs]
    return pred[:n], pred[n:]


def generator_loss(cfg, state, real_A, real_B, fake, feats_real, mesh=None):
    """The G loss terms (reference backward_G, pix2pix_model.py:164-199) of
    ``fake`` against the current D, under the JAX step's names;
    ``feats_real``: the target's VGG taps, or None without the VGG term. On
    a mesh each term is this rank's share (``parallel.mesh``): the TV term,
    a sum over the batch and its image rows, is this rank's part times the
    data size (its divisor over it), so that the shares summed over the
    mesh and divided by the data size are the global sum."""
    zero = torch.zeros((), device=fake.device)
    aux = {"loss_vgg": zero, "loss_G_GAN": zero}
    if cfg.use_gan:
        aux["loss_G_GAN"] = ops.gan_loss(state.netD(d_input(cfg, real_A, fake)), True,
                                         cfg.gan_mode)
    aux["loss_G_L1"] = ops.l1_loss(fake, real_B)
    if feats_real is not None:
        aux["loss_vgg"] = ops.perceptual_loss(state.vgg(fake), feats_real, num_taps=4)
    aux["loss_tv"] = ops.tv_loss(fake, divisor=ops.TV_DIVISOR / data_size(mesh))
    aux["loss_ssim"] = ops.ssim_loss(real_B, fake)
    aux["loss_G"] = (aux["loss_G_GAN"] * cfg.w_gan + aux["loss_G_L1"] + aux["loss_vgg"] * cfg.w_vgg
                     + aux["loss_tv"] * cfg.w_tv + cfg.w_ss * aux["loss_ssim"])
    return aux


def make_train_step(cfg: Pix2PixConfig, mesh=None):
    """The step: (state, real_A, real_B, lr) -> (metrics, fake_B). Inputs
    are (B, H, W, 3) on the networks' device, uint8 or [-1, 1] float;
    ``lr`` a float, or a 0-d device tensor (the captured step's);
    ``metrics`` holds 0-d f32 device tensors under the JAX step's names;
    ``fake_B`` is the generator's output, (B, H, W, 3) f32, detached. On a
    ``mesh`` the inputs are this rank's rows (and on a spatial axis its
    strip of their image rows, the step running under
    ``spatial.rows(mesh)``), and the metrics and the updates are the
    global batch's (``parallel.mesh``)."""

    def step(state, real_A, real_B, lr):
        with spatial.rows(mesh):
            return _step(state, real_A, real_B, lr)

    def _step(state, real_A, real_B, lr):
        raw_B = real_B
        real_A = images(real_A, cfg.compute_dtype)
        real_B = images(real_B, cfg.compute_dtype)
        fake = state.netG(real_A)
        fake_sg = fake.detach()

        if cfg.use_gan:
            fake_AB = query_pool(state.pool, d_input(cfg, real_A, fake_sg), mesh)
            real_AB = d_input(cfg, real_A, real_B)
            if cfg.fuse_d_batch:
                both = state.netD(torch.cat([fake_AB, real_AB], 0))
                pred_fake, pred_real = _split_scales(both, fake_AB.shape[0])
            else:
                pred_fake, pred_real = state.netD(fake_AB), state.netD(real_AB)
            loss_fake = ops.gan_loss(pred_fake, False, cfg.gan_mode)
            loss_real = ops.gan_loss(pred_real, True, cfg.gan_mode)
            loss_D = 0.5 * (loss_fake + loss_real)
            state.opt_D.zero_grad(set_to_none=True)
            loss_D.backward()
            reduce_gradients(state.opt_D, mesh)
            set_lr(state.opt_D, lr)
            state.opt_D.step()
            metrics = dict(loss_D=loss_D, loss_D_fake=loss_fake, loss_D_real=loss_real)
        else:
            zero = torch.zeros((), device=fake.device)
            metrics = dict(loss_D=zero, loss_D_fake=zero, loss_D_real=zero)

        feats_real = None
        if cfg.use_vgg and state.vgg is not None:
            with torch.no_grad():
                feats_real = state.vgg(real_B)
        # the G loss as a function of the fake image alone: D's parameters
        # get no gradient from it
        fake_in = fake_sg.requires_grad_(True)
        aux = generator_loss(cfg, state, real_A, real_B, fake_in, feats_real, mesh)
        (dfake,) = torch.autograd.grad(aux["loss_G"], fake_in)
        state.opt_G.zero_grad(set_to_none=True)
        fake.backward(dfake)
        reduce_gradients(state.opt_G, mesh)
        set_lr(state.opt_G, lr)
        state.opt_G.step()
        metrics.update(aux)

        with torch.no_grad():
            fake_q = ops.quantize_uint8(fake_sg)
            real_q = _target_levels(raw_B, real_B)
            metrics["ssim"] = ops.ssim_uint8(real_q, fake_q)
            metrics = reduce_metrics(metrics, mesh, ops.mse_uint8(real_q, fake_q))
        state.step += 1
        return metrics, fake_sg.detach().permute(0, 2, 3, 1).float()

    return step


class Pix2PixModel(BaseModel):
    """The shell over the step: options -> networks -> state -> step
    (``dsgan_tpu/models/pix2pix.py:276-573``)."""

    # the checkpoint's pool images, joined from the row group's strips
    POOLS = ("pool_images",)

    def name(self):
        return "Pix2PixModel"

    @staticmethod
    def modify_commandline_options(parser, is_train=True):
        if is_train:
            parser.add_argument("--lambda_L1", type=float, default=100.0,
                                help="weight for L1 loss (parity flag; unused by the loss, as "
                                     "in reference pix2pix_model.py:70)")
        return parser

    def initialize(self, opt):
        BaseModel.initialize(self, opt)
        self.loss_names = ["G_GAN", "G_L1", "D_real", "D_fake"]
        self.visual_names = ["real_A", "fake_B", "real_B"]
        dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
        self.dtype = dtype
        self.compute_dtype = dtype if dtype == torch.bfloat16 else None
        dev = self.device
        # training: f32 parameters cast at use; eval: the serving build
        # (``registry.serving_build``), as the JAX package builds its
        # inference G
        self.netG = define_G(opt.input_nc, opt.output_nc, opt.ngf, opt.which_model_netG,
                             norm=opt.norm, use_dropout=not opt.no_dropout,
                             init_type=opt.init_type, dtype=dtype, device=dev,
                             gelu_mode=opt.gelu, seed=opt.seed, train=self.isTrain,
                             remat=opt.remat)
        self.state = None
        if not self.isTrain:
            return
        d_input_nc = opt.input_nc + opt.output_nc if opt.use_condition == 1 else opt.output_nc
        # GANLoss(use_lsgan=opt.no_lsgan), as the reference wires it: by
        # default BCE-with-logits on raw logits; --no_lsgan gives D a
        # sigmoid and the MSE criterion
        self.netD = define_D(d_input_nc, opt.ndf, opt.which_model_netD, opt.n_layers_D,
                             norm=opt.norm, init_type=opt.init_type, dtype=dtype, device=dev,
                             seed=opt.seed + 1, use_sigmoid=opt.no_lsgan)
        use_vgg = float(opt.w_vgg) != 0.0
        vgg = None
        if use_vgg:
            params = load_torchvision_npz(opt.vgg_weights) if opt.vgg_weights else None
            if params is None:
                warnings.warn(
                    "--vgg_weights not given: the perceptual loss runs on random VGG16 "
                    "features, a different objective from the reference's pretrained "
                    "torchvision loss (DSGAN/models/vgg.py:5-28). Write the torchvision "
                    "weights once, on a machine with torchvision:\n"
                    "  python -c \"import numpy, torchvision; numpy.savez('vgg16.npz', "
                    "**{k: v.numpy() for k, v in torchvision.models.vgg16(weights="
                    "'IMAGENET1K_V1').state_dict().items()})\"\n"
                    "then pass --vgg_weights vgg16.npz (or silence this with --w_vgg 0).",
                    stacklevel=2)
            vgg = define_vgg(4, dtype=dtype, device=dev, params=params, seed=opt.seed + 2)
        self.cfg = Pix2PixConfig(
            gan_mode="lsgan" if opt.no_lsgan else "vanilla",
            use_gan=int(opt.use_GAN) == 1,
            use_condition=int(opt.use_condition) == 1,
            pool_size=opt.pool_size,
            w_gan=float(opt.w_gan), w_vgg=float(opt.w_vgg), w_tv=float(opt.w_tv),
            w_ss=float(opt.w_ss), use_vgg=use_vgg, beta1=opt.beta1,
            compute_dtype=self.compute_dtype, fuse_d_batch=opt.norm != "batch")
        rows = opt.fineSize_h // (self.mesh.spatial if self.mesh is not None else 1)
        self.state = init_state(self.netG, self.netD, vgg, self.cfg, (rows, opt.fineSize_w),
                                d_input_nc, seed=opt.seed)
        self._on_mesh(self.netG, self.netD)
        self._step_fn = make_train_step(self.cfg, self.mesh)
        self._chained = chained_train_step(self._step_fn, self.cfg)

    def _networks(self):
        nets = {"G": self.netG}
        if self.isTrain:
            nets["D"] = self.netD
        return nets

    # -- data in -----------------------------------------------------------
    def _sides(self):
        return ("A", "B") if self.opt.which_direction == "AtoB" else ("B", "A")

    def set_input(self, input):
        """Place the loader's batch on the device; the host arrays stay for
        the visuals and the anomaly dump."""
        a, b = self._sides()
        self.real_A_host = self._local(input[a])
        self.real_A = self._place_batch(self.real_A_host)
        if b in input:
            self.real_B_host = self._local(input[b])
            self.real_B = self._place_batch(self.real_B_host)
        self.image_paths = input.get(a + "_paths", [])

    def set_input_chunk(self, inputs):
        """Stage a chunk of loader batches (``--steps_per_dispatch``): the A
        and B sides of every batch stacked into one pinned host buffer, one
        copy to the device. The visuals, the anomaly dump and
        ``image_paths`` show the chunk's last batch, as in the JAX package."""
        a, b = self._sides()
        staged = self._place_stack([np.stack([self._local(d[a]), self._local(d[b])])
                                    for d in inputs])
        self.chunk = (staged[:, 0], staged[:, 1])
        self.real_A_host, self.real_B_host = (self._local(inputs[-1][s]) for s in (a, b))
        self.real_A, self.real_B = staged[-1, 0], staged[-1, 1]
        self.image_paths = inputs[-1].get(a + "_paths", [])

    # -- step --------------------------------------------------------------
    def optimize_parameters(self):
        self._metrics, self.fake_B = self._step_fn(self.state, self.real_A, self.real_B, self.lr)
        self._host_metrics = None

    def optimize_parameters_chunk(self):
        """The staged chunk's steps, in order (``chained_train_step``): on
        the card a captured CUDA graph replayed once a batch from the step
        whose pool is full on, eager steps before it and for a chunk shorter
        than ``--steps_per_dispatch`` (an epoch's tail); on the CPU eager
        steps. The same arithmetic as as many ``optimize_parameters`` calls.
        ``_metrics_seq`` holds each step's metrics (0-d views of one (k, n)
        device tensor), ``_metrics`` the last's; ``fake_B`` is the last
        step's."""
        real_A, real_B = self.chunk
        k = real_A.shape[0]
        seq, self.fake_B = self._chained(self.state, real_A, real_B, self.lr,
                                         eager=k < self.opt.steps_per_dispatch)
        keys = self._chained.keys
        self._metrics_seq = [{key: seq[i, j] for j, key in enumerate(keys)} for i in range(k)]
        self._metrics = self._metrics_seq[-1]
        self._host_metrics = None

    def forward(self):
        """The generator on real_A in eval mode, in inference mode (no
        autograd bookkeeping, as the serving function runs it): fake_B is
        (B, H, W, C) f32 on the device."""
        was_training = self.netG.training
        if was_training:
            self.netG.eval()
        with torch.inference_mode(), spatial.rows(self.mesh):
            y = self.netG(images(self.real_A, self.compute_dtype))
            self.fake_B = y.permute(0, 2, 3, 1).float()
        if was_training:
            self.netG.train()
        return self.fake_B

    # -- image getters (reference pix2pix_model.py:292-310) -----------------
    @staticmethod
    def _to_255(x):
        """A batch as a [0, 255] float32 numpy array: uint8 batches as they
        are, [-1, 1] batches scaled."""
        x = x.detach().cpu() if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        if x.dtype == torch.uint8:
            return x.float().numpy()
        return ((x.float() + 1.0) / 2.0 * 255.0).numpy()

    def _strip(self, arr):
        """A host batch placed on the device: on a spatial axis this rank's
        strip of its image rows (the getters below hand back whole images)."""
        if self.mesh is not None and self.mesh.spatial > 1:
            arr = np.asarray(arr)[:, self.mesh.strip(np.asarray(arr).shape[1])]
        return self._place_batch(arr)

    def _joined(self, t):
        """An NHWC batch joined from the row group's strips (itself without
        a spatial axis)."""
        return gather_image_rows(t.contiguous(), self.mesh, dim=1) if self.mesh else t

    def get_img_tir(self, input):
        """Place the TIR ("A") batch as real_A, whatever the direction, and
        return it in [0, 255] (reference pix2pix_model.py:292-294)."""
        self.real_A = self._strip(input["A"])
        return self._to_255(self._joined(self.real_A))

    def get_img_gen(self, input):
        """Place the target batch, run G on real_A, return the fake in
        [0, 255] (reference pix2pix_model.py:296-300)."""
        self.real_B = self._strip(input[self._sides()[1]])
        self.forward()
        return self._to_255(self._joined(self.fake_B))

    def get_img_label(self, input):
        """Place the target batch and return it in [0, 255]
        (reference pix2pix_model.py:302-305)."""
        self.real_B = self._strip(input[self._sides()[1]])
        return self._to_255(self._joined(self.real_B))

    def get_img_nir(self, input):
        """Place the source batch and return it in [0, 255]
        (reference pix2pix_model.py:307-310)."""
        self.real_A = self._strip(input[self._sides()[0]])
        return self._to_255(self._joined(self.real_A))

    def cal_ssim(self, input=None):
        """The last step's SSIM (computed on the device in the step)."""
        return float(self._metrics["ssim"])

    def cal_psnr(self, input=None):
        """The last step's PSNR (computed on the device in the step)."""
        return float(self._metrics["psnr"])

    # -- persistence -------------------------------------------------------
    def _checkpoint_state(self):
        """The train state and the LR schedule's position. The plateau
        policy's state is not saved, as the JAX package saves only ``state``
        and ``lr_last_epoch`` (``dsgan_tpu/models/pix2pix.py:540-550``). On
        a spatial axis the pool's images are gathered from the row group's
        strips (every rank calls this), so a checkpoint holds whole images
        whatever the mesh (``POOLS``: CycleGAN has two pools)."""
        st = dict(self.state.state_dict(), lr_last_epoch=self._last_epoch)
        if self.mesh is not None and self.mesh.spatial > 1:
            for key in self.POOLS:
                st[key] = gather_image_rows(st[key], self.mesh)
        return st

    def _load_checkpoint_state(self, st):
        """Restore a checkpoint of either mode. The plateau policy starts
        afresh, as a JAX resume does (``dsgan_tpu/models/base_model.py:
        133-135``): a "plateau" entry, which earlier checkpoints of the port
        hold, is ignored. ``resume_position``: where a preempted run stood
        (the train CLI's "run" entry), or None."""
        self._chained.reset()
        if self.mesh is not None and self.mesh.spatial > 1:  # this rank's strip of the pools
            st = dict(st, **{k: st[k][:, :, self.mesh.strip(st[k].shape[2])]
                             for k in self.POOLS})
        self.state.load_state_dict(st)
        self._last_epoch = int(st["lr_last_epoch"])
        self.resume_position = st.get("run")
        self._set_lr_from_schedule()

    def load_networks(self, which_epoch):
        if self.isTrain:
            return BaseModel.load_networks(self, which_epoch)
        # inference only: the generator out of a train checkpoint
        self.netG.load_state_dict(self.generator_state(which_epoch))

    def load_generator_npz(self, path):
        """Generator weights from a JAX-layout params .npz (the JAX package's
        trained generators, or a reference .pth through its converter)."""
        self.netG.load_state_dict(self.generator_state(npz=path))

    def generator_state(self, which_epoch=None, npz=None):
        """The generator's ``state_dict`` in f32 (BatchNorm running
        statistics included): from the JAX-layout params ``npz`` (running
        statistics at their start values), else from the ``which_epoch``
        train checkpoint."""
        opt = self.opt
        if npz:
            entries = generator_entries(opt.input_nc, opt.output_nc, opt.ngf,
                                        opt.which_model_netG, opt.norm, not opt.no_dropout)
            return state_dict_from_jax(load_params_npz(npz), entries)
        which_epoch = self._resolve_epoch(which_epoch)
        print(f"loaded generator from epoch {which_epoch} checkpoint")
        return ckpt.restore_state(self.save_dir, which_epoch)["netG"]

"""Conditional DDPM colorization, ``--model diffusion`` (port of
``dsgan_tpu/models/diffusion.py``: ``make_schedule``, the ``DenoiseUNet``
denoiser, its train step, the DDIM sampler and the ``DiffusionModel``
shell the CLIs drive).

The reference's diffusion scratch (DSGAN/models/dissuion_model.py) gives
the schedule, alpha_t = sqrt(1 - 0.02 t / T) with bar_alpha their
product and bar_beta = sqrt(1 - bar_alpha^2), the noising x_t =
bar_alpha * x0 + bar_beta * eps and the L2 noise-prediction loss; the JAX
package built the rest, and this module ports it value for value:

  * ``DenoiseUNet``: a 3-level UNet eps(x_t, t | cond) on the channel
    concat [x_t ; cond], each level a 3x3 conv, InstanceNorm, a FiLM
    (1 + scale, shift) from the sinusoidal time embedding, and GELU; 2x2
    max pools down, k3 s2 transposed convs up with skip concats. Its
    parameters are f32 and computed in the compute dtype (bf16 on the
    card), cast at use, as the JAX package does. It has no ConvNeXt
    block, so no block-core kernel runs here, as in JAX.
  * the train step: normalize, draw t and eps, noise, the f32 MSE of the
    predicted noise, one Adam step (beta1 0.9); ``t`` / ``eps`` may be
    handed in, so that a test can give both packages JAX's draws;
  * the DDIM sampler (eta 0): ``sample_steps`` denoiser calls on
    ts = linspace(T - 1, 0, S).round(), x0 clipped to [-1, 1], the last
    step landing on x0. It is a Python loop of eager calls (JAX: one
    ``fori_loop``); ``x_T`` may be handed in.

The draws come from explicit ``torch.Generator``s: the step's from the
state's, which the checkpoint holds; a sample's from a generator seeded
with the train step, as JAX folds the step into its key. On a mesh both
are drawn for the global batch's whole images and each rank keeps its
rows, and on a spatial axis its strip of their image rows (``_noise``), as
``layers.Dropout`` draws its mask: the step, the sampler and the probe
run under ``spatial.rows(mesh)``, the MSE and the probe's metrics as this
rank's shares, and the shell's visuals join the strips.
"""

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from dsgan_tpu_torch import ops
from dsgan_tpu_torch.device import resolve_device
from dsgan_tpu_torch.models.base_model import BaseModel
from dsgan_tpu_torch.models.layers import Conv2d, ConvTranspose2d, Linear, gelu
from dsgan_tpu_torch.models.pix2pix import images, load_adam, make_adam, set_lr
from dsgan_tpu_torch.ops.initializers import init_tree
from dsgan_tpu_torch.parallel import (
    data_size,
    reduce_gradients,
    reduce_metrics,
    spatial,
)
from dsgan_tpu_torch.utils import checkpoint as ckpt
from dsgan_tpu_torch.utils.convert import (
    diffusion_entries,
    jax_shapes,
    state_dict_from_jax,
    unflatten,
)


def make_schedule(timesteps):
    """(bar_alpha, bar_beta), f32 CPU tensors of length T, index 0 being
    t = 1: the cumulative product in float64, then f32, as JAX computes it."""
    t = np.arange(1, timesteps + 1, dtype=np.float64)
    bar_alpha = np.cumprod(np.sqrt(1.0 - 0.02 * t / timesteps))
    bar_beta = np.sqrt(1.0 - bar_alpha ** 2)
    return (torch.from_numpy(bar_alpha.astype(np.float32)),
            torch.from_numpy(bar_beta.astype(np.float32)))


class TimeEmbed(nn.Module):
    """Sinusoidal timestep embedding (f32) -> Linear -> GELU -> Linear, in
    the compute dtype."""

    def __init__(self, dim, gelu_mode="auto"):
        super().__init__()
        self.dim, self.gelu_mode = dim, gelu_mode
        self.fc1 = Linear(dim, dim)
        self.fc2 = Linear(dim, dim)

    def forward(self, t, dtype):
        half = self.dim // 2
        freqs = torch.exp(-math.log(10000.0)
                          * torch.arange(half, dtype=torch.float32, device=t.device) / half)
        ang = t.float()[:, None] * freqs[None, :]
        emb = torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)
        return self.fc2(gelu(self.fc1(emb), self.gelu_mode))


class FiLMBlock(nn.Module):
    """3x3 conv -> InstanceNorm (f32 statistics) -> h * (1 + scale) + shift
    from Linear(gelu(temb)) -> GELU."""

    def __init__(self, cin, features, temb_dim, gelu_mode="auto"):
        super().__init__()
        self.gelu_mode = gelu_mode
        self.conv = Conv2d(cin, features, 3, padding=1)
        self.film = Linear(temb_dim, 2 * features)

    def forward(self, x, temb):
        h = ops.instance_norm(self.conv(x))
        scale, shift = self.film(gelu(temb, self.gelu_mode)).chunk(2, dim=-1)
        h = h * (1.0 + scale[:, :, None, None]) + shift[:, :, None, None]
        return gelu(h, self.gelu_mode)


class DenoiseUNet(nn.Module):
    """eps(x_t, t | cond) on NCHW tensors: x_t (B, out_nc, H, W) and the
    condition (B, in_nc, H, W), f32; the output in x_t's dtype. Computes in
    ``compute_dtype`` (None: the inputs' dtype). Module names are the JAX
    package's (``utils.convert.diffusion_entries``)."""

    def __init__(self, in_nc=3, out_nc=3, nf=64, gelu_mode="auto"):
        super().__init__()
        self.out_nc = out_nc
        self.compute_dtype = None
        e = 4 * nf
        self.temb = TimeEmbed(e, gelu_mode)
        self.e1 = FiLMBlock(out_nc + in_nc, nf, e, gelu_mode)
        self.e2 = FiLMBlock(nf, 2 * nf, e, gelu_mode)
        self.e3 = FiLMBlock(2 * nf, 4 * nf, e, gelu_mode)
        self.mid = FiLMBlock(4 * nf, 4 * nf, e, gelu_mode)
        self.up2 = ConvTranspose2d(4 * nf, 2 * nf, 3, stride=2, padding=1, output_padding=1)
        self.d2 = FiLMBlock(4 * nf, 2 * nf, e, gelu_mode)
        self.up1 = ConvTranspose2d(2 * nf, nf, 3, stride=2, padding=1, output_padding=1)
        self.d1 = FiLMBlock(2 * nf, nf, e, gelu_mode)
        self.out = Conv2d(nf, out_nc, 3, padding=1)

    def forward(self, xt, cond, t):
        dt = self.compute_dtype or xt.dtype
        temb = self.temb(t, dt)
        x = torch.cat([xt, cond], 1).to(dt)
        # the three levels (on a strip, a level whose height does not split
        # over the row group runs whole on every rank: ``spatial.Levels``)
        lv = spatial.Levels(x.shape[2], 3)
        with lv.at(0):
            e1 = self.e1(x, temb)
        e2_in = lv.pool(e1, 0)
        with lv.at(1):
            e2 = self.e2(e2_in, temb)
        e3_in = lv.pool(e2, 1)
        with lv.at(2):
            m = self.mid(self.e3(e3_in, temb), temb)
        up2 = lv.up(self.up2, m, 2)
        with lv.at(1):
            d2 = self.d2(torch.cat([up2, e2], 1), temb)
        up1 = lv.up(self.up1, d2, 1)
        with lv.at(0):
            return self.out(self.d1(torch.cat([up1, e1], 1), temb)).to(xt.dtype)


def init_denoiser_params(in_nc=3, out_nc=3, nf=64, seed=0):
    """The denoiser's parameters in the JAX tree and layout, drawn with numpy
    from ``seed`` as the JAX layers initialize them (kernels N(0, 0.02),
    biases 0)."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in DenoiseUNet(in_nc, out_nc, nf).state_dict().items()}
    return unflatten(init_tree(jax_shapes(shapes, diffusion_entries()), seed))


def define_denoiser(in_nc=3, out_nc=3, nf=64, dtype=torch.bfloat16, device=None, params=None,
                    seed=0, gelu_mode="auto"):
    """The denoiser on ``device`` (None: the CUDA card) with f32 parameters
    from the JAX-layout tree ``params`` or drawn from ``seed``, computing
    in ``dtype``."""
    dev = resolve_device(device)
    if params is None:
        params = init_denoiser_params(in_nc, out_nc, nf, seed)
    with torch.device("meta"):
        net = DenoiseUNet(in_nc, out_nc, nf, gelu_mode)
    net = net.to_empty(device=dev)
    net.load_state_dict(state_dict_from_jax(params, diffusion_entries()))
    net.compute_dtype = dtype if dtype != torch.float32 else None
    return net


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    timesteps: int = 1000
    beta1: float = 0.9
    compute_dtype: object = None


@dataclasses.dataclass
class DiffusionState:
    """The denoiser, its Adam, the generator of the step's t and eps draws,
    the step counter (0-d int64 on the device) and the schedule on the
    device; a step updates them in place."""
    net: nn.Module
    opt: torch.optim.Optimizer
    generator: torch.Generator
    step: torch.Tensor
    bar_alpha: torch.Tensor
    bar_beta: torch.Tensor

    def state_dict(self):
        return {"net": self.net.state_dict(), "opt": self.opt.state_dict(),
                "generator": self.generator.get_state(), "step": self.step}

    def load_state_dict(self, st):
        self.net.load_state_dict(st["net"])
        load_adam(self.opt, st["opt"])
        self.generator.set_state(st["generator"])
        self.step.fill_(int(st["step"]))


def init_state(net, cfg, seed=0):
    """Adam (beta1 ``cfg.beta1``) on the denoiser, the draws' generator
    seeded from ``seed``, the step at 0, the schedule on its device."""
    dev = next(net.parameters()).device
    ba, bb = make_schedule(cfg.timesteps)
    return DiffusionState(net, make_adam(net.parameters(), cfg.beta1),
                          torch.Generator(device=dev).manual_seed(seed),
                          torch.zeros((), dtype=torch.int64, device=dev), ba.to(dev), bb.to(dev))


def _rows(n, mesh):
    """(global batch, this rank's rows) of a local batch of ``n``."""
    total = n * data_size(mesh)
    return total, (slice(0, n) if mesh is None else mesh.rows(total))


def _noise(shape, mesh, generator, device):
    """A standard normal (B, C, H, W) draw for this rank's part of the global
    batch: drawn for the global batch and, on a spatial axis, for the whole
    image (H times the row group's size), this rank's rows and strip kept,
    so that each rank holds its part of one process's draw."""
    b, c, h, w = shape
    total, rows = _rows(b, mesh)
    s = 1 if mesh is None else mesh.spatial
    eps = torch.randn((total, c, h * s, w), generator=generator, device=device)[rows]
    return eps if s == 1 else eps[:, :, mesh.strip(h * s)]


def make_diffusion_train_step(cfg, mesh=None):
    """The step: (state, real_A, real_B, lr, t=None, eps=None) -> metrics
    ({"loss_G"}: the f32 noise-prediction MSE, a 0-d device tensor).
    real_A (the condition) and real_B are (B, H, W, C), uint8 or [-1, 1];
    ``t`` (B,) ints and ``eps`` (B, C, H, W) are drawn from the state's
    generator unless given. On a ``mesh`` the inputs are this rank's rows
    (and on a spatial axis its strip of their image rows, the step running
    under ``spatial.rows(mesh)``); the draws are the global batch's whole
    images, this rank's rows and strip kept (``t`` per image, so equal on
    every rank of a row group), the MSE this rank's share, and the gradient
    and loss reduced over the mesh."""

    def step(state, real_A, real_B, lr, t=None, eps=None):
        with spatial.rows(mesh):
            return _step(state, real_A, real_B, lr, t, eps)

    def _step(state, real_A, real_B, lr, t, eps):
        cond = images(real_A, cfg.compute_dtype)
        x0 = images(real_B, cfg.compute_dtype)
        dev = x0.device
        total, rows = _rows(x0.shape[0], mesh)
        if t is None:
            t = torch.randint(0, cfg.timesteps, (total,), generator=state.generator,
                              device=dev)[rows]
        if eps is None:
            eps = _noise(x0.shape, mesh, state.generator, dev)
        t, eps = t.to(dev), eps.to(device=dev, dtype=x0.dtype)
        ba = state.bar_alpha[t].to(x0.dtype)[:, None, None, None]
        bb = state.bar_beta[t].to(x0.dtype)[:, None, None, None]
        x_t = ba * x0 + bb * eps
        pred = state.net(x_t, cond, t)
        loss = spatial.mean((pred.float() - eps.float()).square())
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        reduce_gradients(state.opt, mesh)
        set_lr(state.opt, lr)
        state.opt.step()
        state.step += 1
        return reduce_metrics({"loss_G": loss}, mesh)

    return step


def make_ddim_sampler(cfg, sample_steps=20):
    """DDIM (eta 0): sample(net, cond, x_T=None, generator=None, mesh=None)
    -> (B, H, W, out_nc) f32 on cond's device. ``cond`` is (B, H, W, C),
    uint8 or [-1, 1]; ``x_T`` (B, out_nc, H, W) is drawn from ``generator``
    unless given. On a ``mesh`` ``cond`` is this rank's rows (and on a
    spatial axis its strip), ``x_T`` drawn for the global batch's whole
    images with this rank's part kept, the loop run under
    ``spatial.rows(mesh)``, and the result this rank's part."""
    ts = np.linspace(cfg.timesteps - 1, 0, sample_steps).round().astype(np.int64).tolist()
    schedule = make_schedule(cfg.timesteps)

    @torch.no_grad()
    def sample(net, cond, x_T=None, generator=None, mesh=None):
        cond = images(cond, None)
        dev = cond.device
        bar_alpha, bar_beta = (s.to(dev) for s in schedule)
        b, _, h, w = cond.shape
        if x_T is None:
            x_T = _noise((b, net.out_nc, h, w), mesh, generator, dev)
        x = x_T.to(device=dev, dtype=torch.float32)
        with spatial.rows(mesh):
            for i, t in enumerate(ts):
                eps = net(x, cond, torch.full((b,), t, dtype=torch.int64, device=dev)).float()
                x0 = ((x - bar_beta[t] * eps) / bar_alpha[t]).clamp(-1.0, 1.0)
                # the last step lands on x0 (JAX: ba_p = 1, bb_p = 0)
                x = (bar_alpha[ts[i + 1]] * x0 + bar_beta[ts[i + 1]] * eps if i + 1 < len(ts)
                     else x0)
        return x.permute(0, 2, 3, 1).contiguous()

    return sample


class DiffusionModel(BaseModel):
    """``--model diffusion``: the conditional DDPM trainer (``dsgan_tpu/
    models/diffusion.py:195-315``). Its train CSVs carry the SSIM / PSNR of
    a DDIM sample against real_B every ``--metric_freq`` steps; eval
    samples through ``forward``. ``--steps_per_dispatch`` chunks run their
    steps one by one, as JAX's diffusion model has no chained step."""

    def name(self):
        return "DiffusionModel"

    @staticmethod
    def modify_commandline_options(parser, is_train=True):
        parser.add_argument("--timesteps", type=int, default=1000,
                            help="diffusion timesteps T (reference scratch: 1000)")
        parser.add_argument("--sample_steps", type=int, default=20,
                            help="DDIM steps used for visuals/eval sampling")
        parser.add_argument("--diff_nf", type=int, default=64, help="denoiser UNet base width")
        parser.add_argument("--metric_freq", type=int, default=50,
                            help="train steps between DDIM-sample SSIM/PSNR probes (a sample is "
                                 "~sample_steps net evals; 0 disables)")
        return parser

    def initialize(self, opt):
        BaseModel.initialize(self, opt)
        self.loss_names = ["G"]
        self.visual_names = ["real_A", "fake_B", "real_B"]
        dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
        self.compute_dtype = dtype if dtype == torch.bfloat16 else None
        self.net = define_denoiser(opt.input_nc, opt.output_nc, opt.diff_nf, dtype, self.device,
                                   seed=opt.seed, gelu_mode=opt.gelu)
        self.cfg = DiffusionConfig(timesteps=opt.timesteps, compute_dtype=self.compute_dtype)
        self._sampler = make_ddim_sampler(self.cfg, opt.sample_steps)
        self._sample_step = 0  # eval: the checkpoint's step
        self._probe_count = 0
        self.fake_B = None
        self.state = None
        if self.isTrain:
            self._on_mesh(self.net)
            self.state = init_state(self.net, self.cfg, seed=opt.seed)
            self._step_fn = make_diffusion_train_step(self.cfg, self.mesh)

    def _networks(self):
        return {"G": self.net}

    def set_input(self, input):
        a, b = ("A", "B") if self.opt.which_direction == "AtoB" else ("B", "A")
        self.real_A_host = self._local(input[a])
        self.real_A = self._place_batch(self.real_A_host)
        self.real_B_host = self._local(input[b])
        self.real_B = self._place_batch(self.real_B_host)
        self.image_paths = input.get(a + "_paths", [])
        self.fake_B = None

    def optimize_parameters(self):
        self._metrics = self._step_fn(self.state, self.real_A, self.real_B, self.lr)
        self._host_metrics = None
        self.fake_B = None
        # every --metric_freq steps a DDIM sample scored against real_B on
        # the device, so that the CSVs carry SSIM / PSNR as the GAN models'
        # do (per step it would cost sample_steps denoiser calls a step)
        self._probe_count += 1
        freq = self.opt.metric_freq
        if freq and (self._probe_count % freq == 1 or freq == 1):
            fake_q = ops.quantize_uint8(self.forward().permute(0, 3, 1, 2))
            rb = self.real_B.permute(0, 3, 1, 2)
            real_q = rb.float() if rb.dtype == torch.uint8 else ops.quantize_uint8(rb)
            with torch.no_grad(), spatial.rows(self.mesh):  # on strips: shares
                probe = reduce_metrics({"ssim": ops.ssim_uint8(real_q, fake_q)}, self.mesh,
                                       ops.mse_uint8(real_q, fake_q))
            self._metrics = dict(self._metrics, **probe)

    def forward(self):
        """A DDIM sample for real_A, (B, H, W, C) f32 on the device, drawn
        from a generator seeded with the step (the checkpoint's in eval)."""
        step = int(self.state.step) if self.state is not None else self._sample_step
        gen = torch.Generator(device=self.device).manual_seed(step)
        self.fake_B = self._sampler(self.net, self.real_A, generator=gen, mesh=self.mesh)
        return self.fake_B

    def get_current_visuals(self):
        if self.fake_B is None:  # a sample costs sample_steps denoiser calls
            self.forward()
        return BaseModel.get_current_visuals(self)

    def cal_ssim(self, input=None):
        return float(self._metrics["ssim"]) if "ssim" in self._metrics else 0.0

    def cal_psnr(self, input=None):
        return float(self._metrics["psnr"]) if "psnr" in self._metrics else 0.0

    # -- persistence -------------------------------------------------------
    def _checkpoint_state(self):
        return dict(self.state.state_dict(), lr_last_epoch=self._last_epoch)

    def _load_checkpoint_state(self, st):
        self.state.load_state_dict(st)
        self._last_epoch = int(st["lr_last_epoch"])
        self.resume_position = st.get("run")
        self._set_lr_from_schedule()

    def load_networks(self, which_epoch):
        if self.isTrain:
            return BaseModel.load_networks(self, which_epoch)
        which_epoch = self._resolve_epoch(which_epoch)
        st = ckpt.restore_state(self.save_dir, which_epoch)
        self.net.load_state_dict(st["net"])
        self._sample_step = int(st["step"])
        print(f"loaded denoiser from epoch {which_epoch} checkpoint")

    def load_generator_npz(self, path):
        raise NotImplementedError("--load_npz carries a generator: diffusion evaluates the "
                                  "denoiser of a train checkpoint")

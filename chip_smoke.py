#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``dsgan_tpu_torch``).

    python3 chip_smoke.py [--out DIR]

Needs one CUDA card; exits non-zero, printing no result, without one.
Phases, each of which fails the run:

  1. the device, and its name and power limit as nvidia-smi reports them;
  2. build every CUDA kernel from ``dsgan_tpu_torch/csrc`` with nvcc, one
     nvcc per source, all started together, and beside them the native
     batch decoder (``csrc/loader.cpp``) with g++;
  3. hold K1 at the c1-c5 shapes and K3 at the uc1-uc4 shapes of the
     256x256 generator against their plain PyTorch versions on the card:
     bf16 with tanh GELU at batch 1 and 16 (rtol = atol = 2e-2, read also
     as rel-L2; the Hopper kernels of block_core2_fwd_sm90.cu on each
     site's fwd_plan route), f32 with erf GELU at batch 1 (2e-4, TF32 off;
     the FMA check builds block_core_fwd / block_core2_fwd); time each
     with CUDA events beside its bound;
  4. the same for K2 and K4 (in bf16 the Hopper kernel block_core2_bwd_sm90,
     in f32 the FMA check build block_core_bwd) on a random cotangent:
     bf16/tanh at batch 16 (dn, dx and the folded dh within 2e-2 / 2e-2
     elementwise; every weight gradient and S sum within rel-L2 1e-2 and
     max-abs 2e-2 * max|ref|; the device time of each of its passes from
     torch.profiler), f32/erf at batch 1 (1e-3 relative, atol 1e-3 *
     max|ref|, TF32 off);
  5. serve 256x256 uint8 requests at batch 1 and 16 through the full-width
     MixConvNeXtML (bf16, seeded weights carried in through
     ``state_dict_from_jax``), with every launch counter set to 0 first:
     5 K1 + 4 K3 launches per forward, uint8 outputs of the right shape,
     and the kernel path's float output within 2e-2 of the plain path's;
  6. train: the pix2pix step at full width (MixConvNeXtML + PatchGAN ndf 32
     + VGG16 4 taps, 256x256, batch 16, bf16, pool 50), counters set to 0
     first, 2 warm-up and 5 timed steps: 5 K1 + 4 K3 + 5 K2 + 4 K4 launches
     per step, finite losses, parameters that moved; a torch.profiler split
     of one step by kernel class; then, from one state, the G gradient of
     the step's loss through K1-K4 against the same through the plain
     versions (``gradient_check``, ``GRAD_GATE``): block by block on the
     cotangent the step delivers, every K2/K4 output and the folded dh,
     and over the whole generator (where bf16 rounding accumulates along
     the backward) the median and the distance to the f32 gradient, with
     faulty controls that the gate must refuse;
  7. the CUDA graph (``--steps_per_dispatch``'s form on the card): the
     phase 6 recipe with its pool filled by 4 eager steps, its state copied
     through ``state_dict``; 4 eager steps on one copy, the captured step
     replayed 4 times on the other, and every parameter, Adam moment and
     step, pool image, generator state, step counter and metric must be
     equal bit for bit (else within the JAX suite's cross-program bounds,
     tests/test_chained_step.py:16-24, with the differing tensors named);
     the capture counts 5 K1 + 4 K3 + 5 K2 + 4 K4 launches, and a
     profiled replay runs the same block-core kernels, as many times, as a
     profiled eager step; then eager and replayed steps in turns, each
     with its step ms and one profiled step (wall, device ms, idle share);
  7b. --remat (``remat_phase``): the phase 6 recipe with MixConvNeXtML's
     blocks rematerialized: one step's G and D gradients from one state
     bit for bit with the step without remat (cuDNN's deterministic
     algorithms), 10 K1 + 8 K3 + 5 K2 + 4 K4 launches a step (the
     recompute runs K1 / K3 again), 4 replays against 4 eager steps bit for
     bit, step ms and peak memory each way at 256x256 and 512x512 batch 16,
     and the largest batch of 1, 2, 4, 8, 16 at 1024x1024 that a step runs
     each way (``remat_*`` lines);
  8. the train and eval CLIs, in-process through their ``main(argv)``, on
     a synthetic aligned dataset written from a numpy seed (144 + 4 pairs
     of 256x256 PNGs, 9 steps an epoch at batch 16): train 2 epochs with
     the native decoder and ``--steps_per_dispatch 4`` (the pool's 4 eager
     steps, the capture, replays, an eager tail each epoch), resume it for
     a third epoch from the epoch 2 checkpoint, and as the A/B one epoch
     on the Python loader with k = 1; evaluate epoch 3 on 4 images on the
     serving build; counters set to 0 before each: 5 K1 + 4 K3 + 5 K2 +
     4 K4 launches per eager or captured step and 5 K1 + 4 K3 per eval
     forward, the native decoder's calls, the graph's eager / captured /
     replayed counts, finite losses, the checkpoints and the files of the
     JAX CLIs, the resumed step counter and LR, a ``metrics.csv`` mean
     row; ``cli_train`` lines of host times per run and one ``cli_eval``;
  9. the zoo: its 8 generators' forwards, its BatchNorm + multiscale-D
     recipe through the train CLI, and that recipe's replays against
     eager steps (``zoo_phase``);
 10. CycleGAN (``cyclegan_phase``): full-width MixConvNeXtML G_A / G_B and
     PatchGAN ndf 32 D_A / D_B, 256x256, bf16, pool 50, lambda_identity
     0.5; 7 eager steps at batch 1 and at 16 (8 where 16 does not fit),
     5 of them timed, with peak memory and a profiled step: 30 K1 + 24 K3
     + 30 K2 + 24 K4 launches a step; the G_A / G_B gradient check under
     ``CYCLE_GRAD_GATE`` with its faulty controls; 4 replays against 4
     eager steps at batch 1 once 50 eager steps have filled both pools,
     bit for bit; then the train CLI on unaligned PNGs (40 A, 48 B, batch
     4, ``--steps_per_dispatch 4``, 2 epochs), its eval with random
     Inception features (finite FID / KID rows, 4 generator forwards an
     image) and the video CLI on 8 frames of its G_A (``temporal.csv``);
 11. FID (``fid_phase``): Inception pool3 features of 8 images on the card
     (f32, TF32 off) against the CPU's, with ms a batch;
 11b. the card against the port's CPU path (``card_vs_cpu_phase``): every
     recipe of CVC_RECIPES (together every generator and discriminator of
     the registry, every norm and model; the default recipe with VGG on the
     K1-K4 f32 check builds) one f32 step at 256x256 on the CPU, on the
     card from the CPU's states, and on the CPU in another order from
     states one rounding off (the floor), every module's output and each
     generator application's cotangent held at the CPU's on the last two:
     each loss, module output, generator output and cotangent and every
     parameter gradient read against the CPU's (``cvc_readings``), then the eval ops
     (SSIM / PSNR on uint8 levels, MS-SSIM, 5-D SSIM, LK flow and its
     warped error, the FID resize, the VGG taps); every reading under
     CARD_VS_CPU["limit"] (``card_vs_cpu`` lines, one a recipe, and
     ``card_vs_cpu_eval_ops``);
 12. diffusion (``diffusion_phase``): DenoiseUNet nf 64, 256x256, bf16,
     T 1000, seeded weights carried in through ``diffusion_entries``: 2 +
     5 train steps at batch 16 and at 1 (step ms, img/s, peak memory, a
     profiled step; finite losses, moved parameters, no block-core
     launch), a 20-step DDIM sample at batch 16 (finite, in [-1, 1]), the
     bf16 forward against the f32 CPU forward (rel-L2 under
     DIFF["rel_l2"]), then the train CLI (32 pairs, batch 8, a probe every
     2 steps) and the eval CLI on 4 images, in-process (``diffusion_*``
     lines);
 13. the data axis (``dp_phase``): two gloo ranks spawned on the one card
     against one process on the global batch 16 (phase 6's recipe, 3
     steps: ranks bit-identical, metrics and parameters within DP's
     bounds, 5 K1 + 4 K3 + 5 K2 + 4 K4 a rank a step, the collectives'
     tally), and one NCCL rank whose all-reduces and all-gather the CUDA
     graph captures, 4 replays against 4 eager steps bit for bit
     (``dp_two_ranks``, ``dp_nccl_graph_vs_eager`` lines);
 14. the spatial axis (``spatial_phase``): K1-K4 against their plain
     versions at the strips' shapes, then two gloo ranks spawned on the one
     card, each holding 256 of the 512 rows of tests/test_spatial_512.py's
     config (MixConvNeXtML, PatchGAN ndf 32, pool 0, batch 1): f32 on the
     check builds against one process (the losses at that file's bounds,
     each weight's first-step G and D gradient within rel-L2 1e-4 or twice
     the floor's: one process summing over the two row halves as the
     strips do), then bf16 on the Hopper kernels without and with VGG
     (ranks bit-identical, step ms beside one process's, the tally); 5 K1
     + 4 K3 + 5 K2 + 4 K4 a rank a step on the strips' rows; then the same
     f32 gate and bf16 runs for CycleGAN (two full-width MixConvNeXtML,
     30 K1 + 24 K3 + 30 K2 + 24 K4 a rank a step), diffusion (nf 64, with
     a 20-step DDIM sample on the strips), resnet_9blocks under --norm
     batch and the rest of the zoo at ngf 64 (``SP_ZOO``: unet_256 against
     the pixel D, gll against the multiscale D, cascaded, unetpp and wnet
     under --norm batch against the PatchGAN, unet_128 in CycleGAN against
     the multiscale D) (``SP_RECIPES``; ``spatial_*`` lines); and the f32
     pix2pix step under --remat, bit for bit with the step without it on
     the ranks and in one process (10 K1 + 8 K3 + 5 K2 + 4 K4 a step);
 15. a step that cannot be captured must raise, not run eagerly;
 16. one JSON line of kernel numbers, then the result line.

``--out DIR`` also writes the per-shape numbers to DIR/chip_smoke.json.
``--remat`` and ``--spatial`` run only their phase (after the build).
``--grad_spread N`` runs only one process's f32 first step at the spatial
phase's config N times for each of its recipes and prints each weight's
spread beside the halves' reading the spatial gate doubles (``grad_spread``).
``--card_vs_cpu`` runs only phase 11b; ``--card_vs_cpu_faults`` runs it on
CVC_FAULTS' recipes, clean and then with each fault planted on the card
side, which its gate must refuse by 10x its limit.
"""

import argparse
import csv
import json
import math
import os
import sys
import tempfile
import threading
import time

TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
TOL_F32 = dict(rtol=2e-4, atol=2e-4)
# backward: elementwise outputs (rtol, atol or atol / max|ref|), sums (rel-L2, max-abs / max|ref|)
TOL_BWD = {"bfloat16": dict(elem=(2e-2, 2e-2), scaled=False, rel_l2=1e-2, max_abs=2e-2),
           "float32": dict(elem=(1e-3, 1e-3), scaled=True, rel_l2=None, max_abs=1e-3)}
TRAIN = dict(batch=16, size=256, warmup=2, steps=5)
# seconds a profiler trace runs before the call it measures
PROFILE_SETTLE_S = 0.05
# the graph phase: steps that fill the pool of 50, steps compared
GRAPH = dict(batch=16, size=256, fill=4, steps=4, timed=5)
# the CLI phase: pairs written per phase (9 steps an epoch), steps a chunk
CLI = dict(train_pairs=144, test_pairs=4, batch=16, size=256, k=4)
# the export phase: requests timed per turn; the share of pixels that may
# be one level off the live serving function; the w8 gate's SSIM floor
EXPORT = dict(size=256, requests_b1=30, requests_b16=10, pixels_off=1e-3, quant_tol=0.9)
# the zoo phase: (generator, input size) at ngf 64 and batch 1; pairs of
# its train-CLI epoch (the pool of 50 fills, then the graph replays)
ZOO = dict(generators=[("resnet_9blocks", 256), ("resnet_6blocks", 256), ("unet_128", 128),
                       ("unet_256", 256), ("gll", 256), ("cascaded", 256), ("unetpp", 256),
                       ("wnet", 256)], train_pairs=60)
# the train step's G gradient, kernel path vs plain path: rel-L2 of each K2/K4
# output at block level; median over the block weights of the whole
# generator; kernel path's median distance to the f32 gradient over the plain
# path's. CONTROLS put faults of a known size into K2/K4 (see ``faulty``);
# the gate must refuse those in MUST_FAIL. Set from readings on an H100 at
# this phase's size (PERF.md, "Gradient gate").
GRAD_GATE = dict(block=5e-3, median=2e-2, ratio=1.05)
CONTROLS = [("gain", 0.02), ("gain", 0.01), ("noise", 0.02), ("noise", 0.01)]
MUST_FAIL = [f"{kind} {size}" for kind, size in CONTROLS]
# the CycleGAN phase: full-width MixConvNeXtML G_A / G_B, PatchGAN ndf 32 D_A /
# D_B, 256x256, bf16, pool 50, lambda_identity 0.5; steps timed at batch 1
# (CycleGAN's default) and 16 (pix2pix's; half that where it does not fit); the
# gradient check first, on the state as built, at grad_batch; the replay
# comparison at batch 1 once 50 eager
# steps have filled both pools; the train CLI on train_A / train_B unaligned
# PNGs (12 steps an epoch at cli_batch 4, k = 4), its eval on `test` pairs with
# random Inception features, the video CLI on `frames` frames
CYCLE = dict(size=256, batches=(1, 16), warmup=2, steps=5, grad_batch=16, fill=50, replays=4,
             train_A=40, train_B=48, cli_batch=4, k=4, test=4, frames=8)
# K1 / K3 / K2 / K4 launches of one CycleGAN step with the identity terms:
# six generator applications of 5 one-input and 4 two-input blocks
CYCLE_PER_STEP = {"K1": 30, "K3": 24, "K2": 30, "K4": 24}
# the CycleGAN step's gradient gate, over the 54 K2 / K4 calls of the six
# applications at grad_batch: pix2pix's block and ratio limits; the median of
# the whole generators set from readings on an H100 (PERF.md, "Gradient gate":
# kernel vs plain path 0.0615, where each bf16 path sits 0.146 from the f32
# gradient, against pix2pix's 0.010 and 0.034: the CycleGAN loss's bf16
# gradient is that much noisier, its cycle terms most)
CYCLE_GRAD_GATE = dict(GRAD_GATE, median=0.1)
# the terms of the CycleGAN G loss and their K2 / K4 calls, each read alone by
# ``--grad_terms`` to find which part sets the gradient readings
CYCLE_TERMS = {"full": (("loss_G",), 54), "identity": (("loss_idt_A", "loss_idt_B"), 18),
               "gan": (("loss_G_A", "loss_G_B"), 18), "cycle": (("loss_cycle_A", "loss_cycle_B"), 36)}
# the FID phase: pool3 features of a batch of 256x256 images on the card (f32,
# TF32 off) against the CPU's; max-abs error over max|CPU| and rel-L2
FID = dict(batch=8, size=256, max_abs=1e-3, rel_l2=1e-4)
# the diffusion phase: DenoiseUNet nf 64 at 256x256, bf16, T 1000; train steps
# timed at each batch; a DDIM sample of sample_batch; the bf16 card forward
# against the f32 CPU forward of cpu_batch images, rel-L2 under rel_l2 (bf16
# rounding through nine conv / InstanceNorm / FiLM levels); the train CLI on
# train_pairs (cli_batch, a probe every 2 steps), the eval CLI on test_pairs
DIFF = dict(size=256, nf=64, timesteps=1000, batches=(16, 1), warmup=2, steps=5,
            sample_batch=16, sample_steps=20, cpu_batch=2, rel_l2=3e-2, train_pairs=32,
            test_pairs=4, cli_batch=8)
# the data-parallel phase: phase 6's recipe at global batch 16 (B's rows 8-15 a
# flat grey, so that the two ranks' rows differ and a wrong shard or a mean of
# the ranks' PSNRs shows) on two gloo ranks sharing the card, `steps` compared
# with one process on the global batch, then `timed` steps. The noise floor is
# the same comparison for one process that runs each network on the ranks' two
# blocks of 8 rows and accumulates their gradients (``_split_step``): bf16 with
# 8 rows against 16 changes cuDNN's and K2/K4's reduction splits, and Adam turns
# that rounding into sign steps of lr. Each reading of the ranks (first step's
# G and D gradients, rel-L2 over the weights and over all parameters; after
# `steps`, the share of coordinates more than lr / 2 apart and the worst
# coordinate; each metric, relative, SSIM's absolute) must stay within `noise`
# times the floor's reading (the metrics': their largest) plus its
# `allowance`. ``--dp_faults`` plants each of FAULTS in the ranks and checks
# that the gate fails it.
DP = dict(batch=16, size=256, steps=3, timed=3, noise=2.0,
          allowance=dict(grad=1e-4, share=1e-3, worst=2e-6, metric=1e-4))
# planted data-axis faults, each in the ranks alone: both ranks take rows 0-7;
# the gradients summed over the ranks, not averaged; the TV sum not scaled by
# the data size
FAULTS = ("rows", "sum", "tv")
# The spatial axis (``spatial_phase``): tests/test_spatial_512.py's config
# (MixConvNeXtML, PatchGAN ndf 32, pool 0, w_vgg 0, batch 1, 512x512) over
# two gloo ranks sharing the card (data 1 x spatial 2) against one process:
# `steps` gated steps on one batch pair; the losses within that file's
# bounds (`losses`: (rtol, atol) at each step, tests/test_spatial_512.py:
# 89-93) of one process's, and every weight's first-step G and D gradient
# (and each net's weights as one vector) within rel-L2 `grad` of one
# process's, or within `noise` times the floor's reading on that weight
# where that is larger. The floor is one process that sums the
# InstanceNorm, BatchNorm, cascaded LayerNorm and channel-gate sums and
# K2/K4's sums over the image's two row halves, in the order the two
# strips sum them, and runs each conv on the halves as the strips run it
# (``_row_halves``): at 512² the first
# step's gradients of many weights cancel to ~1e-3 of their terms, and that
# order alone moves them 1e-3 from one process's. The f32 runs take the
# FMA check builds, erf GELU, TF32 off. Then the bf16 runs on the Hopper
# kernels, without and with VGG, `timed` more steps each, and K1-K4
# against their plain versions at the strips' shapes.
SPATIAL = dict(size=512, batch=1, steps=2, timed=3, grad=1e-4, noise=2.0,
               losses=((2e-5, 1e-6), (2e-4, 1e-5)),
               keys=("loss_G", "loss_D", "loss_G_L1", "loss_ssim", "loss_tv"), pool=50, ddim=20)
# The other recipes on the same two ranks at the same size and batch, at full
# width (``_sp_recipe``): CycleGAN (two MixConvNeXtML, PatchGAN ndf 32,
# lambda_identity 0.5, LSGAN; f32 pool 0, bf16 pools of SPATIAL["pool"] full
# from the start, so that every query draws), diffusion (DenoiseUNet nf 64,
# T 1000; the bf16 run also draws a DDIM sample of SPATIAL["ddim"] steps on
# the strips) and resnet_9blocks ngf 64 under --norm batch against the
# PatchGAN ndf 32 with BatchNorm (D on the fake and the real batch apart).
# f32 takes SP_STEPS[False] steps, bf16 SP_STEPS[True]; each f32 run is
# held by ``sp_gate`` on its SP_GATE_KEYS.
# The rest of the zoo (``SP_ZOO``: model, generator, discriminator, norm) at
# ngf 64 against D ndf 32, pix2pix unless named: unet_256 against the pixel D,
# gll against the multiscale D, cascaded, unetpp and wnet under --norm batch
# against the PatchGAN, unet_128 in CycleGAN against the multiscale D.
SP_ZOO = {"unet_pixel": ("pix2pix", "unet_256", "pixel", "instance"),
          "gll_multi": ("pix2pix", "gll", "multi", "instance"),
          "cascaded": ("pix2pix", "cascaded", "basic", "instance"),
          "unetpp": ("pix2pix", "unetpp", "basic", "instance"),
          "wnet_batch": ("pix2pix", "wnet", "basic", "batch"),
          "cycle_unet_multi": ("cycle_gan", "unet_128", "multi", "instance")}
SP_RECIPES = ("cycle_gan", "diffusion", "norm_batch") + tuple(SP_ZOO)
SP_STEPS = {False: 1, True: 2}
_PIX2PIX_KEYS = ("loss_G", "loss_D", "loss_G_L1", "loss_ssim", "loss_tv")
_CYCLE_KEYS = ("loss_G", "loss_G_A", "loss_cycle_A", "loss_idt_A", "loss_tv", "loss_D_A",
               "loss_D_B")
# (model, generator, discriminator, norm) of each recipe ``_sp_recipe``
# builds (the spatial phase's "pix2pix" is ``_sp_steps``')
RECIPES = {"default": ("pix2pix", "MixConvNeXtML", "basic", "instance"),
           "norm_batch": ("pix2pix", "resnet_9blocks", "basic", "batch"),
           "resnet6_nlayers_none": ("pix2pix", "resnet_6blocks", "n_layers", "none"),
           **SP_ZOO,
           "cycle_gan": ("cycle_gan", "MixConvNeXtML", "basic", "instance"),
           "diffusion": ("diffusion", None, None, None)}
SP_GATE_KEYS = {"pix2pix": SPATIAL["keys"], "diffusion": ("loss_G",),
                **{r: _CYCLE_KEYS if m == "cycle_gan" else _PIX2PIX_KEYS
                   for r, (m, _, _, _) in RECIPES.items() if m != "diffusion"}}
# The card against the port's CPU path (``card_vs_cpu_phase``): each of
# CVC_RECIPES (together every generator and discriminator of
# ``models/registry.py``, every norm and model; the default recipe with its
# VGG term, on the K1-K4 f32 check builds) built on the CPU from its seed in
# f32 at `size`, batch `batch` (CycleGAN's `cycle_batch`), its state dicts
# copied to the card; one train step on each side from one numpy batch pair
# (TF32 off, cuDNN's deterministic algorithms, dropout off, pools of 0,
# diffusion's t and eps drawn from the seed and handed to both) at `lr` 0,
# so that the G loss meets the D the CPU's does (Adam's first step is the
# sign of each gradient: a rounding turns into a step of lr). On the card
# every module's output and each generator application's cotangent are
# held at the CPU's (``cvc_side``): each layer runs on the CPU's inputs and
# every kink (ReLU, LeakyReLU, PReLU, max pools, L1, TV) decides as it did
# there. Readings (``cvc_readings``): each loss of SP_GATE_KEYS, each
# module's output (its forward on the CPU's inputs), each generator output
# and cotangent, every parameter gradient of every network, rel-L2 against
# the CPU's, over min(`cap`, max(1, the floor's same distance /
# `resolution`)): the floor is the CPU's step again in another order, its
# parameters, modules' outputs and their cotangents `floor_eta` off; a
# gradient f32 does not resolve to `cap` x `resolution` (0 in exact
# arithmetic, or a sum that cancels; or its RMS under `null` times its
# network's) reads max|card - CPU| over its network's gradient norm. The
# eval ops (``cvc_eval_ops``) read rel-L2 of their f32 forwards at `size`
# (the 5-D SSIM on volumes `volume_depth` deep). Every reading must stay
# under `limit`, set from clean readings on an H100 (PERF.md §6, the
# card-vs-CPU finding): at least 10x the worst, at most 1e-3.
# ``--card_vs_cpu_faults`` plants each of CVC_FAULTS on the card side of its
# recipe alone, and the gate must refuse it by 10x the limit in the readings
# it names.
CARD_VS_CPU = dict(size=256, batch=2, cycle_batch=1, lr=0.0, null=1e-4, cap=10.0,
                   resolution=1e-5, floor_eta=2.0 ** -21, limit=1e-3, volume_depth=16)
CVC_RECIPES = ("default", "norm_batch", "resnet6_nlayers_none") + tuple(SP_ZOO) + (
    "cycle_gan", "diffusion")
# planted card faults: torch's own average pool in place of ``ops.pool_avg``
# (the real torch fault of queue C), whose wrong input gradient reaches gll
# as the cotangent the multiscale D's pools hand back (D's own gradients
# never cross its pools: they act on its input; gll's are computed from the
# CPU's cotangent, so only that cotangent reads it); a transposed conv's
# weight gradient times 1 + 1e-2 on CUDA tensors; every conv's forward
# output times 1 + 2e-2 on CUDA tensors, its gradient unchanged. (recipe,
# the groups of readings the gate must refuse by 10x its limit)
CVC_FAULTS = {"torch_pool": ("gll_multi", ("out_grad.netG.",)),
              "transposed_gain": ("unet_pixel", ("grad.netG.",)),
              "forward_gain": ("unet_pixel", ("module.netG.", "module.netD."))}
# planted spatial-axis faults, each in the ranks alone: the halo rows zeroed;
# the InstanceNorm statistics of the strip alone; K2's / K4's S sums not
# summed over the row group; the fold dividing by the strip's H * W; the
# gradients divided by all the ranks (averaged over the row group too; with
# one data row a sum over the data axis is its mean); BatchNorm counting its
# strip's rows (times the data axis alone); diffusion's eps drawn per strip
# (a strip-sized draw); each rank's pool drawing on its own (the bf16 ranks
# no longer identical); the cascaded LayerNorm's two sums over the strip
# alone; CBAM's channel-gate mean over the strip alone; the 3x3 average
# pool's divisor taken from the strip's own padding (each strip pooled as
# if its edges were the image's). RECIPE_FAULTS: the recipes each is
# planted in.
SPATIAL_FAULTS = ("halo", "stats", "sums", "fold", "grads", "bn_count", "eps", "pool",
                  "cascade_ln", "cbam_mean", "pool_divisor")
RECIPE_FAULTS = {"halo": ("pix2pix",) + SP_RECIPES, "stats": ("pix2pix",),
                 "sums": ("pix2pix",), "fold": ("pix2pix",), "grads": ("pix2pix",) + SP_RECIPES,
                 "bn_count": ("norm_batch", "wnet_batch"), "eps": ("diffusion",),
                 "pool": ("cycle_gan",), "cascade_ln": ("cascaded",), "cbam_mean": ("unetpp",),
                 "pool_divisor": ("gll_multi",)}
# The remat phase (``remat_phase``): the training recipe of phase 6
# (``bench.build``) with and without --remat. At `size` and `batch`: one
# step's G and D gradients from one state, bit for bit under cuDNN's
# deterministic algorithms, and its launches (REMAT_PER_STEP: K1 and K3
# run again in the recompute); the replayed remat step against the eager
# one (``replay_vs_eager``, GRAPH's fill and steps); at each of `sizes`
# `warmup` + `steps` timed steps each way (step ms, peak memory); at `big`
# the largest of `big_batches` whose step runs each way.
REMAT = dict(size=256, batch=16, sizes=(256, 512), warmup=2, steps=3, big=1024,
             big_batches=(1, 2, 4, 8, 16))
REMAT_PER_STEP = {"K1": 10, "K3": 8, "K2": 5, "K4": 4}
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores (the f32 kernel's FMA path).
HBM_BPS = 3.35e12
PEAK = {"bfloat16": 989e12, "float32": 67e12}

# (site, H = W at 256x256 input, input channels (two parts for K3), P)
K1_SITES = [("c1", 256, (3,), 64), ("c2", 128, (64,), 128), ("c3", 64, (128,), 256),
            ("c4", 32, (256,), 512), ("c5", 16, (512,), 1024)]
K3_SITES = [("uc1", 32, (512, 512), 512), ("uc2", 64, (256, 256), 256),
            ("uc3", 128, (128, 128), 128), ("uc4", 256, (64, 64), 64)]


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def time_ms(torch, fn, iters, repeats=5):
    """Time of one call, by CUDA events around ``iters`` calls: the best of
    ``repeats`` such runs (a call too small to fill the card is paced by the
    host, whose load from other work only ever adds time)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(repeats):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def bound(b, hw, c, p, dtype_name):
    """Least time of one block-core call: each input read once, the output
    written once, against the FLOPs of its three GEMMs."""
    s = 2 if dtype_name == "bfloat16" else 4
    weights = 4 * c * c + 4 * c * p + c * p + 4 * c + p
    nbytes = b * hw * (2 * c + p) * s + weights * s + 2 * b * c * 4
    flops = 2 * b * hw * (4 * c * c + 4 * c * p + c * p)
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / PEAK[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound_bwd(b, hw, c, p, dtype_name):
    """Least time of one block-core backward call: h, x and the cotangent
    read once, dn and dx written once, the weights read and their f32
    gradients written once, against the FLOPs of its six GEMMs (the
    hidden recomputed, da, dn, dx, dW1, dW2, dWs)."""
    s = 2 if dtype_name == "bfloat16" else 4
    weights = 4 * c * c + 4 * c * p + c * p + 4 * c
    grads = 4 * (weights + p)
    nbytes = b * hw * (2 * c + p) * s + b * hw * 2 * c * s + weights * s + grads + 4 * b * c * 4
    flops = 2 * b * hw * (12 * c * c + 8 * c * p + 2 * c * p)
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / PEAK[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def pass_times(torch, fn):
    """Device ms of each kernel one call of ``fn`` launches, by name, from
    torch.profiler (a second call, after a warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:60]: [e.self_device_time_total / 1e3, e.count] for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm().clamp(min=1e-30))


def compare_bwd(torch, names, got, want, tol):
    """(max abs error of the elementwise outputs, worst rel-L2 of the sums, ok)."""
    worst_abs, worst_rel, ok = 0.0, 0.0, True
    for name, g, w in zip(names, got, want):
        g, w = g.float(), w.float()
        ok &= bool(torch.isfinite(g).all()) and g.shape == w.shape
        err = (g - w).abs()
        scale = float(w.abs().max())
        if name.startswith(("dn", "dx", "dh")):
            rtol, atol = tol["elem"]
            atol = atol * scale if tol["scaled"] else atol
            ok &= bool((err <= atol + rtol * w.abs()).all())
            worst_abs = max(worst_abs, float(err.max()))
        else:
            r = rel_l2(g, w)
            worst_rel = max(worst_rel, r)
            ok &= float(err.max()) <= tol["max_abs"] * scale
            if tol["rel_l2"] is not None:
                ok &= r <= tol["rel_l2"]
    return worst_abs, worst_rel, ok


def _hw(side):
    """(H, W) of a site's side: H = W = side, or a strip's (rows, W)."""
    return tuple(side) if isinstance(side, tuple) else (side, side)


def check_backward(torch, bc, instance_stats, batch, dtype, gelu, iters,
                   sites=(K1_SITES, K3_SITES)):
    """Each K2 / K4 site (``sites``: K1's and K3's) at this batch and dtype
    on a random cotangent: kernel vs plain version, and the InstanceNorm
    fold of each."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(4321 + batch)
    dname = str(dtype).split(".")[-1]

    def act(c, side):
        t = torch.randn((batch, c, *_hw(side)), generator=gen, device="cuda")
        return t.to(dtype).contiguous(memory_format=torch.channels_last)

    for kernel, sites in zip(("K2", "K4"), sites):
        for site, side, parts, p in sites:
            hw = _hw(side)[0] * _hw(side)[1]
            c = sum(parts)
            w1, b1, w2, b2, ws = [
                (torch.randn(s, generator=gen, device="cuda") * k).to(dtype)
                for s, k in (((c, 4 * c), 0.05), ((4 * c,), 1.0), ((4 * c, p), 0.05), ((p,), 1.0),
                             ((c, p), 0.05))]
            hs, xs = [act(ci, side) for ci in parts], [act(ci, side) for ci in parts]
            g = act(p, side)
            stats = [s for h in hs for s in instance_stats(h)]
            with torch.no_grad():
                if kernel == "K2":
                    packed = bc.pack_weights(w1, b1, w2, b2, ws, dtype)
                    run = lambda: bc.block_core_bwd(hs[0], xs[0], *stats, g, w1, b1, w2, ws,
                                                    gelu, packed=packed)
                    plain = lambda: bc.block_core_bwd_reference(hs[0], xs[0], *stats, g, w1, b1,
                                                                w2, ws, gelu)
                    names = "dn dx dW1 db1 dW2 db2 dWs S1 S2".split()
                else:
                    packed = bc.pack_weights(w1, b1, w2, b2, ws, dtype, c1=parts[0])
                    run = lambda: bc.block_core2_bwd(*hs, *xs, *stats, g, w1, b1, w2, ws, gelu,
                                                     packed=packed)
                    plain = lambda: bc.block_core2_bwd_reference(*hs, *xs, *stats, g, w1, b1, w2,
                                                                 ws, gelu)
                    names = "dna dnb dxa dxb dW1 db1 dW2 db2 dWs S1a S2a S1b S2b".split()
                got, want = run(), plain()
                got = list(got) + folds(bc, got, hs, stats)
                want = list(want) + folds(bc, want, hs, stats)
                names = names + ["dh"] * len(hs)
                torch.cuda.synchronize()
                max_abs, worst_rel, ok = compare_bwd(torch, names, got, want, TOL_BWD[dname])
                del got, want
                ms = time_ms(torch, run, iters)
                plain_ms = time_ms(torch, plain, iters)
                passes = pass_times(torch, run) if dtype == torch.bfloat16 else None
            b_ms, b_by = bound_bwd(batch, hw, c, p, dname)
            cp, h4p = packed.w1.shape
            if dtype == torch.bfloat16:
                # the Hopper kernel: 128-row tiles, and the weight pass's row splits
                tile = dict(rows=128, splits=[j.nsplit for j in bc.k4_plan(
                    batch, hw, cp, h4p, p, packed.w2.shape[1]).jobs],
                            narrow=bc.narrow_route(parts[0], sum(parts[1:])))
            else:
                tile = dict(rows=bc.bwd_rows(cp, bc._hidden_chunk(h4p), packed.w2.shape[1]))
            row = dict(kernel=kernel, site=site, batch=batch, hw=_hw(side), dtype=dname,
                       gelu=gelu, max_abs_err=max_abs, worst_rel_l2=worst_rel, ok=ok, ms=ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, tile=tile, passes=passes)
            print(json.dumps(row))
            rows.append(row)
            if not ok:
                fail(f"{kernel} at {site} (batch {batch}, {dname}) disagrees with its plain "
                     f"version: max abs err {max_abs}, worst rel-L2 {worst_rel}")
    return rows


def check_kernels(torch, bc, instance_stats, batch, dtype, gelu, tol, iters,
                  sites=(K1_SITES, K3_SITES)):
    """Each K1 / K3 site (``sites``: K1's and K3's) at this batch and dtype:
    kernel vs plain version."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(1234 + batch)
    dname = str(dtype).split(".")[-1]

    def act(c, side):
        t = torch.randn((batch, c, *_hw(side)), generator=gen, device="cuda")
        return t.to(dtype).contiguous(memory_format=torch.channels_last)

    for kernel, sites in zip(("K1", "K3"), sites):
        for site, side, parts, p in sites:
            hw = _hw(side)[0] * _hw(side)[1]
            c = sum(parts)
            w = [torch.randn(s, generator=gen, device="cuda") * k
                 for s, k in (((c, 4 * c), 0.05), ((4 * c,), 1.0), ((4 * c, p), 0.05),
                              ((p,), 1.0), ((c, p), 0.05))]
            w = [t.to(dtype) for t in w]
            hs = [act(ci, side) for ci in parts]
            xs = [act(ci, side) for ci in parts]
            stats = [s for h in hs for s in instance_stats(h)]
            with torch.inference_mode():
                if kernel == "K1":
                    packed = bc.pack_weights(*w, dtype)
                    run = lambda: bc.block_core(hs[0], xs[0], *stats, *w, gelu, packed)
                    plain = lambda: bc.block_core_reference(hs[0], xs[0], *stats, *w, gelu)
                else:
                    packed = bc.pack_weights(*w, dtype, c1=parts[0])
                    run = lambda: bc.block_core2(*hs, *xs, *stats, *w, gelu, packed)
                    plain = lambda: bc.block_core2_reference(*hs, *xs, *stats, *w, gelu)
                got, want = run(), plain()
                torch.cuda.synchronize()
                if got.shape != (batch, p, *_hw(side)) or not got.is_contiguous(
                        memory_format=torch.channels_last):
                    fail(f"{kernel} {site}: output {tuple(got.shape)} in the wrong layout")
                err = (got.float() - want.float()).abs()
                ok = bool(torch.isfinite(got).all()) and bool(
                    (err <= tol["atol"] + tol["rtol"] * want.float().abs()).all())
                rel = rel_l2(got, want)
                ms = time_ms(torch, run, iters)
                plain_ms = time_ms(torch, plain, iters)
                passes = pass_times(torch, run) if dtype == torch.bfloat16 else None
            b_ms, b_by = bound(batch, hw, c, p, dname)
            row = dict(kernel=kernel, site=site, batch=batch, hw=_hw(side), dtype=dname, gelu=gelu,
                       max_abs_err=float(err.max()), rel_l2=rel, ok=ok, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, passes=passes)
            if dtype == torch.bfloat16:
                row["plan"] = bc.fwd_plan(batch * hw, parts[0], sum(parts[1:]),
                                          packed.w1.shape[1], packed.w2.shape[1])._asdict()
            print(json.dumps(row))
            rows.append(row)
            if not ok:
                fail(f"{kernel} at {site} (batch {batch}, {dname}) disagrees with its "
                     f"plain version: max abs err {row['max_abs_err']}")
    return rows


# kernel names by class; the block-core classes come first ("sm90" also
# names cuDNN's kernels)
_CLASSES = (("block_core fwd (K1/K3)", ("block_core_kernel", "bc2_fwd_sm90", "bc_fwd_")),
            ("block_core bwd (K2/K4)", ("bwd_rows_kernel", "bwd_weights_kernel",
                                        "bwd_reduce_kernel", "bc2_bwd_sm90")),
            ("convolution (cuDNN)", ("conv", "cudnn", "xmma", "depthwise", "implicit", "fprop",
                                     "dgrad", "wgrad", "sm90", "gemm")),
            ("optimizer (Adam)", ("adam", "multi_tensor", "foreach")),
            ("reduction (IN stats, pools, losses)", ("reduce", "pool")),
            ("copy / layout", ("copy", "memcpy", "cat", "pad")))


def _block_core(name):
    low = name.lower()
    return any(k in low for k in _CLASSES[0][1] + _CLASSES[1][1])


def _trace(torch, fn, settle=None):
    """One call of ``fn`` under torch.profiler, after one untraced call:
    (the profiler, the call's wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the trace can leave out the device work launched in its first
        # milliseconds (``--profile_trials``), so the call waits for it
        time.sleep(PROFILE_SETTLE_S if settle is None else settle)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof, wall_ms


def profile_trials(torch, prof_fns, n):
    """How often a trace leaves out the first kernels of the call it
    measures, without the settling wait and with it: ``n`` traces of each
    of ``prof_fns`` ({mode: fn}) each way, and per trace the kernels traced
    before the first block-core kernel and the block-core kernels traced.
    A trace is short where it traced fewer block-core kernels than the
    most of its mode's traces, or another count before the first of them
    than most of its mode's traces (a lost first block-core kernel raises
    that count)."""
    res = {}
    for settle in (0.0, PROFILE_SETTLE_S):
        for mode, fn in prof_fns.items():
            counts = []
            for _ in range(n):
                prof, _ = _trace(torch, fn, settle)
                names = [e.name for e in sorted(
                    (e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)]
                first = next((i for i, k in enumerate(names) if _block_core(k)), len(names))
                counts.append((first, sum(map(_block_core, names))))
            before = max(set(c[0] for c in counts), key=[c[0] for c in counts].count)
            most = max(c[1] for c in counts)
            short = [c for c in counts if c[0] != before or c[1] < most]
            res[f"{mode}_settle_{settle}"] = dict(
                traces=n, before_block_core=before, block_core=most, short=len(short),
                short_counts=short)
    print(json.dumps({"profile_trials": res}))
    return res


def profile_run(torch, fn, label, **info):
    """Device time of one call of ``fn`` by kernel class, from
    torch.profiler, and the share of its wall time the device sat idle; on
    the host, the kernels it launched and its busiest operators by self CPU
    time (the profiler's own cost included)."""
    prof, wall_ms = _trace(torch, fn)
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    by_class, block_core = {}, {}
    for name, ms, count in kernels:
        low = name.lower()
        cls = next((c for c, keys in _CLASSES if any(k in low for k in keys)), "elementwise")
        by_class[cls] = by_class.get(cls, 0.0) + ms
        if _block_core(name):
            block_core[name[:120]] = count
    device_ms = sum(ms for _, ms, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda k: -k[1])[:8]
    out = dict(info, wall_ms=wall_ms, device_ms=device_ms,
               idle_share=(1.0 - device_ms / wall_ms) if device_ms else None,
               device_launches=sum(c for _, _, c in kernels),
               by_class_ms=by_class, top=[[n[:90], ms, c] for n, ms, c in top],
               host_top=[[n[:60], ms, c] for n, ms, c in host],
               block_core_kernels=block_core)
    print(json.dumps({f"profile_{label}": out}))
    return out


def _counters(bc):
    return (bc.block_core, bc.block_core2, bc.block_core_bwd, bc.block_core2_bwd)


def zero_counts(bc):
    for f in _counters(bc):
        f.launches = 0


def read_counts(bc):
    return dict(zip(("K1", "K3", "K2", "K4"), (f.launches for f in _counters(bc))))


def serve_phase(torch, np, bc, mixconvnext, serve_mod, define_G, card):
    """Drive the serving path and prove every block ran its kernel."""
    from unittest import mock

    netG = define_G(3, 3, 32, "MixConvNeXtML", dtype=torch.bfloat16, device="cuda", seed=0)
    fn = serve_mod.serving_fn(netG)
    rng = np.random.default_rng(0)
    results = {}
    zero_counts(bc)
    forwards = 0
    for batch, steps in ((1, 30), (16, 10)):
        pool = [rng.integers(0, 256, (batch, 256, 256, 3), dtype=np.uint8) for _ in range(4)]
        serve_mod.serve_requests(fn, pool[:2], torch.device("cuda"))
        lat, out = serve_mod.serve_requests(fn, [pool[i % 4] for i in range(steps)],
                                            torch.device("cuda"))
        forwards += steps + 2
        if out.dtype != torch.uint8 or tuple(out.shape) != (batch, 256, 256, 3):
            fail(f"serving output {out.dtype} {tuple(out.shape)} at batch {batch}")
        results[batch] = dict(batch=batch, requests=steps,
                              latency_ms_p50=float(np.percentile(lat, 50)),
                              latency_ms_p95=float(np.percentile(lat, 95)),
                              img_per_s=batch * steps / (lat.sum() / 1e3), card=card)
        print(json.dumps({"serve": results[batch]}))
    launches = read_counts(bc)
    print(json.dumps({"serve_path_forwards": forwards, "launches": launches}))
    if launches != {"K1": 5 * forwards, "K3": 4 * forwards, "K2": 0, "K4": 0}:
        fail(f"launch counts {launches} after {forwards} forwards: want 5 K1 + 4 K3 each")
    x16 = torch.from_numpy(pool[0]).cuda()
    results["profile_b16"] = profile_run(torch, lambda: fn(x16), "serve_b16", batch=16)

    # the kernel path against the plain path on the card, same weights and input
    def plain_in(h, x, w1, b1, w2, b2, ws, gelu="tanh", packed=None):
        mean, rsig = bc.instance_stats(h)
        return bc.block_core_reference(h, x, mean, rsig, w1, b1, w2, b2, ws, gelu)

    def plain2_in(ha, hb, xa, xb, w1, b1, w2, b2, ws, gelu="tanh", packed=None):
        ma, ra = bc.instance_stats(ha)
        mb, rb = bc.instance_stats(hb)
        return bc.block_core2_reference(ha, hb, xa, xb, ma, ra, mb, rb, w1, b1, w2, b2, ws, gelu)

    u8 = torch.from_numpy(rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)).cuda()
    x = serve_mod.normalize_u8(u8).permute(0, 3, 1, 2)
    with torch.inference_mode():
        y_k = netG(x).float()
        with mock.patch.object(mixconvnext, "block_core_in", plain_in), \
                mock.patch.object(mixconvnext, "block_core2_in", plain2_in):
            y_p = netG(x).float()
    torch.cuda.synchronize()
    d = (y_k - y_p).abs()
    q_k, q_p = fn(u8), None
    with mock.patch.object(mixconvnext, "block_core_in", plain_in), \
            mock.patch.object(mixconvnext, "block_core2_in", plain2_in):
        q_p = fn(u8)
    pix = (q_k.int() - q_p.int()).abs()
    agree = dict(max_abs_err=float(d.max()), ref_max_abs=float(y_p.abs().max()),
                 rel_l2=float(d.norm() / y_p.norm()), pixels_off=float((pix > 0).float().mean()),
                 pixels_max_off=int(pix.max()))
    print(json.dumps({"kernel_vs_plain_generator": agree}))
    if not (torch.isfinite(y_k).all() and tuple(y_k.shape) == (2, 3, 256, 256)):
        fail("generator output not finite or of the wrong shape")
    if not bool((d <= TOL_BF16["atol"] + TOL_BF16["rtol"] * y_p.abs()).all()):
        fail(f"kernel path disagrees with the plain path: {agree}")
    return results, launches, agree


def _pixels_off(torch, got, want):
    """Share of uint8 pixels that differ, and the largest difference."""
    d = (got.int() - want.int()).abs()
    return float((d > 0).float().mean()), int(d.max())


def export_phase(torch, np, bc, serve_mod, define_G, card):
    """The serving artifact (``dsgan_tpu_torch.export``) of the full-width
    bf16 generator: exported with a symbolic batch, saved, loaded back
    through ``load_artifact``; at batch 1 and 16 its output against
    ``serve.serving_fn``'s (bit for bit, else at most EXPORT["pixels_off"]
    of pixels one level off), 5 K1 + 4 K3 launches per artifact forward,
    request latency of the two in turns; then the w8 artifact from the
    same weights held in f32: its size beside the float one's, its
    launches, and the quality gate (SSIM / PSNR against the float
    artifact, and ``export._quant_gate``)."""
    from types import SimpleNamespace

    from dsgan_tpu_torch import export

    dev = torch.device("cuda")
    size = EXPORT["size"]
    netG = define_G(3, 3, 32, "MixConvNeXtML", dtype=torch.bfloat16, device="cuda", seed=0)
    res = dict(size=size, card=card)
    forwards = 0
    zero_counts(bc)
    with tempfile.TemporaryDirectory(prefix="dsgan_export_") as tmp:
        t0 = time.perf_counter()
        program, meta = export.export_generator(netG, size, size, 3)
        res["export_s"] = time.perf_counter() - t0
        if meta["batch"] != "polymorphic":
            fail(f"export: the artifact's batch is {meta['batch']}, not symbolic")
        path = export.save_artifact(os.path.join(tmp, "g.pt2"), program, meta)
        t0 = time.perf_counter()
        call, _ = export.load_artifact(path)
        res["load_s"] = time.perf_counter() - t0
        res["bytes_float"] = os.path.getsize(path)
        fn = serve_mod.serving_fn(netG)
        rng = np.random.default_rng(11)
        for batch, requests in ((1, EXPORT["requests_b1"]), (16, EXPORT["requests_b16"])):
            x = torch.from_numpy(rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8))
            x = x.to(dev)
            before = read_counts(bc)
            got = call(x)
            torch.cuda.synchronize()
            after = read_counts(bc)
            forwards += 1
            per = {k: after[k] - before[k] for k in after}
            if per != {"K1": 5, "K3": 4, "K2": 0, "K4": 0}:
                fail(f"export: an artifact forward at batch {batch} launched {per}: want 5 K1 "
                     "+ 4 K3")
            want = fn(x)
            forwards += 1
            off, max_off = _pixels_off(torch, got, want)
            if got.dtype != torch.uint8 or tuple(got.shape) != (batch, size, size, 3):
                fail(f"export: artifact output {got.dtype} {tuple(got.shape)} at batch {batch}")
            if not (off == 0.0 or (max_off <= 1 and off <= EXPORT["pixels_off"])):
                fail(f"export: the artifact differs from serving_fn at batch {batch}: "
                     f"{off:.2e} of pixels off, by up to {max_off}")
            pool = [rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8) for _ in range(4)]
            turns = []
            for mode in ("serving_fn", "artifact", "artifact", "serving_fn"):
                f = fn if mode == "serving_fn" else call
                serve_mod.serve_requests(f, pool[:2], dev)
                lat, _ = serve_mod.serve_requests(f, [pool[i % 4] for i in range(requests)], dev)
                forwards += requests + 2
                turns.append(dict(mode=mode, latency_ms_p50=float(np.percentile(lat, 50)),
                                  latency_ms_p95=float(np.percentile(lat, 95)),
                                  img_per_s=batch * requests / (lat.sum() / 1e3)))
            # one request of each under the profiler: device time, idle share
            prof = {}
            for mode, f in (("serving_fn", fn), ("artifact", call)):
                p = profile_run(torch, lambda f=f: f(x), f"export_{mode}_b{batch}", batch=batch)
                prof[mode] = {k: p[k] for k in ("wall_ms", "device_ms", "idle_share",
                                                "by_class_ms")}
                forwards += 2
            res[f"b{batch}"] = dict(bitwise=off == 0.0, pixels_off=off, max_off=max_off,
                                    held="bit for bit" if off == 0.0 else
                                    f"at most {EXPORT['pixels_off']} of pixels one level off",
                                    turns=turns, profile=prof)
            print(json.dumps({f"export_b{batch}": dict(res[f"b{batch}"], card=card)}))

        # w8 from the f32 weights of the same seed, as the export CLI does
        net32 = define_G(3, 3, 32, "MixConvNeXtML", dtype=torch.bfloat16, device="cuda", seed=0,
                         train=True).eval()
        t0 = time.perf_counter()
        q_program, q_meta = export.export_generator(net32, size, size, 3, quantize="w8")
        res["export_w8_s"] = time.perf_counter() - t0
        q_path = export.save_artifact(os.path.join(tmp, "g_w8.pt2"), q_program, q_meta)
        res["bytes_w8"] = os.path.getsize(q_path)
        q_call, _ = export.load_artifact(q_path)
        probe = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (1, size, size, 3), dtype=np.uint8)).to(dev)
        before = read_counts(bc)
        yq = q_call(probe)
        torch.cuda.synchronize()
        after = read_counts(bc)
        yf = call(probe)
        forwards += 2
        per = {k: after[k] - before[k] for k in after}
        if per != {"K1": 5, "K3": 4, "K2": 0, "K4": 0}:
            fail(f"export: a w8 artifact forward launched {per}: want 5 K1 + 4 K3")
        a, b = (t.permute(0, 3, 1, 2).float() for t in (yf, yq))
        from dsgan_tpu_torch.ops import psnr_uint8, ssim_uint8

        res["w8_vs_float_artifact"] = dict(ssim=float(ssim_uint8(a, b)),
                                           psnr=float(psnr_uint8(a, b)))
        opt = SimpleNamespace(fineSize_h=size, fineSize_w=size, input_nc=3)
        res["quant_gate"] = export._quant_gate(net32, opt,
                                               SimpleNamespace(quant_tol=EXPORT["quant_tol"]))
        forwards += 2
    launches = read_counts(bc)
    if launches != {"K1": 5 * forwards, "K3": 4 * forwards, "K2": 0, "K4": 0}:
        fail(f"export: launch counts {launches} after {forwards} forwards: want 5 K1 + 4 K3 each")
    res.update(forwards=forwards, launches=launches, size_ratio=res["bytes_w8"] / res["bytes_float"])
    print(json.dumps({"export": {k: v for k, v in res.items() if k not in ("b1", "b16")}}))
    return res, launches


def zoo_phase(torch, np, bc, card):
    """The zoo on the card: each generator of ZOO["generators"] in bf16 at
    ngf 64, batch 1, finite output of its size; the train CLI on the zoo
    recipe (resnet_9blocks, --norm batch, multiscale D, batch 1,
    --steps_per_dispatch 4) for one epoch of synthetic PNGs, whose losses
    must be finite and whose graph must capture once the pool is full;
    and that recipe's 4 replays against 4 eager steps from one state
    (``replay_vs_eager``), BatchNorm buffers and the dropout generator
    included. The zoo launches no block-core kernel."""
    from PIL import Image

    from dsgan_tpu_torch import train as train_cli
    from dsgan_tpu_torch.models import define_D, define_G, define_vgg
    from dsgan_tpu_torch.models.pix2pix import Pix2PixConfig, init_state, make_train_step

    dev = torch.device("cuda")
    res = dict(card=card, generators={})
    zero_counts(bc)
    for name, size in ZOO["generators"]:
        net = define_G(3, 3, 64, name, dtype=torch.bfloat16, device="cuda", seed=1)
        x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (1, 3, size, size))
                             .astype(np.float32)).to(dev)
        with torch.inference_mode():
            y = net(x)
            ms = time_ms(torch, lambda: net(x), 3, repeats=3)
        if tuple(y.shape) != (1, 3, size, size) or not bool(torch.isfinite(y).all()):
            fail(f"zoo: {name} gave {tuple(y.shape)}, finite {bool(torch.isfinite(y).all())}")
        res["generators"][name] = dict(size=size, forward_ms=ms, parameters=sum(
            p.numel() for p in net.parameters()))
        del net
    print(json.dumps({"zoo_generators": res["generators"]}))

    recipe = ["--which_model_netG", "resnet_9blocks", "--norm", "batch", "--which_model_netD",
              "multi", "--ngf", "64", "--ndf", "64", "--batchSize", "1",
              "--steps_per_dispatch", "4"]
    pairs = ZOO["train_pairs"]
    with tempfile.TemporaryDirectory(prefix="dsgan_zoo_") as tmp:
        rng = np.random.default_rng(6)
        d = os.path.join(tmp, "data", "train_all")
        os.makedirs(d)
        for side in "ab":
            for i in range(pairs):
                Image.fromarray(rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)).save(
                    os.path.join(d, f"{side}_{i:02d}.png"))
        t0 = time.perf_counter()
        model, rows = train_cli.main(recipe + [
            "--dataroot", os.path.join(tmp, "data"), "--checkpoints_dir",
            os.path.join(tmp, "checkpoints"), "--name", "zoo", "--niter", "1",
            "--niter_decay", "0", "--print_freq", "10"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        counts = dict(model._chained.counts)
        losses = _finite_log(os.path.join(tmp, "checkpoints", "zoo", "result.csv"))
        stats = [k for k in model.netD.state_dict() if k.endswith("running_var")]
    if len(rows) != pairs or not losses or not all(math.isfinite(v) for v in losses):
        fail(f"zoo CLI: {len(rows)} steps, losses {losses[:12]}")
    if counts["captured"] != 1 or counts["replayed"] != pairs - 50 or not stats:
        fail(f"zoo CLI: counts {counts} (want a capture once the pool of 50 is full and "
             f"{pairs - 50} replays), D's BatchNorm buffers {stats[:2]}")
    res["cli"] = dict(steps=len(rows), counts=counts, seconds=cli_s,
                      step_ms=[round(sum(r[2:]) * 1e3, 3) for r in rows][-8:])
    print(json.dumps({"zoo_cli": res["cli"]}))

    def build():
        cfg = Pix2PixConfig(pool_size=50, use_vgg=True, compute_dtype=torch.bfloat16,
                            fuse_d_batch=False)
        g = define_G(3, 3, 64, "resnet_9blocks", norm="batch", use_dropout=True,
                     dtype=torch.bfloat16, device=dev, seed=3, train=True)
        dnet = define_D(6, 64, "multi", norm="batch", dtype=torch.bfloat16, device=dev, seed=4)
        vgg = define_vgg(4, dtype=torch.bfloat16, device=dev, seed=5)
        return init_state(g, dnet, vgg, cfg, (256, 256), seed=3), make_train_step(cfg), cfg

    graph, _, run = replay_vs_eager(torch, np, bc, build, 1, 256, 50, 4,
                                    {"K1": 0, "K3": 0, "K2": 0, "K4": 0}, "zoo graph")
    compared = _state_tensors(torch, run["a_state"])
    graph["batchnorm_buffers_compared"] = sum("running_" in p for p in compared)
    graph["dropout_generator_compared"] = "/dropout_generator" in compared
    res["graph"] = graph
    print(json.dumps({"zoo_graph_vs_eager": graph}))
    launches = read_counts(bc)
    if any(launches.values()):
        fail(f"zoo: the zoo launched block-core kernels {launches}")
    return res


def _write_pngs(np, d, n, size, rng, prefix):
    from PIL import Image

    os.makedirs(d, exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            os.path.join(d, f"{prefix}_{i:02d}.png"))


def _write_frames(np, d, n, size):
    """``n`` frames of a smooth scene that moves 2 pixels a frame."""
    from PIL import Image

    os.makedirs(d)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for t in range(n):
        img = np.stack([np.sin(0.05 * (xx - 2 * t) + c) * np.cos(0.04 * (yy - 2 * t) - c)
                        for c in (0.0, 1.0, 2.0)], -1)
        Image.fromarray(((img + 1) * 127.5).astype(np.uint8)).save(
            os.path.join(d, f"frame_{t:03d}.png"))


def _expect(bc, per, n, what):
    got, want = read_counts(bc), {k: v * n for k, v in per.items()}
    if got != want:
        fail(f"{what}: launch counts {got}, want {want} ({per} x {n})")
    return got


def cyclegan_build(torch, seed=0):
    """A CycleGAN train state of the phase's recipe on the card (full-width
    MixConvNeXtML G_A / G_B, PatchGAN ndf 32 D_A / D_B, bf16, pool 50,
    lambda_identity 0.5), its step and its config."""
    from dsgan_tpu_torch.models import cycle_gan, define_D, define_G

    dev = torch.device("cuda")
    cfg = cycle_gan.CycleGANConfig(pool_size=50, lambda_identity=0.5)
    nets = [define_G(3, 3, 32, "MixConvNeXtML", dtype=torch.bfloat16, device=dev,
                     seed=seed + i, train=True) for i in range(2)]
    nets += [define_D(3, 32, "basic", dtype=torch.bfloat16, device=dev, seed=seed + 2 + i)
             for i in range(2)]
    return (cycle_gan.init_state(*nets, cfg, (CYCLE["size"],) * 2, seed=seed),
            cycle_gan.make_cyclegan_step(cfg), cfg)


def cyclegan_gradients(torch, np, bc, state, cfg, batch, term="full", enforce=True):
    """``gradient_check`` of G_A's and G_B's block weights under
    ``CYCLE_GRAD_GATE`` on one term of the G loss (``CYCLE_TERMS``), from a
    batch of random images (seed 8) against the current Ds."""
    from dsgan_tpu_torch.models import cycle_gan

    keys, calls = CYCLE_TERMS[term]
    rng, size = np.random.default_rng(8), CYCLE["size"]
    A0, B0 = (cycle_gan.images(torch.from_numpy(
        rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)).cuda(), None)
        for _ in range(2))
    return gradient_check(
        torch, bc, {"G_A": state.netG_A, "G_B": state.netG_B}, (state.netD_A, state.netD_B),
        lambda f32: sum(cycle_gan.generator_loss(cfg, state, A0, B0)[0][k] for k in keys),
        calls=calls, gate_limits=CYCLE_GRAD_GATE, label=f"cyclegan_{term}_b{batch}",
        enforce=enforce)


def cyclegan_phase(torch, np, bc, card):
    """The CycleGAN step (``models/cycle_gan.py``) on the K1-K4 path: the
    G_A / G_B gradient check on the state as built (``cyclegan_gradients``,
    with its faulty controls), timed eager steps at batch 1 and 16 with
    their launches and peak memory, a profiled step, 4 CUDA-graph replays
    against 4 eager steps once both pools are full, then the train, eval
    (random Inception features: FID / KID rows) and video CLIs in-process
    on synthetic unaligned data. Every eager or captured step launches
    30 K1 + 24 K3 + 30 K2 + 24 K4; every eval image 4 generator forwards of
    5 K1 + 4 K3; every video batch one."""
    from dsgan_tpu_torch.models import cycle_gan

    dev, size, lr = torch.device("cuda"), CYCLE["size"], 2e-4
    zero = {"K1": 0, "K3": 0, "K2": 0, "K4": 0}

    state, step, cfg = cyclegan_build(torch)
    n_params = sum(p.numel() for p in state.netG_A.parameters())
    if n_params != 22425232:
        fail(f"cyclegan: G_A has {n_params} parameters, not the full-width 22,425,232")
    res = dict(card=card, g_parameters=n_params, timed={})
    res["gradients"] = cyclegan_gradients(torch, np, bc, state, cfg, CYCLE["grad_batch"])
    torch.cuda.empty_cache()
    launches = dict(zero)
    rng = np.random.default_rng(8)

    def batch_of(b):
        return [torch.from_numpy(rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8))
                .to(dev) for _ in range(2)]

    def timed(b):
        data = [batch_of(b) for _ in range(2)]
        before = {k: p.detach().clone() for k, p in state.netG_A.named_parameters()}
        torch.cuda.synchronize()
        zero_counts(bc)
        torch.cuda.reset_peak_memory_stats()
        metrics = [step(state, *data[i % 2], lr)[0] for i in range(CYCLE["warmup"])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics += [step(state, *data[i % 2], lr)[0] for i in range(CYCLE["steps"])]
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / CYCLE["steps"]
        n = CYCLE["warmup"] + CYCLE["steps"]
        got = _expect(bc, CYCLE_PER_STEP, n, f"cyclegan step, batch {b}")
        finite = all(bool(torch.isfinite(v)) for m in metrics for v in m.values())
        moved = sum(not torch.equal(before[k], p.detach())
                    for k, p in state.netG_A.named_parameters())
        if not finite or moved != len(before):
            fail(f"cyclegan step, batch {b}: finite {finite}, {moved} of {len(before)} moved")
        r = dict(batch=b, step_ms=dt * 1e3, img_per_s=b / dt,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, steps_counted=n,
                 launches=got, losses={k: float(v) for k, v in metrics[-1].items()},
                 pools=[state.pool_A.count, state.pool_B.count])
        r["profile"] = profile_run(torch, lambda: step(state, *data[0], lr), f"cyclegan_b{b}",
                                   batch=b)
        for k in launches:
            launches[k] += got[k]
        return r

    for b in CYCLE["batches"]:
        try:
            r = timed(b)
        except torch.cuda.OutOfMemoryError as e:
            res[f"b{b}_refused"] = str(e).splitlines()[0][:200]
            torch.cuda.empty_cache()
            r = timed(b // 2)
        res["timed"][f"b{r['batch']}"] = r
        print(json.dumps({f"cyclegan_b{r['batch']}": r}))

    del state, step
    torch.cuda.empty_cache()

    graph, glaunch, run = replay_vs_eager(
        torch, np, bc, lambda: cyclegan_build(torch), 1, size, CYCLE["fill"], CYCLE["replays"],
        CYCLE_PER_STEP, "cyclegan graph", chain=cycle_gan.chained_cyclegan_step)
    res["graph"] = dict(graph, card=card)
    print(json.dumps({"cyclegan_graph_vs_eager": res["graph"]}))
    for k in launches:
        launches[k] += glaunch[k]
    del run
    torch.cuda.empty_cache()

    cli, cli_launches = cyclegan_clis(torch, np, bc, card, rng)
    res.update(cli)
    res["launches"] = {k: launches[k] + cli_launches[k] for k in launches}
    return res, res["launches"]


def cyclegan_clis(torch, np, bc, card, rng):
    """The train, eval and video CLIs of the CycleGAN phase, in-process,
    on synthetic unaligned PNGs and frames from ``rng``."""
    from dsgan_tpu_torch import test as eval_cli
    from dsgan_tpu_torch import train as train_cli
    from dsgan_tpu_torch import video as video_cli

    size = CYCLE["size"]
    res, launches = {}, {"K1": 0, "K3": 0, "K2": 0, "K4": 0}
    with tempfile.TemporaryDirectory(prefix="dsgan_cyclegan_") as tmp:
        data, ckpt, results = (os.path.join(tmp, d) for d in ("data", "checkpoints", "results"))
        t0 = time.perf_counter()
        for phase, counts in (("train", (CYCLE["train_A"], CYCLE["train_B"])),
                              ("test", (CYCLE["test"], CYCLE["test"]))):
            for side, n in zip("AB", counts):
                _write_pngs(np, os.path.join(data, phase + side), n, size, rng, side.lower())
        _write_frames(np, os.path.join(tmp, "frames"), CYCLE["frames"], size)
        write_s = time.perf_counter() - t0
        common = ["--dataroot", data, "--checkpoints_dir", ckpt, "--name", "cyc",
                  "--model", "cycle_gan", "--dataset_mode", "unaligned"]
        per_epoch = max(CYCLE["train_A"], CYCLE["train_B"]) // CYCLE["cli_batch"]

        zero_counts(bc)
        t0 = time.perf_counter()
        model, rows = train_cli.main(common + [
            "--phase", "train", "--batchSize", str(CYCLE["cli_batch"]), "--print_freq", "4",
            "--steps_per_dispatch", str(CYCLE["k"]), "--niter", "1", "--niter_decay", "1"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = dict(model._chained.counts)
        # a capture runs nothing: the replay after it runs its step
        if (len(rows) != 2 * per_epoch or counts["captured"] != 1
                or counts["eager"] + counts["replayed"] != 2 * per_epoch):
            fail(f"cyclegan train CLI: {len(rows)} steps, counts {counts}: want "
                 f"{2 * per_epoch} steps with one capture once both pools were full")
        got = _expect(bc, CYCLE_PER_STEP, counts["eager"] + counts["captured"],
                      "cyclegan train CLI")
        for k in launches:
            launches[k] += got[k]
        losses = _finite_log(os.path.join(ckpt, "cyc", "result.csv"))
        if not losses or not all(math.isfinite(v) for v in losses):
            fail(f"cyclegan train CLI: losses {losses[:20]}")
        missing = [f for f in ("epoch_1", "epoch_2", "result.csv", "each_epoch.csv",
                               f"train_img/train_Re2_{per_epoch}.png")
                   if not os.path.exists(os.path.join(ckpt, "cyc", f))]
        if missing:
            fail(f"cyclegan train CLI did not write {missing}")
        # host ms of each step (the loader's wait, its share of its chunk, the
        # print work): the Python loader, every step of epoch 2 after the capture
        # a replay
        res["cli_train"] = dict(steps=len(rows), batch=CYCLE["cli_batch"], counts=counts,
                                step_ms=[round(sum(r[2:]) * 1e3, 3) for r in rows],
                                launches=got, seconds=train_s, dataset_write_s=write_s,
                                card=card)
        print(json.dumps({"cyclegan_cli_train": res["cli_train"]}))

        zero_counts(bc)
        ev_model, ev_rows = eval_cli.main(common + [
            "--phase", "test", "--which_epoch", "2", "--how_many", str(CYCLE["test"]),
            "--results_dir", results, "--inception_weights", "random"])
        torch.cuda.synchronize()
        got = _expect(bc, {"K1": 20, "K3": 16, "K2": 0, "K4": 0}, len(ev_rows),
                      "cyclegan eval CLI (4 generator forwards an image)")
        for k in launches:
            launches[k] += got[k]
        with open(os.path.join(results, "cyc", "test_2", "metrics.csv")) as f:
            table = {r[0]: r for r in csv.reader(f)}
        if len(ev_rows) != CYCLE["test"] or not all(
                k in table and math.isfinite(float(table[k][2])) for k in ("mean", "fid", "kid")):
            fail(f"cyclegan eval CLI: {len(ev_rows)} rows, table {list(table)}")
        res["cli_eval"] = dict(images=len(ev_rows), ms=[r["ms"] for r in ev_rows],
                               mean=table["mean"][2:], fid=float(table["fid"][2]),
                               kid=float(table["kid"][2]), launches=got, card=card)
        print(json.dumps({"cyclegan_cli_eval": res["cli_eval"]}))

        zero_counts(bc)
        t0 = time.perf_counter()
        tc = video_cli.main(["--dataroot", os.path.join(tmp, "frames"), "--name", "cyc",
                             "--checkpoints_dir", ckpt, "--which_epoch", "2", "--results_dir",
                             results, "--batchSize", "4"])
        torch.cuda.synchronize()
        video_s = time.perf_counter() - t0
        got = _expect(bc, {"K1": 5, "K3": 4, "K2": 0, "K4": 0},
                      -(-CYCLE["frames"] // 4), "video CLI (one forward a batch of 4 frames)")
        for k in launches:
            launches[k] += got[k]
        csv_path = os.path.join(results, "cyc", "video", "temporal.csv")
        with open(csv_path) as f:
            table = {r[0]: r[1:] for r in csv.reader(f) if r}
        if not math.isfinite(tc) or len(table) != CYCLE["frames"] + 3:
            fail(f"video CLI: TC {tc}, temporal.csv rows {list(table)}")
        res["cli_video"] = dict(frames=CYCLE["frames"], tc=tc, seconds=video_s,
                                flow_warped_err_out=float(table["flow_warped_err_out"][0]),
                                launches=got, card=card)
        print(json.dumps({"cyclegan_cli_video": res["cli_video"]}))
    return res, launches


def fid_phase(torch, np, card):
    """Pool3 features of FID["batch"] 256x256 images through the FID
    graph at random weights, resized to 299 on the device: the card (f32,
    TF32 off, as the extractor runs) against the plain CPU forward of the
    same weights, within FID["max_abs"] * max|CPU| and rel-L2
    FID["rel_l2"]; ms a batch; and the distance TF32 would put between
    them, with its ms."""
    from dsgan_tpu_torch.models import inception

    net = inception.define_inception("random", device="cuda", seed=0)
    cpu = inception.define_inception({k: v.cpu() for k, v in net.state_dict().items()},
                                     device="cpu")
    x = torch.from_numpy(np.random.default_rng(9).uniform(
        -1, 1, (FID["batch"], 3, FID["size"], FID["size"])).astype(np.float32))
    xc = x.cuda()

    def card_run():
        return net(inception.prepare_images(xc))

    with torch.inference_mode():
        want = cpu(inception.prepare_images(x))
        with inception.full_f32():
            got = card_run().cpu()
            ms = time_ms(torch, card_run, 5)
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = card_run().cpu()
            ms_tf32 = time_ms(torch, card_run, 5)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    scale = float(want.abs().max())
    res = dict(batch=FID["batch"], size=FID["size"], precision="f32, TF32 off",
               max_abs_err=float((got - want).abs().max()), ref_max_abs=scale,
               rel_l2=rel_l2(got, want), ms=ms, img_per_s=FID["batch"] / ms * 1e3,
               tf32=dict(max_abs_err=float((tf32 - want).abs().max()),
                         rel_l2=rel_l2(tf32, want), ms=ms_tf32),
               gate=dict(max_abs=FID["max_abs"], rel_l2=FID["rel_l2"]), card=card)
    print(json.dumps({"fid_features": res}))
    if (tuple(got.shape) != (FID["batch"], 2048) or not bool(torch.isfinite(got).all())
            or res["max_abs_err"] > FID["max_abs"] * scale or res["rel_l2"] > FID["rel_l2"]):
        fail(f"FID features on the card disagree with the CPU's: {res}")
    return res


def _plain_kernels(bc):
    """Patches that put the plain versions in the kernels' place (for the
    comparison only: the port has no such switch)."""
    from unittest import mock

    def fwd(*args, packed=None):
        return bc.block_core_reference(*args)

    def fwd2(*args, packed=None):
        return bc.block_core2_reference(*args)

    def bwd(*args, packed=None):
        return bc.block_core_bwd_reference(*args)

    def bwd2(*args, packed=None):
        return bc.block_core2_bwd_reference(*args)

    return [mock.patch.object(bc, n, f) for n, f in (
        ("block_core", fwd), ("block_core2", fwd2), ("block_core_bwd", bwd),
        ("block_core2_bwd", bwd2))]


def folds(bc, out, hs, stats):
    """The InstanceNorm cotangent dh of each part from a K2 / K4 output:
    its dn and its S1, S2 sums (the last 2 * parts outputs)."""
    n = len(hs)
    ss = out[len(out) - 2 * n:]
    return [bc.in_fold(out[i], hs[i], stats[2 * i], stats[2 * i + 1], ss[2 * i], ss[2 * i + 1])
            for i in range(n)]


def faulty(torch, kernel, kind, size):
    """A K2 / K4 with a fault of a known size in every output: ``gain``
    scales each by (1 + size), ``noise`` each element by (1 + size * N(0, 1))."""
    def call(*args, packed=None):
        out = kernel(*args, packed=packed)
        if kind == "gain":
            return tuple((o.float() * (1 + size)).to(o.dtype) for o in out)
        return tuple((o.float() * (1 + size * torch.randn_like(o, dtype=torch.float32)))
                     .to(o.dtype) for o in out)

    call.launches = 0
    return call


def gradient_check(torch, bc, generators, others, loss_fn, calls, gate_limits=None,
                   label="train", enforce=True):
    """From the train state as it stands, with cuDNN held to deterministic
    algorithms: the gradient of a step's G loss (``loss_fn(f32)``, a 0-d
    tensor) with respect to the block weights of ``generators`` (name ->
    MixConvNeXtML) through K1-K4 and through the plain versions.

    Block level: every K2/K4 call of the kernel path (``calls`` of them) is
    repeated by its plain version on the same inputs and cotangent, and
    every output (dn, dx, the weight gradients, the S sums) and the folded
    dh must agree within rel-L2 ``gate_limits["block"]``. Whole generators:
    each block weight's gradient, kernel path vs plain path, each path with
    its own bf16 forward and backward; the dwconv biases are left out
    (their gradient is zero in exact arithmetic: the InstanceNorm right
    after the depthwise conv removes any per-channel constant, so what is
    left is rounding). The median rel-L2 over the rest must be within
    ``gate_limits["median"]``, and against the same gradient in f32 (every
    net of ``generators`` and ``others`` computing in f32, ``loss_fn(True)``)
    the kernel path's median rel-L2 may be at most ``gate_limits["ratio"]``
    times the plain path's. The controls put faults of a known size into
    K2/K4's outputs and go through the same gate, block level and whole
    generators, which must refuse those in MUST_FAIL. ``enforce=False``
    returns the readings without failing on them."""
    from unittest import mock

    gate_limits = gate_limits or GRAD_GATE
    sites = {f"c{i}" for i in range(1, 6)} | {f"uc{i}" for i in range(1, 5)}
    blocks = {f"{name}.{k}": p for name, G in generators.items() for k, p in G.named_parameters()
              if k.split(".")[0] in sites and not k.endswith("dwconv.bias")}
    nets = list(generators.values()) + list(others)

    def grads(f32=False):
        for net in nets:
            net.zero_grad(set_to_none=True)
        loss_fn(f32).backward()
        out = {k: p.grad.float().clone() for k, p in blocks.items()}
        for net in nets:
            net.zero_grad(set_to_none=True)
        return out

    kernel_bwd, kernel_bwd2 = bc.block_core_bwd, bc.block_core2_bwd
    k2_names = ["dn", "dx"] + "dW1 db1 dW2 db2 dWs".split() + ["S1", "S2"]
    k4_names = ["dna", "dnb", "dxa", "dxb"] + "dW1 db1 dW2 db2 dWs".split() + [
        "S1a", "S2a", "S1b", "S2b"]

    def held(kernel, plain, label, names, nparts, sink):
        def call(*args, packed=None):
            out = kernel(*args, packed=packed)
            ref = plain(*args)
            hs, stats = args[:nparts], args[2 * nparts:4 * nparts]
            rels = {n: rel_l2(o, r) for n, o, r in zip(names, out, ref)}
            for i, (o, r) in enumerate(zip(folds(bc, out, hs, stats), folds(bc, ref, hs, stats))):
                rels["dh" + "ab"[i] * (nparts == 2)] = rel_l2(o, r)
            sink.append(dict(kernel=label, shape=list(args[0].shape), rel_l2=rels))
            return out

        # the wrapped kernel counts its launch on whatever holds its name:
        # here this stand-in, so the comparison's launches stay off the counts
        call.launches = 0
        return call

    def blockwise(k2, k4, sink):
        """Every K2 / K4 call held against its plain version, into ``sink``."""
        return (mock.patch.object(bc, "block_core_bwd", held(
                    k2, bc.block_core_bwd_reference, "K2", k2_names, 1, sink)),
                mock.patch.object(bc, "block_core2_bwd", held(
                    k4, bc.block_core2_bwd_reference, "K4", k4_names, 2, sink)))

    per_block, control_blocks = [], {}
    saved_cudnn = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        p2, p4 = blockwise(kernel_bwd, kernel_bwd2, per_block)
        with p2, p4:
            got = grads()
        controls = {}
        for kind, size in CONTROLS:
            name = f"{kind} {size}"
            control_blocks[name] = []
            torch.cuda.manual_seed(99)
            p2, p4 = blockwise(faulty(torch, kernel_bwd, kind, size),
                               faulty(torch, kernel_bwd2, kind, size), control_blocks[name])
            with p2, p4:
                controls[name] = grads()
        patches = _plain_kernels(bc)
        for p in patches:
            p.start()
        try:
            want = grads()
            # the same gradient in f32 (TF32 off, the same tanh GELU): what
            # both bf16 paths approximate
            modes = [m for G in generators.values() for m in G.modules()
                     if hasattr(m, "gelu_mode")]
            saved = [m.compute_dtype for m in nets], [m.gelu_mode for m in modes]
            for m in nets:
                m.compute_dtype = torch.float32
            for m in modes:
                m.gelu_mode = "tanh"
            try:
                truth = grads(f32=True)
            finally:
                for m, v in zip(nets, saved[0]):
                    m.compute_dtype = v
                for m, v in zip(modes, saved[1]):
                    m.gelu_mode = v
        finally:
            for p in patches:
                p.stop()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_cudnn

    def median(vals):
        vals = sorted(vals)
        return vals[len(vals) // 2]

    plain_f32 = median(rel_l2(want[k], truth[k]) for k in want)

    def gate(g, blocks):
        """The readings of one path's gradients, and whether they pass."""
        vs_plain = {k: rel_l2(g[k], want[k]) for k in want}
        r = dict(block_worst_rel_l2=max(v for b in blocks for v in b["rel_l2"].values()),
                 blocks=len(blocks), median_vs_plain=median(vs_plain.values()),
                 max_vs_plain=max(vs_plain.values()),
                 median_vs_f32=median(rel_l2(g[k], truth[k]) for k in want),
                 finite=all(bool(torch.isfinite(v).all()) for v in g.values()))
        r["ratio_to_plain_vs_f32"] = r["median_vs_f32"] / plain_f32
        r["passes"] = bool(r["finite"] and r["blocks"] == calls
                           and r["block_worst_rel_l2"] <= gate_limits["block"]
                           and r["median_vs_plain"] <= gate_limits["median"]
                           and r["ratio_to_plain_vs_f32"] <= gate_limits["ratio"])
        return r, vs_plain

    out, vs_plain = gate(got, per_block)
    out.update(gate=gate_limits, plain_median_vs_f32=plain_f32,
               whole_worst=sorted(vs_plain.items(), key=lambda kv: -kv[1])[:8],
               controls={k: gate(g, control_blocks[k])[0] for k, g in controls.items()},
               block_level=per_block)
    print(json.dumps({f"{label}_gradients_kernel_vs_plain": out}))
    if enforce and not out["passes"]:
        fail(f"{label}: the G gradients of the kernel path disagree with the plain path: "
             f"{ {k: v for k, v in out.items() if k != 'block_level'} }")
    missed = [k for k in MUST_FAIL if out["controls"][k]["passes"]]
    if enforce and missed:
        fail(f"{label}: the gradient gate passes the faulty controls {missed}")
    return out


def train_phase(torch, np, bc, card):
    """Drive the pix2pix train step at full width and prove every block ran
    K1/K3 forward and K2/K4 backward."""
    from dsgan_tpu_torch import bench
    from dsgan_tpu_torch.models import pix2pix

    dev = torch.device("cuda")
    b, size = TRAIN["batch"], TRAIN["size"]
    state, step, cfg = bench.build(dev, size, True, torch.bfloat16, seed=0)
    rng = np.random.default_rng(1)
    batches = [[torch.from_numpy(rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)).to(dev)
                for _ in range(2)] for _ in range(2)]
    before = {k: p.detach().clone() for k, p in
              [*state.netG.named_parameters(), *state.netD.named_parameters()][::7]}
    lr = 2e-4

    torch.cuda.synchronize()
    zero_counts(bc)
    metrics = []
    for i in range(TRAIN["warmup"]):
        metrics.append(step(state, *batches[i % 2], lr)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(TRAIN["steps"]):
        metrics.append(step(state, *batches[i % 2], lr)[0])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts(bc)
    steps = TRAIN["warmup"] + TRAIN["steps"]

    last = {k: float(v) for k, v in metrics[-1].items()}
    finite = all(bool(torch.isfinite(v)) for m in metrics for v in m.values())
    moved = sum(not torch.equal(before[k], p.detach()) for k, p in
                [*state.netG.named_parameters(), *state.netD.named_parameters()] if k in before)
    res = dict(batch=b, size=size, dtype="bfloat16", pool=50, vgg=True, steps_timed=TRAIN["steps"],
               step_ms=dt / TRAIN["steps"] * 1e3, img_per_s=b * TRAIN["steps"] / dt,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, launches=launches,
               steps_counted=steps, losses=last, finite=finite, params_moved=moved,
               params_checked=len(before), pool_count=state.pool.count, card=card)
    print(json.dumps({"train": res}))
    want = {"K1": 5 * steps, "K3": 4 * steps, "K2": 5 * steps, "K4": 4 * steps}
    if launches != want:
        fail(f"launch counts {launches} after {steps} train steps: want 5 K1 + 4 K3 + 5 K2 + "
             f"4 K4 each")
    if not finite or moved != len(before):
        fail(f"train step: finite losses {finite}, {moved} of {len(before)} parameters moved")
    res["profile"] = profile_run(torch, lambda: step(state, *batches[0], lr), "train_step",
                                 batch=b)
    A0, B0 = (pix2pix.images(x, cfg.compute_dtype) for x in batches[0])

    def g_loss(f32):
        A, B = (A0.float(), B0.float()) if f32 else (A0, B0)
        with torch.no_grad():
            feats = state.vgg(B)
        return pix2pix.generator_loss(cfg, state, A, B, state.netG(A), feats)["loss_G"]

    res["gradients"] = gradient_check(torch, bc, {"G": state.netG}, (state.netD, state.vgg),
                                      g_loss, calls=9)
    return res, launches


def _state_tensors(torch, state):
    """Every tensor of a train state's ``state_dict``, by path, and its
    step counts, on the host."""
    out = {}

    def walk(obj, path):
        if isinstance(obj, torch.Tensor):
            out[path] = obj.detach().cpu()
        elif isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, f"{path}/{k}")
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(v, f"{path}/{i}")

    walk(state.state_dict(), "")
    return out


def _bounded(torch, got, want, lr, k):
    """The JAX suite's cross-program bounds (tests/test_chained_step.py:
    16-24): parameters within k * 2 * lr, every other tensor within 1e-6
    relative. Returns the paths that break them."""
    bad = []
    for path, w in want.items():
        g = got[path]
        if g.dtype in (torch.uint8, torch.int64, torch.int32) or not g.is_floating_point():
            ok = torch.equal(g, w)
        elif path.startswith(("/netG", "/netD")):
            ok = bool(((g.double() - w.double()).abs() <= k * 2 * lr).all())
        else:
            ok = bool(((g.double() - w.double()).abs() <= 1e-6 * w.double().abs() + 1e-30).all())
        if not ok:
            bad.append(path)
    return bad


def _compare(torch, graph_keys, sa, sb, got, want):
    """The tensors of two states' ``_state_tensors`` that differ, and the
    metric rows that do, by name; each metric's largest difference."""
    differ = sorted(p for p in sa if not torch.equal(sa[p], sb[p]))
    differ += [f"metric {graph_keys[j]} step {i}" for i, (g, w) in enumerate(zip(got, want))
               for j in range(len(graph_keys)) if not torch.equal(g[j], w[j])]
    diffs = {key: max(float((g[j] - w[j]).abs()) for g, w in zip(got, want))
             for j, key in enumerate(graph_keys)}
    return differ, diffs


def replay_vs_eager(torch, np, bc, build, batch, size, fill, k, want, label, lr=2e-4,
                    chain=None):
    """The captured train step against the eager one, from one state:
    ``build()`` -> (state, step, config) of a recipe, built twice from one
    seed (a frozen VGG is no part of the state_dict); ``fill`` eager steps
    fill its pool, then ``k`` steps each way.

    The control comes first: two eager runs from one state, cuDNN as the
    CLI runs it. Where they agree bit for bit, the comparison runs so too;
    where they do not (cuDNN's nondeterministic algorithms: split
    reductions with atomics in convolution backward), it runs with
    ``torch.backends.cudnn.deterministic`` on. Either way the captured
    step must equal the eager one bit for bit, or else stay within the JAX
    suite's bounds with the differing tensors named. ``want``: the launch
    counts of the capture (one step's); ``chain(step, cfg, warmup=...)``:
    the recipe's ``ChainedStep`` (default: pix2pix's). Returns the result,
    the launches, and what the timed turns need."""
    import copy

    from dsgan_tpu_torch.models.pix2pix import chained_train_step

    chain = chain or chained_train_step
    dev = torch.device("cuda")
    a_state, step, cfg = build()
    rng = np.random.default_rng(7)
    batches = [[torch.from_numpy(rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8))
                .to(dev) for _ in range(2)] for _ in range(fill + k)]
    eager = chain(step, cfg)
    for x in batches[:fill]:
        eager.step(a_state, x, lr)
    if not eager.ready(a_state) or eager.graph is not None:
        fail(f"{label}: pools not full after {fill} steps, or a graph captured before they "
             "were")
    start = copy.deepcopy(a_state.state_dict())
    b_state = build()[0]
    compared = batches[fill:]

    def run(helper, state, **kw):
        out = [helper.step(state, x, lr, **kw)[0].clone() for x in compared]
        torch.cuda.synchronize()
        return out

    # the control: two eager runs from one state, cuDNN as the CLI runs it
    b_state.load_state_dict(copy.deepcopy(start))
    want_m = run(eager, a_state, eager=True)
    again = run(eager, b_state, eager=True)
    differ, diffs = _compare(torch, eager.keys, _state_tensors(torch, a_state),
                             _state_tensors(torch, b_state), again, want_m)
    control = dict(tensors_differ=len(differ), first=differ[:6], metric_max_abs_diff=diffs)
    deterministic = bool(differ)

    # the comparison: eager on a, the graph on b
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic, False
    try:
        a_state.load_state_dict(copy.deepcopy(start))
        b_state.load_state_dict(copy.deepcopy(start))
        want_m = run(eager, a_state, eager=True)
        graph = chain(step, cfg, warmup=0)
        zero_counts(bc)
        t0 = time.perf_counter()
        got = run(graph, b_state)
        capture_s = time.perf_counter() - t0
        launches = read_counts(bc)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    if graph.counts != dict(eager=0, captured=1, replayed=k):
        fail(f"{label}: counts {graph.counts}, want 1 capture and {k} replays")
    if launches != want:
        fail(f"{label}: the capture counted {launches}: want one step's {want}, and nothing "
             "for the replays")
    sa, sb = _state_tensors(torch, a_state), _state_tensors(torch, b_state)
    differ, diffs = _compare(torch, graph.keys, sa, sb, got, want_m)
    res = dict(batch=batch, size=size, steps=k, tensors=len(sa),
               cudnn_deterministic=deterministic, bitwise=not differ, differ=differ[:20],
               metric_max_abs_diff=diffs, capture_and_replays_s=capture_s, counts=graph.counts,
               launches_at_capture=launches, eager_vs_eager_default_cudnn=control)
    if differ:
        metrics_ok = all(bool(((g - w).abs() <= 1e-6 * w.abs()).all()) for g, w in zip(got, want_m))
        res["outside_jax_bounds"] = _bounded(torch, sb, sa, lr, k) + ([] if metrics_ok else ["metrics"])
    if differ and res["outside_jax_bounds"]:
        print(json.dumps({label: res}))
        fail(f"{label}: graph replays disagree with eager steps beyond the JAX bounds: "
             f"{res['outside_jax_bounds'][:10]} (metrics {diffs})")
    return res, launches, dict(eager=eager, a_state=a_state, b_state=b_state, step=step, cfg=cfg,
                               batches=batches)


def graph_phase(torch, np, bc, card, trials=0):
    """The default recipe's captured train step against the eager one
    (``replay_vs_eager``), then the two in turns under the profiler. The
    timed turns run cuDNN as the CLI runs it, on a graph captured under
    those settings. With ``trials``, ``profile_trials`` of the two steps
    in place of the turns."""
    from dsgan_tpu_torch import bench
    from dsgan_tpu_torch.models.pix2pix import chained_train_step

    dev = torch.device("cuda")
    b, size, lr = GRAPH["batch"], GRAPH["size"], 2e-4
    res, launches, run = replay_vs_eager(
        torch, np, bc, lambda: bench.build(dev, size, True, torch.bfloat16, seed=0), b, size,
        GRAPH["fill"], GRAPH["steps"], {"K1": 5, "K3": 4, "K2": 5, "K4": 4}, "graph phase")
    res["card"] = card
    print(json.dumps({"graph_vs_eager": res}))
    eager, a_state, b_state = run["eager"], run["a_state"], run["b_state"]
    step, cfg, batches = run["step"], run["cfg"], run["batches"]

    # in turns, cuDNN as the CLI runs it: eager (state a), replay (state b,
    # a graph captured now), replay, eager
    timed_graph = chained_train_step(step, cfg, warmup=0)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(GRAPH["timed"]):
            fn(batches[i % len(batches)])
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / GRAPH["timed"] * 1e3

    runs = dict(eager=lambda x: eager.step(a_state, x, lr, eager=True),
                replay=lambda x: timed_graph.step(b_state, x, lr))
    runs["replay"](batches[0])  # the capture, outside the timing
    if trials:
        return profile_trials(torch, {m: lambda m=m: runs[m](batches[0]) for m in runs},
                              trials), launches
    turns = []
    for mode in ("eager", "replay", "replay", "eager"):
        ms = timed(runs[mode])
        prof = profile_run(torch, lambda: runs[mode](batches[0]), f"{mode}_step", batch=b)
        turns.append(dict(mode=mode, step_ms=ms, wall_ms=prof["wall_ms"],
                          device_ms=prof["device_ms"], idle_share=prof["idle_share"],
                          by_class_ms=prof["by_class_ms"],
                          block_core_kernels=prof["block_core_kernels"]))
    print(json.dumps({"graph_turns": turns}))
    kernels = {t["mode"]: t["block_core_kernels"] for t in turns}
    if not kernels["replay"] or kernels["replay"] != kernels["eager"]:
        fail(f"a profiled replay ran block-core kernels {kernels['replay']}, an eager step "
             f"{kernels['eager']}")
    res["turns"] = turns
    return res, launches


def _remat_grads(torch, bc, build, batches, lr):
    """One step of ``build()``'s recipe on ``batches``: its G and D
    gradients and its launches."""
    state, step, _ = build()
    zero_counts(bc)
    step(state, *batches, lr)
    torch.cuda.synchronize()
    launches = read_counts(bc)
    grads = {n: {k: q.grad.clone() for k, q in net.named_parameters() if q.grad is not None}
             for n, net in (("netG", state.netG), ("netD", state.netD))}
    return grads, launches


def _remat_timed(torch, np, bc, remat, size, batch, warmup, steps, lr=2e-4):
    """``warmup`` + ``steps`` steps of the training recipe at ``size`` and
    ``batch``, with or without --remat: step ms, peak memory and the
    launches a step; or why a step could not run (out of memory, or a
    kernel refusing the shape)."""
    from dsgan_tpu_torch import bench

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = None
    try:
        state, step, _ = bench.build(dev, size, True, torch.bfloat16, seed=0, remat=remat)
        rng = np.random.default_rng(3)
        ab = [torch.from_numpy(rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8))
              .to(dev) for _ in range(2)]
        for _ in range(warmup):
            step(state, *ab, lr)
        torch.cuda.synchronize()
        zero_counts(bc)
        t0 = time.perf_counter()
        for _ in range(steps):
            m, _ = step(state, *ab, lr)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        out = dict(step_ms=ms, img_per_s=batch / ms * 1e3,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   launches={k: v // steps for k, v in read_counts(bc).items()},
                   finite=all(math.isfinite(float(v)) for v in m.values()))
    except torch.cuda.OutOfMemoryError as e:
        out = dict(refused="out of memory", detail=str(e).split("\n")[0][:200])
    except ValueError as e:  # a kernel's plan that cannot take the shape
        out = dict(refused="kernel", detail=str(e)[:200])
    finally:
        del state
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return dict(remat=remat, size=size, batch=batch, **out)


def remat_phase(torch, np, bc, card):
    """--remat on the training recipe (``REMAT``): the gradients of one step
    with and without it from one state, bit for bit under cuDNN's
    deterministic algorithms, and its launches; its replays against its
    eager steps; step ms and peak memory each way at each size; the largest
    batch at ``REMAT["big"]`` each way (``remat_*`` lines)."""
    from dsgan_tpu_torch import bench

    dev = torch.device("cuda")
    size, b, lr = REMAT["size"], REMAT["batch"], 2e-4
    rng = np.random.default_rng(1)
    batches = [torch.from_numpy(rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8))
               .to(dev) for _ in range(2)]
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = {remat: _remat_grads(torch, bc, lambda remat=remat: bench.build(
            dev, size, True, torch.bfloat16, seed=0, remat=remat), batches, lr)
            for remat in (False, True)}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    (want, plain), (got, launches) = runs[False], runs[True]
    differ = [f"{n}.{k}" for n in want for k in want[n] if not torch.equal(got[n][k], want[n][k])]
    grads = dict(batch=b, size=size, tensors=sum(len(v) for v in want.values()),
                 differ=differ[:10], bitwise=not differ, launches=launches,
                 launches_without=plain, card=card)
    print(json.dumps({"remat_gradients": grads}))
    del runs, want, got
    torch.cuda.empty_cache()
    problems = []
    if differ:
        problems.append(f"the remat step's gradients differ from the step's: {differ[:5]}")
    if launches != REMAT_PER_STEP or plain != {"K1": 5, "K3": 4, "K2": 5, "K4": 4}:
        problems.append(f"launches a step {launches} with remat, {plain} without: want "
                        f"{REMAT_PER_STEP}")

    graph, graph_launches, _ = replay_vs_eager(
        torch, np, bc, lambda: bench.build(dev, size, True, torch.bfloat16, seed=0, remat=True),
        b, size, GRAPH["fill"], GRAPH["steps"], REMAT_PER_STEP, "remat graph phase")
    graph["card"] = card
    print(json.dumps({"remat_graph_vs_eager": graph}))
    torch.cuda.empty_cache()

    timed = [_remat_timed(torch, np, bc, remat, s, b, REMAT["warmup"], REMAT["steps"])
             for s in REMAT["sizes"] for remat in (False, True)]
    for t in timed:
        print(json.dumps({"remat_timed": dict(t, card=card)}))
    for plain_t, remat_t in zip(timed[::2], timed[1::2]):
        for t in (plain_t, remat_t):
            if "refused" in t or not t["finite"]:
                problems.append(f"remat {t['remat']} at {t['size']} batch {t['batch']}: {t}")
        if "refused" in plain_t or "refused" in remat_t:
            continue
        # K2 / K4 run in chunks of images past their 32-bit indices
        # (``block_core.image_chunks``), alike with and without remat
        want = dict(plain_t["launches"], K1=REMAT_PER_STEP["K1"], K3=REMAT_PER_STEP["K3"])
        if (remat_t["launches"] != want
                or (plain_t["launches"]["K1"], plain_t["launches"]["K3"]) != (5, 4)):
            problems.append(f"at {plain_t['size']}: launches {plain_t['launches']} without "
                            f"remat, {remat_t['launches']} with")
    largest = {}
    for remat in (False, True):
        tries = []
        for batch in REMAT["big_batches"]:
            tries.append(_remat_timed(torch, np, bc, remat, REMAT["big"], batch, 1, 1))
            if "refused" in tries[-1]:
                break
        ran = [t["batch"] for t in tries if "refused" not in t]
        largest[str(remat)] = dict(largest_batch=max(ran, default=0), tries=tries)
    print(json.dumps({"remat_largest_batch": dict(size=REMAT["big"], card=card, **largest)}))
    if problems:
        fail("remat: " + "; ".join(problems))
    return dict(gradients=grads, graph=graph, timed=timed, largest=largest), graph_launches


def capture_must_fail(torch):
    """A step that reads a device value on the host cannot be captured:
    the chained step must raise rather than run it eagerly."""
    from dsgan_tpu_torch.models.base_model import ChainedStep

    chained = ChainedStep(lambda state, x, lr: ({"m": x.sum() * float(x.max())}, x),
                                warmup=0)
    try:
        chained.step({}, [torch.ones(4, device="cuda")], 0.1)
    except RuntimeError as e:
        print(json.dumps({"capture_failure_raises": str(e).splitlines()[0][:160]}))
    else:
        fail("a step with a host read was captured or ran eagerly instead of raising")
    if chained.counts["eager"] or chained.graph is not None:
        fail(f"a failed capture left {chained.counts}")


def write_dataset(np, root):
    """An aligned dataset from a numpy seed: train_all/ and test_all/ with
    a_* (A) and b_* (B) 256x256 RGB PNGs, paired by the half-split."""
    from PIL import Image

    rng = np.random.default_rng(5)
    for phase, n in (("train_all", CLI["train_pairs"]), ("test_all", CLI["test_pairs"])):
        d = os.path.join(root, phase)
        os.makedirs(d)
        for side in "ab":
            for i in range(n):
                img = rng.integers(0, 256, (CLI["size"], CLI["size"], 3), dtype=np.uint8)
                Image.fromarray(img).save(os.path.join(d, f"{side}_{i:02d}.png"))


def _cli_launches(bc, steps, forwards, what):
    """The launch counts after ``steps`` eager or captured train steps and
    ``forwards`` eval forwards (a replay counts none)."""
    got = read_counts(bc)
    want = {"K1": 5 * (steps + forwards), "K3": 4 * (steps + forwards), "K2": 5 * steps,
            "K4": 4 * steps}
    if got != want:
        fail(f"{what}: launch counts {got} after {steps} eager or captured train steps and "
             f"{forwards} forwards: want 5 K1 + 4 K3 + 5 K2 + 4 K4 a step, 5 K1 + 4 K3 a forward")
    return got


def _finite_log(path):
    """Every loss, SSIM and PSNR of result.csv, as floats."""
    vals = []
    with open(path) as f:
        for epoch, message, ssim, psnr in csv.reader(f):
            vals += [float(v) for v in message.split()[1::2]] + [float(ssim), float(psnr)]
    return vals


def _best_ms(fn, repeats=3):
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def host_split(torch, eval_cli, train_model, eval_model, tmp):
    """Where the CLIs' host time goes, each part alone on the main thread
    (best of 3): one train batch's decode and augmentation (16 items) by
    the Python path (no threads) and by the native decoder (4 threads),
    and the parts of one eval image: the serving build's forward to a
    synchronized result, the visuals' fetch, the float64 SSIM + PSNR, the
    MS-SSIM on the card, the three gallery PNGs."""
    from dsgan_tpu_torch import ops
    from dsgan_tpu_torch.data import CreateDataset
    from dsgan_tpu_torch.utils.util import save_image

    ds = CreateDataset(train_model.opt)
    batch = CLI["batch"]
    out = dict(decode_batch_ms=_best_ms(lambda: [ds.__getitem__(i, i) for i in range(batch)]),
               native_decode_batch_ms=_best_ms(
                   lambda: ds.native_batch(list(range(batch)), 4, serials=list(range(batch)))))

    def forward():
        eval_model.test()
        torch.cuda.synchronize()

    out["eval_forward_ms"] = _best_ms(forward)
    out["eval_visuals_ms"] = _best_ms(eval_model.get_current_visuals)
    vis = eval_model.get_current_visuals()
    real, fake = vis["real_B"], vis["fake_B"]
    out["eval_ssim_psnr_ms"] = _best_ms(
        lambda: (ops.ssim_ref(real, fake), ops.psnr_ref(real, fake)))
    dev = eval_model.device
    out["eval_ms_ssim_ms"] = _best_ms(
        lambda: float(ops.ms_ssim(eval_cli._nchw(real, dev), eval_cli._nchw(fake, dev),
                                  data_range=255)))
    out["eval_png_ms"] = _best_ms(
        lambda: [save_image(v, os.path.join(tmp, f"{k}.png")) for k, v in vis.items()])
    return out


def _cli_times(rows, label, **info):
    """Host ms a step of the train CLI's rows (epoch, lr, loader wait,
    dispatch, print work): over all of them and without each epoch's first
    two."""
    def summary(rs):
        wait, step, fetch = (sum(r[i] for r in rs) for i in (2, 3, 4))
        total = wait + step + fetch
        return dict(steps=len(rs), img_per_s=CLI["batch"] * len(rs) / total,
                    step_ms=total / len(rs) * 1e3, loader_wait_ms=wait / len(rs) * 1e3,
                    loader_wait_share=wait / total, dispatch_ms=step / len(rs) * 1e3,
                    print_ms=fetch / len(rs) * 1e3)

    per_epoch = CLI["train_pairs"] // CLI["batch"]
    steady = [r for i, r in enumerate(rows) if i % per_epoch >= 2]
    return dict(info, run=label, all=summary(rows), steady=summary(steady),
                rows=[[round(v * 1e3, 3) for v in r[2:]] for r in rows])


def cli_phase(torch, np, bc, card):
    """Drive ``python -m dsgan_tpu_torch.train`` and ``.test`` in-process at
    full width: the native decoder and CUDA-graph replay, a resume, the
    Python loader with eager steps as the A/B, and the eval on the serving
    build; prove every eager or captured step and every forward ran its
    kernels."""
    from dsgan_tpu_torch import runtime
    from dsgan_tpu_torch import test as eval_cli
    from dsgan_tpu_torch import train as train_cli

    per_epoch = CLI["train_pairs"] // CLI["batch"]
    with tempfile.TemporaryDirectory(prefix="dsgan_cli_") as tmp:
        data, ckpt = os.path.join(tmp, "data"), os.path.join(tmp, "checkpoints")
        t0 = time.perf_counter()
        write_dataset(np, data)
        write_s = time.perf_counter() - t0
        base = ["--dataroot", data, "--checkpoints_dir", ckpt]
        train = base + ["--batchSize", str(CLI["batch"]), "--print_freq", "1", "--pool_size", "50"]
        graph = train + ["--name", "cli", "--native_loader", "auto",
                         "--steps_per_dispatch", str(CLI["k"])]

        # 2 epochs: [4 eager (the pool fills)] [capture + 4 replays] [eager
        # tail], then [4 replays] [4 replays] [eager tail]
        zero_counts(bc)
        runtime.load_batch_u8.calls = 0
        model, run1 = train_cli.main(graph + ["--niter", "1", "--niter_decay", "1"])
        torch.cuda.synchronize()
        counts = dict(model._chained.counts)
        launches = {"graph": _cli_launches(bc, counts["eager"] + counts["captured"], 0,
                                           "train CLI, graph")}
        if counts != dict(eager=6, captured=1, replayed=12):
            fail(f"train CLI, graph: counts {counts}, want 6 eager steps (4 filling the pool, 2 "
                 "epoch tails), 1 capture and 12 replays")
        if runtime.load_batch_u8.calls != 2 * len(run1):
            fail(f"train CLI: the native decoder ran {runtime.load_batch_u8.calls} times for "
                 f"{len(run1)} batches (want A and B of each): the native path did not run "
                 f"({runtime.reason()})")
        if len(run1) != 2 * per_epoch or int(model.state.step) != 2 * per_epoch:
            fail(f"train CLI: {len(run1)} steps, step counter {int(model.state.step)}: want "
                 f"{2 * per_epoch}")

        # a third epoch from the epoch 2 checkpoint: [eager (warm-up), capture
        # + 3 replays] [4 replays] [eager tail]
        zero_counts(bc)
        model, run2 = train_cli.main(graph + ["--continue_train", "--which_epoch", "2",
                                              "--epoch_count", "3", "--niter", "2",
                                              "--niter_decay", "1"])
        torch.cuda.synchronize()
        counts2 = dict(model._chained.counts)
        launches["resume"] = _cli_launches(bc, counts2["eager"] + counts2["captured"], 0,
                                           "resumed train CLI")
        # the epoch 2 checkpoint holds the schedule position of epoch 2 (1),
        # which the lambda rule counts beside --epoch_count, as JAX's does
        lr_want = 2e-4 * (1.0 - max(0, 1 + 1 + 3 - 2) / float(1 + 1))
        lrs = sorted({r[1] for r in run2})
        if (len(run2) != per_epoch or int(model.state.step) != 3 * per_epoch or lrs != [lr_want]
                or counts2 != dict(eager=2, captured=1, replayed=per_epoch - 2)):
            fail(f"resumed train CLI: {len(run2)} steps, step counter {int(model.state.step)} "
                 f"(want {per_epoch} and {3 * per_epoch}), LR {lrs} (want {lr_want}), counts "
                 f"{counts2}")
        losses = _finite_log(os.path.join(ckpt, "cli", "result.csv"))
        if len(losses) != 3 * per_epoch * 6 or not all(math.isfinite(v) for v in losses):
            fail(f"CLI losses not all finite: {losses}")
        out = os.path.join(ckpt, "cli")
        missing = [f for f in ("epoch_1", "epoch_2", "epoch_3", "result.csv", "each_epoch.csv",
                               "opt.txt", "loss_log.txt", f"train_img/train_Re3_{per_epoch}.png")
                   if not os.path.exists(os.path.join(out, f))]
        if missing:
            fail(f"train CLI did not write {missing}")

        # the A/B: the Python loader, every step eager on the default stream
        zero_counts(bc)
        runtime.load_batch_u8.calls = 0
        model_py, run3 = train_cli.main(train + ["--name", "cli_py", "--native_loader", "off",
                                                 "--niter", "1", "--niter_decay", "0"])
        torch.cuda.synchronize()
        launches["python_k1"] = _cli_launches(bc, len(run3), 0, "train CLI, Python loader")
        if runtime.load_batch_u8.calls or len(run3) != per_epoch:
            fail(f"train CLI, Python loader: {runtime.load_batch_u8.calls} native calls, "
                 f"{len(run3)} steps")

        zero_counts(bc)
        results = os.path.join(tmp, "results")
        ev_model, rows = eval_cli.main(base + ["--name", "cli", "--which_epoch", "3",
                                               "--how_many", str(CLI["test_pairs"]),
                                               "--results_dir", results])
        torch.cuda.synchronize()
        launches["eval"] = _cli_launches(bc, 0, len(rows), "eval CLI")
        dtypes = {str(p.dtype) for p in ev_model.netG.parameters()}
        with open(os.path.join(results, "cli", "test_all", "_3", "metrics.csv")) as f:
            mean = list(csv.reader(f))[-1]
        if len(rows) != CLI["test_pairs"] or mean[0] != "mean" or not all(
                math.isfinite(float(v)) for v in mean[2:]) or dtypes != {"torch.bfloat16"}:
            fail(f"eval CLI: {len(rows)} rows, mean row {mean}, G parameters {dtypes} (want the "
                 "serving build's bf16)")
        split = host_split(torch, eval_cli, model, ev_model, tmp)

    runs = [_cli_times(run1[per_epoch:], "native + graph k=4, epoch 2", counts=counts),
            _cli_times(run2, "native + graph k=4, resumed epoch 3", counts=counts2),
            _cli_times(run3, "python + eager k=1, epoch 1")]
    for r in runs:
        print(json.dumps({"cli_train": dict(r, launches=launches, dataset_write_s=write_s,
                                            card=card)}))
    res = dict(runs=runs, first_epoch_graph=_cli_times(run1[:per_epoch], "native + graph k=4, "
                                                       "epoch 1 (pool, capture)"),
               launches=launches, resumed_lr=lr_want, dataset_write_s=write_s, card=card)
    ev = dict(images=len(rows), ms_per_image=sum(r["ms"] for r in rows[1:]) / (len(rows) - 1),
              first_image_ms=rows[0]["ms"], ms=[r["ms"] for r in rows], g_dtypes=sorted(dtypes),
              mean_ssim=float(mean[2]), mean_psnr=float(mean[3]), mean_ms_ssim=float(mean[4]),
              host_split_ms=split, card=card)
    print(json.dumps({"cli_eval": ev}))
    total_launches = {k: sum(v[k] for v in launches.values()) for k in ("K1", "K2", "K3", "K4")}
    return dict(train=res, eval=ev), total_launches


def diffusion_build(torch, seed=0):
    """The diffusion recipe on the card: DenoiseUNet nf 64 (bf16 compute, f32
    parameters) with seeded numpy weights carried in through
    ``utils.convert.diffusion_entries``, T 1000; (state, step, config, the
    weights' JAX tree)."""
    from dsgan_tpu_torch.models import diffusion

    params = diffusion.init_denoiser_params(3, 3, DIFF["nf"], seed)
    net = diffusion.define_denoiser(3, 3, DIFF["nf"], torch.bfloat16, torch.device("cuda"),
                                    params=params)
    cfg = diffusion.DiffusionConfig(timesteps=DIFF["timesteps"], compute_dtype=torch.bfloat16)
    return (diffusion.init_state(net, cfg, seed=seed), diffusion.make_diffusion_train_step(cfg),
            cfg, params)


def diffusion_phase(torch, np, bc, card):
    """``--model diffusion`` at full width (no block-core kernel runs: the
    UNet has no ConvNeXt block): timed train steps at batch 16 and 1 with
    peak memory and a profiled step, a 20-step DDIM sample at batch 16, the
    bf16 forward on the card against the f32 forward on the CPU of the same
    weights (rel-L2 under DIFF["rel_l2"]), then the train CLI (a probe
    runs) and the eval CLI on 4 images, in-process."""
    from dsgan_tpu_torch.models import diffusion

    dev, size, lr = torch.device("cuda"), DIFF["size"], 2e-4
    state, step, cfg, params = diffusion_build(torch)
    n_params = sum(p.numel() for p in state.net.parameters())
    res = dict(card=card, parameters=n_params, nf=DIFF["nf"], timesteps=DIFF["timesteps"],
               timed={})
    rng = np.random.default_rng(11)

    def batch_of(b):
        return [torch.from_numpy(rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8))
                .to(dev) for _ in range(2)]

    zero_counts(bc)
    for b in DIFF["batches"]:
        data = [batch_of(b) for _ in range(2)]
        before = {k: p.detach().clone() for k, p in state.net.named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = [step(state, *data[i % 2], lr)["loss_G"] for i in range(DIFF["warmup"])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step(state, *data[i % 2], lr)["loss_G"] for i in range(DIFF["steps"])]
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / DIFF["steps"]
        losses = [float(v) for v in losses]
        moved = sum(not torch.equal(before[k], p.detach()) for k, p in state.net.named_parameters())
        if not all(math.isfinite(v) for v in losses) or moved != len(before):
            fail(f"diffusion step, batch {b}: losses {losses}, {moved} of {len(before)} moved")
        r = dict(batch=b, step_ms=dt * 1e3, img_per_s=b / dt,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, losses=losses)
        r["profile"] = profile_run(torch, lambda: step(state, *data[0], lr), f"diffusion_b{b}",
                                   batch=b)
        res["timed"][f"b{b}"] = r
        print(json.dumps({f"diffusion_b{b}": r}))

    sampler = diffusion.make_ddim_sampler(cfg, DIFF["sample_steps"])
    cond = batch_of(DIFF["sample_batch"])[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    sampler(state.net, cond, generator=gen)  # the first call's cuDNN plans, untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = sampler(state.net, cond, generator=gen)
    torch.cuda.synchronize()
    sample_ms = (time.perf_counter() - t0) * 1e3
    ok = bool(torch.isfinite(x).all()) and float(x.abs().max()) <= 1.0
    res["sample"] = dict(batch=DIFF["sample_batch"], steps=DIFF["sample_steps"], ms=sample_ms,
                         shape=list(x.shape), finite_in_range=ok, card=card)
    print(json.dumps({"diffusion_sample": res["sample"]}))
    if not ok or list(x.shape) != [DIFF["sample_batch"], size, size, 3]:
        fail(f"diffusion sample: shape {list(x.shape)}, finite and in [-1, 1] {ok}")

    # the forward, bf16 on the card against f32 on the CPU, on the built weights
    fresh = diffusion.define_denoiser(3, 3, DIFF["nf"], torch.bfloat16, dev, params=params)
    cpu = diffusion.define_denoiser(3, 3, DIFF["nf"], torch.float32, "cpu", params=params)
    g = torch.Generator().manual_seed(12)
    b = DIFF["cpu_batch"]
    xt, cnd = (torch.randn((b, 3, size, size), generator=g) for _ in range(2))
    t = torch.tensor([10, DIFF["timesteps"] - 100])[:b]
    with torch.no_grad():
        want = cpu(xt, cnd, t)
        got = fresh(xt.to(dev), cnd.to(dev), t.to(dev)).float().cpu()
    err = rel_l2(got, want)
    res["forward_vs_cpu"] = dict(batch=b, rel_l2=err, limit=DIFF["rel_l2"],
                                 max_abs=float((got - want).abs().max()),
                                 ref_max_abs=float(want.abs().max()))
    print(json.dumps({"diffusion_forward_vs_cpu": res["forward_vs_cpu"]}))
    if not err < DIFF["rel_l2"]:
        fail(f"diffusion forward: bf16 card vs f32 CPU rel-L2 {err} >= {DIFF['rel_l2']}")
    launches = read_counts(bc)
    if any(launches.values()):
        fail(f"diffusion launched block-core kernels {launches}")
    del state, step, fresh
    torch.cuda.empty_cache()
    res.update(diffusion_clis(torch, np, card))
    return res


def diffusion_clis(torch, np, card):
    """The train CLI with ``--model diffusion`` (one epoch, a probe every 2
    steps) and its eval CLI on DIFF["test_pairs"] images, in-process."""
    from dsgan_tpu_torch import test as eval_cli
    from dsgan_tpu_torch import train as train_cli

    res = {}
    with tempfile.TemporaryDirectory(prefix="dsgan_diffusion_") as tmp:
        data, ckpt, results = (os.path.join(tmp, d) for d in ("data", "checkpoints", "results"))
        rng = np.random.default_rng(13)
        for phase, n in (("train_all", DIFF["train_pairs"]), ("test_all", DIFF["test_pairs"])):
            for side in "ab":
                _write_pngs(np, os.path.join(data, phase), n, DIFF["size"], rng, side)
        sizes = [f"--{k}Size_{d}" for k in ("load", "fine") for d in "wh"]
        common = ["--dataroot", data, "--checkpoints_dir", ckpt, "--name", "diff", "--model",
                  "diffusion", "--diff_nf", str(DIFF["nf"])]
        common += [v for f in sizes for v in (f, str(DIFF["size"]))]
        t0 = time.perf_counter()
        model, rows = train_cli.main(common + [
            "--batchSize", str(DIFF["cli_batch"]), "--print_freq", "2", "--metric_freq", "2",
            "--niter", "1", "--niter_decay", "0"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        steps = DIFF["train_pairs"] // DIFF["cli_batch"]
        vals = _finite_log(os.path.join(ckpt, "diff", "result.csv"))
        with open(os.path.join(ckpt, "diff", "each_epoch.csv")) as f:
            epoch = [r for r in csv.reader(f)][-1]
        missing = [f for f in ("epoch_1/state.pt", "train_img/train_Re1_2.png")
                   if not os.path.exists(os.path.join(ckpt, "diff", f))]
        if (len(rows) != steps or missing or not vals or not all(math.isfinite(v) for v in vals)
                or not float(epoch[3]) > 0):
            fail(f"diffusion train CLI: {len(rows)} steps, missing {missing}, result.csv "
                 f"{vals[:12]}, each_epoch {epoch}")
        res["cli_train"] = dict(steps=len(rows), batch=DIFF["cli_batch"], seconds=train_s,
                                step_ms=[round(sum(r[2:]) * 1e3, 3) for r in rows],
                                epoch_ssim_psnr=[float(epoch[2]), float(epoch[3])], card=card)
        print(json.dumps({"diffusion_cli_train": res["cli_train"]}))
        _, ev_rows = eval_cli.main(common + ["--which_epoch", "1", "--how_many",
                                             str(DIFF["test_pairs"]), "--results_dir", results])
        with open(os.path.join(results, "diff", "test_all/_1", "metrics.csv")) as f:
            table = {r[0]: r for r in csv.reader(f)}
        if len(ev_rows) != DIFF["test_pairs"] or not all(
                math.isfinite(float(table["mean"][i])) for i in (2, 3)):
            fail(f"diffusion eval CLI: {len(ev_rows)} rows, mean {table.get('mean')}")
        res["cli_eval"] = dict(images=len(ev_rows), ms=[r["ms"] for r in ev_rows],
                               mean_ssim_psnr=[float(table["mean"][2]), float(table["mean"][3])],
                               card=card)
        print(json.dumps({"diffusion_cli_eval": res["cli_eval"]}))
    return res


def _dp_batches(np):
    """DP["steps"] + DP["timed"] global uint8 (A, B) batches from a seed; B's
    second half a flat grey."""
    rng = np.random.default_rng(14)
    shape = (DP["batch"], DP["size"], DP["size"], 3)
    out = []
    for _ in range(DP["steps"] + DP["timed"]):
        a, b = (rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(2))
        b[DP["batch"] // 2:] = 128
        out.append([a, b])
    return out


def _split_step(torch, cfg, state, real_A, real_B, lr, blocks=2):
    """One process's step on the global batch as the data axis must compute
    it, written without ``parallel``: G and D run forward and backward on
    ``blocks`` blocks of rows (the ranks' shapes) and their gradients
    accumulate, the pool is queried on the global batch, and the losses are
    the global batch's (each term a mean over its rows, TV a sum over
    them). The metrics as the one-process step reports them."""
    from dsgan_tpu_torch import ops
    from dsgan_tpu_torch.models import pix2pix as p
    from dsgan_tpu_torch.ops.metrics import psnr_from_mse

    raw_B = real_B
    real_A, real_B = p.images(real_A, cfg.compute_dtype), p.images(real_B, cfg.compute_dtype)
    n = real_A.shape[0]
    rows = [slice(i * n // blocks, (i + 1) * n // blocks) for i in range(blocks)]
    fakes = [state.netG(real_A[r]) for r in rows]
    fake_sg = torch.cat([f.detach() for f in fakes])

    fake_AB = state.pool.query(p.d_input(cfg, real_A, fake_sg))
    real_AB = p.d_input(cfg, real_A, real_B)
    preds = [p._split_scales(state.netD(torch.cat([fake_AB[r], real_AB[r]])), r.stop - r.start)
             for r in rows]
    loss_fake = ops.gan_loss(torch.cat([f for f, _ in preds]), False, cfg.gan_mode)
    loss_real = ops.gan_loss(torch.cat([r for _, r in preds]), True, cfg.gan_mode)
    loss_D = 0.5 * (loss_fake + loss_real)
    state.opt_D.zero_grad(set_to_none=True)
    loss_D.backward()
    p.set_lr(state.opt_D, lr)
    state.opt_D.step()

    with torch.no_grad():
        feats = [state.vgg(real_B[r]) if cfg.use_vgg else None for r in rows]
    fake_in = [f.detach().requires_grad_(True) for f in fakes]
    aux = [p.generator_loss(cfg, state, real_A[r], real_B[r], fake_in[i], feats[i])
           for i, r in enumerate(rows)]
    tv = sum(x["loss_tv"] for x in aux)
    loss_G = sum(x["loss_G"] - cfg.w_tv * x["loss_tv"] for x in aux) / blocks + cfg.w_tv * tv
    dfakes = torch.autograd.grad(loss_G, fake_in)
    state.opt_G.zero_grad(set_to_none=True)
    for f, d in zip(fakes, dfakes):
        f.backward(d)
    p.set_lr(state.opt_G, lr)
    state.opt_G.step()

    metrics = dict(loss_D=loss_D, loss_D_fake=loss_fake, loss_D_real=loss_real)
    metrics.update({k: sum(x[k] for x in aux) / blocks for k in aux[0]})
    metrics.update(loss_tv=tv, loss_G=loss_G)
    with torch.no_grad():
        fake_q = ops.quantize_uint8(fake_sg)
        real_q = p._target_levels(raw_B, real_B)
        metrics["ssim"] = ops.ssim_uint8(real_q, fake_q)
        metrics["psnr"] = psnr_from_mse(ops.mse_uint8(real_q, fake_q))
    state.step += 1
    return {k: v.detach().float() for k, v in metrics.items()}, fake_sg


def _plant(fault):
    """Plant one of FAULTS in this process's data-parallel pix2pix step;
    returns how the rank takes its rows of a global batch."""
    from dsgan_tpu_torch.models import pix2pix
    from dsgan_tpu_torch.parallel import mesh as mesh_mod

    if fault == "sum":
        def summed(opt, mesh):
            mesh_mod.reduce_gradients(opt, mesh)
            for g in opt.param_groups:
                for prm in g["params"]:
                    if prm.grad is not None:
                        prm.grad.mul_(mesh.data)
        pix2pix.reduce_gradients = summed
    elif fault == "tv":
        pix2pix.data_size = lambda mesh: 1
    elif fault not in (None, "rows"):
        fail(f"dp: no planted fault {fault!r}: {FAULTS}")
    if fault == "rows":
        return lambda x, mesh: x[:x.shape[0] // mesh.data]
    return mesh_mod.shard_batch


def _dp_run(torch, np, bc, mesh, split=False, fault=None, timed=True):
    """The phase 6 recipe's compared steps, then (``timed``) its timed steps,
    on this rank's rows (all of them without a mesh), from the state built
    from seed 0; ``split``: through ``_split_step``; ``fault``: one of
    FAULTS planted first. Returns the compared steps' metrics, the timed
    steps' ms, the launch counts, the tallies of the compared steps, the
    first step's G and D gradients (after the mesh's reduction) and G's
    and D's parameters after the compared steps."""
    from dsgan_tpu_torch import bench
    from dsgan_tpu_torch.models import pix2pix
    from dsgan_tpu_torch.parallel import comms, replicate

    take = _plant(fault)
    dev, lr = torch.device("cuda"), 2e-4
    state, _, cfg = bench.build(dev, DP["size"], True, torch.bfloat16, seed=0)
    if mesh is not None:
        replicate([state.netG, state.netD], mesh)
    step = pix2pix.make_train_step(cfg, mesh)
    if split:
        def step(state, a, b, lr):
            return _split_step(torch, cfg, state, a, b, lr)
    batches = [[torch.from_numpy(take(x, mesh) if mesh else x).to(dev) for x in ab]
               for ab in _dp_batches(np)]
    nets = (("netG", state.netG), ("netD", state.netD))
    zero_counts(bc)
    metrics, tallies, grads = [], [], None
    for a, b in batches[:DP["steps"]]:
        if mesh is not None:
            comms.reset(mesh)
        m, _ = step(state, a, b, lr)
        metrics.append({k: float(v) for k, v in m.items()})
        if mesh is not None:
            tallies.append(comms.collective_stats(mesh))
        if grads is None:
            grads = {n: {k: q.grad.float().cpu() for k, q in net.named_parameters()
                         if q.grad is not None} for n, net in nets}
    params = {n: {k: v.detach().to("cpu", copy=True) for k, v in net.state_dict().items()}
              for n, net in nets}
    ms = None
    if timed:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a, b in batches[DP["steps"]:]:
            step(state, a, b, lr)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / DP["timed"] * 1e3
    return dict(metrics=metrics, step_ms=ms, launches=read_counts(bc), tallies=tallies,
                grads=grads, params=params,
                g=sum(p.numel() for p in state.netG.parameters()),
                d=sum(p.numel() for p in state.netD.parameters()))


def _dp_readings(torch, run, one, lr):
    """``run`` against ``one`` (one process on the global batch): the first
    step's gradients (rel-L2 over the weights, tensors of two or more
    dims, and over all parameters: a bias that feeds an InstanceNorm has
    an exact-zero gradient, so bf16 gives it cancellation noise as large
    as the weights' gradient), the parameters after the compared steps
    (the share of coordinates more than lr / 2 apart, the worst
    coordinate), and each metric's largest difference over the steps
    (relative; SSIM's absolute)."""
    out = {}
    for n in ("netG", "netD"):
        for part in ("w", "all"):
            keys = [k for k, g in one["grads"][n].items() if part == "all" or g.dim() > 1]
            got, want = ([torch.cat([r["grads"][n][k].reshape(-1) for k in keys])
                          for r in (run, one)])
            out[f"grad_{part}_{n}"] = rel_l2(got, want)
        diffs = [(run["params"][n][key].double() - v.double()).abs()
                 for key, v in one["params"][n].items()]
        out[f"share_{n}"] = (sum(int((d > 0.5 * lr).sum()) for d in diffs)
                             / sum(d.numel() for d in diffs))
        out[f"worst_{n}"] = max(float(d.max()) for d in diffs)
    for g, w in zip(run["metrics"], one["metrics"]):
        for key in w:
            d = abs(g[key] - w[key]) / (1.0 if key == "ssim" else max(abs(w[key]), 1e-6))
            out[f"metric_{key}"] = max(out.get(f"metric_{key}", 0.0), d)
    return out


def dp_gate(torch, rank, one, split, lr):
    """The readings of a rank's run beside the noise floor's (``split``'s)
    and their limits, DP["noise"] times the floor plus the allowance of
    the reading's kind; a metric's floor is the largest of the metrics'
    (a loss a few rounding steps from one process's reads far below
    another's). Returns (table, the readings over their limits)."""
    got, floor = _dp_readings(torch, rank, one, lr), _dp_readings(torch, split, one, lr)
    metric_floor = max(v for key, v in floor.items() if key.startswith("metric_"))
    table, over = {}, []
    for key, v in got.items():
        kind = key.split("_")[0]
        f = metric_floor if kind == "metric" else floor[key]
        limit = DP["noise"] * f + DP["allowance"][kind]
        table[key] = dict(got=v, floor=f, limit=limit)
        if not v <= limit:
            over.append(key)
    return table, over


def _card_flags(torch):
    """TF32 off: the f32 checks and every phase after them run so."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _dp_rank(rank, out, fault=None):
    """Phase (a)'s rank: two gloo ranks sharing the card; ``fault``: one of
    FAULTS planted in both."""
    import numpy as np
    import torch

    from dsgan_tpu_torch.kernels import block_core as bc
    from dsgan_tpu_torch.parallel import resolve_mesh

    _card_flags(torch)
    mesh = resolve_mesh(0, 1, batch_size=DP["batch"])
    run = _dp_run(torch, np, bc, mesh, fault=fault, timed=fault is None)
    torch.save(run, os.path.join(out, f"rank{rank}.pt"))


def _nccl_rank(rank, out):
    """Phase (b): one NCCL rank; the phase 7 comparison of replays and eager
    steps, the mesh's collectives inside the captured step."""
    import numpy as np
    import torch

    from dsgan_tpu_torch.kernels import block_core as bc
    from dsgan_tpu_torch.parallel import Mesh, multihost

    _card_flags(torch)
    mesh = Mesh(1, 1, 0, None, multihost.host_group())
    if mesh.gloo:
        fail("dp graph: the one-rank group is not NCCL")
    with open(os.path.join(out, "nccl.json"), "w") as f:
        json.dump(_graph_run(torch, np, bc, mesh), f)


def _graph_run(torch, np, bc, mesh):
    """``replay_vs_eager`` of the phase 6 recipe's step on ``mesh``."""
    from dsgan_tpu_torch import bench
    from dsgan_tpu_torch.models import pix2pix

    def build():
        state, _, cfg = bench.build(torch.device("cuda"), DP["size"], True, torch.bfloat16, seed=0)
        return state, pix2pix.make_train_step(cfg, mesh), cfg

    res, launches, _ = replay_vs_eager(
        torch, np, bc, build, DP["batch"], DP["size"], GRAPH["fill"], GRAPH["steps"],
        {"K1": 5, "K3": 4, "K2": 5, "K4": 4}, "dp nccl graph")
    return dict(res, launches=launches)


def _spawn_ranks(torch, tmp, fault=None):
    """Phase (a)'s two gloo ranks (``_dp_rank``): their runs and the
    spawn's seconds."""
    from dsgan_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    multihost.spawn(_dp_rank, 2, (tmp, fault), platform="gpu", backend="gloo", timeout=600)
    spawn_s = time.perf_counter() - t0
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(2)], spawn_s


def dp_phase(torch, np, bc, card, faults=()):
    """The data axis (``parallel.mesh``) on the one card: (a) two gloo ranks,
    spawned, run the phase 6 recipe at global batch 16 (8 a rank) for
    DP["steps"] steps from one state against one process on the global
    batch: the ranks hold one state bit for bit; their first step's
    gradients, their parameters after the steps and their metrics stay
    within DP's noise gate (``dp_gate``: the same readings of one process
    that runs the ranks' row blocks, ``_split_step``); each rank launches
    5 K1 + 4 K3 + 5 K2 + 4 K4 a step, and a step's tally is one all-reduce
    of G's f32 gradient bytes, one of D's, one of the metrics and one
    all-gather of the pool's rows; then DP["timed"] timed steps each way.
    (b) One NCCL rank: 4 replays of the captured step, its all-reduces and
    all-gather inside the graph, against 4 eager steps, bit for bit. With
    ``faults`` (``--dp_faults``): (a) alone, then each fault planted in
    the ranks, which the gate must fail."""
    from dsgan_tpu_torch.parallel import multihost

    lr, k = 2e-4, DP["steps"]
    torch.cuda.empty_cache()
    one = _dp_run(torch, np, bc, None)
    torch.cuda.empty_cache()
    split = _dp_run(torch, np, bc, None, split=True, timed=False)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="dsgan_dp_") as tmp:
        ranks, spawn_s = _spawn_ranks(torch, tmp)
        planted = {}
        for fault in faults:
            runs, _ = _spawn_ranks(torch, tmp, fault)
            table, over = dp_gate(torch, runs[0], one, split, lr)
            planted[fault] = {key: table[key]["got"] for key in over}
        if not faults:
            t0 = time.perf_counter()
            multihost.spawn(_nccl_rank, 1, (tmp,), platform="gpu", timeout=600)
            nccl_s = time.perf_counter() - t0
            with open(os.path.join(tmp, "nccl.json")) as f:
                graph = json.load(f)
    r0, r1 = ranks
    same = all(torch.equal(r0["params"][n][key], r1["params"][n][key])
               for n in r0["params"] for key in r0["params"][n]) and r0["metrics"] == r1["metrics"]
    gate, over = dp_gate(torch, r0, one, split, lr)
    vs_split = _dp_readings(torch, r0, split, lr)
    # where the floor's first-step G gradient differs most: (tensor, |split - one|, |one|)
    g1, gs = one["grads"]["netG"], split["grads"]["netG"]
    top = sorted(((k, float((gs[k] - g).norm()), float(g.norm())) for k, g in g1.items()),
                 key=lambda t: -t[1])[:4]
    grad_bytes = 4 * (r0["g"] + r0["d"])
    n_vec = len(r0["metrics"][0])  # the metrics, PSNR's uint8 MSE in psnr's place
    want_tally = {"all-reduce": {"count": 3, "bytes": grad_bytes + 4 * n_vec},
                  "all-gather": {"count": 1, "bytes": DP["batch"] * 6 * DP["size"] ** 2 * 2}}
    per = {"K1": 5, "K3": 4, "K2": 5, "K4": 4}
    n_steps = DP["steps"] + DP["timed"]
    res = dict(card=card, batch=DP["batch"], per_rank=DP["batch"] // 2, steps=k,
               ranks_identical=same, gate=gate, over=over, ranks_vs_split=vs_split,
               floor_top_g=top,
               step_ms=dict(one_process=one["step_ms"], rank0=r0["step_ms"], rank1=r1["step_ms"]),
               launches=[r0["launches"], r1["launches"]], tally=r0["tallies"][-1],
               gradient_bytes=grad_bytes, spawn_s=spawn_s)
    print(json.dumps({"dp_two_ranks": res}))
    if faults:
        print(json.dumps({"dp_faults": dict(card=card, over=planted)}))
    if not same:
        fail("dp: the two ranks' states or metrics differ")
    if over:
        fail("dp: two ranks vs one process beyond the noise gate: "
             + ", ".join(f"{key} {gate[key]}" for key in over))
    if faults:
        missed = [f for f, o in planted.items() if not o]
        if missed:
            fail(f"dp: the gate passed the planted faults {missed}")
        return res, None
    for r in ranks:
        if r["launches"] != {key: v * n_steps for key, v in per.items()}:
            fail(f"dp: a rank launched {r['launches']}: want {per} x {n_steps}")
        if any(t != want_tally for t in r["tallies"]):
            fail(f"dp: tallies {r['tallies']}, want {want_tally} a step")
    graph_res = dict(graph, card=card, seconds=nccl_s)
    print(json.dumps({"dp_nccl_graph_vs_eager": graph_res}))
    res["graph"] = graph_res
    launches = {key: r0["launches"][key] + r1["launches"][key] + graph["launches"][key]
                for key in per}
    return res, launches


def _sp_plant(fault):
    """Plant one of SPATIAL_FAULTS in this process's spatial-axis steps."""
    import torch

    from dsgan_tpu_torch.kernels import block_core as bc
    from dsgan_tpu_torch.models import cycle_gan, diffusion, layers, pix2pix
    from dsgan_tpu_torch.ops import norm
    from dsgan_tpu_torch.parallel import comms
    from dsgan_tpu_torch.parallel import mesh as mesh_mod
    from dsgan_tpu_torch.parallel import spatial

    if fault == "halo":
        spatial._exchange = lambda rows, sends, recvs: [b.zero_() for b in recvs.values()]
    elif fault == "stats":
        norm.global_moments = lambda xf: (xf.mean(dim=(2, 3)), xf.square().mean(dim=(2, 3)))
    elif fault == "sums":
        bc._reduce_s = lambda rows, *sums: sums
    elif fault == "fold":
        bc._fold_hw = lambda rows, h: None
    elif fault == "grads":
        def averaged(opt, mesh):
            mesh_mod.reduce_gradients(opt, mesh)
            for g in opt.param_groups:
                for prm in g["params"]:
                    if prm.grad is not None:
                        prm.grad.div_(mesh.spatial)
        for mod in (pix2pix, cycle_gan, diffusion):
            mod.reduce_gradients = averaged
    elif fault == "bn_count":
        def strip_count(self, xf):  # the strip's B * H * W times the data axis alone
            n = xf.numel() // xf.shape[1] * self.mesh.data
            mean = comms.SumOverRanks.apply(xf.sum(dim=(0, 2, 3)), self.mesh) / n
            sq = (xf - mean[:, None, None]).square().sum(dim=(0, 2, 3))
            return mean, comms.SumOverRanks.apply(sq, self.mesh) / n, n
        layers.BatchNorm2d._stats = strip_count
    elif fault == "eps":
        def strip_noise(shape, mesh, generator, device):  # the strip's shape, drawn per strip
            total, rows = diffusion._rows(shape[0], mesh)
            return torch.randn((total, *shape[1:]), generator=generator, device=device)[rows]
        diffusion._noise = strip_noise
    elif fault == "pool":
        class PerRank(cycle_gan.ImagePool):  # each rank's pool its own draws
            def __init__(self, pool_size, shape, dtype, device, seed):
                super().__init__(pool_size, shape, dtype, device,
                                 seed + 1000 * (1 + torch.distributed.get_rank()))
        cycle_gan.ImagePool = PerRank
    elif fault == "cascade_ln":
        from dsgan_tpu_torch.models import generators_zoo

        def strip_ln(self, x):  # the strip's mean and std
            with spatial.replicated():
                return cascade_ln(self, x)
        cascade_ln = generators_zoo.CascadeLayerNorm.forward
        generators_zoo.CascadeLayerNorm.forward = strip_ln
    elif fault == "cbam_mean":
        from dsgan_tpu_torch.models import blocks_extra

        def strip_gate(self, x):  # the strip's mean; the maximum stays the image's
            def mlp(v):
                return self.fc2(self.relu1(self.fc1(v)))
            from dsgan_tpu_torch import ops
            return torch.sigmoid(mlp(x.mean(dim=(2, 3), keepdim=True))
                                 + mlp(ops.adaptive_max_pool(x)))
        blocks_extra.ChannelAttentionCBAM.forward = strip_gate
    elif fault == "pool_divisor":
        import torch.nn.functional as F

        def strip_pool(x, window, stride, padding, count_include_pad, rows):
            return F.avg_pool2d(x, window, stride, padding, count_include_pad=count_include_pad)
        spatial.avg_pool2d = strip_pool
    elif fault is not None:
        fail(f"spatial: no planted fault {fault!r}: {SPATIAL_FAULTS}")


def _sp_batches(np):
    """SPATIAL["steps"] + SPATIAL["timed"] global uint8 (A, B) batch pairs
    from a seed, B's lower quarter a flat grey; the gated steps repeat the
    first pair, as tests/test_spatial_512.py does."""
    rng = np.random.default_rng(15)
    shape = (SPATIAL["batch"], SPATIAL["size"], SPATIAL["size"], 3)
    pairs = []
    for _ in range(1 + SPATIAL["timed"]):
        a, b = (rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(2))
        b[:, 3 * SPATIAL["size"] // 4:] = 128
        pairs.append([a, b])
    return [pairs[0]] * SPATIAL["steps"] + pairs[1:]


def _row_halves(torch, bc, n=2):
    """Patches that sum, in one process, every cross-row sum of the spatial
    axis over the image's ``n`` row blocks, as ``n`` strips sum them (each
    block's sum, then the blocks' added in row order): the InstanceNorm sums
    of x and x^2, K2's / K4's S sums and weight gradients, BatchNorm's sums
    of x and (x - mean)^2, the cascaded LayerNorm's sums of x and of its
    centred squares, and the global mean of the channel gates (CBAM's and
    MixConvNeXtML's); and every convolution and transposed convolution
    whose input and output heights ``n`` divides runs block by block on
    the rows each block's output reads (zeros past the image), as the
    strips run it, so that its weight gradient is the blocks' partial
    sums added in row order and each block's shape is a strip's. A level
    whose height ``n`` does not divide, which the strips gather, stays
    whole. The average pools need no patch: a strip sums each window of
    the fetched rows as one process does. For the comparison only: the
    port has no such switch."""
    from unittest import mock

    import torch.nn.functional as F

    from dsgan_tpu_torch import ops
    from dsgan_tpu_torch.models import generators_zoo, layers
    from dsgan_tpu_torch.ops import norm

    moments, bwd, bwd2 = norm.global_moments, bc.block_core_bwd, bc.block_core2_bwd
    bn_stats, avg_pool = layers.BatchNorm2d._stats, ops.adaptive_avg_pool
    cascade_ln = generators_zoo.CascadeLayerNorm.forward

    def blocks(t):
        h = t.shape[2] // n
        cl = t.is_contiguous(memory_format=torch.channels_last) and not t.is_contiguous()
        fmt = torch.channels_last if cl else torch.contiguous_format
        return [t.narrow(2, i * h, h).contiguous(memory_format=fmt) for i in range(n)]

    def total(t, dim):
        """The sum of ``t`` over ``dim``, block by block, in row order."""
        parts = [b.sum(dim=dim, keepdim=True) for b in blocks(t)]
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def split_moments(xf):
        if xf.shape[2] % n:
            return moments(xf)
        c = xf.shape[2] * xf.shape[3]
        return (total(xf, (2, 3))[:, :, 0, 0] / c, total(xf.square(), (2, 3))[:, :, 0, 0] / c)

    def split_bn(self, xf):
        if self.mesh is not None or xf.shape[2] % n:
            return bn_stats(self, xf)
        c = xf.numel() // xf.shape[1]
        mean = total(xf, (0, 2, 3)).reshape(-1) / c
        sq = total((xf - mean[:, None, None]).square(), (0, 2, 3)).reshape(-1)
        return mean, sq / c, c

    def split_avg_pool(x):
        if x.shape[2] % n:
            return avg_pool(x)
        return total(x, (2, 3)) / (x.shape[2] * x.shape[3])

    def split_cascade_ln(self, x):
        if x.shape[2] % n:
            return cascade_ln(self, x)
        xf = x.float()
        c = x.shape[1] * x.shape[2] * x.shape[3]
        mean = total(xf, (1, 2, 3)) / c
        var = total((xf - mean).square(), (1, 2, 3)) / (c - 1)
        y = (xf - mean) / (torch.sqrt(var) + self.eps)
        return (self.gamma[:, None, None] * y + self.beta[:, None, None]).to(x.dtype)

    def split(fn, parts):
        """``fn`` (K2 / K4, whose ``parts`` leading inputs and cotangent are
        per pixel, as are as many leading outputs) on each block."""
        def run(*args, packed=None):
            if args[0].shape[2] % n:
                return fn(*args, packed=packed)
            cut = {j: blocks(args[j]) for j in set(range(parts)) | {2 * parts}}
            outs = [fn(*[cut[j][i] if j in cut else a for j, a in enumerate(args)],
                       packed=packed) for i in range(n)]
            sums = list(outs[0][parts:])
            for o in outs[1:]:
                sums = [a + b for a, b in zip(sums, o[parts:])]
            return [torch.cat(o, 2) for o in zip(*(o[:parts] for o in outs))] + sums
        return run

    conv2d, conv_t = F.conv2d, F.conv_transpose2d

    def pair(v):
        return tuple(v) if isinstance(v, (tuple, list)) else (v, v)

    def rows_of(x, first, count, fmt):
        """Rows ``first`` .. ``first + count - 1`` of ``x``, zeros past its edges."""
        lo, hi = max(first, 0), min(first + count, x.shape[2])
        part = x.narrow(2, lo, hi - lo)
        if lo - first or first + count - hi:
            part = F.pad(part, (0, 0, lo - first, first + count - hi))
        return part.contiguous(memory_format=fmt)

    def fmt_of(x):
        cl = x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous()
        return torch.channels_last if cl else torch.contiguous_format

    def split_conv(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        (sh, sw), kh = pair(stride), w.shape[2]
        if (not w.requires_grad or isinstance(padding, str) or pair(dilation) != (1, 1)
                or x.dim() != 4):  # a fixed window (SSIM's) is no layer of the nets
            return conv2d(x, w, b, stride, padding, dilation, groups)
        ph, pw = pair(padding)
        h = x.shape[2]
        ho = (h + 2 * ph - kh) // sh + 1
        if h % n or ho % n:
            return conv2d(x, w, b, stride, padding, dilation, groups)
        per = ho // n
        outs = [conv2d(rows_of(x, i * per * sh - ph, (per - 1) * sh + kh, fmt_of(x)), w, b,
                       (sh, sw), (0, pw), 1, groups) for i in range(n)]
        return torch.cat(outs, 2)

    def split_conv_t(x, w, b=None, stride=1, padding=0, output_padding=0, groups=1,
                     dilation=1):
        (sh, sw), (ph, pw), (oh, ow), kh = pair(stride), pair(padding), pair(output_padding), \
            w.shape[2]
        h = x.shape[2]
        ho = (h - 1) * sh - 2 * ph + kh + oh
        if not w.requires_grad or pair(dilation) != (1, 1) or h % n or ho != sh * h:
            return conv_t(x, w, b, stride, padding, output_padding, groups, dilation)
        per = ho // n
        outs = []
        for i in range(n):
            a = i * per
            first = -((ph - kh + 1 + a) // -sh)
            last = (a + per - 1 + ph) // sh
            y = conv_t(rows_of(x, first, last - first + 1, fmt_of(x)), w, b, (sh, sw), (0, pw),
                       (0, ow), groups, dilation)
            outs.append(y.narrow(2, a + ph - sh * first, per))
        return torch.cat(outs, 2)

    return [mock.patch.object(norm, "global_moments", split_moments),
            mock.patch.object(F, "conv2d", split_conv),
            mock.patch.object(F, "conv_transpose2d", split_conv_t),
            mock.patch.object(layers.BatchNorm2d, "_stats", split_bn),
            mock.patch.object(ops, "adaptive_avg_pool", split_avg_pool),
            mock.patch.object(generators_zoo.CascadeLayerNorm, "forward", split_cascade_ln),
            mock.patch.object(bc, "block_core_bwd", split(bwd, 2)),
            mock.patch.object(bc, "block_core2_bwd", split(bwd2, 4))]


def _sp_run(torch, np, bc, mesh, recipe, dtype, use_vgg=False, timed=True, halves=False,
            steps=None, deterministic=None):
    """One run of a recipe (``SP_RECIPES``): ``_sp_steps`` for pix2pix
    (and ``pix2pix_remat``, its G under --remat), ``_sp_recipe_steps`` for
    the others; ``halves``: one process summing
    over the two row halves (``_row_halves``); ``deterministic``: cuDNN's
    deterministic algorithms (None: for the f32 runs, which the gate reads,
    so that one process's gradients repeat from run to run; under the
    default algorithms they do not, ``grad_spread``). Adds the run's
    seconds."""
    patches = _row_halves(torch, bc) if halves else []
    if deterministic is None:
        deterministic = dtype == torch.float32
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    t0 = time.perf_counter()
    for p in patches:
        p.start()
    try:
        if recipe in ("pix2pix", "pix2pix_remat"):
            run = _sp_steps(torch, np, bc, mesh, dtype, use_vgg, timed, steps,
                            remat=recipe == "pix2pix_remat")
        else:
            run = _sp_recipe_steps(torch, np, bc, mesh, recipe, dtype, steps)
    finally:
        for p in patches:
            p.stop()
        torch.backends.cudnn.deterministic = saved
    torch.cuda.synchronize()
    return dict(run, seconds=time.perf_counter() - t0, cudnn_deterministic=deterministic)


def _nets_state(nets):
    return {n: {k: v.detach().to("cpu", copy=True) for k, v in net.state_dict().items()}
            for n, net in nets.items()}


def _sp_steps(torch, np, bc, mesh, dtype, use_vgg, timed, steps=None, remat=False):
    """The spatial recipe's gated steps, then (``timed``) its timed steps,
    on this rank's strip (the whole image without a mesh), from the state
    built from seed 0, in ``dtype`` (f32: the FMA check builds, erf GELU;
    bf16: the Hopper kernels, tanh GELU). Returns the gated steps' metrics,
    the first step's G and D gradients, the launch counts of the gated
    steps, the rows each ConvNeXt block's input held, the tally of a step,
    the timed steps' ms and the peak memory."""
    from dsgan_tpu_torch.models import define_D, define_G, define_vgg, pix2pix
    from dsgan_tpu_torch.models.mixconvnext import ConvNeXtBlock
    from dsgan_tpu_torch.parallel import comms, shard_batch

    dev, lr, size = torch.device("cuda"), 2e-4, SPATIAL["size"]
    cfg = pix2pix.Pix2PixConfig(pool_size=0, use_vgg=use_vgg, w_vgg=1.0 if use_vgg else 0.0,
                                compute_dtype=None if dtype == torch.float32 else dtype)
    G = define_G(3, 3, 32, "MixConvNeXtML", dtype=dtype, device=dev, seed=0, train=True,
                 remat=remat)
    D = define_D(6, 32, "basic", dtype=dtype, device=dev, seed=1)
    vgg = define_vgg(4, dtype=dtype, device=dev, seed=2) if use_vgg else None
    rows = size // (mesh.spatial if mesh is not None else 1)
    state = pix2pix.init_state(G, D, vgg, cfg, (rows, size), seed=0)
    step = pix2pix.make_train_step(cfg, mesh)
    seen = {}

    def record(name):
        def hook(mod, args):
            seen.setdefault(name, tuple(args[0].shape))
        return hook

    for name, m in G.named_modules():
        if isinstance(m, ConvNeXtBlock):
            m.register_forward_pre_hook(record(name))
    batches = [[torch.from_numpy(np.ascontiguousarray(shard_batch(x, mesh) if mesh else x))
                .to(dev) for x in ab] for ab in _sp_batches(np)]
    torch.cuda.reset_peak_memory_stats()
    zero_counts(bc)
    metrics, grads, tally = [], None, None
    for a, b in batches[:steps or SPATIAL["steps"]]:
        if mesh is not None:
            comms.reset(mesh)
        m, _ = step(state, a, b, lr)
        metrics.append({k: float(v) for k, v in m.items()})
        if mesh is not None:
            tally = comms.collective_stats(mesh)
        if grads is None:
            grads = {n: {k: q.grad.float().cpu() for k, q in net.named_parameters()
                         if q.grad is not None} for n, net in (("netG", G), ("netD", D))}
    launches = read_counts(bc)
    ms = None
    if timed:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a, b in batches[SPATIAL["steps"]:]:
            step(state, a, b, lr)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / SPATIAL["timed"] * 1e3
    return dict(metrics=metrics, grads=grads, launches=launches, block_inputs=seen, tally=tally,
                step_ms=ms, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                params=_nets_state({"netG": G, "netD": D}))


def _fill_pools(torch, state, mesh):
    """Both CycleGAN pools full from the start, of seeded whole images (this
    rank's strip of them), so that every query draws its coins and indices."""
    dev = state.pool_A.images.device
    gen = torch.Generator(device=dev).manual_seed(7)
    s = mesh.spatial if mesh is not None else 1
    for pool in (state.pool_A, state.pool_B):
        n, c, h, w = pool.images.shape
        whole = torch.rand((n, c, h * s, w), generator=gen, device=dev) * 2 - 1
        pool.images.copy_(whole if mesh is None else whole[:, :, mesh.strip(h * s)])
        pool.count = pool.pool_size


def _sp_recipe(torch, recipe, mesh, dtype, device="cuda", size=None, ngf=64, use_vgg=False):
    """One of RECIPES (the spatial phase's SP_RECIPES, the card_vs_cpu
    phase's CVC_RECIPES) on ``device``, built from seed 0 on this rank's
    strip (the whole image without a mesh) of a ``size``-square image
    (default SPATIAL["size"]): the zoo's generators at ``ngf``,
    MixConvNeXtML at its own widths, D ndf 32, dropout off; ``use_vgg``: a
    pix2pix recipe's VGG term on (weight 1); in ``dtype`` (f32: its pools
    empty, 0 images; bf16: the CycleGAN recipes' pools of SPATIAL["pool"],
    full): (state, step returning (metrics, out), {name: network});
    diffusion's step also takes ``t`` and ``eps``."""
    from dsgan_tpu_torch.models import (
        cycle_gan,
        define_D,
        define_G,
        define_vgg,
        diffusion,
        pix2pix,
    )
    from dsgan_tpu_torch.models.layers import set_batchnorm_mesh

    if recipe not in RECIPES:
        fail(f"no recipe {recipe!r}: {sorted(RECIPES)}")
    model, which_g, which_d, norm = RECIPES[recipe]
    dev, size = torch.device(device), size or SPATIAL["size"]
    rows = size // (mesh.spatial if mesh is not None else 1)
    bf16 = dtype == torch.bfloat16
    if model == "diffusion":
        net = diffusion.define_denoiser(3, 3, DIFF["nf"], dtype, dev, seed=0)
        cfg = diffusion.DiffusionConfig(timesteps=DIFF["timesteps"],
                                        compute_dtype=dtype if bf16 else None)
        step = diffusion.make_diffusion_train_step(cfg, mesh)
        return (diffusion.init_state(net, cfg, seed=0),
                lambda s, a, b, lr, **draws: (step(s, a, b, lr, **draws), None), {"net": net})
    width = 32 if which_g == "MixConvNeXtML" else ngf
    n_layers_D = 4 if which_d == "n_layers" else 3

    def G(seed):
        return define_G(3, 3, width, which_g, norm=norm, use_dropout=False, dtype=dtype,
                        device=dev, seed=seed, train=True)

    def D(input_nc, seed):
        return define_D(input_nc, 32, which_d, n_layers_D, norm=norm, dtype=dtype, device=dev,
                        seed=seed)

    if model == "cycle_gan":
        cfg = cycle_gan.CycleGANConfig(pool_size=SPATIAL["pool"] if bf16 else 0,
                                       lambda_identity=0.5)
        nets = [G(0), G(1), D(3, 2), D(3, 3)]
        state = cycle_gan.init_state(*nets, cfg, (rows, size), seed=0)
        if bf16:
            _fill_pools(torch, state, mesh)
        return state, cycle_gan.make_cyclegan_step(cfg, mesh), dict(zip(cycle_gan.NETS, nets))
    netG, netD = G(0), D(6, 1)
    vgg = define_vgg(4, dtype=dtype, device=dev, seed=2) if use_vgg else None
    cfg = pix2pix.Pix2PixConfig(pool_size=0, use_vgg=use_vgg, w_vgg=1.0 if use_vgg else 0.0,
                                compute_dtype=dtype if bf16 else None,
                                fuse_d_batch=norm != "batch")
    state = pix2pix.init_state(netG, netD, vgg, cfg, (rows, size), seed=0)
    if mesh is not None:
        for net in (netG, netD):
            set_batchnorm_mesh(net, mesh)
    return state, pix2pix.make_train_step(cfg, mesh), {"netG": netG, "netD": netD}


def _sp_recipe_steps(torch, np, bc, mesh, recipe, dtype, steps=None):
    """A recipe's steps (f32 1, bf16 2: SP_STEPS) on pairs 0 and 1 of
    ``_sp_batches`` on this rank's strip, each timed alone: the metrics,
    the first step's gradients, the launch counts, the tally of a step,
    each step's ms, the peak memory, the networks' states and the draws'
    generators (what the ranks must hold alike); the bf16 diffusion run
    then draws one DDIM sample of SPATIAL["ddim"] steps on the strip."""
    from dsgan_tpu_torch.models import diffusion
    from dsgan_tpu_torch.parallel import comms, shard_batch

    dev, lr = torch.device("cuda"), 2e-4
    steps = steps or SP_STEPS[dtype == torch.bfloat16]
    state, step, nets = _sp_recipe(torch, recipe, mesh, dtype)
    pairs = _sp_batches(np)
    batches = [[torch.from_numpy(np.ascontiguousarray(shard_batch(x, mesh) if mesh else x))
                .to(dev) for x in ab] for ab in (pairs[0], pairs[SPATIAL["steps"]])][:steps]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(bc)
    metrics, grads, tally, ms = [], None, None, []
    for a, b in batches:
        if mesh is not None:
            comms.reset(mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, _ = step(state, a, b, lr)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        if mesh is not None:
            tally = comms.collective_stats(mesh)
        if grads is None:
            grads = {n: {k: q.grad.float().cpu() for k, q in net.named_parameters()
                         if q.grad is not None} for n, net in nets.items()}
    launches = read_counts(bc)
    params = _nets_state(nets)
    gens = [getattr(state, g) for g in ("pool_A", "pool_B") if hasattr(state, g)]
    params["draws"] = {f"generator{i}": g.generator.get_state() for i, g in enumerate(gens)}
    params["draws"].update({f"count{i}": torch.tensor(g.count) for i, g in enumerate(gens)})
    if recipe == "diffusion":
        params["draws"]["generator"] = state.generator.get_state()
    run = dict(metrics=metrics, grads=grads, launches=launches, tally=tally, step_ms=ms,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, params=params)
    if recipe == "diffusion" and dtype == torch.bfloat16:
        sampler = diffusion.make_ddim_sampler(
            diffusion.DiffusionConfig(timesteps=DIFF["timesteps"]), SPATIAL["ddim"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = sampler(state.net, batches[0][0], generator=torch.Generator(device=dev).manual_seed(5),
                    mesh=mesh)
        torch.cuda.synchronize()
        run.update(sample=x.cpu(), sample_ms=(time.perf_counter() - t0) * 1e3)
    return run


def _sp_keys(fault=None):
    """The runs a spatial rank makes, (key, recipe, dtype name, VGG): every
    run clean; with ``fault`` the f32 runs of the recipes it is planted in
    (``RECIPE_FAULTS``), and CycleGAN's bf16 run for the pool's."""
    runs = [("f32", "pix2pix", "f32", False), ("f32_remat", "pix2pix_remat", "f32", False),
            ("bf16", "pix2pix", "bf16", False), ("bf16_vgg", "pix2pix", "bf16", True)]
    runs += [(f"{r}_{d}", r, d, False) for r in SP_RECIPES for d in ("f32", "bf16")]
    if fault is None:
        return runs
    if fault == "pool":
        return [k for k in runs if k[0] == "cycle_gan_bf16"]
    return [k for k in runs if k[2] == "f32" and k[1] in RECIPE_FAULTS[fault]]


def _is_remat(key):
    return key.endswith("_remat")


def _sp_rank(rank, out, fault=None):
    """A spatial rank: data 1 x spatial 2, gloo, the card shared; with
    ``fault`` the runs of ``_sp_keys(fault)`` alone, that fault planted."""
    import numpy as np
    import torch

    from dsgan_tpu_torch.kernels import block_core as bc
    from dsgan_tpu_torch.parallel import resolve_mesh

    _card_flags(torch)
    _sp_plant(fault)
    mesh = resolve_mesh(1, 2, batch_size=SPATIAL["batch"], height=SPATIAL["size"])
    runs = {}
    for key, recipe, dname, vgg in _sp_keys(fault):
        dtype = torch.float32 if dname == "f32" else torch.bfloat16
        runs[key] = _sp_run(torch, np, bc, mesh, recipe, dtype, vgg,
                            timed=fault is None and dname != "f32")
        torch.cuda.empty_cache()
    torch.save(runs, os.path.join(out, f"rank{rank}.pt"))


def _sp_grads(torch, run, ref):
    """Per net: each weight's first-step gradient's rel-L2 against ``ref``'s,
    and over all its weights."""
    out = {}
    for n in ref["grads"]:
        keys = [k for k, v in ref["grads"][n].items() if v.dim() > 1]
        each = {k: rel_l2(run["grads"][n][k], ref["grads"][n][k]) for k in keys}
        every = rel_l2(torch.cat([run["grads"][n][k].reshape(-1) for k in keys]),
                       torch.cat([ref["grads"][n][k].reshape(-1) for k in keys]))
        out[n] = (each, every)
    return out


def sp_gate(torch, run, one, floor, keys=SPATIAL["keys"]):
    """A rank's f32 run against one process's (``one``): each gated loss's
    (``keys``) difference beside its bound (SPATIAL["losses"]); each
    weight's first-step gradient's rel-L2, and each net's over all its
    weights, beside SPATIAL["grad"] or SPATIAL["noise"] times the halves'
    run's (``floor``) reading where that is larger. The table holds each
    net's weight nearest its limit, all its weights, and every reading over
    its limit. Returns (table, the readings over their limits)."""
    table, over = {}, []
    for i, (g, w) in enumerate(zip(run["metrics"], one["metrics"])):
        rtol, atol = SPATIAL["losses"][i]
        for key in keys:
            d, limit = abs(g[key] - w[key]), atol + rtol * abs(w[key])
            table[f"{key}_step{i + 1}"] = dict(got=d, limit=limit)
            if not d <= limit:
                over.append(f"{key}_step{i + 1}")
    floors = _sp_grads(torch, floor, one)
    for n, (each, every) in _sp_grads(torch, run, one).items():
        f_each, f_every = floors[n]
        readings = {f"grad_{n}.{k}": (v, f_each[k]) for k, v in each.items()}
        readings[f"grad_all_{n}"] = (every, f_every)
        table_n = {label: dict(got=v, floor=f, limit=max(SPATIAL["grad"], SPATIAL["noise"] * f))
                   for label, (v, f) in readings.items()}
        worst = max((k for k in table_n if k != f"grad_all_{n}"),
                    key=lambda k: table_n[k]["got"] / table_n[k]["limit"])
        table[f"grad_worst_{n}"] = dict(table_n[worst], tensor=worst.split(".", 1)[1])
        table[f"grad_all_{n}"] = table_n[f"grad_all_{n}"]
        for label, t in table_n.items():
            if not t["got"] <= t["limit"]:
                table[label] = t
                over.append(label)
    return table, over


def _sp_spawn(torch, tmp, fault=None):
    from dsgan_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    multihost.spawn(_sp_rank, 2, (tmp, fault), platform="gpu", backend="gloo", timeout=900)
    return ([torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(2)],
            time.perf_counter() - t0)


def _sp_rows():
    """The rows each ConvNeXt block's input holds on a strip of 2 at 512:
    c_k at level k - 1, uc_k at level 4 - k."""
    rows = {f"c{k}": SPATIAL["size"] // 2 ** (k - 1) // 2 for k in range(1, 6)}
    rows.update({f"uc{k}": SPATIAL["size"] // 2 ** (4 - k) // 2 for k in range(1, 5)})
    return rows


def _sp_sites():
    """K1_SITES and K3_SITES at the strips' shapes: each site's (rows, W)
    on a strip of 2 at SPATIAL["size"] (``_sp_rows``), the shapes the
    bf16 ranks give the Hopper kernels."""
    rows, scale = _sp_rows(), SPATIAL["size"] // 256
    return tuple([(site, (rows[site], side * scale), parts, p) for site, side, parts, p in sites]
                 for sites in (K1_SITES, K3_SITES))


def _identical(torch, r0, r1):
    """Whether two ranks' runs hold the same metrics and state, bit for bit."""
    return r0["metrics"] == r1["metrics"] and all(
        torch.equal(r0["params"][n][k], r1["params"][n][k])
        for n in r0["params"] for k in r0["params"][n])


def _same_step(torch, a, b):
    """What differs between two runs' metrics, first-step gradients and
    states, bit for bit: [] where nothing does."""
    differ = [k for k in a["metrics"][0] if any(x[k] != y[k] for x, y in
                                                zip(a["metrics"], b["metrics"]))]
    for part in ("grads", "params"):
        differ += [f"{part}.{n}.{k}" for n in b[part] for k in b[part][n]
                   if not torch.equal(a[part][n][k], b[part][n][k])]
    return differ


def _sp_per(key):
    """K1-K4 launches a step of a run (``_sp_keys``): pix2pix's 5/4/5/4,
    CycleGAN's CYCLE_PER_STEP, none for diffusion and resnet_9blocks."""
    if _is_remat(key):
        return REMAT_PER_STEP
    if key in ("f32", "bf16", "bf16_vgg"):
        return {"K1": 5, "K3": 4, "K2": 5, "K4": 4}
    return CYCLE_PER_STEP if key.startswith("cycle_gan") else {k: 0 for k in CYCLE_PER_STEP}


def _sp_gates(torch, runs, one, halves):
    """Each recipe's f32 gate (``sp_gate``) on a rank's ``runs``: {recipe:
    (table, over)}."""
    out = {}
    for recipe in ("pix2pix",) + SP_RECIPES:
        key = "f32" if recipe == "pix2pix" else f"{recipe}_f32"
        if key in runs:
            out[recipe] = sp_gate(torch, runs[key], one[key], halves[recipe],
                                  SP_GATE_KEYS[recipe])
    return out


def avg_pool_check(torch):
    """The 3x3 stride-2 average pool's input gradient (gll's and the
    multiscale D's pyramids) on a channels_last card tensor against the
    CPU's: through ``ops.avg_pool2d`` (which must agree), and torch's own
    pool on that layout, read for the record (wrong on torch 2.11 + CUDA
    12.8: ``ops.pool_avg``)."""
    import torch.nn.functional as F

    from dsgan_tpu_torch import ops

    gen = torch.Generator().manual_seed(5)
    x = torch.randn((1, 6, SPATIAL["size"], SPATIAL["size"]), generator=gen)
    g = torch.randn((1, 6, SPATIAL["size"] // 2, SPATIAL["size"] // 2), generator=gen)

    def grad(fn, t):
        t = t.detach().clone().requires_grad_(True)
        fn(t, 3, 2, 1, count_include_pad=False).backward(g.to(t.device))
        return t.grad.cpu()

    want = grad(F.avg_pool2d, x)
    card = x.cuda().contiguous(memory_format=torch.channels_last)
    res = {name: rel_l2(grad(fn, card), want)
           for name, fn in (("ops_avg_pool2d", ops.avg_pool2d), ("torch_avg_pool2d", F.avg_pool2d))}
    print(json.dumps({"avg_pool_channels_last_grad_vs_cpu": res}))
    if not res["ops_avg_pool2d"] <= 1e-6:
        fail(f"ops.avg_pool2d's gradient on the card is off the CPU's: {res}")
    return res


def spatial_phase(torch, np, bc, card, faults=()):
    """The spatial axis (``parallel.spatial``) on the one card: two gloo ranks
    (data 1 x spatial 2), spawned, each holding 256 of the 512 image rows.
    First K1-K4 (bf16, the Hopper kernels) against their plain versions at
    the strips' shapes (``_sp_sites``). Then four recipes (pix2pix on
    MixConvNeXtML, and SP_RECIPES: CycleGAN, diffusion, resnet_9blocks
    under ``--norm batch``), each (a) f32 on the FMA check builds: the
    ranks against one process and the halves' run at ``sp_gate``'s bounds,
    K1-K4's launches a rank a step; (b) bf16 on the Hopper kernels (pix2pix
    without and with VGG): the ranks bit-identical, the launches, a rank's
    step ms and peak memory beside one process's, the tally of a step with
    its halo bytes; diffusion's bf16 run also a DDIM sample on the strips.
    With ``faults`` (``--spatial_faults``): (a) clean, then with each of
    SPATIAL_FAULTS planted in the ranks (``_sp_keys``), which the gates of
    the recipes it is planted in must fail (the pool's: the bf16 ranks no
    longer identical)."""
    from dsgan_tpu_torch.ops import instance_stats

    pool_check = avg_pool_check(torch)
    kernel_rows = (check_kernels(torch, bc, instance_stats, SPATIAL["batch"], torch.bfloat16,
                                 "tanh", TOL_BF16, 3, sites=_sp_sites())
                   + check_backward(torch, bc, instance_stats, SPATIAL["batch"], torch.bfloat16,
                                    "tanh", 3, sites=_sp_sites()))
    one, halves = {}, {}
    keys = [k for k in _sp_keys() if not faults or k[2] == "f32"]
    for key, recipe, dname, vgg in keys:
        torch.cuda.empty_cache()
        dtype = torch.float32 if dname == "f32" else torch.bfloat16
        one[key] = _sp_run(torch, np, bc, None, recipe, dtype, vgg, timed=dname != "f32")
        if dname == "f32" and not _is_remat(key):
            torch.cuda.empty_cache()
            halves[recipe] = _sp_run(torch, np, bc, None, recipe, dtype, timed=False,
                                     halves=True)
    torch.cuda.empty_cache()
    planted = {}
    with tempfile.TemporaryDirectory(prefix="dsgan_sp_") as tmp:
        ranks, spawn_s = _sp_spawn(torch, tmp)
        for fault in faults:
            runs, fault_s = _sp_spawn(torch, tmp, fault)
            if fault == "pool":
                same = _identical(torch, runs[0]["cycle_gan_bf16"], runs[1]["cycle_gan_bf16"])
                planted[fault] = dict(cycle_gan=dict(over=int(not same), ranks_identical=same),
                                      seconds=fault_s)
                continue
            planted[fault] = {recipe: dict(over=len(over),
                                           first={k: table[k]["got"] for k in over[:4]})
                              for recipe, (table, over) in
                              _sp_gates(torch, runs[0], one, halves).items()}
            planted[fault]["seconds"] = fault_s
    gates = _sp_gates(torch, ranks[0], one, halves)
    # ungated: the worst weight and all weights, the ranks' against one
    # process and against the halves' run, the halves' against one process
    distances = {}
    for recipe in gates:
        key = "f32" if recipe == "pix2pix" else f"{recipe}_f32"
        for a, run, b, ref in (("ranks", ranks[0][key], "one", one[key]),
                               ("ranks", ranks[0][key], "halves", halves[recipe]),
                               ("halves", halves[recipe], "one", one[key])):
            for n, (each, every) in _sp_grads(torch, run, ref).items():
                distances[f"{recipe}_{a}_vs_{b}_{n}"] = (max(each, key=each.get),
                                                         max(each.values()), every)
    res = dict(card=card, size=SPATIAL["size"], batch=SPATIAL["batch"], mesh=[1, 2],
               avg_pool_check=pool_check,
               gates={r: dict(gate=t, over=o) for r, (t, o) in gates.items()},
               spawn_s=spawn_s, runs={}, distances=distances, kernel_rows=kernel_rows,
               seconds={k: dict(one_process=one[k]["seconds"], rank0=ranks[0][k]["seconds"],
                                rank1=ranks[1][k]["seconds"]) for k in one})
    problems = [f"{r} f32 gate: {k} {t[k]}" for r, (t, o) in gates.items() for k in o]
    # --remat on the strips and in one process: the f32 step bit for bit
    # with the step without it
    remat = {who: _same_step(torch, run["f32_remat"], run["f32"])
             for who, run in (("one_process", one), ("rank0", ranks[0]), ("rank1", ranks[1]))
             if "f32_remat" in run}
    res["remat_vs_no_remat"] = remat
    problems += [f"--remat's f32 step differs from the step without it ({who}): {d[:4]}"
                 for who, d in remat.items() if d]
    launches = {k: 0 for k in CYCLE_PER_STEP}
    for key, recipe, dname, _ in keys:
        r0, r1 = ranks[0][key], ranks[1][key]
        same = _identical(torch, r0, r1)
        run = dict(ranks_identical=same, launches=[r0["launches"], r1["launches"]],
                   one_process_launches=one[key]["launches"], tally=r0["tally"],
                   step_ms=dict(one_process=one[key]["step_ms"], rank0=r0["step_ms"],
                                rank1=r1["step_ms"]),
                   peak_gib=dict(one_process=one[key]["peak_gib"], rank0=r0["peak_gib"],
                                 rank1=r1["peak_gib"]),
                   seconds=res["seconds"][key],
                   loss_G=[m["loss_G"] for m in r0["metrics"]],
                   loss_G_one=[m["loss_G"] for m in one[key]["metrics"]])
        if "block_inputs" in r0:
            run["block_inputs"] = r0["block_inputs"]
        if "sample" in r0:
            got = torch.cat([r0["sample"], r1["sample"]], 1)
            want = one[key]["sample"]
            run["ddim"] = dict(shape=list(got.shape), finite=bool(torch.isfinite(got).all()),
                               max_abs=float(got.abs().max()),
                               vs_one_process_max_abs=float((got - want).abs().max()),
                               ms=dict(one_process=one[key]["sample_ms"],
                                       rank0=r0["sample_ms"]))
            if not (run["ddim"]["finite"] and run["ddim"]["max_abs"] <= 1.0
                    and tuple(got.shape) == tuple(want.shape)):
                problems.append(f"{key}: the DDIM sample on strips {run['ddim']}")
        res["runs"][key] = run
        print(json.dumps({f"spatial_{key}": run}))
        n_steps = len(r0["metrics"])
        want = {k: v * n_steps for k, v in _sp_per(key).items()}
        if not same:
            problems.append(f"{key}: the ranks' states or metrics differ")
        for r in (r0, r1):
            if r["launches"] != want:
                problems.append(f"{key}: a rank launched {r['launches']}, want {want}")
            if "block_inputs" in r:
                rows = {n: shape[2] for n, shape in r["block_inputs"].items()}
                if rows != _sp_rows():
                    problems.append(f"{key}: block input rows {rows}, want {_sp_rows()}")
        if not (r0["tally"] or {}).get("collective-permute", {}).get("bytes"):
            problems.append(f"{key}: no halo bytes in the tally {r0['tally']}")
        if not all(math.isfinite(v) for m in r0["metrics"] for v in m.values()):
            problems.append(f"{key}: non-finite metrics")
        if dname != "f32":
            launches = {k: launches[k] + r0["launches"][k] + r1["launches"][k] for k in launches}
    print(json.dumps({"spatial_f32_gates": dict(card=card, gates=res["gates"],
                                                distances=distances,
                                                remat_vs_no_remat=res["remat_vs_no_remat"])}))
    if faults:
        print(json.dumps({"spatial_faults": dict(card=card, over=planted)}))
        missed = [f"{f} ({r})" for f, o in planted.items() for r, v in o.items()
                  if r != "seconds" and not v["over"]]
        if missed:
            problems.append(f"the gates passed the planted faults {missed}")
        res["faults"] = planted
    if problems:
        fail("spatial: " + "; ".join(problems))
    return res, launches


def grad_spread(torch, np, bc, card, n, out=None):
    """``--grad_spread N``: one process's f32 first step at SPATIAL's config
    (512x512, batch 1, pool 0, TF32 off) N times for pix2pix and each of
    SP_RECIPES, and the halves' run once, under cuDNN's default algorithms
    and then under its deterministic ones; for each weight (and each net's
    weights as one vector) the largest rel-L2 between any two of the N
    runs (the spread), the halves' reading against the first run, and the
    spread as a fraction of that reading. The gate's limit is
    max(SPATIAL["grad"], SPATIAL["noise"] x the halves' reading), so a
    rank's reading of halves + spread stays within it where the fraction is
    at most 1 (or the limit is the flat floor): ``covered``. One line a
    weight, one summary line a recipe and mode; with ``out`` all of it in
    out/grad_spread.json."""
    report = {}
    for mode in ("default", "deterministic"):
        for recipe in ("pix2pix",) + SP_RECIPES:
            report[f"{recipe}_{mode}"] = _spread(torch, np, bc, card, n, recipe,
                                                 mode == "deterministic")
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "grad_spread.json"), "w") as f:
            json.dump(report, f, indent=1)
    return report


def _spread(torch, np, bc, card, n, recipe, deterministic):
    """``grad_spread``'s readings of one recipe in one cuDNN mode."""
    runs = []
    for _ in range(n):
        torch.cuda.empty_cache()
        runs.append(_sp_run(torch, np, bc, None, recipe, torch.float32, timed=False, steps=1,
                            deterministic=deterministic))
    torch.cuda.empty_cache()
    halves = _sp_run(torch, np, bc, None, recipe, torch.float32, timed=False, halves=True,
                     steps=1, deterministic=deterministic)
    mode = "deterministic" if deterministic else "default"
    rows = []
    for net, weights in runs[0]["grads"].items():
        keys = [k for k, v in weights.items() if v.dim() > 1]
        vec = {"all weights": lambda r: torch.cat([r["grads"][net][k].reshape(-1)
                                                   for k in keys])}
        vec.update({k: (lambda r, k=k: r["grads"][net][k]) for k in keys})
        for k, get in vec.items():
            spread = max((rel_l2(get(a), get(b)) for i, a in enumerate(runs)
                          for b in runs[i + 1:]), default=0.0)
            h = rel_l2(get(halves), get(runs[0]))
            limit = max(SPATIAL["grad"], SPATIAL["noise"] * h)
            row = dict(recipe=recipe, cudnn=mode, net=net, tensor=k, spread=spread, halves=h,
                       fraction=spread / h if h else math.inf, limit=limit,
                       covered=h + spread <= limit)
            rows.append(row)
            print(json.dumps({"grad_spread_weight": row}))
    uncovered = [r for r in rows if not r["covered"]]
    worst = max(rows, key=lambda r: r["fraction"] if r["halves"] else -1)
    summary = dict(card=card, recipe=recipe, cudnn=mode, runs=n, weights=len(rows),
                   uncovered=len(uncovered),
                   uncovered_tensors=[f"{r['net']}.{r['tensor']}" for r in uncovered][:10],
                   largest_fraction=dict(tensor=f"{worst['net']}.{worst['tensor']}",
                                         fraction=worst["fraction"], spread=worst["spread"],
                                         halves=worst["halves"]),
                   largest_spread=max(r["spread"] for r in rows),
                   seconds=[r["seconds"] for r in runs])
    print(json.dumps({"grad_spread": summary}))
    return dict(summary=summary, rows=rows)


def cvc_inputs(np, recipe, size, batch):
    """A recipe's step inputs from a seed: a uint8 (A, B) batch pair, and
    for diffusion the t and eps both sides take."""
    rng = np.random.default_rng(13)
    a, b = (rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8) for _ in range(2))
    draws = {}
    if RECIPES[recipe][0] == "diffusion":
        draws = dict(t=rng.integers(0, DIFF["timesteps"], (batch,)),
                     eps=rng.standard_normal((batch, 3, size, size)).astype(np.float32))
    return (a, b), draws


def _copy(t):
    """A detached f32 copy of ``t`` on the CPU (a CPU tensor's own storage
    is not kept: the step may write it in place later)."""
    return t.detach().float().to("cpu", copy=True)


def cvc_side(torch, recipe, device, inputs, size, ngf=64, init=None, patches=(), pin=None,
             jitter=0.0):
    """One f32 train step of ``recipe`` (``_sp_recipe``; the default
    recipe with its VGG term) on ``device``, from the networks' states
    ``init`` where given, ``patches`` started around the build and the
    step. Every module's tensor output is recorded, call by call, and each
    generator application's cotangent. With ``pin`` (another side's
    record) every module's output is held at ``pin``'s value (its
    gradient still reaching the module), so that each layer runs on the
    other side's inputs and every kink (ReLU, LeakyReLU, PReLU, a max
    pool, L1, TV) decides as it did there, and each generator
    application's cotangent, once recorded, is replaced by ``pin``'s: a
    generator's backward then starts from the other side's cotangent.
    ``jitter`` (the floor's): every pinned value and every cotangent
    reaching a pinned module output scaled by 1 +- jitter, the sign at
    random, a generator's output alone held exact. Returns the metrics, the
    generators' outputs and cotangents ({net: [one a call]}), the modules'
    outputs, every parameter gradient, the parameters without one, the
    networks' states before the step, the step's seconds and, on the card,
    its K1-K4 launches; tensors are CPU copies."""
    from dsgan_tpu_torch.kernels import block_core as bc

    (a, b), draws = inputs
    dev = torch.device(device)
    for p in patches:
        p.start()
    try:
        state, step, nets = _sp_recipe(torch, recipe, None, torch.float32, dev, size, ngf,
                                       use_vgg=recipe == "default")
        if init is not None:
            for n, net in nets.items():
                net.load_state_dict(init[n])
        before = _nets_state(nets)
        gens = [n for n in nets if n.startswith("netG") or n == "net"]
        outs, cots, mods = {n: [] for n in gens}, {n: [] for n in gens}, {}

        signs = torch.Generator().manual_seed(1)

        def jittered(t, scale):
            """``t`` with each entry scaled by 1 +- ``scale``, the sign at random."""
            if not scale:
                return t
            sign = torch.where(torch.rand(t.shape, generator=signs) < 0.5, -1.0, 1.0)
            return t * (1 + scale * sign).to(t)

        def held(key, y, scale=0.0):
            """Record ``y`` under ``key``; with ``pin`` return ``pin``'s value,
            it and its cotangent ``jittered`` by ``scale``."""
            mods.setdefault(key, []).append(_copy(y))
            if pin is None:
                return y
            out = y + (jittered(pin["mods"][key][len(mods[key]) - 1], scale).to(y) - y).detach()
            if scale and out.requires_grad:
                out.register_hook(lambda g: jittered(g, scale))
            return out

        def module_hook(key):
            def hook(mod, args, y):
                return held(key, y, jitter) if isinstance(y, torch.Tensor) else None
            return hook

        def generator_hook(n):
            def hook(mod, args, y):
                k = len(outs[n])
                outs[n].append(_copy(y))
                cots[n].append(None)
                y = held(n, y)

                def cotangent(g):
                    cots[n][k] = _copy(g)
                    return None if pin is None else jittered(pin["cots"][n][k], jitter).to(g)
                y.register_hook(cotangent)
                return y
            return hook
        every = dict(nets, vgg=state.vgg) if getattr(state, "vgg", None) is not None else nets
        hooks = [m.register_forward_hook(module_hook(f"{n}.{name}" if name else n))
                 for n, net in every.items() for name, m in net.named_modules()
                 if name or n not in gens]
        hooks += [nets[n].register_forward_hook(generator_hook(n)) for n in gens]
        a, b = (torch.from_numpy(x).to(dev) for x in (a, b))
        zero_counts(bc)
        t0 = time.perf_counter()
        m, _ = step(state, a, b, CARD_VS_CPU["lr"],
                    **{k: torch.from_numpy(v) for k, v in draws.items()})
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        for h in hooks:
            h.remove()
        grads = {n: {k: _copy(q.grad) for k, q in net.named_parameters()
                     if q.grad is not None} for n, net in nets.items()}
        no_grad = [f"{n}.{k}" for n, net in nets.items() for k, q in net.named_parameters()
                   if q.grad is None]
    finally:
        for p in reversed(patches):
            p.stop()
    return dict(metrics={k: float(v) for k, v in m.items()}, outs=outs, cots=cots, mods=mods,
                grads=grads, no_grad=no_grad, init=before, seconds=seconds,
                launches=read_counts(bc) if dev.type == "cuda" else None)


def _cvc_raw(torch, got, want, keys):
    """A step's distances to the reference step (``want``): each loss of
    ``keys`` relative; each module call's output (but a generator's, read
    as its output), each generator application's output and cotangent and
    each parameter gradient rel-L2 (inf where missing or misshapen); and
    each gradient's max|got - want| over its network's gradient norm."""
    def rel(g, w):
        return math.inf if g is None or w is None or g.shape != w.shape else rel_l2(g, w)

    raw, peak = {}, {}
    for k in keys:
        w = want["metrics"][k]
        raw[f"loss.{k}"] = abs(got["metrics"][k] - w) / max(abs(w), 1e-30)
    for key in set(want["mods"]) | set(got["mods"]):
        if key not in want["outs"]:
            ws, gs = want["mods"].get(key, []), got["mods"].get(key, [])
            raw.update({f"module.{key}.{k}": rel(gs[k] if k < len(gs) else None,
                                                 ws[k] if k < len(ws) else None)
                        for k in range(max(len(ws), len(gs)))})
    for n in want["outs"]:
        for part, what in (("outs", "output"), ("cots", "out_grad")):
            pairs = zip(got[part][n], want[part][n])
            raw.update({f"{what}.{n}.{k}": rel(g, w) for k, (g, w) in enumerate(pairs)})
    for n, grads in want["grads"].items():
        norm = float(torch.cat([g.reshape(-1) for g in grads.values()]).norm())
        for k in set(grads) | set(got["grads"][n]):
            name, g, h = f"grad.{n}.{k}", grads.get(k), got["grads"][n].get(k)
            raw[name] = rel(h, g)
            peak[name] = float((h - g).abs().max()) / norm if raw[name] < math.inf else math.inf
    return raw, peak


def cvc_readings(torch, got, want, floor, keys):
    """The readings of a step (``got``) against the reference step
    (``want``), beside ``floor``: the reference's step again, on the CPU in
    another order (``_cvc_other_order``), its parameters, module outputs
    (but the generators') and their cotangents a few roundings off
    (CARD_VS_CPU["floor_eta"]), both pinned to ``want`` (``cvc_side``).
    Each distance of ``_cvc_raw`` over its divisor, min(CARD_VS_CPU["cap"],
    max(1, the floor's same distance / CARD_VS_CPU["resolution"])): plain
    where f32 resolves the quantity to the resolution, in units of f32's
    own reach on it where it does not (a sum that cancels), never more
    than `cap` of them. A gradient f32 does not resolve to `cap` x
    `resolution` (the floor's rel-L2 that far off: 0 in exact arithmetic,
    as a bias straight into an InstanceNorm or BatchNorm, or a sum that
    cancels), or whose RMS is under CARD_VS_CPU["null"] times its
    network's, is read by max|got - want| over its network's gradient
    norm, in the same units. Returns ({name: reading}, {name: (distance,
    floor's distance)}, the names read as null, {name: divisor}, {name: the
    floor's distance / resolution where it is over `cap`})."""
    cap, resolution = CARD_VS_CPU["cap"], CARD_VS_CPU["resolution"]
    raw, peak = _cvc_raw(torch, got, want, keys)
    fl, fl_peak = _cvc_raw(torch, floor, want, keys)
    small = set()
    for n, grads in want["grads"].items():
        rms = float(torch.cat([g.reshape(-1) for g in grads.values()]).norm()) / math.sqrt(
            sum(g.numel() for g in grads.values()))
        small |= {f"grad.{n}.{k}" for k, g in grads.items()
                  if float(g.norm()) / math.sqrt(g.numel()) <= CARD_VS_CPU["null"] * rms}
    nulls = sorted(k for k in peak if k in small or not fl[k] < cap * resolution)
    dist = {k: (peak[k], fl_peak[k]) if k in nulls else (raw[k], fl[k]) for k in raw}
    div = {k: min(cap, max(1.0, f / resolution)) for k, (_, f) in dist.items()}
    capped = {k: f / resolution for k, (_, f) in dist.items() if not f / resolution <= cap}
    read = {k: d / div[k] for k, (d, _) in dist.items()}
    return read, dist, nulls, div, capped


def cvc_perturbed(torch, states):
    """``states`` ({net: state dict}) with every floating entry scaled by
    1 +- CARD_VS_CPU["floor_eta"], the sign at random from a seed: the
    floor's start, which with ``_cvc_other_order`` moves every backward's
    operands and sums as another implementation's arithmetic does."""
    gen = torch.Generator().manual_seed(0)
    eta = CARD_VS_CPU["floor_eta"]
    out = {}
    for n, sd in states.items():
        out[n] = {}
        for k, v in sd.items():
            if v.is_floating_point():
                sign = torch.where(torch.rand(v.shape, generator=gen) < 0.5, -1.0, 1.0)
                v = v * (1 + eta * sign).to(v.dtype)
            out[n][k] = v
    return out


class _Threads:
    """Start / stop: run with ``n`` CPU threads."""

    def __init__(self, torch, n):
        self.torch, self.n = torch, n

    def start(self):
        self.saved = self.torch.get_num_threads()
        self.torch.set_num_threads(self.n)

    def stop(self):
        self.torch.set_num_threads(self.saved)


def _cvc_other_order(torch):
    """The floor's patches: the step's images in contiguous memory (the
    convolutions then take other algorithms) and half the CPU threads (the
    reductions other splits), so that its sums run in another order."""
    from unittest import mock

    from dsgan_tpu_torch.models import pix2pix

    return [mock.patch.object(pix2pix, "CL", torch.contiguous_format),
            _Threads(torch, max(1, torch.get_num_threads() // 2))]


def _over(read, limit):
    """The readings over ``limit`` (NaN too), worst first."""
    return sorted((k for k, v in read.items() if not v <= limit),
                  key=lambda k: -read[k] if read[k] == read[k] else -math.inf)


def cvc_compare(torch, np, recipe, device, size, batch, ngf=64, patches=()):
    """``recipe``'s f32 step on the CPU (the reference), on the CPU from
    the reference's states one unit in the last place off (the floor) and
    on ``device`` from the reference's states, on the same inputs
    (``cvc_inputs``), the last two pinned to the reference (``cvc_side``);
    ``patches`` on the ``device`` side alone. Returns (the recipe's line:
    its three worst readings with their distances, the losses', the
    generator outputs' and cotangents', the modules' count and worst, the
    null gradients', the largest divisor and the readings whose floor it
    caps, those over ``limit``, each side's seconds and the device side's
    launches; all readings; {name: (distance, floor's distance)})."""
    model, which_g, which_d, norm = RECIPES[recipe]
    inputs = cvc_inputs(np, recipe, size, batch)
    want = cvc_side(torch, recipe, "cpu", inputs, size, ngf)
    floor = cvc_side(torch, recipe, "cpu", inputs, size, ngf,
                     init=cvc_perturbed(torch, want["init"]), patches=_cvc_other_order(torch),
                     pin=want, jitter=CARD_VS_CPU["floor_eta"])
    got = cvc_side(torch, recipe, device, inputs, size, ngf, init=want["init"], patches=patches,
                   pin=want)
    read, dist, nulls, div, capped = cvc_readings(torch, got, want, floor, SP_GATE_KEYS[recipe])
    if got["no_grad"] != want["no_grad"]:
        read["no_grad"], dist["no_grad"], div["no_grad"] = math.inf, (math.inf, 0.0), 1.0
    limit = CARD_VS_CPU["limit"]
    over = _over(read, limit)
    worst = _over({k: v for k, v in read.items() if k not in nulls}, -1.0)[:3]
    modules = [k for k in read if k.startswith("module.")]
    line = dict(recipe=recipe, model=model, G=which_g, D=which_d, norm=norm, size=size,
                batch=batch, readings=len(read), limit=limit,
                worst={k: dict(reading=read[k], distance=dist[k][0], floor=dist[k][1])
                       for k in worst},
                losses={k: v for k, v in read.items() if k.startswith("loss.")},
                outputs={k: v for k, v in read.items() if k.startswith(("output.", "out_grad."))},
                modules=dict(count=len(modules), worst={k: read[k] for k in _over(
                    {k: read[k] for k in modules}, -1.0)[:3]}),
                null={k: read[k] for k in nulls}, no_grad=want["no_grad"],
                divisors=dict(largest=max(div.values()), over_1=sum(v > 1 for v in div.values()),
                              capped=len(capped), capped_worst=dict(sorted(
                                  capped.items(), key=lambda kv: -kv[1])[:5])),
                over={k: dict(reading=read[k], distance=dist[k][0], floor=dist[k][1])
                      for k in over},
                seconds=dict(cpu=want["seconds"], floor=floor["seconds"], device=got["seconds"]),
                launches=got["launches"])
    return line, read, dist


def cvc_eval_ops(torch, np, device, size=CARD_VS_CPU["size"], layout=None):
    """The eval ops' f32 forwards on ``device`` against the CPU's, on the
    same inputs from a seed at ``size``: ``ssim_uint8`` / ``psnr_uint8``
    (the step's metrics), ``ms_ssim`` (the eval CLI's, per image), the 5-D
    SSIM (per volume), ``flow.estimate_flow`` then ``flow_warped_error``
    (the video CLI's) on a pair of frames one shifted by (2, 1) pixels,
    ``inception.prepare_images`` (the FID resize), and each of the four
    VGG taps (the perceptual loss); ``layout`` the ``device`` side's image
    batches' memory format (as given, contiguous, by default). Returns
    ({op: rel-L2}, the CPU's values of the scalar ops)."""
    from dsgan_tpu_torch import ops
    from dsgan_tpu_torch.models import define_vgg, inception
    from dsgan_tpu_torch.ops import flow

    rng = np.random.default_rng(17)
    b = CARD_VS_CPU["batch"]
    smooth = rng.standard_normal((b, 3, size // 8, size // 8)).astype(np.float32)
    smooth = np.repeat(np.repeat(smooth, 8, 2), 8, 3)
    label = np.clip(np.round(127.5 + 50 * smooth + 20 * rng.standard_normal(smooth.shape)),
                    0, 255).astype(np.float32)
    result = np.clip(label + np.round(12 * rng.standard_normal(label.shape)), 0, 255)
    image = (label / 127.5 - 1).astype(np.float32)
    depth = CARD_VS_CPU["volume_depth"]
    vol = rng.uniform(-1, 1, (1, 1, depth, size, size)).astype(np.float32)
    vol2 = (vol + 0.2 * rng.standard_normal(vol.shape)).astype(np.float32)
    frame0 = image[0].transpose(1, 2, 0)
    frame1 = np.roll(frame0, (1, 2), (0, 1)) + 0.02 * rng.standard_normal(frame0.shape)
    outs = [np.tanh(f + 0.1 * rng.standard_normal(f.shape)) for f in (frame0, frame1)]
    vgg_cpu = define_vgg(4, dtype=torch.float32, device="cpu", seed=2)

    def on(dev, layout=torch.contiguous_format):
        t = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev) for k, v in dict(
            label=label, result=result, image=image, vol=vol, vol2=vol2, f0=frame0, f1=frame1,
            o0=outs[0], o1=outs[1]).items()}
        t.update({k: t[k].contiguous(memory_format=layout) for k in ("label", "result", "image")})
        vgg = define_vgg(4, dtype=torch.float32, device=dev, seed=2)
        vgg.load_state_dict(vgg_cpu.state_dict())
        res = dict(ssim_uint8=ops.ssim_uint8(t["label"], t["result"]),
                   psnr_uint8=ops.psnr_uint8(t["label"], t["result"]),
                   ms_ssim=ops.ms_ssim(t["label"], t["result"], data_range=255,
                                       size_average=False),
                   ssim_5d=ops.ssim(t["vol"], t["vol2"], data_range=2.0, size_average=False))
        fl = flow.estimate_flow(t["f0"], t["f1"])
        res["estimate_flow"] = fl
        res["flow_warped_error"] = torch.stack(flow.flow_warped_error(t["o0"], t["o1"], t["f0"],
                                                                      t["f1"], fl))
        res["resize_bilinear"] = inception.prepare_images(t["image"])
        with torch.no_grad():
            res.update({f"vgg_tap{i}": tap for i, tap in enumerate(vgg(t["image"]))})
        return {k: v.detach().float().cpu() for k, v in res.items()}

    want, got = on(torch.device("cpu")), on(torch.device(device), layout or torch.contiguous_format)
    values = {k: v.tolist() for k, v in want.items() if v.numel() <= 2}
    return {k: rel_l2(got[k], want[k]) for k in want}, values


def _cvc_plant(torch, fault):
    """The patches that plant one of CVC_FAULTS on the card side."""
    from unittest import mock

    import torch.nn.functional as F

    from dsgan_tpu_torch.ops import conv

    if fault == "torch_pool":
        def torch_pool(x, window, stride, padding, count_include_pad):
            return F.avg_pool2d(x, window, stride, padding, count_include_pad=count_include_pad)
        return [mock.patch.object(conv, "pool_avg", torch_pool)]
    if fault == "transposed_gain":
        class Gain(torch.autograd.Function):
            @staticmethod
            def forward(ctx, w):
                return w.view_as(w)

            @staticmethod
            def backward(ctx, g):
                return g * (1 + 1e-2) if g.is_cuda else g

        conv_t = F.conv_transpose2d

        def gained(x, w, *args, **kw):
            return conv_t(x, Gain.apply(w) if x.is_cuda else w, *args, **kw)
        return [mock.patch.object(F, "conv_transpose2d", gained)]
    if fault == "forward_gain":
        conv2d = F.conv2d

        def forward_gained(x, *args, **kw):
            y = conv2d(x, *args, **kw)
            return y + 2e-2 * y.detach() if x.is_cuda else y
        return [mock.patch.object(F, "conv2d", forward_gained)]
    fail(f"card_vs_cpu: no planted fault {fault!r}: {sorted(CVC_FAULTS)}")


def _cvc_batch(recipe):
    return CARD_VS_CPU["cycle_batch" if RECIPES[recipe][0] == "cycle_gan" else "batch"]


def card_vs_cpu_phase(torch, np, card, faults=False, out=None):
    """Each of CVC_RECIPES' f32 step on the card against the port's CPU
    path (``cvc_compare``), the launches of the K1-K4 f32 check builds
    where the recipe runs them (the default's 5 / 4 / 5 / 4, CycleGAN's
    CYCLE_PER_STEP, else none), and the eval ops (``cvc_eval_ops``): one
    ``card_vs_cpu`` line a recipe, one ``card_vs_cpu_eval_ops`` line, and
    every reading under CARD_VS_CPU["limit"] or the run fails naming the
    recipe and tensor. With ``faults`` (``--card_vs_cpu_faults``): the
    recipes of CVC_FAULTS clean, then each fault planted on the card side
    of its recipe, which the gate must refuse by 10x the limit in each
    group of readings CVC_FAULTS names; torch's own pool is planted only where
    ``avg_pool_check`` still reads it wrong on the card, else that fact is
    recorded."""
    size, limit = CARD_VS_CPU["size"], CARD_VS_CPU["limit"]
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    t_start = time.perf_counter()
    res, problems = dict(card=card, size=size, limit=limit, recipes={}), []
    try:
        recipes = tuple(dict.fromkeys(r for r, _ in CVC_FAULTS.values())) if faults \
            else CVC_RECIPES
        for recipe in recipes:
            line, read, dist = cvc_compare(torch, np, recipe, "cuda", size, _cvc_batch(recipe))
            res.setdefault("readings", {})[recipe] = read
            res.setdefault("distances", {})[recipe] = dist
            per = ({"K1": 5, "K3": 4, "K2": 5, "K4": 4} if recipe == "default" else
                   CYCLE_PER_STEP if recipe == "cycle_gan" else {k: 0 for k in CYCLE_PER_STEP})
            print(json.dumps({"card_vs_cpu": line}))
            res["recipes"][recipe] = line
            problems += [f"{recipe}: {k} reads {v['reading']:.3g}, over {limit}" for k, v in
                         line["over"].items()]
            if line["launches"] != per:
                problems.append(f"{recipe}: the card's step launched {line['launches']}, "
                                f"want {per}")
            torch.cuda.empty_cache()
        if not faults:
            ev, values = cvc_eval_ops(torch, np, "cuda")
            res["eval_ops"] = dict(readings=ev, cpu_values=values)
            print(json.dumps({"card_vs_cpu_eval_ops": dict(card=card, size=size, limit=limit,
                                                           readings=ev, cpu_values=values)}))
            problems += [f"eval op {k} reads {ev[k]:.3g}, over {limit}" for k in _over(ev, limit)]
        else:
            res["faults"] = _cvc_faults(torch, np, card)
            problems += res["faults"].pop("problems")
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    res["seconds"] = time.perf_counter() - t_start
    print(json.dumps({"card_vs_cpu_seconds": res["seconds"]}))
    if out:  # written before the verdict, so that a failed run keeps its readings
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "chip_smoke_card_vs_cpu.json"), "w") as f:
            json.dump(dict(res, problems=problems), f, indent=1)
    if problems:
        fail("card_vs_cpu: " + "; ".join(problems))
    return res


def _cvc_faults(torch, np, card):
    """``--card_vs_cpu_faults``' planted runs: {fault: the readings over
    the limit, the worst of each group of readings CVC_FAULTS names over
    the limit, the line's divisors}, and the problems (a fault the gate
    did not refuse by 10x the limit in every group it names)."""
    limit, out, problems = CARD_VS_CPU["limit"], {}, []
    pool = avg_pool_check(torch)
    for fault, (recipe, groups) in CVC_FAULTS.items():
        if fault == "torch_pool" and not pool["torch_avg_pool2d"] > 10 * limit:
            out[fault] = dict(recipe=recipe, torch_pool_reads=pool["torch_avg_pool2d"],
                              note="torch's own pool is right on this card: nothing to plant")
            print(json.dumps({"card_vs_cpu_fault": dict(fault=fault, **out[fault])}))
            continue
        line, read, _ = cvc_compare(torch, np, recipe, "cuda", CARD_VS_CPU["size"],
                                    _cvc_batch(recipe), patches=_cvc_plant(torch, fault))
        named = {grp: max((v for k, v in read.items() if k.startswith(grp)), default=0.0) / limit
                 for grp in groups}
        out[fault] = dict(recipe=recipe, card=card, over=len(line["over"]),
                          first_over={k: v["reading"] for k, v in list(line["over"].items())[:8]},
                          worst_over_limit=named, divisors=line["divisors"],
                          networks_over=sorted({k.split(".")[1] for k in line["over"]}))
        print(json.dumps({"card_vs_cpu_fault": dict(fault=fault, **out[fault])}))
        short = [grp for grp in groups if not named[grp] >= 10]
        if short:
            problems.append(f"the gate did not refuse {fault} in {recipe} by 10x its limit on "
                            f"{short}: {named}")
        torch.cuda.empty_cache()
    out["problems"] = problems
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="On-card check of dsgan_tpu_torch")
    ap.add_argument("--out", default=None, help="directory for chip_smoke.json")
    ap.add_argument("--grad_terms", type=int, nargs="+", metavar="BATCH",
                    help="only read the CycleGAN gradient check for each term of the G loss "
                         "alone (CYCLE_TERMS) at each batch, on the state as built, and exit")
    ap.add_argument("--dp_faults", action="store_true",
                    help="only run the data-parallel comparison, then once with each of FAULTS "
                         "planted in the ranks, which its gate must fail, and exit")
    ap.add_argument("--remat", action="store_true",
                    help="only run the --remat phase (remat_phase), and exit")
    ap.add_argument("--spatial", action="store_true",
                    help="only run the spatial-axis phase (spatial_phase), and exit")
    ap.add_argument("--spatial_faults", action="store_true",
                    help="only run the spatial-axis f32 comparison, then once with each of "
                         "SPATIAL_FAULTS planted in the ranks, which its gate must fail, and exit")
    ap.add_argument("--grad_spread", type=int, metavar="N",
                    help="only run one process's f32 first step at the spatial phase's config N "
                         "times for each recipe, print each weight's spread across the runs "
                         "beside the halves' reading the spatial gate doubles, and exit")
    ap.add_argument("--card_vs_cpu", action="store_true",
                    help="only run the card_vs_cpu phase (every recipe's f32 step and the eval "
                         "ops on the card against the port's CPU path), and exit")
    ap.add_argument("--card_vs_cpu_faults", action="store_true",
                    help="only run the card_vs_cpu comparison of CVC_FAULTS' recipes, then once "
                         "with each fault planted on the card side, which its gate must refuse, "
                         "and exit")
    ap.add_argument("--profile_trials", type=int, metavar="N",
                    help="only trace the graph phase's eager and replayed steps N times each, "
                         "without and with the trace's settling wait, count the traces that "
                         "left out kernels, and exit")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from dsgan_tpu_torch import serve as serve_mod
    from dsgan_tpu_torch.device import card_info
    from dsgan_tpu_torch.kernels import _build
    from dsgan_tpu_torch.kernels import block_core as bc
    from dsgan_tpu_torch.models import define_G, mixconvnext
    from dsgan_tpu_torch.ops import instance_stats

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    card = card_info()
    if card is None:
        fail("nvidia-smi did not report the card")
    print(f"device: {kind} (count {torch.cuda.device_count()}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(card)

    # the native decoder builds with g++ beside the kernels' nvcc jobs
    from dsgan_tpu_torch import runtime

    t0 = time.perf_counter()
    decoder = threading.Thread(target=runtime.available)
    decoder.start()
    libs = _build.build()
    decoder.join()
    if not runtime.available():
        fail(f"the native decoder did not build: {runtime.reason()}")
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "libraries": [p.name for p in libs],
                      "native_decoder": [runtime.build().name, sorted(runtime.formats())]}))

    if args.grad_terms:
        _card_flags(torch)
        state, _, cfg = cyclegan_build(torch)
        for b in args.grad_terms:
            for term in CYCLE_TERMS:
                cyclegan_gradients(torch, np, bc, state, cfg, b, term, enforce=False)
                torch.cuda.empty_cache()
        return 0
    if args.profile_trials:
        _card_flags(torch)
        graph_phase(torch, np, bc, card, trials=args.profile_trials)
        return 0
    if args.dp_faults:
        _card_flags(torch)
        dp_phase(torch, np, bc, card, faults=FAULTS)
        print("chip_smoke: the data-parallel gate failed every planted fault")
        return 0
    if args.grad_spread:
        _card_flags(torch)
        grad_spread(torch, np, bc, card, args.grad_spread, args.out)
        print(f"chip_smoke: the gradient spread took {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.remat:
        _card_flags(torch)
        res, _ = remat_phase(torch, np, bc, card)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "chip_smoke_remat.json"), "w") as f:
                json.dump(res, f, indent=1)
        print(f"chip_smoke: the remat phase passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.card_vs_cpu or args.card_vs_cpu_faults:
        _card_flags(torch)
        card_vs_cpu_phase(torch, np, card, faults=args.card_vs_cpu_faults, out=args.out)
        print("chip_smoke: the card_vs_cpu phase passed"
              + (" and its gate refused every planted fault" if args.card_vs_cpu_faults else ""))
        return 0
    if args.spatial or args.spatial_faults:
        _card_flags(torch)
        res, _ = spatial_phase(torch, np, bc, card,
                               faults=SPATIAL_FAULTS if args.spatial_faults else ())
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "chip_smoke_spatial.json"), "w") as f:
                json.dump(res, f, indent=1)
        print("chip_smoke: the spatial phase passed"
              + (" and its gate failed every planted fault" if args.spatial_faults else ""))
        return 0

    rows = check_kernels(torch, bc, instance_stats, 1, torch.bfloat16, "tanh", TOL_BF16, 20)
    rows += check_kernels(torch, bc, instance_stats, 16, torch.bfloat16, "tanh", TOL_BF16, 10)
    _card_flags(torch)
    print(json.dumps({"f32_check": {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                                    "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}}))
    rows += check_kernels(torch, bc, instance_stats, 1, torch.float32, "erf", TOL_F32, 5)
    bwd_rows = check_backward(torch, bc, instance_stats, 16, torch.bfloat16, "tanh", 5)
    bwd_rows += check_backward(torch, bc, instance_stats, 1, torch.float32, "erf", 3)

    serving, serve_launches, agree = serve_phase(torch, np, bc, mixconvnext, serve_mod, define_G,
                                                 card)
    exported, export_launches = export_phase(torch, np, bc, serve_mod, define_G, card)
    training, train_launches = train_phase(torch, np, bc, card)
    graphed, graph_launches = graph_phase(torch, np, bc, card)
    remat, remat_launches = remat_phase(torch, np, bc, card)
    cli, cli_launches = cli_phase(torch, np, bc, card)
    zoo = zoo_phase(torch, np, bc, card)
    cyclegan, cycle_launches = cyclegan_phase(torch, np, bc, card)
    fid = fid_phase(torch, np, card)
    cvc = card_vs_cpu_phase(torch, np, card)
    diff = diffusion_phase(torch, np, bc, card)
    dp, dp_launches = dp_phase(torch, np, bc, card)
    sp, sp_launches = spatial_phase(torch, np, bc, card)
    capture_must_fail(torch)

    kernels = []
    for name, src_fn, line, src, table in (
            ("K1", "block_core2_fwd_sm90", 205, "block_core2_fwd_sm90.cu", rows),
            ("K2", "block_core2_bwd_sm90", 262, "block_core2_bwd_sm90.cu", bwd_rows),
            ("K3", "block_core2_fwd_sm90", 553, "block_core2_fwd_sm90.cu", rows),
            ("K4", "block_core2_bwd_sm90", 598, "block_core2_bwd_sm90.cu", bwd_rows)):
        main = [r for r in table if r["kernel"] == name and r["batch"] == 16]
        bf16 = [r for r in table + sp["kernel_rows"]
                if r["kernel"] == name and r["dtype"] == "bfloat16"]
        by_ops = sum(r["bound_ms"] for r in main if r["bound_by"] == "operations")
        kernels.append(dict(
            name=f"{name} {src_fn}", route="cuda", source=f"dsgan_tpu_torch/csrc/{src}",
            replaces=f"dsgan_tpu/pallas/block_core.py:{line}",
            launches=(serve_launches[name] + export_launches[name] + train_launches[name]
                      + graph_launches[name] + cli_launches[name] + cycle_launches[name]
                      + dp_launches[name] + sp_launches[name] + remat_launches[name]),
            max_abs_err=max(r["max_abs_err"] for r in bf16),
            ms=sum(r["ms"] for r in main), plain_ms=sum(r["plain_ms"] for r in main),
            bound_ms=sum(r["bound_ms"] for r in main),
            bound_by="operations" if 2 * by_ops >= sum(r["bound_ms"] for r in main) else "bytes",
            library_ms=None))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(card=card, kind=kind, rows=rows, bwd_rows=bwd_rows, serving=serving,
                           generator_agreement=agree, export=exported, training=training,
                           graph=graphed, remat=remat, cli=cli, zoo=zoo, cyclegan=cyclegan,
                           fid=fid, card_vs_cpu=cvc,
                           diffusion=diff, dp=dp, spatial=sp, kernels=kernels,
                           seconds=time.perf_counter() - t_start), f, indent=1)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

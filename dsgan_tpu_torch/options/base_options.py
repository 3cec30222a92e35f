"""Base CLI flags (port of ``dsgan_tpu/options/base_options.py``).

Flag names and defaults are the reference's (DSGAN/options/
base_options.py) and the JAX package's, so a DS-GAN command line runs
against the port unchanged. Parsing sets no process-wide state in a
single process: the device comes from ``--platform`` where a model is
built, the GELU flavour from ``--gelu`` through ``define_G(gelu_mode=...)``.
``--num_hosts N`` joins the N processes of a run into one
``torch.distributed`` group (``parallel.multihost``); only rank 0 writes
``opt.txt``.

Every flag of the JAX package runs: ``--remat`` rematerializes
MixConvNeXtML's blocks in training (``define_G(remat=...)``), and
``--spatial_axis`` above 1 puts the image rows of every model, generator
and discriminator over that many ranks (``parallel.spatial``).
"""

import argparse
import os

from dsgan_tpu_torch.parallel import multihost
from dsgan_tpu_torch.utils import util


class BaseOptions:
    def __init__(self):
        self.initialized = False

    def initialize(self, parser):
        # ---- data location and geometry
        parser.add_argument("--dataroot", type=str, default="./datasets",
                            help="dataset root; each phase is a subfolder beneath it")
        parser.add_argument("--batchSize", type=int, default=1, help="samples per training batch")
        parser.add_argument("--loadSize_w", type=int, default=256, help="pre-crop resize width")
        parser.add_argument("--fineSize_w", type=int, default=256,
                            help="final crop width fed to the nets")
        parser.add_argument("--loadSize_h", type=int, default=256, help="pre-crop resize height")
        parser.add_argument("--fineSize_h", type=int, default=256,
                            help="final crop height fed to the nets")
        parser.add_argument("--input_nc", type=int, default=3, help="channel count of the A-side images")
        parser.add_argument("--output_nc", type=int, default=3,
                            help="channel count of the B-side images")
        # ---- network recipe
        parser.add_argument("--ngf", type=int, default=32,
                            help="generator base width (unused by MixConvNeXtML)")
        parser.add_argument("--ndf", type=int, default=32, help="discriminator base width")
        parser.add_argument("--which_model_netD", type=str, default="basic",
                            help="discriminator recipe: basic | n_layers | pixel | multi")
        parser.add_argument("--which_model_netG", type=str, default="MixConvNeXtML",
                            help="generator recipe: MixConvNeXtML | resnet_9blocks | "
                                 "resnet_6blocks | unet_128 | unet_256 | gll | cascaded | unetpp | "
                                 "wnet")
        parser.add_argument("--n_layers_D", type=int, default=3,
                            help="conv depth when --which_model_netD n_layers")
        parser.add_argument("--gpu_ids", type=str, default="0",
                            help="kept so reference command lines parse; --platform picks the device")
        parser.add_argument("--name", type=str, default="experiment_name",
                            help="experiment tag; checkpoints and samples are filed under it")
        parser.add_argument("--dataset_mode", type=str, default="aligned",
                            help="pairing scheme: aligned | unaligned | single")
        parser.add_argument("--model", type=str, default="pix2pix",
                            help="training algorithm: pix2pix | cycle_gan | diffusion | test")
        parser.add_argument("--which_direction", type=str, default="AtoB",
                            help="translation direction, AtoB or BtoA")
        parser.add_argument("--nThreads", default=4, type=int, help="decode worker threads")
        parser.add_argument("--checkpoints_dir", type=str, default="./checkpoints/",
                            help="directory that receives model checkpoints")
        parser.add_argument("--norm", type=str, default="instance",
                            help="normalization inside the nets: instance | batch | none "
                                 "(MixConvNeXtML has its own)")
        parser.add_argument("--serial_batches", action="store_true",
                            help="iterate the dataset in file order instead of sampling randomly")
        parser.add_argument("--display_winsize", type=int, default=256,
                            help="edge length of saved preview images")
        parser.add_argument("--display_id", type=int, default=1,
                            help="kept for reference-CLI parity (visdom window id)")
        parser.add_argument("--display_server", type=str, default="http://localhost",
                            help="kept for reference-CLI parity (visdom host)")
        parser.add_argument("--display_port", type=int, default=8097,
                            help="kept for reference-CLI parity (visdom port)")
        parser.add_argument("--no_dropout", action="store_true",
                            help="build the generator without dropout layers (the resnet and "
                                 "unet generators have them; MixConvNeXtML has none)")
        parser.add_argument("--max_dataset_size", type=float, default=float("inf"),
                            help="cap on images read per phase (inf = use everything)")
        parser.add_argument("--resize_or_crop", type=str, default="resize_and_crop",
                            help="augmentation geometry: resize_and_crop | crop | scale_width | "
                                 "scale_width_and_crop")
        parser.add_argument("--no_flip", action="store_true",
                            help="disable random horizontal flips")
        parser.add_argument("--init_type", type=str, default="normal",
                            help="weight init scheme: normal | xavier | kaiming | orthogonal "
                                 "(gain 0.02)")
        parser.add_argument("--verbose", action="store_true", help="chatty network construction")
        parser.add_argument("--suffix", default="", type=str,
                            help="template appended to --name, e.g. {model}_{which_model_netG}")
        # ---- composite-loss weights (the DS-GAN objective)
        parser.add_argument("--use_GAN", type=int, default=1, help="1 enables the adversarial term")
        parser.add_argument("--w_gan", type=float, default=0.01, help="adversarial term weight")
        parser.add_argument("--w_vgg", type=float, default=1.0, help="VGG perceptual term weight")
        parser.add_argument("--w_tv", type=float, default=1.0, help="total-variation term weight")
        parser.add_argument("--w_ss", type=float, default=1.25, help="(1 - SSIM) term weight")
        parser.add_argument("--use_condition", type=int, default=1,
                            help="1 feeds cat(A, B/fake) to the discriminator (conditional GAN)")
        # ---- the JAX package's own flags
        parser.add_argument("--dtype", type=str, default="bfloat16",
                            help="network compute dtype [bfloat16|float32]; params stay float32")
        parser.add_argument("--vgg_weights", type=str, default="",
                            help="torchvision VGG16 features as an .npz of its state_dict "
                                 "(features.N.weight / .bias); without it the perceptual loss "
                                 "runs random features")
        parser.add_argument("--seed", type=int, default=20, help="global RNG seed")
        parser.add_argument("--native_loader", type=str, default="auto",
                            help="batch decoder: auto = the native C++ decoder (built with g++ at "
                                 "first use; the Python loader where it cannot take the batch), "
                                 "off = the Python loader")
        parser.add_argument("--remat", action="store_true",
                            help="rematerialize MixConvNeXtML's blocks in training (memory for "
                                 "a second forward of each block: larger batches and "
                                 "512^2-class images)")
        parser.add_argument("--gelu", type=str, default="auto",
                            help="GELU flavor [auto|exact|tanh]. auto = tanh for bf16 tensors, "
                                 "erf otherwise; exact = erf everywhere")
        parser.add_argument("--data_axis", type=int, default=0,
                            help="data-parallel mesh size in ranks (0 = all ranks, reduced until "
                                 "it divides --batchSize)")
        parser.add_argument("--spatial_axis", type=int, default=1,
                            help="spatial-parallel mesh size: image rows over this many ranks "
                                 "(every model, generator and discriminator)")
        parser.add_argument("--num_hosts", type=int, default=1,
                            help="processes of the run, one a card (torchrun's, or JAX's "
                                 "JAX_COORDINATOR_ADDRESS / JAX_PROCESS_ID rendezvous)")
        parser.add_argument("--platform", type=str, default="",
                            help="device: empty, gpu or cuda = the CUDA card (raises without "
                                 "one); cpu = the CPU")
        self.initialized = True
        return parser

    def gather_options(self, argv=None):
        parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
        parser = self.initialize(parser)
        opt, _ = parser.parse_known_args(argv)

        # two-stage parse: the selected algorithm adds its own flags
        from dsgan_tpu_torch.models import get_option_setter

        parser = get_option_setter(opt.model)(parser, self.isTrain)
        self.parser = parser
        return parser.parse_args(argv)

    def print_options(self, opt):
        """Echo the resolved options and write them to opt.txt beside the
        checkpoints (flags that differ from their default are marked)."""
        lines = ["----------------- Options ---------------"]
        for key in sorted(vars(opt)):
            val = getattr(opt, key)
            mark = ""
            if val != self.parser.get_default(key):
                mark = f"\t[default: {self.parser.get_default(key)}]"
            lines.append(f"{key:>25}: {val!s:<30}{mark}")
        lines.append("----------------- End -------------------")
        message = "\n".join(lines)
        print(message)

        expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
        util.mkdirs(expr_dir)
        with open(os.path.join(expr_dir, "opt.txt"), "wt") as f:
            f.write(message + "\n")

    def parse(self, dataset_path=None, path=None, argv=None):
        opt = self.gather_options(argv)
        opt.isTrain = self.isTrain
        multihost.initialize(opt.num_hosts, platform=opt.platform)
        if path is not None:
            opt.checkpoints_dir = os.path.join(path, "checkpoints")
        if dataset_path is not None:
            opt.dataroot = dataset_path
        if opt.suffix:
            opt.name = opt.name + "_" + opt.suffix.format(**vars(opt))
        if multihost.is_primary():
            self.print_options(opt)
        self.opt = opt
        return self.opt

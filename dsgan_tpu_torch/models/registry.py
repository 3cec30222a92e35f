"""Factories, seeded parameters and the model registry (port of
``dsgan_tpu/models/registry.py`` and the VGG part of ``models/vgg.py``,
and of its ``create_model``).

``define_G`` takes every ``--which_model_netG`` of the JAX package
(``registry.py:33-68``): ``MixConvNeXtML``, ``resnet_9blocks``,
``resnet_6blocks``, ``unet_128``, ``unet_256``, ``gll``, ``cascaded``,
``unetpp``, ``wnet``; ``define_D`` every ``--which_model_netD``
(``basic``, ``n_layers``, ``pixel``, ``multi``). Every factory builds its
module on ``device`` (None: the CUDA card) from a JAX-layout parameter
tree, either given (``params``, with ``batch_stats`` for BatchNorm) or
drawn with numpy from ``seed`` under ``--init_type`` (``ops.initializers``:
kernels redrawn, biases 0, BatchNorm scales N(1, 0.02), PReLU slopes 0.25),
as the JAX package's ``init_params`` / ``reinit_params`` do.
"""

import importlib

import torch

from dsgan_tpu_torch.device import resolve_device
from dsgan_tpu_torch.models import blocks_extra, generators_zoo
from dsgan_tpu_torch.models.discriminators import (
    MultiscaleDiscriminator,
    NLayerDiscriminator,
    PixelDiscriminator,
)
from dsgan_tpu_torch.models.mixconvnext import MixConvNeXtML
from dsgan_tpu_torch.models.vgg import Vgg16Features, num_convs
from dsgan_tpu_torch.ops.initializers import init_tree
from dsgan_tpu_torch.utils import convert
from dsgan_tpu_torch.utils.convert import (
    jax_shapes,
    nlayer_entries,
    state_dict_from_jax,
    unflatten,
    vgg_entries,
)

GENERATORS = ("MixConvNeXtML", "resnet_9blocks", "resnet_6blocks", "unet_128", "unet_256", "gll",
              "cascaded", "unetpp", "wnet")
DISCRIMINATORS = ("basic", "n_layers", "pixel", "multi")


def _meta(module_fn):
    with torch.device("meta"):
        return module_fn()


def _init(module_fn, seed, entries=None, init_type="normal"):
    """A module's parameters in the JAX tree and layout, drawn from ``seed``."""
    net = _meta(module_fn)
    if callable(entries):
        entries = entries(net)
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    return unflatten(init_tree(jax_shapes(shapes, entries), seed, init_type))


def _build(module_fn, params, entries, device, batch_stats=None):
    net = _meta(module_fn)
    if callable(entries):
        entries = entries(net)
    net = net.to_empty(device=device)
    net.load_state_dict(state_dict_from_jax(params, entries, batch_stats))
    return net


def init_params(seed=0):
    """MixConvNeXtML parameters in the JAX package's tree and layout, as
    numpy arrays, drawn with numpy from ``seed``."""
    return _init(MixConvNeXtML, seed)


def init_d_params(input_nc=6, ndf=32, n_layers=3, seed=0, norm="instance", init_type="normal"):
    """The PatchGAN's parameters in the JAX tree (``conv0 .. conv_out``)."""
    return _init(lambda: NLayerDiscriminator(input_nc, ndf, n_layers, norm=norm), seed,
                 nlayer_entries(n_layers, norm), init_type)


def init_vgg_params(num_taps=4, seed=0):
    """VGG16 feature parameters in the JAX tree (``conv0 ..``), random: the
    pretrained torchvision weights are not in the repo."""
    return _init(lambda: Vgg16Features(num_taps), seed, vgg_entries(num_convs(num_taps)))


def generator_spec(input_nc, output_nc, ngf, which_model_netG, norm="instance",
                   use_dropout=False, gelu_mode="auto", remat=False):
    """(module factory, entries) of a generator recipe (reference
    networks.py:81-113; ``unetpp`` and ``wnet`` are the JAX package's
    extension names). MixConvNeXtML maps 3 channels to 3 and ignores
    ``ngf``, ``norm`` and ``use_dropout``, as in the reference; ``remat``
    applies to it alone (``mixconvnext.REMAT``), as in the JAX package's
    ``define_G``."""
    z, x = generators_zoo, blocks_extra
    d = use_dropout
    if which_model_netG == "MixConvNeXtML":
        if (input_nc, output_nc) != (3, 3):
            raise ValueError("MixConvNeXtML maps 3 channels to 3")
        return (lambda: MixConvNeXtML(gelu_mode=gelu_mode, remat=remat)), None
    if which_model_netG in ("resnet_9blocks", "resnet_6blocks"):
        n = 9 if which_model_netG == "resnet_9blocks" else 6
        return ((lambda: z.ResnetGenerator(input_nc, output_nc, ngf, n, norm, d)),
                convert.resnet_entries(n, norm, d))
    if which_model_netG in ("unet_128", "unet_256"):
        n = 7 if which_model_netG == "unet_128" else 8
        return ((lambda: z.UnetGenerator(input_nc, output_nc, n, ngf, norm, d)),
                convert.unet_entries(n, norm, d))
    if which_model_netG == "gll":
        return ((lambda: z.LocalEnhancer(input_nc, output_nc, ngf, 3, 9, 1, 3, norm)),
                convert.gll_entries(3, 9, 3, norm))
    if which_model_netG == "cascaded":
        return (lambda: z.CascadedGenerator(input_nc, output_nc, ngf)), convert.named_entries
    if which_model_netG == "unetpp":
        return (lambda: x.UnetPlusPlus(input_nc, output_nc, ngf, norm)), convert.unetpp_entries(norm)
    if which_model_netG == "wnet":
        return (lambda: x.WNet(input_nc, ngf, norm)), convert.wnet_entries(norm)
    raise NotImplementedError(f"Generator model name [{which_model_netG}] is not recognized")


def generator_entries(input_nc, output_nc, ngf, which_model_netG, norm="instance",
                      use_dropout=False):
    """The entries table (``utils.convert``) of a generator recipe."""
    fn, entries = generator_spec(input_nc, output_nc, ngf, which_model_netG, norm, use_dropout)
    return entries(_meta(fn)) if callable(entries) else entries


def serving_build(net):
    """``net`` as a serving build stores it: MixConvNeXtML's parameters cast
    once to its compute dtype (the values a cast at use gives); the zoo
    keeps f32 parameters (BatchNorm computes in f32 with them) and casts at
    use. Returns ``net``."""
    if isinstance(net, MixConvNeXtML) and net.compute_dtype is not None:
        net.to(dtype=net.compute_dtype)
        net.compute_dtype = None
    return net


def define_G(input_nc, output_nc, ngf, which_model_netG, norm="instance", use_dropout=False,
             init_type="normal", dtype=torch.bfloat16, device=None, gelu_mode="auto",
             params=None, batch_stats=None, seed=0, train=False, remat=False):
    """Generator factory (reference networks.py:81-113). Weights come from
    ``params`` (a JAX-layout tree, e.g. ``utils.convert.load_params_npz``;
    BatchNorm statistics from ``batch_stats``) or else are drawn from
    ``seed`` under ``init_type``. ``device=None`` means the CUDA card;
    without one, pass ``device="cpu"``.

    The training build (``train=True``) keeps f32 parameters, as the JAX
    package does, computes in ``dtype`` with the weights cast at use, and
    is in train mode. The serving build (``serving_build``) is in eval mode.
    ``remat`` (False, True or "dots") rematerializes MixConvNeXtML's blocks
    in training; the other generators ignore it."""
    fn, entries = generator_spec(input_nc, output_nc, ngf, which_model_netG, norm, use_dropout,
                                 gelu_mode, remat)
    dev = resolve_device(device)
    if params is None:
        params = _init(fn, seed, entries, init_type)
    net = _build(fn, params, entries, dev, batch_stats)
    net.compute_dtype = dtype
    if train:
        return net.train()
    return serving_build(net).eval()


def discriminator_spec(input_nc, ndf, which_model_netD, n_layers_D=3, norm="instance",
                       use_sigmoid=False):
    """(module factory, entries) of a discriminator recipe (reference
    networks.py:115-131)."""
    if which_model_netD in ("basic", "n_layers"):
        n = 3 if which_model_netD == "basic" else n_layers_D
        return ((lambda: NLayerDiscriminator(input_nc, ndf, n, use_sigmoid=use_sigmoid,
                                             norm=norm)), nlayer_entries(n, norm))
    if which_model_netD == "pixel":
        return ((lambda: PixelDiscriminator(input_nc, ndf, norm, use_sigmoid)),
                convert.named_entries)
    if which_model_netD == "multi":
        return ((lambda: MultiscaleDiscriminator(input_nc, ndf, n_layers_D, norm, use_sigmoid)),
                convert.named_entries)
    raise NotImplementedError(f"Discriminator model name [{which_model_netD}] is not recognized")


def discriminator_entries(input_nc, ndf, which_model_netD, n_layers_D=3, norm="instance"):
    """The entries table (``utils.convert``) of a discriminator recipe."""
    fn, entries = discriminator_spec(input_nc, ndf, which_model_netD, n_layers_D, norm)
    return entries(_meta(fn)) if callable(entries) else entries


def define_D(input_nc, ndf, which_model_netD, n_layers_D=3, norm="instance", init_type="normal",
             dtype=torch.bfloat16, device=None, params=None, batch_stats=None, seed=0,
             use_sigmoid=False):
    """Discriminator factory (reference networks.py:115-131): raw logits
    (``use_sigmoid``: their sigmoid), f32 parameters, computing in
    ``dtype``, in train mode."""
    fn, entries = discriminator_spec(input_nc, ndf, which_model_netD, n_layers_D, norm,
                                     use_sigmoid)
    dev = resolve_device(device)
    if params is None:
        params = _init(fn, seed, entries, init_type)
    net = _build(fn, params, entries, dev, batch_stats)
    net.compute_dtype = dtype
    return net.train()


def define_vgg(num_taps=4, dtype=torch.bfloat16, device=None, params=None, seed=0):
    """The perceptual feature extractor, frozen: f32 parameters that need
    no gradient, computing in ``dtype``. ``params``: a JAX ``Vgg16Features``
    tree (e.g. ``load_torchvision_npz(path)["params"]``)."""
    dev = resolve_device(device)
    if params is None:
        params = init_vgg_params(num_taps, seed)
    net = _build(lambda: Vgg16Features(num_taps), params, vgg_entries(num_convs(num_taps)), dev)
    net.compute_dtype = dtype
    return net.eval().requires_grad_(False)


def find_model_using_name(model_name):
    """``dsgan_tpu_torch.models.<name>``'s ``<Name>Model`` class (reference
    models/__init__.py:4-25)."""
    modname = "dsgan_tpu_torch.models." + model_name
    try:
        modellib = importlib.import_module(modname)
    except ModuleNotFoundError as e:
        raise NotImplementedError(f"model [{model_name}] is not ported: the port has "
                                  "pix2pix, cycle_gan, diffusion and test") from e
    target = model_name.replace("_", "") + "model"
    for name in dir(modellib):
        cls = getattr(modellib, name)
        if name.lower() == target and isinstance(cls, type):
            return cls
    raise NotImplementedError(f"In {modname}.py, there should be a class named {target} "
                              "(case-insensitive).")


def get_option_setter(model_name):
    return find_model_using_name(model_name).modify_commandline_options


def create_model(opt):
    instance = find_model_using_name(opt.model)()
    instance.initialize(opt)
    print(f"model [{instance.name()}] was created")
    return instance

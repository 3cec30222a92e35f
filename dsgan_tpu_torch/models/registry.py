"""Factories, seeded parameters and the model registry (port of the
MixConvNeXtML, PatchGAN and VGG16 parts of ``dsgan_tpu/models/
registry.py`` and ``models/vgg.py``, and of its ``create_model``).

Every factory builds its module on ``device`` (None: the CUDA card) from a
JAX-layout parameter tree, either given (``params``) or drawn with numpy
from ``seed``: N(0, 0.02) kernels, zero biases, PReLU slopes 0.25, as the
JAX package's ``init_params`` with ``init_type="normal"``.
"""

import importlib

import torch

from dsgan_tpu_torch.device import resolve_device
from dsgan_tpu_torch.models.discriminators import NLayerDiscriminator
from dsgan_tpu_torch.models.mixconvnext import MixConvNeXtML
from dsgan_tpu_torch.models.vgg import Vgg16Features, num_convs
from dsgan_tpu_torch.ops.initializers import init_tree
from dsgan_tpu_torch.utils.convert import (
    jax_shapes,
    nlayer_entries,
    state_dict_from_jax,
    unflatten,
    vgg_entries,
)


def _init(module_fn, seed, entries=None):
    """A module's parameters in the JAX tree and layout, drawn from ``seed``."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in module_fn().state_dict().items()}
    return unflatten(init_tree(jax_shapes(shapes, entries), seed))


def _build(module_fn, params, entries, device):
    with torch.device("meta"):
        net = module_fn()
    net = net.to_empty(device=device)
    net.load_state_dict(state_dict_from_jax(params, entries))
    return net


def init_params(seed=0):
    """MixConvNeXtML parameters in the JAX package's tree and layout, as
    numpy arrays, drawn with numpy from ``seed``."""
    return _init(MixConvNeXtML, seed)


def init_d_params(input_nc=6, ndf=32, n_layers=3, seed=0):
    """The PatchGAN's parameters in the JAX tree (``conv0 .. conv_out``)."""
    return _init(lambda: NLayerDiscriminator(input_nc, ndf, n_layers), seed,
                 nlayer_entries(n_layers))


def init_vgg_params(num_taps=4, seed=0):
    """VGG16 feature parameters in the JAX tree (``conv0 ..``), random: the
    pretrained torchvision weights are not in the repo."""
    return _init(lambda: Vgg16Features(num_taps), seed, vgg_entries(num_convs(num_taps)))


def define_G(input_nc, output_nc, ngf, which_model_netG, dtype=torch.bfloat16,
             device=None, gelu_mode="auto", params=None, seed=0, train=False):
    """Generator factory (reference networks.py:81-113). Only the flagship
    ``MixConvNeXtML`` is ported (3 -> 3 channels; ``ngf`` is unused, as in
    the reference). Weights come from ``params`` (a JAX-layout tree, e.g.
    ``utils.convert.load_params_npz``) or else from ``init_params(seed)``.
    ``device=None`` means the CUDA card; without one, pass ``device="cpu"``.

    The serving build (``train=False``) stores the parameters in ``dtype``
    and is in eval mode. The training build keeps them in f32, as the JAX
    package does, computes in ``dtype`` with the weights cast at use, and
    is in train mode."""
    if which_model_netG != "MixConvNeXtML":
        raise NotImplementedError(
            f"generator [{which_model_netG}] is not ported yet; see ROADMAP.md queue A")
    if (input_nc, output_nc) != (3, 3):
        raise ValueError("MixConvNeXtML maps 3 channels to 3")
    dev = resolve_device(device)
    net = _build(lambda: MixConvNeXtML(gelu_mode=gelu_mode),
                 init_params(seed) if params is None else params, None, dev)
    if train:
        net.compute_dtype = dtype
        return net.train()
    return net.to(dtype=dtype).eval()


def define_D(input_nc, ndf, which_model_netD, n_layers_D=3, dtype=torch.bfloat16, device=None,
             params=None, seed=0, use_sigmoid=False):
    """Discriminator factory, the ``basic`` / ``n_layers`` subset of the
    reference's (networks.py:115-131): the instance-norm PatchGAN with raw
    logits (``use_sigmoid``: their sigmoid). f32 parameters, computing in
    ``dtype``."""
    if which_model_netD == "basic":
        n_layers_D = 3
    elif which_model_netD != "n_layers":
        raise NotImplementedError(
            f"discriminator [{which_model_netD}] is not ported yet; see ROADMAP.md queue A")
    dev = resolve_device(device)
    if params is None:
        params = init_d_params(input_nc, ndf, n_layers_D, seed)
    net = _build(lambda: NLayerDiscriminator(input_nc, ndf, n_layers_D, use_sigmoid=use_sigmoid),
                 params, nlayer_entries(n_layers_D), dev)
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
                                  "pix2pix and test") from e
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

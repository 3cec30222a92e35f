"""Weight carry-over between the JAX package's parameter trees and the
port's ``state_dict``s.

The port's module names are the reference torch ``state_dict`` keys, so
the JAX package's converters read a port ``state_dict`` as they read a
reference checkpoint, and the functions here are their exact inverses:

  generator      ``state_dict_from_jax``      <- ``pth_convert.convert_mixconvnext``
  PatchGAN D     ``d_state_dict_from_jax``    <- ``pth_convert.convert_nlayer_discriminator``
  VGG16 features ``vgg_state_dict_from_jax``  <- ``vgg.load_torchvision_npz`` (``features.N``)

Layout rules (the JAX package's, kept here as a copy):

  conv   OIHW  [O, I/g, kh, kw] <-> HWIO [kh, kw, I/g, O]
  convT  IOHW  [I, O, kh, kw]   <-> HWIO [kh, kw, I, O]   (no spatial flip)
  linear [O, I]                 <-> [I, O]
  PReLU  weight [1]             <-> negative_slope scalar

npz files hold the JAX tree flattened with slash-joined keys.
"""

import numpy as np
import torch

# kind -> (JAX leaf name, torch suffix, torch -> JAX, JAX -> torch)
_LEAVES = {
    "conv": ("kernel", "weight", lambda w: w.transpose(2, 3, 1, 0),
             lambda k: k.transpose(3, 2, 0, 1)),
    "convT": ("kernel", "weight", lambda w: w.transpose(2, 3, 0, 1),
              lambda k: k.transpose(2, 3, 0, 1)),
    "linear": ("kernel", "weight", lambda w: w.T, lambda k: k.T),
    "prelu": ("negative_slope", "weight", lambda w: w.reshape(()),
              lambda k: k.reshape((1,))),
    "bias": ("bias", "bias", lambda b: b, lambda b: b),
}


def _mixconvnext_entries():
    """(torch module name, JAX path, leaf kinds) of every MixConvNeXtML
    parameter, as ``convert_mixconvnext`` maps them."""
    out = []

    def add(tk, jp, *kinds):
        out.append((tk, jp, kinds))

    def block(tk, jp):
        add(tk + ".shortcut", jp + "/shortcut", "conv")
        add(tk + ".dwconv", jp + "/dwconv", "conv", "bias")
        add(tk + ".pwconv1", jp + "/pwconv1", "linear", "bias")
        add(tk + ".pwconv2", jp + "/pwconv2", "linear", "bias")

    def midmlka(tk, jp):
        for k in ("X3", "X5", "X7", "X9", "conv"):
            add(f"{tk}.{k}", f"{jp}/{k}", "conv", "bias")
        add(tk + ".attn.fc1", jp + "/attn/fc1", "conv")
        add(tk + ".attn.fc2", jp + "/attn/fc2", "conv")
        add(tk + ".attn.relu1", jp + "/attn/relu1", "prelu")

    for i in range(1, 6):
        block(f"c{i}", f"c{i}")
    for i in range(1, 5):
        block(f"uc{i}", f"uc{i}")
        add(f"u{i}.model.0", f"u{i}/deconv", "convT", "bias")
    # torch names the projections by out_channels / 64, JAX by pool scale
    for mod, pairs in (("down64", ((2, 2), (4, 4), (8, 8), (16, 16))),
                       ("down128", ((2, 4), (4, 8), (8, 16))),
                       ("down256", ((2, 8), (4, 16))),
                       ("down512", ((2, 16),))):
        for scale, chmul in pairs:
            add(f"{mod}.to{chmul}.1", f"{mod}_to{scale}/proj", "conv")
    for k in ("to32", "to64", "to128", "to256"):
        add(f"local.{k}", f"local/{k}", "conv")
    for k in ("mid32", "mid64", "mid128", "mid256", "upc2", "upc3"):
        midmlka(f"local.{k}", f"local/{k}")
    for k in ("up1", "up2", "up3"):
        add(f"local.{k}.model.0", f"local/{k}/deconv", "convT", "bias")
    add("local.upc1.0", "local/upc1_proj", "conv")
    midmlka("local.upc1.1", "local/upc1")
    add("local.up4.0", "local/up4", "convT", "bias")
    add("local.shortcut.0", "local/shortcut", "conv")
    add("res", "res", "conv", "bias")
    return out


def nlayer_entries(n_layers=3):
    """The PatchGAN's convs: ``model.0, 2, 5, 8, ..`` (each conv after the
    first is followed by a parameter-free InstanceNorm and a LeakyReLU) as
    ``conv0 .. conv{n_layers}, conv_out`` (``convert_nlayer_discriminator``)."""
    idx = [0] + [2 + 3 * i for i in range(n_layers + 1)]
    names = [f"conv{i}" for i in range(n_layers + 1)] + ["conv_out"]
    return [(f"model.{i}", n, ("conv", "bias")) for i, n in zip(idx, names)]


# torchvision vgg16.features index of each conv (dsgan_tpu/models/vgg.py VGG16_CONVS)
VGG16_FEATURE_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def vgg_entries(num_convs=len(VGG16_FEATURE_INDEX)):
    """``features.N`` as ``convI`` (``load_torchvision_npz``)."""
    return [(f"features.{n}", f"conv{i}", ("conv", "bias"))
            for i, n in enumerate(VGG16_FEATURE_INDEX[:num_convs])]


def _leaf_map(entries=None):
    """[(torch key, JAX slash path, torch->JAX, JAX->torch)] for every leaf."""
    table = []
    for tk, jp, kinds in entries if entries is not None else _mixconvnext_entries():
        for kind in kinds:
            jleaf, tsuffix, fwd, inv = _LEAVES[kind]
            table.append((f"{tk}.{tsuffix}", f"{jp}/{jleaf}", fwd, inv))
    return table


def flatten(tree, prefix=""):
    """Nested dict -> {slash-joined path: leaf}."""
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten(v, path))
        else:
            flat[path] = v
    return flat


def unflatten(flat):
    """{slash-joined path: leaf} -> nested dict."""
    tree = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def load_params_npz(path):
    """The JAX package's slash-keyed params npz -> nested dict of ndarrays."""
    with np.load(path) as data:
        return unflatten({k: data[k] for k in data.files})


def load_torchvision_npz(path):
    """A torchvision VGG16 ``state_dict`` saved as an npz
    (``features.N.weight`` OIHW / ``.bias``) -> the ``Vgg16Features``
    params tree (``conv0 ..``), as the JAX package's
    ``models/vgg.py::load_torchvision_npz`` reads it."""
    table = [(tk, jp, fwd) for tk, jp, fwd, _ in _leaf_map(vgg_entries())]
    with np.load(path) as data:
        return unflatten({jp: fwd(np.asarray(data[tk], np.float32)) for tk, jp, fwd in table})


def jax_shapes(state_dict_shapes, entries=None):
    """{torch key: shape} -> {JAX path: shape} under the layout rules."""
    return {jp: fwd(np.broadcast_to(np.float32(0), state_dict_shapes[tk])).shape
            for tk, jp, fwd, _ in _leaf_map(entries)}


def state_dict_from_jax(params, entries=None):
    """JAX-layout params (nested dict of ndarrays) -> the port's ``state_dict``
    (torch tensors, f32). Inverse of ``convert_mixconvnext`` (default), or
    of the converter whose ``entries`` are given."""
    flat = flatten(params)
    sd = {}
    for tk, jp, _, inv in _leaf_map(entries):
        sd[tk] = torch.from_numpy(np.ascontiguousarray(inv(np.asarray(flat[jp], np.float32))))
    return sd


def d_state_dict_from_jax(params, n_layers=3):
    """The PatchGAN's JAX params -> its ``state_dict``; inverse of
    ``convert_nlayer_discriminator``."""
    return state_dict_from_jax(params, nlayer_entries(n_layers))


def vgg_state_dict_from_jax(params, num_convs=None):
    """``Vgg16Features`` JAX params (``{"conv0": ...}``, as
    ``load_torchvision_npz(path)["params"]``) -> the ``features.N``
    ``state_dict`` that ``load_torchvision_npz`` reads back from an npz;
    the first ``num_convs`` convs (default: all that ``params`` holds)."""
    return state_dict_from_jax(params, vgg_entries(num_convs or len(params)))

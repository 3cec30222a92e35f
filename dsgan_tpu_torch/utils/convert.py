"""Weight carry-over between the JAX package's parameter trees and the
port's ``state_dict``s.

The port's module names are the reference torch ``state_dict`` keys, so
the JAX package's converters read a port ``state_dict`` as they read a
reference checkpoint, and the entries tables here are their exact
inverses (``state_dict_from_jax`` with a network's entries):

  MixConvNeXtML     ``_mixconvnext_entries``  <- ``pth_convert.convert_mixconvnext``
  PatchGAN D        ``nlayer_entries``        <- ``pth_convert.convert_nlayer_discriminator``
  VGG16 features    ``vgg_entries``           <- ``vgg.load_torchvision_npz`` (``features.N``)
  resnet_*blocks    ``resnet_entries``        <- ``pth_convert.convert_resnet_generator``
  unet_128 / 256    ``unet_entries``          <- ``pth_convert.convert_unet_generator``
  gll               ``gll_entries``           <- ``pth_convert.convert_gll_generator``
  unetpp            ``unetpp_entries``        <- ``pth_convert.convert_unetpp``
  wnet              ``wnet_entries``          <- ``pth_convert.convert_wnet``
  Inception pool3   ``inception_state_dict_from_jax`` <- ``inception.load_torchvision_npz``

(the converters read instance-norm networks; ``convert_wnet`` also
BatchNorm). ``cascaded``, ``pixel`` and ``multi`` have no converter: their
modules carry the JAX package's names, and ``named_entries`` maps them
path for path.

Layout rules (the JAX package's, kept here as a copy):

  conv   OIHW  [O, I/g, kh, kw] <-> HWIO [kh, kw, I/g, O]
  convT  IOHW  [I, O, kh, kw]   <-> HWIO [kh, kw, I, O]   (no spatial flip)
  linear [O, I]                 <-> [I, O]
  PReLU  weight [1]             <-> negative_slope scalar
  BatchNorm weight / bias       <-> params scale / bias
            running_mean / var  <-> batch_stats mean / var

npz files hold the JAX tree flattened with slash-joined keys.
"""

import numpy as np
import torch


def _same(a):
    return a


# kind -> [(JAX leaf name, torch suffix, torch -> JAX, JAX -> torch, collection)]
_LEAVES = {
    "conv": [("kernel", "weight", lambda w: w.transpose(2, 3, 1, 0),
              lambda k: k.transpose(3, 2, 0, 1), "params")],
    "convT": [("kernel", "weight", lambda w: w.transpose(2, 3, 0, 1),
               lambda k: k.transpose(2, 3, 0, 1), "params")],
    "linear": [("kernel", "weight", lambda w: w.T, lambda k: k.T, "params")],
    "prelu": [("negative_slope", "weight", lambda w: w.reshape(()),
               lambda k: k.reshape((1,)), "params")],
    "bias": [("bias", "bias", _same, _same, "params")],
    "bn": [("scale", "weight", _same, _same, "params"), ("bias", "bias", _same, _same, "params"),
           ("mean", "running_mean", _same, _same, "batch_stats"),
           ("var", "running_var", _same, _same, "batch_stats")],
    "ln": [("gamma", "gamma", _same, _same, "params"), ("beta", "beta", _same, _same, "params")],
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


def nlayer_entries(n_layers=3, norm="instance"):
    """The PatchGAN's convs: ``model.0, 2, 5, 8, ..`` (each conv after the
    first followed by a norm at the next index and a LeakyReLU) as
    ``conv0 .. conv{n_layers}, conv_out`` (``convert_nlayer_discriminator``),
    the BatchNorms as ``norm1 .. norm{n_layers}``; under BatchNorm the
    middle convs carry no bias."""
    idx = [0] + [2 + 3 * i for i in range(n_layers + 1)]
    names = [f"conv{i}" for i in range(n_layers + 1)] + ["conv_out"]
    out = []
    for j, (i, n) in enumerate(zip(idx, names)):
        inner = 0 < j <= n_layers
        out.append((f"model.{i}", n, ("conv",) if inner and norm == "batch" else ("conv", "bias")))
        if inner and norm == "batch":
            out.append((f"model.{i + 1}", f"norm{j}", ("bn",)))
    return out


def _conv(tk, jp, bias=True, kind="conv"):
    return (tk, jp, (kind, "bias") if bias else (kind,))


def _norm(tk, jp, norm):
    """The entry of a ``--norm`` layer: BatchNorm only (the others hold nothing)."""
    return [(tk, jp, ("bn",))] if norm == "batch" else []


def _res_block(tk, jp, norm, bias, dropout=False):
    """A residual block's ``conv_block``: pad, conv, norm, PReLU, [dropout],
    pad, conv, norm."""
    k = 5 if dropout else 4
    return ([_conv(f"{tk}.1", f"{jp}/conv1", bias)] + _norm(f"{tk}.2", f"{jp}/norm1", norm)
            + [(f"{tk}.3", f"{jp}/prelu", ("prelu",)), _conv(f"{tk}.{k + 1}", f"{jp}/conv2", bias)]
            + _norm(f"{tk}.{k + 2}", f"{jp}/norm2", norm))


def _trunk(prefix, jp, n_down, n_blocks, norm, bias, dropout=False, block_bias=None):
    """The resnet / pix2pixHD trunk ``pad, conv_in, norm, PReLU, (conv s2,
    norm, PReLU) x n_down, blocks, (convT, norm, PReLU) x n_down`` from index
    0 of ``prefix``; returns (entries, the next index)."""
    block_bias = bias if block_bias is None else block_bias
    out = ([_conv(f"{prefix}.1", f"{jp}conv_in", bias)] + _norm(f"{prefix}.2", f"{jp}norm_in", norm)
           + [(f"{prefix}.3", f"{jp}prelu_in", ("prelu",))])
    i = 4
    for d in range(n_down):
        out += ([_conv(f"{prefix}.{i}", f"{jp}down{d}", bias)]
                + _norm(f"{prefix}.{i + 1}", f"{jp}down_norm{d}", norm)
                + [(f"{prefix}.{i + 2}", f"{jp}down_prelu{d}", ("prelu",))])
        i += 3
    for b in range(n_blocks):
        out += _res_block(f"{prefix}.{i}.conv_block", f"{jp}block{b}", norm, block_bias, dropout)
        i += 1
    for u in range(n_down):
        out += ([_conv(f"{prefix}.{i}", f"{jp}up{u}", bias, "convT")]
                + _norm(f"{prefix}.{i + 1}", f"{jp}up_norm{u}", norm)
                + [(f"{prefix}.{i + 2}", f"{jp}up_prelu{u}", ("prelu",))])
        i += 3
    return out, i


def resnet_entries(n_blocks=9, norm="instance", use_dropout=False):
    """``ResnetGenerator``'s ``model.N`` (``convert_resnet_generator``): the
    trunk with two downsamples, then pad, ``conv_out`` (with its bias), tanh."""
    out, i = _trunk("model", "", 2, n_blocks, norm, norm != "batch", use_dropout)
    return out + [_conv(f"model.{i + 1}", "conv_out")]


def unet_entries(num_downs=8, norm="instance", use_dropout=False):
    """``UnetGenerator``'s nested ``model.model.N`` (``convert_unet_generator``),
    level 0 the outermost: ``down{i}``, ``down_norm{i}``, ``up_prelu{i}``,
    ``up{i}``, ``up_norm{i}``."""
    bias = norm != "batch"
    out, prefix = [], "model.model"
    for lv in range(num_downs):
        if lv == 0:  # down conv, inner levels, PReLU, convT (bias), tanh
            out += [_conv(f"{prefix}.0", "down0", bias), (f"{prefix}.2", "up_prelu0", ("prelu",)),
                    _conv(f"{prefix}.3", "up0", True, "convT")]
            prefix += ".1.model"
        elif lv == num_downs - 1:  # LeakyReLU, down conv, PReLU, convT, norm
            out += ([_conv(f"{prefix}.1", f"down{lv}", bias),
                     (f"{prefix}.2", f"up_prelu{lv}", ("prelu",)),
                     _conv(f"{prefix}.3", f"up{lv}", bias, "convT")]
                    + _norm(f"{prefix}.4", f"up_norm{lv}", norm))
        else:  # LeakyReLU, down conv, norm, inner levels, PReLU, convT, norm, [dropout]
            out += ([_conv(f"{prefix}.1", f"down{lv}", bias)]
                    + _norm(f"{prefix}.2", f"down_norm{lv}", norm)
                    + [(f"{prefix}.4", f"up_prelu{lv}", ("prelu",)),
                       _conv(f"{prefix}.5", f"up{lv}", bias, "convT")]
                    + _norm(f"{prefix}.6", f"up_norm{lv}", norm))
            prefix += ".3.model"
    return out


def gll_entries(n_down=3, n_blocks=9, n_blocks_local=3, norm="instance"):
    """``LocalEnhancer`` with one enhancer (``convert_gll_generator``): the
    global trunk ``model.N`` under ``global/``; ``model1_1`` (pad, conv_in,
    norm, PReLU, down, norm, PReLU) and ``model1_2`` (blocks, up, norm,
    PReLU, pad, conv_out, tanh) as ``le1_*``. Every conv has its bias."""
    out, _ = _trunk("model", "global/", n_down, n_blocks, norm, True)
    out += ([_conv("model1_1.1", "le1_conv_in")] + _norm("model1_1.2", "le1_norm_in", norm)
            + [("model1_1.3", "le1_prelu_in", ("prelu",)), _conv("model1_1.4", "le1_down")]
            + _norm("model1_1.5", "le1_down_norm", norm)
            + [("model1_1.6", "le1_down_prelu", ("prelu",))])
    for b in range(n_blocks_local):
        out += _res_block(f"model1_2.{b}.conv_block", f"le1_block{b}", norm, True)
    i = n_blocks_local
    out += ([_conv(f"model1_2.{i}", "le1_up", True, "convT")]
            + _norm(f"model1_2.{i + 1}", "le1_up_norm", norm)
            + [(f"model1_2.{i + 2}", "le1_up_prelu", ("prelu",)),
               _conv(f"model1_2.{i + 4}", "le1_conv_out")])
    return out


def _cbam_entries(tk, jp):
    return [_conv(f"{tk}.channelattention.fc1", f"{jp}/channelattention/fc1", False),
            _conv(f"{tk}.channelattention.fc2", f"{jp}/channelattention/fc2", False),
            (f"{tk}.channelattention.relu1", f"{jp}/channelattention/relu1", ("prelu",)),
            _conv(f"{tk}.spatialattention.conv1", f"{jp}/spatialattention/conv1", False)]


def unetpp_entries(norm="instance"):
    """``UnetPlusPlus`` (``convert_unetpp``): ConvD blocks ``X.ConvD.0 / 4``,
    ConvN ``X.ConvN.0``, ConvU ``X.ConvU.0`` with their norms at the next
    index, the CBAM gates, the final ``conv``."""
    out = []
    for name in ("conv2_1", "conv3_1", "conv4_1"):
        out += ([_conv(f"{name}.ConvD.0", f"{name}/conv1")]
                + _norm(f"{name}.ConvD.1", f"{name}/norm1", norm)
                + [_conv(f"{name}.ConvD.4", f"{name}/conv2")]
                + _norm(f"{name}.ConvD.5", f"{name}/norm2", norm))
    for name in ("conv4_2", "conv3_2", "conv2_2", "conv1_2"):
        out += [_conv(f"{name}.ConvN.0", f"{name}/conv1")] + _norm(f"{name}.ConvN.1",
                                                                  f"{name}/norm1", norm)
    for name in ("conv4_3", "conv3_3", "conv2_3"):
        out += [_conv(f"{name}.ConvU.0", f"{name}/deconv", True, "convT")] + _norm(
            f"{name}.ConvU.1", f"{name}/norm1", norm)
    for name in ("att2_1", "att3_1", "att4_1", "att4_2", "att4_3", "att3_2", "att3_3", "att2_2",
                 "att2_3", "att1_2"):
        out += _cbam_entries(name, name)
    return out + [_conv("conv", "conv")]


def wnet_entries(norm="batch", prefix="", jprefix=""):
    """``WNet`` (``convert_wnet``): each stage ``X.0`` conv or convT (bias),
    ``X.1`` its norm, ``X.2`` the one shared PReLU (``activate``, listed
    under every name the ``state_dict`` gives it)."""
    from dsgan_tpu_torch.models.blocks_extra import WNET_STAGES

    out = [(f"{prefix}activate", f"{jprefix}activate", ("prelu",))]
    for name, transposed, _, _ in WNET_STAGES:
        site = name + ("_deconv" if transposed else "_conv")
        out += ([_conv(f"{prefix}{name}.0", f"{jprefix}{site}", True,
                       "convT" if transposed else "conv")]
                + _norm(f"{prefix}{name}.1", f"{jprefix}{name}_norm", norm)
                + [(f"{prefix}{name}.2", f"{jprefix}activate", ("prelu",))])
    return out


def named_entries(net):
    """Entries of a network whose modules carry the JAX package's names
    (``cascaded``, ``pixel``, ``multi``, ``ResDecoderBlockCBAM``,
    ``ConvCBlock``): each parametrized leaf module maps to its own path
    with the dots made slashes."""
    from dsgan_tpu_torch.models import layers
    from dsgan_tpu_torch.models.generators_zoo import CascadeLayerNorm

    kinds = ((torch.nn.ConvTranspose2d, "convT"), (torch.nn.Conv2d, "conv"),
             (torch.nn.PReLU, "prelu"), (layers.BatchNorm2d, "bn"), (CascadeLayerNorm, "ln"))
    out = []
    for name, m in net.named_modules():
        kind = next((k for cls, k in kinds if isinstance(m, cls)), None)
        if kind is None:
            continue
        bias = kind in ("conv", "convT") and m.bias is not None
        out.append((name, name.replace(".", "/"), (kind, "bias") if bias else (kind,)))
    return out


# torchvision vgg16.features index of each conv (dsgan_tpu/models/vgg.py VGG16_CONVS)
VGG16_FEATURE_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def vgg_entries(num_convs=len(VGG16_FEATURE_INDEX)):
    """``features.N`` as ``convI`` (``load_torchvision_npz``)."""
    return [(f"features.{n}", f"conv{i}", ("conv", "bias"))
            for i, n in enumerate(VGG16_FEATURE_INDEX[:num_convs])]


def _leaf_map(entries=None):
    """[(torch key, JAX slash path, torch->JAX, JAX->torch, collection)] for
    every leaf; collection ``params`` or ``batch_stats``."""
    table = []
    for tk, jp, kinds in entries if entries is not None else _mixconvnext_entries():
        for kind in kinds:
            for jleaf, tsuffix, fwd, inv, coll in _LEAVES[kind]:
                table.append((f"{tk}.{tsuffix}", f"{jp}/{jleaf}", fwd, inv, coll))
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
    table = [(tk, jp, fwd) for tk, jp, fwd, _, _ in _leaf_map(vgg_entries())]
    with np.load(path) as data:
        return unflatten({jp: fwd(np.asarray(data[tk], np.float32)) for tk, jp, fwd in table})


def jax_shapes(state_dict_shapes, entries=None):
    """{torch key: shape} -> {JAX params path: shape} under the layout rules
    (the ``batch_stats`` leaves left out: they start at 0 and 1)."""
    return {jp: fwd(np.broadcast_to(np.float32(0), state_dict_shapes[tk])).shape
            for tk, jp, fwd, _, coll in _leaf_map(entries) if coll == "params"}


def state_dict_from_jax(params, entries=None, batch_stats=None):
    """JAX-layout params (nested dict of ndarrays) -> the port's ``state_dict``
    (torch tensors, f32). Inverse of ``convert_mixconvnext`` (default), or
    of the converter whose ``entries`` are given. BatchNorm running
    statistics come from ``batch_stats`` (the JAX ``batch_stats``
    collection), else at their start values, mean 0 and var 1."""
    flat = flatten(params)
    stats = flatten(batch_stats) if batch_stats else {}
    sd = {}
    for tk, jp, _, inv, coll in _leaf_map(entries):
        if coll == "params":
            v = flat[jp]
        elif jp in stats:
            v = stats[jp]
        else:
            scale = flat[jp.rsplit("/", 1)[0] + "/scale"]
            v = (np.zeros_like if jp.endswith("/mean") else np.ones_like)(scale)
        sd[tk] = torch.from_numpy(np.ascontiguousarray(inv(np.asarray(v, np.float32))))
    return sd


def jax_from_state_dict(state_dict, entries=None):
    """A port ``state_dict`` -> (params, batch_stats) JAX trees (numpy f32);
    ``batch_stats`` is {} for a network without BatchNorm."""
    params, stats = {}, {}
    for tk, jp, fwd, _, coll in _leaf_map(entries):
        v = fwd(state_dict[tk].detach().float().cpu().numpy())
        (params if coll == "params" else stats)[jp] = np.array(v, np.float32)
    return unflatten(params), unflatten(stats)


def d_state_dict_from_jax(params, n_layers=3, norm="instance", batch_stats=None):
    """The PatchGAN's JAX params -> its ``state_dict``; inverse of
    ``convert_nlayer_discriminator``."""
    return state_dict_from_jax(params, nlayer_entries(n_layers, norm), batch_stats)


def vgg_state_dict_from_jax(params, num_convs=None):
    """``Vgg16Features`` JAX params (``{"conv0": ...}``, as
    ``load_torchvision_npz(path)["params"]``) -> the ``features.N``
    ``state_dict`` that ``load_torchvision_npz`` reads back from an npz;
    the first ``num_convs`` convs (default: all that ``params`` holds)."""
    return state_dict_from_jax(params, vgg_entries(num_convs or len(params)))


def cyclegan_state_from_jax(params_G_A, params_G_B, params_D_A, params_D_B, g_entries=None,
                            d_entries=None, stats_G_A=None, stats_G_B=None, stats_D_A=None,
                            stats_D_B=None):
    """A JAX ``CycleGANState``'s four networks (and their ``batch_stats``)
    -> the port's ``state_dict``s under ``CycleGANState``'s names (``netG_A``
    ..). ``g_entries`` / ``d_entries``: the recipes' entries tables
    (default: MixConvNeXtML and the 3-layer PatchGAN)."""
    d_entries = nlayer_entries(3) if d_entries is None else d_entries
    return {"netG_A": state_dict_from_jax(params_G_A, g_entries, stats_G_A),
            "netG_B": state_dict_from_jax(params_G_B, g_entries, stats_G_B),
            "netD_A": state_dict_from_jax(params_D_A, d_entries, stats_D_A),
            "netD_B": state_dict_from_jax(params_D_B, d_entries, stats_D_B)}


# JAX InceptionPool3 BasicConv2d leaves -> torchvision suffixes
_INCEPTION_LEAVES = {"kernel": "conv.weight", "bn_scale": "bn.weight", "bn_bias": "bn.bias",
                     "bn_mean": "bn.running_mean", "bn_var": "bn.running_var"}


def inception_state_dict_from_jax(params):
    """A JAX ``InceptionPool3`` params tree (``{"Mixed_5b": {"branch1x1":
    {"kernel", "bn_scale", ..}}}``) -> the port's torchvision-key
    ``state_dict``; the inverse of ``dsgan_tpu/models/inception.py::
    load_torchvision_npz`` (HWIO kernels back to OIHW)."""
    sd = {}
    for path, v in flatten(params).items():
        *module, leaf = path.split("/")
        v = np.asarray(v, np.float32)
        if leaf == "kernel":
            v = v.transpose(3, 2, 0, 1)
        name = ".".join(module) + "." + _INCEPTION_LEAVES[leaf]
        sd[name] = torch.from_numpy(np.ascontiguousarray(v))
        if leaf == "bn_scale":
            sd[name.replace("bn.weight", "bn.num_batches_tracked")] = torch.zeros(
                (), dtype=torch.long)
    return sd


def load_inception_npz(path):
    """A torchvision / pytorch-fid Inception3 ``state_dict`` saved as an npz
    -> the port's ``InceptionPool3`` ``state_dict``: the classifier (``fc``)
    and the aux tower (``AuxLogits``) dropped, every other key as it is."""
    with np.load(path) as data:
        sd = {k: torch.from_numpy(np.asarray(data[k])) for k in data.files
              if k.split(".")[0] not in ("fc", "AuxLogits")}
    for k, v in sd.items():
        sd[k] = v.long() if k.endswith("num_batches_tracked") else v.float()
    return sd

"""The port's generator and discriminator zoo (dsgan_tpu_torch.models:
generators_zoo, blocks_extra, discriminators, the registry and the init
types) against dsgan_tpu on the CPU at f32: the JAX forward on weights
carried across (rtol 5e-3, atol 5e-4, the generator test's tolerance), in
eval mode and in train mode with dropout off; BatchNorm running statistics
after one train forward against JAX's batch_stats; the init types; a port
state_dict through each of the JAX package's reference converters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsgan_tpu.models import blocks_extra as jax_blocks
from dsgan_tpu.models import define_D as jax_define_D
from dsgan_tpu.models import define_G as jax_define_G
from dsgan_tpu.utils import pth_convert
from dsgan_tpu_torch.models import blocks_extra, define_G, registry
from dsgan_tpu_torch.ops.initializers import INIT_TYPES
from dsgan_tpu_torch.utils.convert import (
    flatten,
    jax_from_state_dict,
    named_entries,
    wnet_entries,
)

TOL = dict(rtol=5e-3, atol=5e-4)
STATS_TOL = dict(rtol=1e-4, atol=1e-6)
NGF = 8
# name -> input size (unet_128 / unet_256 need 2^7 / 2^8, the pyramids 64)
SIZES = {"resnet_9blocks": 32, "resnet_6blocks": 32, "unet_128": 128, "unet_256": 256,
         "gll": 64, "cascaded": 64, "unetpp": 32, "wnet": 32}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_run(module, variables, x, train):
    """JAX forward (one jit) in eval or train mode; train mode returns the
    updated batch_stats too (None without BatchNorm)."""
    if train and "batch_stats" in variables:
        def fn(v, x):
            out, aux = module.apply(v, x, train=True, mutable=["batch_stats"])
            return out, aux["batch_stats"]
    else:
        def fn(v, x):
            return module.apply(v, x, train=train), None
    return jax.jit(fn)(variables, jnp.asarray(x))


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _close(got, want):
    """Port NCHW output(s) against JAX NHWC output(s)."""
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    got = got.detach().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def _carried(module_fn, entries, jax_module, shape, seed):
    """Seeded weights, every leaf moved off its start value (so that biases,
    norm affines and slopes count), as the JAX tree and in the port module
    built from it. The tree's paths and shapes must be those JAX's init
    makes (traced abstractly, nothing compiled)."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        registry._init(module_fn, seed, entries))
    net = registry._build(module_fn, params, entries, torch.device("cpu"))
    _, stats = jax_from_state_dict(net.state_dict(), entries if not callable(entries)
                                   else entries(net))
    key = jax.random.PRNGKey(0)
    abstract = jax.eval_shape(lambda x: jax_module.init({"params": key, "dropout": key}, x,
                                                        train=False),
                              jax.ShapeDtypeStruct(shape, jnp.float32))
    for coll, tree in (("params", params), ("batch_stats", stats)):
        want = {k: v.shape for k, v in flatten(abstract.get(coll, {})).items()}
        assert {k: v.shape for k, v in flatten(tree).items()} == want, coll
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return net, variables


def _stats_close(net, entries, want):
    _, got = jax_from_state_dict(net.state_dict(), entries)
    want = flatten(_np(want))
    got = flatten(got)
    assert set(got) == set(want) and got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **STATS_TOL)


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("name", list(SIZES))
def test_generator_matches_jax(name, mode):
    """Eval mode with instance norm; train mode with BatchNorm (batch
    statistics, then the running averages after the forward)."""
    norm = "batch" if mode == "train" else "instance"
    size = SIZES[name]
    jg = jax_define_G(3, 3, NGF, name, norm, False, dtype=None)
    fn, entries = registry.generator_spec(3, 3, NGF, name, norm, False)
    net, variables = _carried(fn, entries, jg, (1, size, size, 3), 3)
    net.compute_dtype = torch.float32
    net.train(mode == "train")
    x = np.random.default_rng(0).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want, stats = _jax_run(jg, variables, x, mode == "train")
    with torch.no_grad():
        got = net(_nchw(x))
    _close(got, want)
    if stats is not None:
        _stats_close(net, registry.generator_entries(3, 3, NGF, name, norm), stats)


@pytest.mark.parametrize("name,norm,mode", [
    ("pixel", "instance", "eval"), ("pixel", "batch", "train"), ("multi", "instance", "eval"),
    ("multi", "batch", "train"), ("basic", "batch", "train")])
def test_discriminator_matches_jax(name, norm, mode):
    jd = jax_define_D(6, NGF, name, 3, norm, False, dtype=None)
    fn, entries = registry.discriminator_spec(6, NGF, name, 3, norm)
    net, variables = _carried(fn, entries, jd, (1, 64, 64, 6), 4)
    net.train(mode == "train")
    x = np.random.default_rng(1).uniform(-1, 1, (2, 64, 64, 6)).astype(np.float32)
    want, stats = _jax_run(jd, variables, x, mode == "train")
    with torch.no_grad():
        got = net(_nchw(x))
    _close(got, want)
    if stats is not None:
        _stats_close(net, registry.discriminator_entries(6, NGF, name, 3, norm), stats)


@pytest.mark.parametrize("block", ["ResDecoderBlockCBAM", "ConvCBlock", "FENNet"])
def test_extra_blocks_match_jax(block):
    """The blocks no define_G name reaches, under their JAX names."""
    if block == "FENNet":
        jm, c = jax_blocks.FENNet("instance"), 3

        def fn():
            return blocks_extra.FENNet("instance")

        def entries(net):
            own = [e for e in named_entries(net) if not e[0].startswith("wnet.")]
            return own + wnet_entries("instance", "wnet.", "wnet/")
    else:
        if block == "ConvCBlock":
            jm, c = jax_blocks.ConvCBlock(8, "batch"), 16

            def fn():
                return blocks_extra.ConvCBlock(16, 8, "batch")
        else:
            jm, c = jax_blocks.ResDecoderBlockCBAM(8, "instance"), 16

            def fn():
                return blocks_extra.ResDecoderBlockCBAM(16, 8, "instance")
        entries = named_entries
    net, variables = _carried(fn, entries, jm, (1, 32, 32, c), 5)
    net.eval()
    x = np.random.default_rng(2).uniform(-1, 1, (2, 32, 32, c)).astype(np.float32)
    want, _ = _jax_run(jm, variables, x, False)
    with torch.no_grad():
        _close(net(_nchw(x)), want)


@pytest.mark.parametrize("init_type", INIT_TYPES)
def test_init_types_give_expected_std_and_zero_biases(init_type):
    net = define_G(3, 3, 16, "resnet_6blocks", norm="batch", init_type=init_type,
                   dtype=torch.float32, device="cpu", seed=7, train=True)
    conv = net.model[4].weight  # down0: (32, 16, 3, 3), fan_in 144, fan_out 288
    fan_in, fan_out = 16 * 9, 32 * 9
    want = {"normal": 0.02, "xavier": 0.02 * (2.0 / (fan_in + fan_out)) ** 0.5,
            "kaiming": (2.0 / fan_in) ** 0.5,
            "orthogonal": 0.02 / fan_in ** 0.5}[init_type]
    assert abs(float(conv.std()) - want) < 0.1 * want
    if init_type == "orthogonal":  # (kh*kw*in, out) columns orthonormal, times the gain
        flat = conv.detach().permute(2, 3, 1, 0).reshape(-1, 32)
        torch.testing.assert_close(flat.t() @ flat, 0.02 ** 2 * torch.eye(32), rtol=0,
                                   atol=1e-7)
    biases = [m.bias for m in net.modules() if isinstance(m, torch.nn.Conv2d)
              and m.bias is not None]
    assert biases and all(float(b.abs().max()) == 0.0 for b in biases)
    scales = torch.cat([m.weight.detach() for m in net.modules()
                        if type(m).__name__ == "BatchNorm2d"])
    assert abs(float(scales.mean()) - 1.0) < 0.01 and 0.01 < float(scales.std()) < 0.03
    slopes = [m.weight for m in net.modules() if isinstance(m, torch.nn.PReLU)]
    assert all(float(s) == 0.25 for s in slopes)


@pytest.mark.parametrize("name,kw", [
    ("resnet", dict(which="resnet_6blocks", use_dropout=False)),
    ("resnet_dropout", dict(which="resnet_9blocks", use_dropout=True)),
    ("unet", dict(which="unet_128")), ("gll", dict(which="gll")),
    ("unetpp", dict(which="unetpp")), ("wnet_batch", dict(which="wnet", norm="batch")),
    ("wnet_instance", dict(which="wnet"))])
def test_state_dict_goes_through_pth_convert(tmp_path, name, kw):
    """torch.save of a port state_dict, read by the JAX package's converter
    for the reference's checkpoints, gives back the JAX tree bit for bit."""
    which, norm = kw["which"], kw.get("norm", "instance")
    net = define_G(3, 3, NGF, which, norm=norm, use_dropout=kw.get("use_dropout", False),
                   dtype=torch.float32, device="cpu", seed=11, train=True)
    if norm == "batch":  # running statistics that are not their start values
        with torch.no_grad():
            net(torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0)))
    want, want_stats = jax_from_state_dict(net.state_dict(), registry.generator_entries(
        3, 3, NGF, which, norm, kw.get("use_dropout", False)))
    path = str(tmp_path / f"{name}.pth")
    torch.save(net.state_dict(), path)
    convert = {"resnet_6blocks": pth_convert.convert_resnet_generator,
               "resnet_9blocks": pth_convert.convert_resnet_generator,
               "unet_128": pth_convert.convert_unet_generator,
               "gll": pth_convert.convert_gll_generator,
               "unetpp": pth_convert.convert_unetpp}
    if which == "wnet":
        got, got_stats = pth_convert.convert_wnet(path, norm=norm)
        assert set(flatten(got_stats)) == set(flatten(want_stats))
        for k, v in flatten(want_stats).items():
            assert np.array_equal(flatten(got_stats)[k], v), k
    else:
        got = convert[which](path)
    got, want = flatten(got), flatten(want)
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.float32 and np.array_equal(got[k], v), k


@pytest.mark.parametrize("mode", ["reflect", "replicate"])
def test_pad2d_equals_torch_pad(mode):
    """The zoo's padding (slices, flips, a concat: no atomic adds in its
    backward on the card) gives F.pad's values and, to summation order,
    its gradient."""
    from dsgan_tpu_torch.models.layers import pad2d

    x = torch.randn(2, 5, 9, 11, generator=torch.Generator().manual_seed(0), requires_grad=True)
    for p in (1, 3):
        got, want = pad2d(x, p, mode), torch.nn.functional.pad(x, (p,) * 4, mode=mode)
        assert torch.equal(got, want)
        g = torch.randn_like(want)
        torch.testing.assert_close(torch.autograd.grad(got, x, g)[0],
                                   torch.autograd.grad(want, x, g)[0], rtol=1e-6, atol=1e-6)

"""The port's weights-only int8 (dsgan_tpu_torch.quant) and the w8 artifact
against dsgan_tpu on the CPU: tests/test_quant.py's checks (the error
bound, the report's counts, the unknown mode, the gate reporting and
enforcing), quantize_params bit for bit against the JAX package's through
its reference converter, the w8 artifact's size, and its output against
JAX's w8 artifact (<= 1 level on <= 1e-3 of pixels)."""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsgan_tpu.export import export_generator as jax_export_generator
from dsgan_tpu.export import load_artifact as jax_load_artifact
from dsgan_tpu.export import save_artifact as jax_save_artifact
from dsgan_tpu.models import define_G as jax_define_G
from dsgan_tpu.quant import quantize_params as jax_quantize_params
from dsgan_tpu.utils import pth_convert
from dsgan_tpu_torch import export
from dsgan_tpu_torch.models import define_G, registry
from dsgan_tpu_torch.ops.metrics import psnr_uint8, ssim_uint8
from dsgan_tpu_torch.quant import (
    Quantized,
    dequantize_params,
    quant_report,
    quantize_params,
    transposed_weights,
)
from dsgan_tpu_torch.utils.convert import flatten, jax_from_state_dict


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    # a conv weight (OIHW) with varied per-channel ranges: per-channel scales
    conv = (rng.standard_normal((64, 32, 3, 3)).astype(np.float32)
            * np.linspace(0.1, 3.0, 64, dtype=np.float32)[:, None, None, None])
    params = {"conv.weight": t(conv), "conv.bias": t(rng.standard_normal(64)),
              "dense.weight": t(rng.standard_normal((128, 256))),
              "tiny2d": t(rng.standard_normal((8, 8)))}
    q = quantize_params(params)
    d = dequantize_params(q)
    # small leaves pass through exactly (bias 1-D, tiny2d below min_size)
    assert torch.equal(d["conv.bias"], params["conv.bias"])
    assert torch.equal(d["tiny2d"], params["tiny2d"])
    # quantized leaves: |w - deq| <= s_c / 2 per output channel
    for name in ("conv.weight", "dense.weight"):
        w = params[name]
        s = w.reshape(w.shape[0], -1).abs().amax(1) / 127.0
        err = (d[name] - w).reshape(w.shape[0], -1).abs().amax(1)
        assert bool((err <= s * 0.5 + 1e-7).all()), name
    rep = quant_report(q)
    assert rep["quantized_leaves"] == 2 and rep["float_leaves"] == 2
    assert rep["bytes_q8"] < rep["bytes_f32"] / 3


def _port_q_through_converter(tmp_path, net, convert, q, field):
    """The port's q8 (or scale) leaves in the JAX layout, read back through
    the reference converter: a state_dict holding them in place of the
    weights (the other keys as they are), torch.saved."""
    sd = {k: getattr(q[k], field) if isinstance(q.get(k), Quantized) else v
          for k, v in net.state_dict().items()}
    path = str(tmp_path / f"{field}.pth")
    torch.save(sd, path)
    return flatten(convert(path))


@pytest.mark.parametrize("which", ["MixConvNeXtML", "resnet_6blocks"])
def test_quantize_params_matches_jax_bit_for_bit(tmp_path, which):
    """int8 values and scales of every eligible leaf, Conv2d, Linear and
    ConvTranspose2d, compared in the JAX layout."""
    ngf = 32 if which == "MixConvNeXtML" else 16
    net = define_G(3, 3, ngf, which, dtype=torch.float32, device="cpu", seed=5, train=True)
    entries = registry.generator_entries(3, 3, ngf, which)
    params, _ = jax_from_state_dict(net.state_dict(), entries)
    # eagerly, as dsgan_tpu/export.py quantizes (outside jit: under jit XLA
    # turns the division by 127 into another rounding of the scales)
    want = jax_quantize_params(jax.tree_util.tree_map(jnp.asarray, params))
    q = quantize_params(dict(net.named_parameters()), transposed=transposed_weights(net))
    convert = (pth_convert.convert_mixconvnext if which == "MixConvNeXtML"
               else pth_convert.convert_resnet_generator)
    got_q = _port_q_through_converter(tmp_path, net, convert, q, "q")
    got_s = _port_q_through_converter(tmp_path, net, convert, q, "scale")
    flat_want = flatten(want)
    quantized = {k.rsplit("/", 1)[0] for k in flat_want if k.endswith("/__q8__")}
    assert quantized and len(quantized) == sum(isinstance(v, Quantized) for v in q.values())
    assert any("up" in k for k in quantized)  # ConvTranspose leaves among them
    for path in quantized:
        wq, ws = np.asarray(flat_want[path + "/__q8__"]), np.asarray(flat_want[path + "/__scale__"])
        assert got_q[path].dtype == np.int8 and np.array_equal(got_q[path], wq), path
        assert got_s[path].shape == ws.shape and np.array_equal(got_s[path], ws), path


def _resnet16():
    return define_G(3, 3, 16, "resnet_6blocks", dtype=torch.float32, device="cpu", seed=0)


@pytest.fixture(scope="module")
def resnet16(tmp_path_factory):
    """The resnet (ngf 16) and its float and w8 artifacts: (net, {mode:
    (path, meta)}), exported once for the tests below."""
    net, out, tmp = _resnet16(), {}, tmp_path_factory.mktemp("artifacts")
    for mode in ("none", "w8"):
        program, meta = export.export_generator(net, 32, 32, 3,
                                                quantize=None if mode == "none" else mode)
        out[mode] = (export.save_artifact(str(tmp / f"{mode}.pt2"), program, meta), meta)
    return net, out


def test_w8_export_shrinks_artifact_and_keeps_quality(resnet16):
    (pf, meta_f), (pq, meta_q) = resnet16[1]["none"], resnet16[1]["w8"]
    assert meta_f["quantize"] == "none" and meta_q["quantize"] == "w8"
    # the int8 payloads survive into the saved program
    size_f, size_q = os.path.getsize(pf), os.path.getsize(pq)
    assert size_q < 0.7 * size_f, (size_q, size_f)
    call_f, _ = export.load_artifact(pf, device="cpu")
    call_q, _ = export.load_artifact(pq, device="cpu")
    x = np.random.default_rng(1).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    yf, yq = call_f(x), call_q(x)
    assert yq.dtype == torch.uint8 and yq.shape == yf.shape
    a, b = (y.permute(0, 3, 1, 2).float() for y in (yf, yq))
    s, p = float(ssim_uint8(a, b)), float(psnr_uint8(a, b))
    assert s > 0.95 and p > 30.0, (s, p)


def test_w8_artifact_matches_jax_w8_artifact(tmp_path, resnet16):
    net, paths = resnet16
    call, _ = export.load_artifact(paths["w8"][0], device="cpu")
    params, _ = jax_from_state_dict(net.state_dict(),
                                    registry.generator_entries(3, 3, 16, "resnet_6blocks"))
    g = jax_define_G(3, 3, 16, "resnet_6blocks", dtype=None, inference=True)
    blob, jmeta = jax_export_generator(g, {"params": jax.tree_util.tree_map(jnp.asarray, params)},
                                       32, 32, 3, platforms=("cpu",), quantize="w8")
    jcall, _ = jax_load_artifact(jax_save_artifact(str(tmp_path / "q.stablehlo"), blob, jmeta))
    x = np.random.default_rng(2).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    want = np.asarray(jcall(x)).astype(np.int32)
    diff = np.abs(call(x).numpy().astype(np.int32) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (int(diff.max()), (diff > 0).mean())


def test_unknown_quantize_mode_rejected():
    net = define_G(3, 3, 8, "resnet_6blocks", dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="quantize mode"):
        export.serving_module(net, uint8_io=True, quantize="int4")


def test_quant_gate_reports_and_enforces_tol():
    net = _resnet16()
    opt = SimpleNamespace(fineSize_h=32, fineSize_w=32, input_nc=3)
    gate = export._quant_gate(net, opt, SimpleNamespace(quant_tol=0.0))
    assert 0.9 < gate["ssim"] <= 1.0 and gate["psnr"] > 25.0
    with pytest.raises(SystemExit, match="quality gate"):
        export._quant_gate(net, opt, SimpleNamespace(quant_tol=1.01))

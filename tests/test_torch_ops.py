"""The port's plain ops (dsgan_tpu_torch.ops, models.layers) against the JAX
package's, on the CPU at f32: the same numpy inputs through both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsgan_tpu import ops as jops
from dsgan_tpu.models import layers as jlayers
from dsgan_tpu_torch import ops
from dsgan_tpu_torch.models.layers import PReLU, gelu, gelu_is_tanh

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _nchw(x_nhwc):
    """NHWC numpy -> NCHW torch view in channels_last memory (the port's layout)."""
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_instance_norm_and_stats():
    x = (_rng(0).standard_normal((2, 8, 8, 5)) * 3 + 1).astype(np.float32)
    mean, rsig = ops.instance_stats(_nchw(x))
    jm, jr = jops.instance_stats(jnp.asarray(x))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(rsig.numpy(), np.asarray(jr), **TOL)
    np.testing.assert_allclose(_nhwc(ops.instance_norm(_nchw(x))),
                               np.asarray(jops.instance_norm(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("k,stride,groups", [(3, 1, 1), (3, 2, 1), (1, 1, 1), (7, 1, 6)])
def test_conv2d(k, stride, groups):
    rng = _rng(1)
    cin, cout = 6, (6 if groups > 1 else 4)
    x = rng.standard_normal((2, 9, 9, cin)).astype(np.float32)
    w = rng.standard_normal((k, k, cin // groups, cout)).astype(np.float32)   # HWIO
    b = rng.standard_normal((cout,)).astype(np.float32)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                       stride=stride, padding=k // 2, groups=groups)
    got = ops.conv2d(_nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                     torch.from_numpy(b), stride=stride, padding=k // 2, groups=groups)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_conv_transpose2d_k3s2p1op1():
    rng = _rng(2)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    w = rng.standard_normal((3, 3, 6, 4)).astype(np.float32)    # HWIO, I = x's channels
    b = rng.standard_normal((4,)).astype(np.float32)
    want = jops.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                 stride=2, padding=1, output_padding=1)
    got = ops.conv_transpose2d(_nchw(x), torch.from_numpy(w.transpose(2, 3, 0, 1).copy()),
                               torch.from_numpy(b))
    assert got.shape == (2, 4, 10, 14)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_pools():
    x = _rng(3).standard_normal((2, 8, 12, 5)).astype(np.float32)
    xt = _nchw(x)
    for window in (2, 4):
        np.testing.assert_allclose(_nhwc(ops.max_pool2d(xt, window)),
                                   np.asarray(jops.max_pool2d(jnp.asarray(x), window)), **TOL)
    np.testing.assert_allclose(_nhwc(ops.adaptive_avg_pool(xt)),
                               np.asarray(jops.adaptive_avg_pool(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(_nhwc(ops.adaptive_max_pool(xt)),
                               np.asarray(jops.adaptive_max_pool(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("mode", ["auto", "exact", "tanh"])
def test_gelu_modes(mode):
    x = (_rng(4).standard_normal((4, 64)) * 3).astype(np.float32)
    try:
        jlayers.set_gelu_mode(mode)
        want = np.asarray(jlayers.gelu(jnp.asarray(x)))
    finally:
        jlayers.set_gelu_mode("auto")
    np.testing.assert_allclose(gelu(torch.from_numpy(x), mode).numpy(), want, **TOL)


def test_gelu_auto_flavour_follows_dtype():
    assert gelu_is_tanh("auto", torch.bfloat16)
    assert not gelu_is_tanh("auto", torch.float32)
    assert gelu_is_tanh("tanh", torch.float32) and not gelu_is_tanh("exact", torch.bfloat16)
    with pytest.raises(ValueError):
        gelu_is_tanh("fast", torch.float32)


def test_prelu_shared_slope():
    import flax.linen as fnn

    x = _rng(5).standard_normal((2, 3, 3, 4)).astype(np.float32)
    want = fnn.PReLU(negative_slope_init=0.25).apply({"params": {"negative_slope": 0.25}},
                                                     jnp.asarray(x))
    act = PReLU()
    assert act.weight.shape == (1,) and float(act.weight) == 0.25
    with torch.no_grad():
        got = act(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_normalize_and_quantize_uint8():
    from dsgan_tpu.ops import metrics as jmetrics

    u = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    np.testing.assert_allclose(ops.normalize_u8(torch.from_numpy(u)).numpy(),
                               np.asarray(jmetrics.normalize_u8(jnp.asarray(u))), **TOL)
    f = np.linspace(-1.3, 1.3, 4097, dtype=np.float32)
    f = np.concatenate([f, (np.arange(256, dtype=np.float32) / 255.0) * 2 - 1])
    got = ops.quantize_uint8(torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmetrics.quantize_uint8(jnp.asarray(f))))
    t = torch.from_numpy(f)
    assert ops.normalize_u8(t) is t   # float input passes through


def test_overlapping_average_pool_runs_on_contiguous_memory():
    """``ops.avg_pool2d`` with overlapping windows hands torch's pool
    contiguous memory and returns the input's channels_last layout, its
    values and gradient the plain pool's (torch's overlapping pool on
    channels_last CUDA memory returns wrong gradients: ``ops.pool_avg``)."""
    from unittest import mock

    from dsgan_tpu_torch import ops

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 5, 16, 12)).astype(np.float32))
    xc = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    seen = []
    pool = torch.nn.functional.avg_pool2d

    def spy(t, *args, **kwargs):
        seen.append(t.is_contiguous())
        return pool(t, *args, **kwargs)

    with mock.patch.object(torch.nn.functional, "avg_pool2d", spy):
        y = ops.avg_pool2d(xc, 3, 2, 1, count_include_pad=False)
        ops.avg_pool2d(xc, 2)
    assert seen == [True, False]
    assert y.is_contiguous(memory_format=torch.channels_last)
    xr = x.clone().requires_grad_(True)
    want = torch.nn.functional.avg_pool2d(xr, 3, 2, 1, count_include_pad=False)
    assert torch.equal(y, want)
    g = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(np.float32))
    y.backward(g)
    want.backward(g)
    assert torch.equal(xc.grad, xr.grad)

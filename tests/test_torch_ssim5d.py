"""The 5-D (video volume) forms of the port's SSIM / MS-SSIM
(dsgan_tpu_torch.ops.ssim, NCDHW) against the JAX package's (NDHWC,
``dsgan_tpu.ops.ssim``) on the same seeded volumes: every spatial dim
filtered where it is at least the window, a depth shorter than the window
skipped with JAX's warning, the trailing size-1 squeeze, and the
configured-callable ``SSIM`` / ``MS_SSIM``. Tolerance: rel 1e-5 (f32)."""

import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the modules (each package's ``ops`` exports the function under the same name)
jssim = importlib.import_module("dsgan_tpu.ops.ssim")
tssim = importlib.import_module("dsgan_tpu_torch.ops.ssim")

TOL = dict(rel=1e-5, abs=1e-6)


def _pair(shape, seed):
    """Two correlated volumes, (N, D, H, W, C) in [0, 255]."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, shape).astype(np.float32)
    y = np.clip(x + rng.normal(0, 20, shape), 0, 255).astype(np.float32)
    return x, y


def _t(a):
    return torch.from_numpy(np.moveaxis(a, -1, 1).copy())


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("depth", [12, 5], ids=["depth_12", "depth_5_skipped"])
def test_ssim_5d_matches_jax(depth, size_average):
    x, y = _pair((2, depth, 24, 20, 3), depth)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        want = np.asarray(jssim.ssim(jnp.asarray(x), jnp.asarray(y), data_range=255,
                                     size_average=size_average))
        jax_warned = len(caught)
        got = tssim.ssim(_t(x), _t(y), data_range=255, size_average=size_average).numpy()
    torch_warned = len(caught) - jax_warned
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL["rel"], atol=TOL["abs"])
    # the depth shorter than the window is skipped, with a warning on each side
    assert (jax_warned > 0) == (torch_warned > 0) == (depth < 11)


def test_ssim_5d_squeezes_a_trailing_unit_dim():
    x, y = _pair((1, 12, 16, 14, 2), 3)
    want = float(jssim.ssim(jnp.asarray(x[:, :, :, :, None]), jnp.asarray(y[:, :, :, :, None])))
    # NDHW1C in JAX; in the port the volume (N, C, D, H, W, 1) loses its last dim
    got = float(tssim.ssim(_t(x)[..., None], _t(y)[..., None]))
    assert got == pytest.approx(want, **TOL)
    assert got == pytest.approx(float(tssim.ssim(_t(x), _t(y))), **TOL)


@pytest.mark.parametrize("size_average", [True, False])
def test_ms_ssim_5d_matches_jax(size_average):
    """Depth 8 < the window: skipped at every level; avg_pool3d between
    levels pools D, H and W."""
    x, y = _pair((1, 8, 176, 168, 2), 7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.asarray(jssim.ms_ssim(jnp.asarray(x), jnp.asarray(y), data_range=255,
                                        size_average=size_average))
        got = tssim.ms_ssim(_t(x), _t(y), data_range=255, size_average=size_average).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL["rel"], atol=TOL["abs"])


def test_ssim_classes_match_jax():
    x, y = _pair((1, 12, 176, 176, 1), 9)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for jcls, tcls in ((jssim.SSIM, tssim.SSIM), (jssim.MS_SSIM, tssim.MS_SSIM)):
            want = float(jcls(data_range=255, channel=1, spatial_dims=3)(jnp.asarray(x),
                                                                          jnp.asarray(y)))
            got = float(tcls(data_range=255, channel=1, spatial_dims=3)(_t(x), _t(y)))
            assert got == pytest.approx(want, **TOL), tcls.__name__


def test_ssim_refuses_other_ranks():
    with pytest.raises(ValueError, match="4-d or 5-d"):
        tssim.ssim(torch.zeros(2, 3, 16), torch.zeros(2, 3, 16))

"""The port's loss terms, SSIM, uint8 metrics and replay pool against the
JAX package's (``dsgan_tpu.ops.losses``, ``ops.ssim``, ``ops.metrics``,
``utils.image_pool``), on the CPU at f32. Images go in NHWC to JAX and
NCHW to the port; every function here reduces over all positions, so the
layouts give the same values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsgan_tpu import ops as jops
from dsgan_tpu.utils.image_pool import init_pool, pool_query
from dsgan_tpu_torch import ops
from dsgan_tpu_torch.utils.image_pool import ImagePool

TOL = dict(rel=1e-5, abs=1e-6)


def _pair(rng, shape=(2, 24, 20, 3), lo=-1.0, hi=1.0):
    a = rng.uniform(lo, hi, shape).astype(np.float32)
    return a, torch.from_numpy(a).permute(0, 3, 1, 2)


@pytest.mark.parametrize("mode", ["vanilla", "lsgan", "bce"])
@pytest.mark.parametrize("real", [True, False])
def test_gan_loss_matches_jax(mode, real):
    rng = np.random.default_rng(1)
    lo, hi = (0.01, 0.99) if mode == "bce" else (-6.0, 6.0)
    a, t = _pair(rng, (3, 5, 5, 1), lo, hi)
    want = float(jops.gan_loss(jnp.asarray(a), real, mode))
    assert float(ops.gan_loss(t, real, mode)) == pytest.approx(want, **TOL)
    # a multiscale list sums the last tensor of each scale
    want = float(jops.gan_loss([[jnp.asarray(a)], [jnp.asarray(a[:, :3, :3])]], real, mode))
    got = float(ops.gan_loss([[t], [t[:, :, :3, :3]]], real, mode))
    assert got == pytest.approx(want, **TOL)


def test_l1_tv_and_perceptual_losses_match_jax():
    rng = np.random.default_rng(2)
    (a, ta), (b, tb) = _pair(rng), _pair(rng)
    assert float(ops.l1_loss(ta, tb)) == pytest.approx(float(jops.l1_loss(a, b)), **TOL)
    assert float(ops.tv_loss(ta)) == pytest.approx(float(jops.tv_loss(jnp.asarray(a))), **TOL)
    feats = [_pair(rng, (2, 16 // 2 ** i, 16 // 2 ** i, 8 * 2 ** i)) for i in range(5)]
    reals = [_pair(rng, (2, 16 // 2 ** i, 16 // 2 ** i, 8 * 2 ** i)) for i in range(5)]
    want = float(jops.perceptual_loss([jnp.asarray(f) for f, _ in feats],
                                      [jnp.asarray(r) for r, _ in reals], num_taps=4))
    got = float(ops.perceptual_loss([t for _, t in feats], [t for _, t in reals], num_taps=4))
    assert got == pytest.approx(want, **TOL)


@pytest.mark.parametrize("size_average", [True, False])
def test_ssim_matches_jax(size_average):
    rng = np.random.default_rng(3)
    (a, ta), (b, tb) = _pair(rng, lo=0.0), _pair(rng, lo=0.0)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), 0, 1)
    tb = torch.from_numpy(b).permute(0, 3, 1, 2)
    want = np.asarray(jops.ssim(jnp.asarray(a), jnp.asarray(b), data_range=1,
                                size_average=size_average))
    got = ops.ssim(ta, tb, data_range=1, size_average=size_average).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_ssim_loss_matches_jax_and_skips_short_dims():
    rng = np.random.default_rng(4)
    (a, ta), (b, tb) = _pair(rng), _pair(rng)
    want = float(jops.ssim_loss(jnp.asarray(a), jnp.asarray(b)))
    assert float(ops.ssim_loss(ta, tb)) == pytest.approx(want, **TOL)
    # a dim shorter than the 11-tap window is left unfiltered, as in JAX
    (a, ta), (b, tb) = _pair(rng, (1, 8, 20, 3)), _pair(rng, (1, 8, 20, 3))
    with pytest.warns(UserWarning, match="Skipping"):
        got = float(ops.ssim_loss(ta, tb))
    assert got == pytest.approx(float(jops.ssim_loss(jnp.asarray(a), jnp.asarray(b))), **TOL)


def test_uint8_metrics_match_jax():
    rng = np.random.default_rng(5)
    (a, ta), (b, tb) = _pair(rng, (2, 32, 32, 3)), _pair(rng, (2, 32, 32, 3))
    b = np.clip(a + 0.2 * rng.standard_normal(a.shape).astype(np.float32), -1, 1)
    tb = torch.from_numpy(b).permute(0, 3, 1, 2)
    qa, qb = jops.metrics.quantize_uint8(jnp.asarray(a)), jops.metrics.quantize_uint8(jnp.asarray(b))
    ta_q, tb_q = ops.quantize_uint8(ta), ops.quantize_uint8(tb)
    np.testing.assert_array_equal(ta_q.permute(0, 2, 3, 1).numpy(), np.asarray(qa))
    assert float(ops.psnr_uint8(ta_q, tb_q)) == pytest.approx(float(jops.psnr_uint8(qa, qb)), **TOL)
    assert float(ops.ssim_uint8(ta_q, tb_q)) == pytest.approx(float(jops.ssim_uint8(qa, qb)),
                                                              rel=1e-5, abs=1e-5)
    # identical images: PSNR at the 1e-12 floor of the MSE, SSIM 1
    assert float(ops.psnr_uint8(ta_q, ta_q)) == pytest.approx(float(jops.psnr_uint8(qa, qa)))
    assert float(ops.ssim_uint8(ta_q, ta_q)) == pytest.approx(1.0, abs=1e-6)


def _jax_draws(rng, n, pool_size):
    """The swap coin and the index JAX's pool_query draws for element i."""
    coins, idx = [], []
    for i in range(n):
        k_p, k_idx = jax.random.split(jax.random.fold_in(rng, i))
        coins.append(float(jax.random.uniform(k_p)))
        idx.append(int(jax.random.randint(k_idx, (), 0, pool_size)))
    return torch.tensor(coins), torch.tensor(idx)


def test_image_pool_matches_jax_with_the_same_draws():
    """Insert while not full, then a 50% swap, over four queries that fill
    the pool of 5 part-way through the second."""
    rng = np.random.default_rng(6)
    size, batch, shape = 5, 3, (4, 4, 2)
    images, count = init_pool(size, shape)
    pool = ImagePool(size, (shape[2], *shape[:2]))
    for q in range(4):
        x = rng.standard_normal((batch, *shape)).astype(np.float32)
        key = jax.random.PRNGKey(q)
        images, count, want = pool_query(images, count, jnp.asarray(x), key)
        got = pool.query(torch.from_numpy(x).permute(0, 3, 1, 2),
                         draws=_jax_draws(key, batch, size))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))
        assert pool.count == int(count)
        np.testing.assert_array_equal(pool.images.permute(0, 2, 3, 1).numpy(), np.asarray(images))


def test_image_pool_draws_from_its_generator_and_size_zero_passes_through():
    x = torch.randn(4, 2, 3, 3)
    assert ImagePool(0, (2, 3, 3)).query(x) is x
    a, b = ImagePool(2, (2, 3, 3), seed=9), ImagePool(2, (2, 3, 3), seed=9)
    outs = [(a.query(x), b.query(x)) for _ in range(3)]
    assert all(torch.equal(p, q) for p, q in outs)
    # each output row is an input row or a stored one
    assert a.count == 2 and torch.equal(outs[0][0][:2], x[:2])

"""The port's optical flow (dsgan_tpu_torch.ops.flow) against the JAX
package's (dsgan_tpu.ops.flow) on seeded frames: the box filter's
asymmetric padding, the edge-clamped bilinear warp (gray and RGB, flows
that leave the frame), the pyramidal LK estimate (an odd size, whose
pyramid drops a row and a column, and the coarse-to-fine resize), and the
flow-warped error. Tolerance: rtol 1e-4 (f32), atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsgan_tpu.ops import flow as jflow
from dsgan_tpu_torch.ops import flow as tflow

TOL = dict(rtol=1e-4, atol=1e-5)


def _scene(h, w, seed, shift=(1.5, -2.0)):
    """A smooth random RGB frame in [-1, 1] and the same scene moved by
    ``shift`` (dx, dy) pixels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    freqs = rng.uniform(0.05, 0.3, (6, 2))
    phases = rng.uniform(0, 2 * np.pi, (6, 3))

    def img(dx, dy):
        out = np.zeros((h, w, 3), np.float32)
        for (fx, fy), ph in zip(freqs, phases):
            out += np.sin((fx * (xx - dx) + fy * (yy - dy))[..., None] + ph).astype(np.float32)
        return np.tanh(out / 3).astype(np.float32)

    return img(0, 0), img(*shift)


def test_box_pads_asymmetrically():
    x = np.random.default_rng(0).standard_normal((13, 11)).astype(np.float32)
    for win in (4, 9):
        np.testing.assert_allclose(tflow._box(torch.from_numpy(x), win).numpy(),
                                   np.asarray(jflow._box(jnp.asarray(x), win)), **TOL)


@pytest.mark.parametrize("channels", [0, 3], ids=["gray", "rgb"])
def test_warp_bilinear_matches_jax(channels):
    rng = np.random.default_rng(1)
    shape = (17, 23) + ((channels,) if channels else ())
    img = rng.standard_normal(shape).astype(np.float32)
    # flows that reach past every edge
    flow = rng.uniform(-6, 6, (17, 23, 2)).astype(np.float32)
    want = np.asarray(jflow.warp_bilinear(jnp.asarray(img), jnp.asarray(flow)))
    got = tflow.warp_bilinear(torch.from_numpy(img), torch.from_numpy(flow)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("size", [(48, 64), (45, 61)], ids=["even", "odd"])
def test_estimate_flow_matches_jax(size):
    a, b = _scene(*size, seed=2)
    want = np.asarray(jax.jit(jflow.estimate_flow)(jnp.asarray(a), jnp.asarray(b)))
    got = tflow.estimate_flow(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (*size, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the estimate found the motion: a pull of about (-1.5, +2) pixels inside
    inner = got[8:-8, 8:-8]
    assert abs(float(np.median(inner[..., 0])) + 1.5) < 0.5
    assert abs(float(np.median(inner[..., 1])) - 2.0) < 0.5


def test_flow_warped_error_matches_jax():
    xa, xb = _scene(40, 40, seed=3)
    ya, yb = _scene(40, 40, seed=4)
    flow = np.asarray(jflow.estimate_flow(jnp.asarray(xa), jnp.asarray(xb)))
    want = [float(v) for v in jflow.flow_warped_error(*(jnp.asarray(v) for v in (ya, yb, xa, xb,
                                                                                   flow)))]
    got = [float(v) for v in tflow.flow_warped_error(*(torch.from_numpy(v) for v in (
        ya, yb, xa, xb, flow)))]
    np.testing.assert_allclose(got, want, rtol=1e-4)

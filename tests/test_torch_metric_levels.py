"""The train step's in-step PSNR / SSIM target levels against the JAX
package's in every compute dtype: in f32 JAX's jitted step fuses
normalize -> quantize and a uint8 target keeps its own levels; in bf16 it
quantizes the bf16-cast target (``dsgan_tpu/models/pix2pix.py:252``),
which puts 127 of the 256 levels one below their own. Then one bf16 step's
psnr / ssim through both model shells on carried weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dsgan_tpu.data import CreateDataLoader as JaxCreateDataLoader
from dsgan_tpu.models.layers import set_gelu_mode
from dsgan_tpu.ops.metrics import normalize_u8 as jax_normalize_u8
from dsgan_tpu.ops.metrics import quantize_uint8 as jax_quantize_uint8
from dsgan_tpu_torch.models.pix2pix import _target_levels, images
from tests.test_torch_model_parity import paired_models, step_both

LEVELS = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_target_levels_equal_jax_for_all_256_levels(dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    want = np.asarray(jax.jit(lambda u: jax_quantize_uint8(jax_normalize_u8(u).astype(jdt)))(
        LEVELS)).reshape(-1)
    raw = torch.from_numpy(LEVELS)
    got = _target_levels(raw, images(raw, getattr(torch, dtype))).reshape(-1).numpy()
    np.testing.assert_array_equal(got, want)
    below = int((got != np.arange(256)).sum())
    assert below == (127 if dtype == "bfloat16" else 0)
    assert (got <= np.arange(256)).all()


@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    root = tmp_path_factory.mktemp("levels")
    rng = np.random.default_rng(13)
    d = root / "train_all"
    d.mkdir()
    for side in "ab":
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
                d / f"{side}_{i}.png")
    yield root
    set_gelu_mode("auto")  # the JAX options set it process-wide


def test_bf16_step_metrics_match_jax(dataroot, tmp_path):
    """bf16 with tanh GELU on both sides (the CLI's default dtype), VGG off:
    the metrics measure the generator's forward, which the VGG term does
    not change."""
    jm, m, jopt = paired_models(dataroot, tmp_path, ["--dtype", "bfloat16", "--gelu", "tanh",
                                                     "--w_vgg", "0"])
    assert m.cfg.compute_dtype == torch.bfloat16
    (batch,) = list(JaxCreateDataLoader(jopt, "train").load_data())
    want, got = step_both(jm, m, batch)
    assert got["psnr"] == pytest.approx(want["psnr"], rel=1e-3, abs=1e-3)
    assert got["ssim"] == pytest.approx(want["ssim"], rel=1e-3, abs=1e-3)

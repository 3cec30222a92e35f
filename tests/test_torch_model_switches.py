"""The step switches of the port's model shell against the JAX package's,
each through its command-line flag: ``--no_lsgan`` (a sigmoid D and the
MSE criterion), ``--use_GAN 0`` (no D update, zero D losses) and
``--use_condition 0`` (D sees the image alone, 3 input channels). One
step each from carried weights, as tests/test_torch_model_parity.py sets
them up, with ``--w_vgg 0`` to keep the JAX compile short."""

import numpy as np
import pytest
from PIL import Image

from dsgan_tpu.data import CreateDataLoader as JaxCreateDataLoader
from dsgan_tpu.models.layers import set_gelu_mode
from tests.test_torch_model_parity import LOSSES, assert_metrics_match, paired_models, step_both


@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    root = tmp_path_factory.mktemp("switches")
    rng = np.random.default_rng(12)
    d = root / "train_all"
    d.mkdir()
    for side in "ab":
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
                d / f"{side}_{i}.png")
    yield root
    set_gelu_mode("auto")  # the JAX options set it process-wide


@pytest.mark.parametrize("flags", [["--no_lsgan"], ["--use_GAN", "0"], ["--use_condition", "0"]],
                         ids=["no_lsgan", "use_GAN_0", "use_condition_0"])
def test_step_switch_matches_jax(dataroot, tmp_path, flags):
    jm, m, jopt = paired_models(dataroot, tmp_path, ["--w_vgg", "0"] + flags)
    assert m.cfg.gan_mode == jm.cfg.gan_mode and m.cfg.use_gan == jm.cfg.use_gan
    assert m.cfg.use_condition == jm.cfg.use_condition and not m.cfg.use_vgg
    (batch,) = list(JaxCreateDataLoader(jopt, "train").load_data())
    want, got = step_both(jm, m, batch)
    assert_metrics_match(got, want, LOSSES)
    if flags[0] == "--use_GAN":
        assert got["loss_D"] == got["loss_G_GAN"] == 0.0
    if flags[0] == "--use_condition":
        assert m.netD.model[0].in_channels == 3
    if flags[0] == "--no_lsgan":
        assert m.netD.use_sigmoid and m.cfg.gan_mode == "lsgan"

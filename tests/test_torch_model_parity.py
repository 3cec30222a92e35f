"""The port's model shell (dsgan_tpu_torch.models.pix2pix.Pix2PixModel) and
eval CLI against the JAX package's, on the CPU at f32, 32x32, batch 2,
``--gelu exact``, pool 0, one command line for both, the JAX loader's
batches fed to both, and the port's seeded weights carried into the JAX
model (its init replaced by them, the VGG16 features through
``--vgg_weights`` on both sides): the losses of two
``optimize_parameters`` calls agree to 1e-4; the
eval CLI's per-image PSNR / SSIM on one ``--load_npz`` agree with
``dsgan_tpu.test``'s ``metrics.csv``; the host eval metrics and the 2-D
MS-SSIM agree with JAX's. The step switches (``--no_lsgan``,
``--use_GAN 0``, ``--use_condition 0``) are in
tests/test_torch_model_switches.py."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from dsgan_tpu import ops as jax_ops
from dsgan_tpu.data import CreateDataLoader as JaxCreateDataLoader
from dsgan_tpu.models import create_model as jax_create_model
from dsgan_tpu.models import registry as jax_registry
from dsgan_tpu.models.layers import set_gelu_mode
from dsgan_tpu.models.mixconvnext import MixConvNeXtML as JaxMixConvNeXtML
from dsgan_tpu.options.train_options import TrainOptions as JaxTrainOptions
from dsgan_tpu.test import main as jax_eval_main
from dsgan_tpu_torch import ops
from dsgan_tpu_torch.models import (
    create_model,
    define_vgg,
    init_d_params,
    init_params,
    init_vgg_params,
)
from dsgan_tpu_torch.options.train_options import TrainOptions
from dsgan_tpu_torch.test import main as eval_main
from dsgan_tpu_torch.utils.convert import flatten

SIZE = 32
COMMON = ["--loadSize_w", "32", "--fineSize_w", "32", "--loadSize_h", "32", "--fineSize_h", "32",
          "--dtype", "float32", "--gelu", "exact", "--data_axis", "1", "--nThreads", "1",
          "--native_loader", "off", "--ndf", "8", "--seed", "5"]
TRAIN = ["--batchSize", "2", "--pool_size", "0"]
LOSSES = ("loss_D", "loss_D_fake", "loss_D_real", "loss_G_GAN", "loss_G_L1", "loss_vgg",
          "loss_tv", "loss_ssim", "loss_G")


@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity")
    rng = np.random.default_rng(11)
    for phase, n in (("train_all", 4), ("test_all", 3)):
        d = root / phase
        d.mkdir()
        for side in "ab":
            for i in range(n):
                Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(
                    d / f"{side}_{i}.png")
    yield root
    set_gelu_mode("auto")  # the JAX options set it process-wide


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def paired_models(dataroot, tmp_path, extra=()):
    """The JAX and the port Pix2PixModel from one command line. The port
    draws G from --seed and D from --seed + 1; the JAX model's init returns
    the same trees, and both read one VGG16 npz."""
    seed = int(COMMON[COMMON.index("--seed") + 1])
    vgg = define_vgg(5, device="cpu", params=init_vgg_params(5, seed=seed + 2))
    npz = tmp_path / "vgg16.npz"
    np.savez(npz, **{k: v.numpy() for k, v in vgg.state_dict().items()})
    argv = COMMON + TRAIN + ["--vgg_weights", str(npz)] + list(extra)

    def carried(module, rng, sample_shape, init_type="normal", train=False):
        if isinstance(module, JaxMixConvNeXtML):
            return {"params": as_jax(init_params(seed))}
        return {"params": as_jax(init_d_params(sample_shape[-1], module.ndf, module.n_layers,
                                               seed=seed + 1))}

    jopt = JaxTrainOptions().parse(str(dataroot), str(tmp_path / "jax"), argv)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_registry, "init_params", carried)
        jm = jax_create_model(jopt)
    jm.setup(jopt)
    opt = TrainOptions().parse(str(dataroot), str(tmp_path / "torch"), argv + ["--platform", "cpu"])
    m = create_model(opt)
    m.setup(opt)
    assert jm.lr == m.lr == opt.lr
    return jm, m, jopt


def step_both(jm, m, batch):
    jm.set_input(batch)
    jm.optimize_parameters()
    m.set_input(batch)
    m.optimize_parameters()
    return jm.get_current_metrics(), m.get_current_metrics()


def assert_metrics_match(got, want, losses=LOSSES):
    assert set(got) == set(want)
    for k in losses:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-4), (k, got[k], want[k])
    assert got["psnr"] == pytest.approx(want["psnr"], rel=1e-3)
    assert got["ssim"] == pytest.approx(want["ssim"], abs=1e-3)


@pytest.fixture(scope="module")
def two_steps(dataroot, tmp_path_factory):
    jm, m, jopt = paired_models(dataroot, tmp_path_factory.mktemp("two"))
    batches = list(JaxCreateDataLoader(jopt, "train").load_data())
    assert len(batches) == 2 and batches[0]["A"].dtype == np.uint8
    out = [step_both(jm, m, b) for b in batches]
    return out, jm, m


@pytest.mark.parametrize("it", [0, 1], ids=["step1", "step2"])
def test_model_shell_losses_match_jax(two_steps, it):
    want, got = two_steps[0][it]
    assert_metrics_match(got, want)


def test_model_shell_current_losses_and_visuals_match_jax(two_steps):
    _, jm, m = two_steps
    got, want = m.get_current_losses(), jm.get_current_losses()
    assert list(got) == list(want) == ["G_GAN", "G_L1", "D_real", "D_fake"]
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-4), k
    gv, wv = m.get_current_visuals(), jm.get_current_visuals()
    assert list(gv) == list(wv)
    for k in ("real_A", "real_B"):
        np.testing.assert_array_equal(gv[k], wv[k])
    assert np.mean(gv["fake_B"].astype(int) != wv["fake_B"].astype(int)) < 0.01
    assert m.state.step == int(jm.state.step) == 2


def test_shell_methods_match_jax(two_steps, dataroot):
    """The reference's image getters and metric calls on one 32x32 batch
    (dsgan_tpu/models/pix2pix.py:487-531): the placed batches in [0, 255]
    equal JAX's, the generated one agrees within the forward's f32
    tolerance (one JAX inference call); cal_ssim / cal_psnr read the last
    step's metrics as JAX's do; image_paths follows set_input."""
    _, jm, m = two_steps
    assert m.cal_ssim() == pytest.approx(jm.cal_ssim(), abs=1e-3)
    assert m.cal_psnr() == pytest.approx(jm.cal_psnr(), rel=1e-3)
    batch = next(iter(JaxCreateDataLoader(jm.opt, "train").load_data()))
    m.set_input(batch)
    jm.set_input(batch)
    assert m.image_paths == list(jm.image_paths) == list(batch["A_paths"])
    for name in ("get_img_tir", "get_img_label", "get_img_nir"):
        got, want = getattr(m, name)(batch), getattr(jm, name)(batch)
        assert got.dtype == want.dtype == np.float32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    got, want = m.get_img_gen(batch), jm.get_img_gen(batch)
    assert got.shape == want.shape == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=0.2)


def test_eval_cli_matches_jax_on_one_npz(dataroot, tmp_path):
    npz = tmp_path / "g.npz"
    np.savez(npz, **flatten(init_params(9)))
    argv = COMMON + ["--name", "ev", "--load_npz", str(npz), "--how_many", "3"]
    jax_eval_main(argv + ["--results_dir", str(tmp_path / "jax")], dataset_path=str(dataroot),
                  out_path=str(tmp_path / "jo"))
    _, rows = eval_main(argv + ["--results_dir", str(tmp_path / "torch"), "--platform", "cpu"],
                     dataset_path=str(dataroot), out_path=str(tmp_path / "to"))

    def read(root):
        with open(root / "ev" / "test_all/_1" / "metrics.csv") as f:
            return list(csv.reader(f))

    got, want = read(tmp_path / "torch"), read(tmp_path / "jax")
    assert len(got) == len(want) == 5 and got[-1][0] == want[-1][0] == "mean"
    for g, w in zip(got[1:], want[1:]):
        assert g[:2] == w[:2]
        assert float(g[3]) == pytest.approx(float(w[3]), rel=1e-3), g
        assert float(g[2]) == pytest.approx(float(w[2]), abs=1e-3), g
    assert len(rows) == 3


def test_host_eval_metrics_equal_jax():
    rng = np.random.default_rng(2)
    for shape in ((24, 20, 3), (16, 16)):
        a = rng.integers(0, 256, shape, dtype=np.uint8)
        b = np.clip(a.astype(int) + rng.integers(-20, 21, shape), 0, 255).astype(np.uint8)
        assert ops.psnr_ref(a, b) == jax_ops.psnr_ref(a, b)
        assert ops.ssim_ref(a, b) == jax_ops.ssim_ref(a, b)
        assert ops.psnr_ref(a, a) == jax_ops.psnr_ref(a, a) == 100.0
        fa, fb = a / 255.0, b / 255.0
        assert ops.ssim_ref(fa, fb) == jax_ops.ssim_ref(fa, fb)


@pytest.mark.parametrize("size_average", [True, False])
def test_ms_ssim_matches_jax_at_176(size_average):
    import torch

    rng = np.random.default_rng(3)
    x = rng.uniform(0, 255, (2, 176, 176, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 25, x.shape), 0, 255).astype(np.float32)
    want = np.asarray(jax_ops.ms_ssim(jnp.asarray(x), jnp.asarray(y), data_range=255,
                                      size_average=size_average))
    got = ops.ms_ssim(torch.from_numpy(x).permute(0, 3, 1, 2),
                      torch.from_numpy(y).permute(0, 3, 1, 2), data_range=255,
                      size_average=size_average).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="larger than 160"):
        ops.ms_ssim(torch.zeros(1, 3, 160, 176), torch.zeros(1, 3, 160, 176))

"""The port's train and eval CLIs end to end on the CPU (``--platform cpu``,
f32, 32x32, batch 2): the files ``dsgan_tpu/train.py`` and
``dsgan_tpu/test.py`` write, a resumed run, the single-image TestModel,
and the refusal to run without a card unless the CPU is asked for."""

import csv
import os

import numpy as np
import pytest
import torch
from PIL import Image

from dsgan_tpu_torch.test import main as eval_main
from dsgan_tpu_torch.train import main as train_main

COMMON = ["--platform", "cpu", "--dtype", "float32", "--loadSize_w", "32", "--loadSize_h", "32",
          "--fineSize_w", "32", "--fineSize_h", "32", "--nThreads", "2", "--ndf", "8"]
TRAIN = ["--batchSize", "2", "--pool_size", "4", "--niter", "1", "--niter_decay", "0",
         "--print_freq", "2"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs one process per core group, and
    more threads than cores slow every process down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch over 6 pairs (3 steps), then its eval."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    for phase in ("train_all", "test_all"):
        d = root / "data" / phase
        d.mkdir(parents=True)
        for side in "ab":
            for i in range(6 if phase == "train_all" else 3):
                Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
                    d / f"{side}_{i}.png")
    out = root / "out"
    model, steps = train_main(COMMON + TRAIN + ["--name", "e2e"], dataset_path=str(root / "data"),
                              out_path=str(out))
    return root, out, model, steps


def test_train_cli_writes_the_jax_cli_files(trained):
    root, out, model, steps = trained
    ckpt_dir = out / "checkpoints" / "e2e"
    assert (ckpt_dir / "epoch_1" / "state.pt").is_file()
    for f in (out / "result.csv", out / "each_epoch.csv", ckpt_dir / "opt.txt",
              ckpt_dir / "loss_log.txt"):
        assert f.is_file(), f
    assert os.listdir(out / "train_img") == ["train_Re1_2.png"]
    trip = np.asarray(Image.open(out / "train_img" / "train_Re1_2.png"))
    assert trip.shape == (32, 96, 3)
    rows = list(csv.reader(open(out / "each_epoch.csv")))
    assert rows[0][:2] == ["1", "train"] and all(np.isfinite(float(v)) for v in rows[0][2:])
    assert "G_GAN" in (ckpt_dir / "loss_log.txt").read_text()
    assert len(steps) == 3 and model.state.step == 3 and model._last_epoch == 1
    lr = 2e-4 * model._lr_lambda(0)  # the reference's LambdaLR at epoch 1 of 1
    assert all(r[0] == 1 and r[1] == lr and min(r[2:]) >= 0 for r in steps)


def test_eval_cli_after_training(trained):
    root, out, _, _ = trained
    results = root / "results"
    _, rows = eval_main(COMMON + ["--name", "e2e", "--which_epoch", "1", "--results_dir",
                               str(results), "--how_many", "2"],
                     dataset_path=str(root / "data"), out_path=str(out))
    web_dir = results / "e2e" / "test_all/_1"
    assert (web_dir / "index.html").is_file()
    assert sorted(os.listdir(web_dir / "images")) == [
        f"a_{i}_{v}.png" for i in range(2) for v in ("fake_B", "real_A", "real_B")]
    lines = list(csv.reader(open(web_dir / "metrics.csv")))
    assert lines[0] == ["index", "path", "ssim", "psnr", "ms_ssim"] and len(lines) == 4
    assert lines[-1][0] == "mean" and np.isfinite(float(lines[-1][2]))
    assert len(rows) == 2 and all(r["ms"] > 0 for r in rows)
    assert float(lines[-1][3]) == pytest.approx(
        np.mean([r["psnr"] for r in rows]))


def test_resume_through_the_cli(trained):
    root, out, _, _ = trained
    model, steps = train_main(
        COMMON + TRAIN + ["--name", "e2e", "--continue_train", "--which_epoch", "1",
                          "--epoch_count", "2", "--niter", "2"],
        dataset_path=str(root / "data"), out_path=str(out))
    assert (out / "checkpoints" / "e2e" / "epoch_2").is_dir()
    # the checkpoint holds the schedule position before its epoch's update
    assert len(steps) == 3 and model.state.step == 6 and model._last_epoch == 1
    assert [r[0] for r in csv.reader(open(out / "each_epoch.csv"))] == ["1", "2"]


def test_testmodel_on_a_single_dataset(trained):
    root, out, _, _ = trained
    results = root / "results_single"
    _, rows = eval_main(COMMON + ["--model", "test", "--dataset_mode", "single", "--name", "e2e",
                               "--which_epoch", "1", "--results_dir", str(results),
                               "--how_many", "2"],
                     dataset_path=str(root / "data" / "test_all"), out_path=str(out))
    web_dir = results / "e2e" / "test_all/_1"
    assert (web_dir / "index.html").is_file() and len(rows) == 2
    assert all("ssim" not in r for r in rows)
    assert sorted(os.listdir(web_dir / "images")) == [
        f"a_{i}_{v}.png" for i in range(2) for v in ("fake_B", "real_A")]


def test_cli_without_a_card_raises_unless_the_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    (tmp_path / "train_all").mkdir()
    with pytest.raises(RuntimeError, match="--platform cpu"):
        train_main(["--dataroot", str(tmp_path), "--checkpoints_dir", str(tmp_path / "c")])
    with pytest.raises(RuntimeError, match="--platform cpu"):
        eval_main(["--dataroot", str(tmp_path), "--checkpoints_dir", str(tmp_path / "c"),
                   "--phase", "train_all"])


def test_tensor2im_and_diagnose_network_match_jax():
    from dsgan_tpu.utils.util import tensor2im as jax_tensor2im
    from dsgan_tpu_torch.utils.util import diagnose_network, tensor2im

    rng = np.random.default_rng(4)
    x = rng.uniform(-1.2, 1.2, (2, 8, 8, 3)).astype(np.float32)
    u8 = rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tensor2im(torch.from_numpy(x)), jax_tensor2im(x))
    np.testing.assert_array_equal(tensor2im(x), jax_tensor2im(x))
    np.testing.assert_array_equal(tensor2im(torch.from_numpy(u8)), u8[0])
    np.testing.assert_array_equal(tensor2im(u8[0]), u8[0])
    net = torch.nn.Linear(3, 2)
    net(torch.ones(4, 3)).sum().backward()
    want = float(np.mean([p.grad.abs().mean() for p in net.parameters()]))
    assert diagnose_network(net) == pytest.approx(want)
    assert diagnose_network([p.grad for p in net.parameters()]) == pytest.approx(want)
    assert diagnose_network(torch.nn.Linear(3, 2)) == 0.0

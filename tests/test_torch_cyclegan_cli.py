"""The train and eval CLIs with ``--model cycle_gan`` on the CPU
(``--platform cpu``, f32, 32x32, resnet_6blocks at ngf 8 with dropout,
PatchGAN ndf 8) on a tiny unaligned dataset (trainA 5 and trainB 7 PNGs:
3 steps an epoch at batch 2):

* a run stopped by SIGTERM in its second epoch and resumed with
  ``--continue_train --which_epoch preempt`` ends where an uninterrupted
  run ends: the same ``result.csv`` / ``each_epoch.csv`` and the epoch 2
  checkpoint bit for bit (all four nets, both Adams, both pools and their
  generators, the dropout generator, the step);
* ``--steps_per_dispatch 2`` takes ``ChainedStep``'s eager path on the CPU
  and equals single steps, bit for bit;
* the eval CLI loads G_A and G_B from the checkpoint and writes the JAX
  CLI's ``metrics.csv`` rows (per image, mean) for fake_B against real_B,
  and the three gallery images of each."""

import contextlib
import csv
import io
import os
import signal

import numpy as np
import pytest
import torch
from PIL import Image

from dsgan_tpu_torch.models.cycle_gan import CycleGANModel
from dsgan_tpu_torch.test import main as eval_main
from dsgan_tpu_torch.train import main as train_main

COMMON = ["--platform", "cpu", "--dtype", "float32", "--model", "cycle_gan",
          "--dataset_mode", "unaligned", "--which_model_netG", "resnet_6blocks", "--ngf", "8",
          "--ndf", "8", "--loadSize_w", "36", "--loadSize_h", "36", "--fineSize_w", "32",
          "--fineSize_h", "32", "--nThreads", "2"]
# a constant rate (the step policy, 0.1x every 50 epochs) so that epoch 2 trains too
TRAIN = ["--batchSize", "2", "--pool_size", "3", "--print_freq", "1", "--niter", "2",
         "--niter_decay", "0", "--lr_policy", "step", "--phase", "train"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataroot(tmp_path_factory):
    root = tmp_path_factory.mktemp("cyclegan_cli")
    rng = np.random.default_rng(2)
    for phase, sizes in (("train", (5, 7)), ("test", (3, 3))):
        for side, n in zip("AB", sizes):
            d = root / f"{phase}{side}"
            d.mkdir()
            for i in range(n):
                Image.fromarray(rng.integers(0, 256, (36, 36, 3), dtype=np.uint8)).save(
                    d / f"{side.lower()}_{i}.png")
    return root


def _train(root, name, *extra):
    with contextlib.redirect_stdout(io.StringIO()):
        return train_main(COMMON + TRAIN + ["--name", name, *extra], dataset_path=str(root),
                          out_path=str(root / f"out_{name}"))


@pytest.fixture(scope="module")
def whole(dataroot):
    return _train(dataroot, "whole")


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _same_run(root, name, ref="whole", epochs=(1, 2)):
    out, want = root / f"out_{name}", root / f"out_{ref}"
    for f in ("result.csv", "each_epoch.csv"):
        assert (out / f).read_text() == (want / f).read_text(), f
    for epoch in epochs:
        got = torch.load(out / "checkpoints" / name / f"epoch_{epoch}" / "state.pt",
                         weights_only=True)
        exp = torch.load(want / "checkpoints" / ref / f"epoch_{epoch}" / "state.pt",
                         weights_only=True)
        assert _equal(got, exp), epoch
        assert {"netG_A", "netG_B", "netD_A", "netD_B", "opt_G", "opt_D", "pool_A_images",
                "pool_B_generator", "dropout_generator", "step"} <= set(got)


def test_train_cli_writes_cyclegan_losses_and_visuals(dataroot, whole):
    model, steps = whole
    assert isinstance(model, CycleGANModel) and len(steps) == 6 and int(model.state.step) == 6
    assert model.state.pool_A.count == model.state.pool_B.count == 3
    out = dataroot / "out_whole"
    rows = list(csv.reader(open(out / "result.csv")))
    names = rows[0][1].split()[0::2]
    assert names == ["D_A:", "G_A:", "cycle_A:", "idt_A:", "D_B:", "G_B:", "cycle_B:", "idt_B:"]
    assert all(np.isfinite(float(v)) for r in rows for v in r[1].split()[1::2] + r[2:])
    trip = np.asarray(Image.open(out / "train_img" / "train_Re2_3.png"))
    assert trip.shape == (32, 96, 3)
    vis = model.get_current_visuals()
    assert list(vis) == ["real_A", "fake_B", "rec_A", "real_B", "fake_A", "rec_B"]
    assert all(v.shape == (32, 32, 3) and v.dtype == np.uint8 for v in vis.values())


def test_preempted_and_resumed_run_equals_uninterrupted(dataroot, whole, monkeypatch):
    """SIGTERM after the first step of epoch 2 (step 4): the CLI saves the
    ``preempt`` state at the next chunk boundary; the resume runs the
    epoch's last two batches."""
    step = CycleGANModel.optimize_parameters

    def stop_after_step_4(self):
        step(self)
        if int(self.state.step) == 4:
            signal.raise_signal(signal.SIGTERM)

    monkeypatch.setattr(CycleGANModel, "optimize_parameters", stop_after_step_4)
    model, steps = _train(dataroot, "split")
    assert len(steps) == 4 and int(model.state.step) == 4
    monkeypatch.setattr(CycleGANModel, "optimize_parameters", step)
    model, steps = _train(dataroot, "split", "--continue_train", "--which_epoch", "preempt")
    assert len(steps) == 2 and int(model.state.step) == 6
    _same_run(dataroot, "split", epochs=(2,))


def test_steps_per_dispatch_equals_single_steps(dataroot, whole):
    model, steps = _train(dataroot, "k2", "--steps_per_dispatch", "2")
    # 3 steps an epoch: a chunk of 2 and an eager tail of 1, all eager on the CPU
    assert model._chained.counts == dict(eager=6, captured=0, replayed=0) and len(steps) == 6
    _same_run(dataroot, "k2")


def test_eval_cli_scores_fake_b_against_real_b(dataroot, whole):
    results = dataroot / "results"
    with contextlib.redirect_stdout(io.StringIO()):
        model, rows = eval_main(COMMON + ["--name", "whole", "--which_epoch", "2", "--phase",
                                          "test", "--results_dir", str(results),
                                          "--how_many", "3"],
                                dataset_path=str(dataroot),
                                out_path=str(dataroot / "out_whole"))
    web_dir = results / "whole" / "test_2"
    lines = list(csv.reader(open(web_dir / "metrics.csv")))
    assert lines[0] == ["index", "path", "ssim", "psnr", "ms_ssim"] and len(lines) == 5
    assert [r[0] for r in lines[1:]] == ["0", "1", "2", "mean"]
    assert all(r[4] == "" for r in lines[1:])  # 32x32: no MS-SSIM
    assert float(lines[-1][2]) == pytest.approx(np.mean([r["ssim"] for r in rows]))
    assert sorted(os.listdir(web_dir / "images")) == [
        f"a_{i}_{v}.png" for i in range(3) for v in ("fake_B", "real_A", "real_B")]
    # the generators are the checkpoint's, and fake_B is G_A's
    st = torch.load(dataroot / "out_whole" / "checkpoints" / "whole" / "epoch_2" / "state.pt",
                    weights_only=True)
    assert _equal(model.netG_A.state_dict(), st["netG_A"])
    assert _equal(model.netG_B.state_dict(), st["netG_B"])
    assert model.rec_A.shape == model.fake_A.shape == (1, 32, 32, 3)

"""The eval build and the model shell's remaining methods on the CPU: the
eval model builds the serving generator (parameters stored in the compute
dtype), and on one train checkpoint its forward equals the training
build's bit for bit in f32 and in bf16 (casting once on load gives the
bf16 weights that casting at every use gives); ``eval``,
``print_networks``, ``image_paths`` (pix2pix and the single-image
TestModel) and ``save_images2``. The getters and ``cal_ssim`` /
``cal_psnr`` against JAX's are in tests/test_torch_model_parity.py."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from dsgan_tpu_torch.models import create_model
from dsgan_tpu_torch.options.test_options import TestOptions
from dsgan_tpu_torch.options.train_options import TrainOptions
from dsgan_tpu_torch.utils import html
from dsgan_tpu_torch.utils.visualizer import save_images2

SIZE = 32
GEOMETRY = ["--loadSize_w", str(SIZE), "--fineSize_w", str(SIZE), "--loadSize_h", str(SIZE),
            "--fineSize_h", str(SIZE), "--platform", "cpu", "--ndf", "8"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _build(options, argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        opt = options().parse(argv=GEOMETRY + argv)
        model = create_model(opt)
        model.setup(opt)
    return model, out.getvalue()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_build_forward_equals_training_build_forward(tmp_path, dtype):
    common = ["--dtype", dtype, "--checkpoints_dir", str(tmp_path), "--name", "ev"]
    train, _ = _build(TrainOptions, common + ["--w_vgg", "0"])
    train.save_networks(1)
    ev, out = _build(TestOptions, common + ["--which_epoch", "1", "--model", "pix2pix"])
    assert "loaded generator from epoch 1" in out
    want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert {p.dtype for p in ev.netG.parameters()} == {want}
    assert {p.dtype for p in train.netG.parameters()} == {torch.float32}
    assert not ev.netG.training and train.netG.training
    batch = np.random.default_rng(0).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    for m in (train, ev):
        m.set_input({"A": batch, "B": batch, "A_paths": ["x", "y"]})
    got, ref = ev.forward(), train.forward()
    assert got.dtype == ref.dtype == torch.float32 and got.shape == (2, SIZE, SIZE, 3)
    assert torch.equal(got, ref)
    assert train.netG.training  # forward put the training build back in train mode


def test_eval_print_networks_and_image_paths(tmp_path, capsys):
    m, _ = _build(TrainOptions, ["--dtype", "float32", "--w_vgg", "0", "--checkpoints_dir",
                                 str(tmp_path), "--name", "shell"])
    m.print_networks()
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["[Network G] Total number of parameters : 22.425 M",
                     "[Network D] Total number of parameters : %.3f M"
                     % (sum(p.numel() for p in m.netD.parameters()) / 1e6)]
    m.eval()
    assert m.is_eval and not m.netG.training and not m.netD.training
    batch = {k: np.zeros((2, SIZE, SIZE, 3), np.uint8) for k in "AB"}
    m.set_input(dict(batch, A_paths=["a0", "a1"], B_paths=["b0", "b1"]))
    assert m.image_paths == ["a0", "a1"]
    m.opt.which_direction = "BtoA"
    m.set_input(dict(batch, A_paths=["a0", "a1"], B_paths=["b0", "b1"]))
    assert m.image_paths == ["b0", "b1"]

    m.save_networks(1)
    single, _ = _build(TestOptions, ["--dtype", "float32", "--checkpoints_dir", str(tmp_path),
                                     "--name", "shell", "--model", "test"])
    single.set_input({"A": batch["A"], "A_paths": ["s0", "s1"]})
    assert single.image_paths == ["s0", "s1"] and single.visual_names == ["real_A", "fake_B"]


def test_save_images2_writes_the_reference_names(tmp_path):
    page = html.HTML(str(tmp_path / "web"), "t")
    img = np.zeros((4, 4, 3), np.uint8)
    save_images2(page, {"real_A": img, "fake_B": img, "real_B": img}, ["/d/frame_7.png"])
    page.save()
    assert sorted(os.listdir(page.get_image_dir())) == [
        "input_frame_7.png", "output_frame_7.png", "target_frame_7.png"]
    text = (tmp_path / "web" / "index.html").read_text()
    assert "frame_7" in text and "target" in text

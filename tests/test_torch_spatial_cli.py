"""The spatial axis through the port's CLIs on the CPU (gloo ranks,
spawned), the counterpart of ``tests/test_parallel.py:138-193``:

  * the train CLI at ``--data_axis 2 --spatial_axis 2`` (4 ranks;
    resnet_6blocks ngf 8, 32x32, batch 2, f32, a replay pool of 2, the
    triptych every step) against ``--data_axis 1 --spatial_axis 1`` over
    the same data order: the epoch-1 checkpoints agree (the parameters,
    Adam's moments, the pool's images joined from the strips, the step),
    and rank 0 alone writes files, its triptych joined from the strips;
  * the train CLI at ``--spatial_axis 2`` on MixConvNeXtML, then the eval
    CLI and the video CLI at ``--spatial_axis 2`` on its checkpoint against
    one process: the same ``metrics.csv`` and ``temporal.csv``;
  * ``--model cycle_gan`` and ``--model diffusion`` through the train CLI
    (one step) and the eval CLI at ``--spatial_axis 2`` against one
    process: the checkpoints (CycleGAN's two pools joined from the strips,
    diffusion's draws) and the eval's metrics;
  * the rest of the zoo (gll against the multiscale D) through the train
    CLI for one step and the eval CLI at ``--spatial_axis 2`` against one
    process; every recipe parses on the spatial axis and its nets build.
"""

import csv

import numpy as np
import pytest
import torch
from PIL import Image

from dsgan_tpu_torch.parallel import multihost
from dsgan_tpu_torch.utils import checkpoint as ckpt

SIZE = ["--loadSize_w", "32", "--loadSize_h", "32", "--fineSize_w", "32", "--fineSize_h", "32"]
COMMON = ["--platform", "cpu", "--dtype", "float32", "--nThreads", "1", "--serial_batches",
          "--no_flip", "--seed", "7", "--niter", "1", "--niter_decay", "0", "--print_freq", "1",
          "--batchSize", "2", "--w_vgg", "0"] + SIZE
RESNET = ["--which_model_netG", "resnet_6blocks", "--ngf", "8", "--ndf", "8", "--no_dropout",
          "--pool_size", "2"]
MIX = ["--ndf", "8", "--pool_size", "0"]


def _dataset(root, n=4, size=32):
    rng = np.random.default_rng(0)
    d = root / "data" / "train_all"
    d.mkdir(parents=True)
    for pfx in "ab":
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(
                d / f"{pfx}_{i}.png")
    t = root / "data" / "test_all"
    t.mkdir()
    for i in range(2):
        for pfx in "ab":
            Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(
                t / f"{pfx}_{i}.png")
    return str(root / "data")


def _train_rank(rank, root, argv):
    torch.set_num_threads(1)
    from dsgan_tpu_torch import train

    train.main(argv + ["--checkpoints_dir", f"{root}/ck{rank}", "--name", "s"])


def _adam(st, key):
    """Adam's moments of the weights (a bias whose gradient cancels through
    an InstanceNorm is rounding noise in one process too)."""
    return torch.cat([v[k].reshape(-1) for v in st[key]["state"].values()
                      for k in ("exp_avg", "exp_avg_sq") if v[k].dim() > 1])


def rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


def test_train_cli_data2_spatial2_matches_one_process(tmp_path):
    from dsgan_tpu_torch import train

    data = _dataset(tmp_path)
    argv = ["--dataroot", data] + COMMON + RESNET
    train.main(argv + ["--data_axis", "1", "--spatial_axis", "1", "--checkpoints_dir",
                       str(tmp_path / "one"), "--name", "s"])
    multihost.spawn(_train_rank, 4, (str(tmp_path), argv + [
        "--num_hosts", "4", "--data_axis", "2", "--spatial_axis", "2"]), timeout=300)
    want, got = (ckpt.restore_state(str(tmp_path / d / "s"), 1) for d in ("one", "ck0"))
    assert int(got["step"]) == int(want["step"]) == 2
    for net in ("netG", "netD"):  # lr 0 in the last epoch of LambdaLR: Adam's moments move
        for k, w in want[net].items():
            torch.testing.assert_close(got[net][k], w, rtol=0, atol=1e-6)
        assert rel_l2(_adam(got, "opt_" + net[-1]), _adam(want, "opt_" + net[-1])) <= 1e-4
    assert got["pool_images"].shape == want["pool_images"].shape == (2, 6, 32, 32)
    torch.testing.assert_close(got["pool_images"], want["pool_images"], rtol=1e-4, atol=2e-4)
    assert got["pool_count"] == want["pool_count"] == 2
    trip = np.asarray(Image.open(tmp_path / "ck0" / "s" / "train_img" / "train_Re1_2.png"))
    ref = np.asarray(Image.open(tmp_path / "one" / "s" / "train_img" / "train_Re1_2.png"))
    assert trip.shape == ref.shape == (32, 96, 3)
    assert np.abs(trip.astype(int) - ref.astype(int)).max() <= 1
    rows = [list(csv.reader(open(tmp_path / d / "s" / "each_epoch.csv"))) for d in ("one", "ck0")]
    np.testing.assert_allclose([float(v) for v in rows[1][0][2:]],
                               [float(v) for v in rows[0][0][2:]], rtol=1e-3, atol=1e-3)
    for r in (1, 2, 3):
        assert not (tmp_path / f"ck{r}").exists(), f"rank {r} wrote files"


def _eval_rank(rank, root, train_argv, eval_argv, video_argv):
    torch.set_num_threads(1)
    from dsgan_tpu_torch import test, train, video

    train.main(train_argv + ["--checkpoints_dir", f"{root}/ck{rank}"])
    test.main(eval_argv + ["--results_dir", f"{root}/res{rank}"])
    video.main(video_argv + ["--results_dir", f"{root}/res{rank}"])


def _frames(root):
    d = root / "frames"
    d.mkdir()
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
    for t in range(4):
        img = np.stack([np.sin(0.2 * (xx - 2 * t) + c + 0.1 * yy) for c in (0.0, 1.0, 2.0)], -1)
        Image.fromarray(((img + 1) * 127.5).astype(np.uint8)).save(d / f"f{t}.png")
    return str(d)


def test_mixconvnext_train_eval_video_on_two_strips(tmp_path):
    """MixConvNeXtML (K1-K4's plain versions) through the train CLI at
    ``--spatial_axis 2``, then the eval and video CLIs on its epoch-1
    checkpoint at ``--spatial_axis 2``, against one process on the one
    process's checkpoint: the same per-image and mean metrics, the same
    temporal metrics (a uint8 level off is a pixel of f32 noise)."""
    from dsgan_tpu_torch import test, train, video

    data, frames = _dataset(tmp_path), _frames(tmp_path)
    train_argv = ["--dataroot", data, "--name", "m"] + COMMON + MIX
    tail = ["--name", "m", "--which_epoch", "1", "--platform", "cpu", "--dtype", "float32"] + SIZE
    eval_argv = ["--dataroot", data, "--how_many", "2"] + tail
    video_argv = ["--dataroot", frames, "--batchSize", "2", "--no_flow_metric"] + tail
    train.main(train_argv + ["--checkpoints_dir", str(tmp_path / "one")])
    test.main(eval_argv + ["--checkpoints_dir", str(tmp_path / "one"), "--results_dir",
                           str(tmp_path / "res_one")])
    video.main(video_argv + ["--checkpoints_dir", str(tmp_path / "one"), "--results_dir",
                             str(tmp_path / "res_one")])
    multihost.spawn(_eval_rank, 2, (
        str(tmp_path), train_argv + ["--num_hosts", "2", "--spatial_axis", "2"],
        eval_argv + ["--num_hosts", "2", "--spatial_axis", "2", "--checkpoints_dir",
                     str(tmp_path / "ck0")],
        video_argv + ["--num_hosts", "2", "--spatial_axis", "2", "--checkpoints_dir",
                      str(tmp_path / "ck0")]), timeout=300)
    want, got = (ckpt.restore_state(str(tmp_path / d / "m"), 1) for d in ("one", "ck0"))
    assert rel_l2(_adam(got, "opt_G"), _adam(want, "opt_G")) <= 1e-4
    table = [list(csv.reader(open(tmp_path / d / "m" / "test_all" / "_1" / "metrics.csv")))
             for d in ("res_one", "res0")]
    assert [r[:2] for r in table[0]] == [r[:2] for r in table[1]] and len(table[0]) == 4
    for a, b in zip(table[0][1:], table[1][1:]):
        np.testing.assert_allclose([float(b[2]), float(b[3])], [float(a[2]), float(a[3])],
                                   rtol=1e-3, atol=1e-3)
    temporal = [(tmp_path / d / "m" / "video" / "temporal.csv").read_text().splitlines()
                for d in ("res_one", "res0")]
    assert len(temporal[0]) == len(temporal[1])
    for a, b in zip(temporal[0][1:], temporal[1][1:]):
        if a:
            np.testing.assert_allclose([float(v) for v in b.split(",")[1:]],
                                       [float(v) for v in a.split(",")[1:]], rtol=1e-3,
                                       atol=1e-5)
    assert not (tmp_path / "res1").exists() and not (tmp_path / "ck1").exists()


def _unaligned(root, n=2):
    rng = np.random.default_rng(3)
    for phase in ("train", "test"):
        for side in "AB":
            d = root / "udata" / f"{phase}{side}"
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
                    d / f"{side.lower()}_{i}.png")
    return str(root / "udata")


def _train_eval_rank(rank, root, train_argv, eval_argv):
    torch.set_num_threads(1)
    from dsgan_tpu_torch import test, train

    train.main(train_argv + ["--checkpoints_dir", f"{root}/ck{rank}"])
    test.main(eval_argv + ["--checkpoints_dir", f"{root}/ck0", "--results_dir",
                           f"{root}/res{rank}"])


def _train_eval(tmp_path, train_argv, eval_argv, name):
    """The train CLI (one step) and the eval CLI on its epoch-1 checkpoint,
    in one process and at ``--spatial_axis 2``: (the two checkpoints, the
    two metrics.csv tables); rank 1 writes nothing."""
    from dsgan_tpu_torch import test, train

    train.main(train_argv + ["--checkpoints_dir", str(tmp_path / "one")])
    test.main(eval_argv + ["--checkpoints_dir", str(tmp_path / "one"), "--results_dir",
                           str(tmp_path / "res_one")])
    strips = ["--num_hosts", "2", "--spatial_axis", "2"]
    multihost.spawn(_train_eval_rank, 2, (str(tmp_path), train_argv + strips,
                                          eval_argv + strips), timeout=300)
    assert not (tmp_path / "res1").exists() and not (tmp_path / "ck1").exists()
    phase = eval_argv[eval_argv.index("--phase") + 1] if "--phase" in eval_argv else "test_all/"
    return ([ckpt.restore_state(str(tmp_path / d / name), 1) for d in ("one", "ck0")],
            [list(csv.reader(open(tmp_path / d / name / f"{phase}_1" / "metrics.csv")))
             for d in ("res_one", "res0")])


def _same_metrics(tables):
    assert [r[:2] for r in tables[0]] == [r[:2] for r in tables[1]] and len(tables[0]) == 4
    for a, b in zip(tables[0][1:], tables[1][1:]):
        np.testing.assert_allclose([float(b[2]), float(b[3])], [float(a[2]), float(a[3])],
                                   rtol=1e-3, atol=1e-3)


def test_cyclegan_train_eval_on_two_strips(tmp_path):
    """``--model cycle_gan`` (resnet_6blocks ngf 8, PatchGAN ndf 8, a pool of
    2 per side) through the train CLI for one step at ``--spatial_axis 2``
    (a chunk of ``--steps_per_dispatch 2`` staged on the strips, its one
    step eager) and the eval CLI on its checkpoint, against one process: the
    checkpoint's parameters, both pools joined from the strips, both Adams'
    moments; the eval's per-image and mean metrics."""
    data = _unaligned(tmp_path)
    argv = ["--dataroot", data, "--name", "c", "--model", "cycle_gan", "--dataset_mode",
            "unaligned", "--steps_per_dispatch", "2"] + COMMON + RESNET
    tail = ["--dataroot", data, "--name", "c", "--which_epoch", "1", "--model", "cycle_gan",
            "--dataset_mode", "unaligned", "--phase", "test", "--how_many", "2",
            "--which_model_netG", "resnet_6blocks", "--ngf", "8", "--no_dropout",
            "--platform", "cpu", "--dtype", "float32"] + SIZE
    (want, got), tables = _train_eval(tmp_path, argv + ["--phase", "train"], tail, "c")
    assert int(got["step"]) == int(want["step"]) == 1
    for net in ("netG_A", "netG_B", "netD_A", "netD_B"):
        for k, w in want[net].items():
            torch.testing.assert_close(got[net][k], w, rtol=0, atol=1e-6)
    for opt in ("opt_G", "opt_D"):
        assert rel_l2(_adam(got, opt), _adam(want, opt)) <= 1e-4
    for side in "AB":
        assert got[f"pool_{side}_images"].shape == (2, 3, 32, 32)
        torch.testing.assert_close(got[f"pool_{side}_images"], want[f"pool_{side}_images"],
                                   rtol=1e-4, atol=2e-4)
        assert got[f"pool_{side}_count"] == want[f"pool_{side}_count"] == 2
    _same_metrics(tables)


def test_diffusion_train_eval_on_two_strips(tmp_path):
    """``--model diffusion`` (nf 8, T 20, a 3-step DDIM probe every step)
    through the train CLI for one step at ``--spatial_axis 2`` and the eval
    CLI on its checkpoint, against one process: the same draws (the
    generator's state), Adam's moments, the probe's SSIM / PSNR in
    each_epoch.csv and the eval's DDIM samples' metrics."""
    data = _dataset(tmp_path, n=2)
    model = ["--model", "diffusion", "--diff_nf", "8", "--timesteps", "20", "--sample_steps",
             "3"]
    argv = ["--dataroot", data, "--name", "d", "--metric_freq", "1"] + model + COMMON
    tail = ["--dataroot", data, "--name", "d", "--which_epoch", "1", "--how_many", "2",
            "--platform", "cpu", "--dtype", "float32"] + model + SIZE
    (want, got), tables = _train_eval(tmp_path, argv, tail, "d")
    assert int(got["step"]) == int(want["step"]) == 1
    assert torch.equal(got["generator"], want["generator"])
    for k, w in want["net"].items():
        torch.testing.assert_close(got["net"][k], w, rtol=0, atol=1e-6)
    assert rel_l2(_adam(got, "opt"), _adam(want, "opt")) <= 1e-4
    rows = [list(csv.reader(open(tmp_path / d / "d" / "each_epoch.csv"))) for d in ("one", "ck0")]
    np.testing.assert_allclose([float(v) for v in rows[1][0][2:]],
                               [float(v) for v in rows[0][0][2:]], rtol=1e-3, atol=1e-3)
    _same_metrics(tables)


@pytest.mark.parametrize("argv", [
    ["--which_model_netG", "unet_128"],
    ["--which_model_netD", "multi"],
    ["--which_model_netD", "pixel"],
    ["--which_model_netG", "cascaded", "--norm", "batch"],
], ids=lambda v: "_".join(a.lstrip("-") for a in v))
def test_item_21_recipes_raise(tmp_path, argv):
    """The recipes of item 21's part 4, refused until it was ported, parse
    at ``--spatial_axis 2`` and their nets build on the parsed options (a
    forward on strips: ``tests/test_torch_spatial_zoo.py``)."""
    from dsgan_tpu_torch.models import define_D, define_G
    from dsgan_tpu_torch.options.train_options import TrainOptions

    opt = TrainOptions().parse(argv=["--checkpoints_dir", str(tmp_path), "--spatial_axis", "2",
                                     "--ngf", "8"] + argv)
    assert opt.spatial_axis == 2
    G = define_G(opt.input_nc, opt.output_nc, opt.ngf, opt.which_model_netG, opt.norm,
                 not opt.no_dropout, dtype=torch.float32, device="cpu", train=True)
    D = define_D(opt.input_nc + opt.output_nc, opt.ndf, opt.which_model_netD, opt.n_layers_D,
                 opt.norm, dtype=torch.float32, device="cpu")
    names = {"unet_128": "UnetGenerator", "cascaded": "CascadedGenerator",
             "MixConvNeXtML": "MixConvNeXtML", "multi": "MultiscaleDiscriminator",
             "pixel": "PixelDiscriminator", "basic": "NLayerDiscriminator"}
    assert (type(G).__name__, type(D).__name__) == (names[opt.which_model_netG],
                                                    names[opt.which_model_netD])


def test_zoo_train_eval_on_two_strips(tmp_path):
    """gll (ngf 4) against the multiscale D (ndf 8), pool 2, 64x64 (its
    global trunk's deepest level 4x4, as ``tests/test_torch_spatial_zoo.py``
    runs it), through the train CLI for one step at ``--spatial_axis 2`` and
    the eval CLI on its checkpoint, against one process: the checkpoint's
    parameters and Adam's moments, the pool's images joined from the
    strips, the eval's per-image and mean metrics."""
    data = _dataset(tmp_path, n=2, size=64)
    zoo = ["--which_model_netG", "gll", "--ngf", "4", "--no_dropout"] + [
        v for f in ("loadSize_w", "loadSize_h", "fineSize_w", "fineSize_h") for v in (f"--{f}",
                                                                                       "64")]
    argv = (["--dataroot", data, "--name", "z", "--which_model_netD", "multi", "--ndf", "8",
             "--pool_size", "2"] + COMMON + zoo)
    tail = (["--dataroot", data, "--name", "z", "--which_epoch", "1", "--how_many", "2",
             "--platform", "cpu", "--dtype", "float32"] + zoo)
    (want, got), tables = _train_eval(tmp_path, argv, tail, "z")
    assert int(got["step"]) == int(want["step"]) == 1
    for net in ("netG", "netD"):
        for k, w in want[net].items():
            torch.testing.assert_close(got[net][k], w, rtol=0, atol=1e-6)
    for opt in ("opt_G", "opt_D"):
        assert rel_l2(_adam(got, opt), _adam(want, opt)) <= 1e-4
    assert got["pool_images"].shape == (2, 6, 64, 64)
    torch.testing.assert_close(got["pool_images"], want["pool_images"], rtol=1e-4, atol=2e-4)
    _same_metrics(tables)


@pytest.mark.parametrize("argv", [
    ["--model", "cycle_gan", "--dataset_mode", "unaligned"],
    ["--model", "diffusion"],
    ["--norm", "batch", "--which_model_netG", "resnet_6blocks"],
    ["--norm", "none", "--which_model_netG", "resnet_9blocks"],
], ids=lambda v: "_".join(a.lstrip("-") for a in v))
def test_item_21_parts_1_to_3_parse_on_the_spatial_axis(tmp_path, argv):
    """CycleGAN, diffusion and ``--norm batch|none`` run on the spatial axis
    (train and eval)."""
    from dsgan_tpu_torch.options.test_options import TestOptions
    from dsgan_tpu_torch.options.train_options import TrainOptions

    for options in (TrainOptions, TestOptions):
        opt = options().parse(argv=["--checkpoints_dir", str(tmp_path), "--spatial_axis", "2"]
                              + argv)
        assert opt.spatial_axis == 2 and [getattr(opt, a.lstrip("-")) for a in argv[::2]] == \
            [a if not a.isdigit() else int(a) for a in argv[1::2]]


def test_the_default_recipe_parses_on_the_spatial_axis(tmp_path):
    from dsgan_tpu_torch.options.test_options import TestOptions
    from dsgan_tpu_torch.options.train_options import TrainOptions

    for which in ("MixConvNeXtML", "resnet_6blocks", "resnet_9blocks"):
        opt = TrainOptions().parse(argv=["--checkpoints_dir", str(tmp_path), "--spatial_axis",
                                         "2", "--data_axis", "2", "--which_model_netG", which])
        assert (opt.spatial_axis, opt.which_model_netG) == (2, which)
    # eval builds no D: its flag does not matter there
    assert TestOptions().parse(argv=["--checkpoints_dir", str(tmp_path), "--spatial_axis", "2",
                                     "--which_model_netD", "multi"]).spatial_axis == 2

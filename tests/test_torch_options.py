"""The port's options (dsgan_tpu_torch.options) against the JAX package's:
every flag with the same name, default, type and action; the flags that
refused their values until their ROADMAP.md items were ported parse and
build; and the LR policies of the port's BaseModel against
JAX BaseModel's over 25 epochs."""

import argparse
import math
import types

import pytest

from dsgan_tpu.models.base_model import BaseModel as JaxBaseModel
from dsgan_tpu.models.pix2pix import Pix2PixModel as JaxPix2PixModel
from dsgan_tpu.options.test_options import TestOptions as JaxTestOptions
from dsgan_tpu.options.train_options import TrainOptions as JaxTrainOptions
from dsgan_tpu_torch.models.base_model import BaseModel
from dsgan_tpu_torch.models.pix2pix import Pix2PixModel
from dsgan_tpu_torch.options.test_options import TestOptions
from dsgan_tpu_torch.options.train_options import TrainOptions


def _actions(options, model_cls, is_train):
    parser = options.initialize(argparse.ArgumentParser())
    parser = model_cls.modify_commandline_options(parser, is_train)
    return {a.dest: a for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("kind", ["train", "test"])
def test_flags_match_jax(kind):
    port, jax_ = (TrainOptions(), JaxTrainOptions()) if kind == "train" else \
        (TestOptions(), JaxTestOptions())
    got = _actions(port, Pix2PixModel, kind == "train")
    want = _actions(jax_, JaxPix2PixModel, kind == "train")
    assert sorted(got) == sorted(want)
    for dest, w in want.items():
        g = got[dest]
        assert g.option_strings == w.option_strings, dest
        assert type(g) is type(w) and g.type is w.type and g.nargs == w.nargs, dest
        same = g.default == w.default or (
            isinstance(w.default, float) and math.isnan(w.default) and math.isnan(g.default))
        assert same, (dest, g.default, w.default)


def test_parse_writes_opt_txt_and_sets_no_process_state(tmp_path):
    import dsgan_tpu_torch.models.layers as layers

    before = dict(vars(layers))
    opt = TrainOptions().parse(argv=["--checkpoints_dir", str(tmp_path), "--name", "o",
                                     "--gelu", "exact", "--suffix", "{model}"])
    assert opt.isTrain and opt.name == "o_pix2pix" and opt.gelu == "exact"
    assert opt.lambda_L1 == 100.0  # the model's own flag, from the two-stage parse
    text = (tmp_path / "o_pix2pix" / "opt.txt").read_text()
    assert "gelu: exact" in text and "[default: auto]" in text
    assert dict(vars(layers)) == before


@pytest.mark.parametrize("argv,nets", [
    # the spatial axis runs the U-Nets and the pixel D, and --remat
    # rematerializes MixConvNeXtML's blocks
    pytest.param(["--spatial_axis", "2", "--which_model_netG", "unet_256"],
                 ("UnetGenerator", "NLayerDiscriminator"), id="--spatial_axis_2-item 13"),
    pytest.param(["--data_axis", "2", "--spatial_axis", "2", "--which_model_netD", "pixel"],
                 ("MixConvNeXtML", "PixelDiscriminator"),
                 id="--data_axis_2_--spatial_axis_2-item 13"),
    pytest.param(["--remat"], ("MixConvNeXtML", "NLayerDiscriminator"), id="--remat-not needed"),
])
def test_unported_switches_raise_with_their_roadmap_item(tmp_path, argv, nets):
    """The switches that raised until their items were ported (item 21: the
    rest of the zoo on the spatial axis; item 22: --remat) now parse, and
    the networks build from the parsed options."""
    import torch

    from dsgan_tpu_torch.models import define_D, define_G

    opt = TrainOptions().parse(argv=["--checkpoints_dir", str(tmp_path), "--ngf", "8"] + argv)
    G = define_G(opt.input_nc, opt.output_nc, opt.ngf, opt.which_model_netG, opt.norm,
                 not opt.no_dropout, dtype=torch.float32, device="cpu", remat=opt.remat,
                 train=True)
    D = define_D(opt.input_nc + opt.output_nc, opt.ndf, opt.which_model_netD, opt.n_layers_D,
                 opt.norm, dtype=torch.float32, device="cpu")
    assert (type(G).__name__, type(D).__name__) == nets
    assert getattr(G, "remat", False) == ("--remat" in argv)


@pytest.mark.parametrize("argv,match", [
    (["--data_axis", "2"], "needs more than the 1 visible devices"),
    (["--num_hosts", "2"], "rendezvous"),
], ids=lambda v: "_".join(v) if isinstance(v, list) else None)
def test_data_axis_parses_and_needs_its_group(tmp_path, argv, match, monkeypatch):
    """ROADMAP item 13's data axis is ported: --data_axis / --num_hosts are
    accepted, and without a group of that many ranks the run raises
    (--data_axis 2 where the model builds, --num_hosts 2 at the parse,
    having no rendezvous); it never runs alone."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "JAX_COORDINATOR_ADDRESS",
                 "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    from dsgan_tpu_torch.models import create_model

    argv = ["--checkpoints_dir", str(tmp_path), "--platform", "cpu", "--dtype", "float32",
            "--which_model_netG", "resnet_6blocks", "--ngf", "8", "--batchSize", "2"] + argv
    with pytest.raises(ValueError, match=match):
        create_model(TrainOptions().parse(argv=argv))


@pytest.mark.parametrize("argv,key,value", [
    (["--steps_per_dispatch", "4"], "steps_per_dispatch", 4),
    (["--profile_dir", "prof", "--profile_steps", "2:5"], "profile_dir", "prof"),
    (["--debug_nans"], "debug_nans", True),
    (["--native_loader", "off"], "native_loader", "off"),
], ids=lambda v: "_".join(v) if isinstance(v, list) else None)
def test_runtime_switches_parse(tmp_path, argv, key, value):
    """The train CLI's runtime flags are ported: they parse to their values."""
    opt = TrainOptions().parse(argv=["--checkpoints_dir", str(tmp_path)] + argv)
    assert getattr(opt, key) == value


@pytest.mark.parametrize("argv,key,value", [
    (["--norm", "batch"], "norm", "batch"),
    (["--norm", "none"], "norm", "none"),
    (["--which_model_netG", "resnet_9blocks"], "which_model_netG", "resnet_9blocks"),
    (["--which_model_netG", "wnet"], "which_model_netG", "wnet"),
    (["--which_model_netD", "pixel"], "which_model_netD", "pixel"),
    (["--which_model_netD", "multi"], "which_model_netD", "multi"),
    (["--init_type", "xavier"], "init_type", "xavier"),
    (["--init_type", "orthogonal"], "init_type", "orthogonal"),
], ids=lambda v: "_".join(v) if isinstance(v, list) else None)
def test_zoo_switches_parse(tmp_path, argv, key, value):
    """The zoo's flags (ROADMAP queue A item 14) are ported: they parse."""
    opt = TrainOptions().parse(argv=["--checkpoints_dir", str(tmp_path)] + argv)
    assert getattr(opt, key) == value


@pytest.mark.parametrize("argv", [
    ["--model", "cycle_gan"],
    ["--dataset_mode", "unaligned"],
    ["--inception_weights", "random"],
], ids=lambda v: "_".join(v))
def test_items_15_and_16_parse_and_build(tmp_path, argv):
    """ROADMAP items 15 (CycleGAN, the unaligned dataset) and 16 (FID/KID)
    are ported: each flag parses and builds what it names on the CPU."""
    import numpy as np
    from PIL import Image

    from dsgan_tpu_torch.data import CreateDataLoader
    from dsgan_tpu_torch.models import create_model

    base = ["--checkpoints_dir", str(tmp_path), "--platform", "cpu", "--dtype", "float32"]
    if argv[0] == "--model":
        opt = TrainOptions().parse(argv=base + argv + ["--which_model_netG", "resnet_6blocks",
                                                       "--ngf", "8", "--ndf", "8"])
        assert (opt.lambda_A, opt.lambda_B, opt.lambda_identity) == (10.0, 10.0, 0.5)
        model = create_model(opt)
        assert model.name() == "CycleGANModel" and model.cfg.gan_mode == "lsgan"
        assert sorted(model._networks()) == ["D_A", "D_B", "G_A", "G_B"]
    elif argv[0] == "--dataset_mode":
        for side in "AB":
            (tmp_path / f"train{side}").mkdir()
            Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / f"train{side}" / "x.png")
        opt = TrainOptions().parse(argv=base + argv + ["--dataroot", str(tmp_path), "--phase",
                                                       "train"])
        assert CreateDataLoader(opt, "train").dataset.name() == "UnalignedDataset"
    else:
        opt = TestOptions().parse(argv=base + argv)
        assert opt.inception_weights == "random"
        from dsgan_tpu_torch.models.inception import make_feature_accumulators

        acc = make_feature_accumulators(opt.inception_weights, batch=2, device="cpu")()
        acc.add(np.zeros((16, 16, 3), np.uint8))
        assert acc.result().shape == (1, 2048)


@pytest.mark.parametrize("kind", ["train", "test"])
def test_cyclegan_flags_match_jax(kind):
    from dsgan_tpu.models.cycle_gan import CycleGANModel as JaxCycleGANModel
    from dsgan_tpu_torch.models.cycle_gan import CycleGANModel

    port, jax_ = (TrainOptions(), JaxTrainOptions()) if kind == "train" else \
        (TestOptions(), JaxTestOptions())
    got = _actions(port, CycleGANModel, kind == "train")
    want = _actions(jax_, JaxCycleGANModel, kind == "train")
    assert sorted(got) == sorted(want)
    for dest, w in want.items():
        g = got[dest]
        assert (g.option_strings, g.default, g.type) == (w.option_strings, w.default, w.type), dest


def test_defaults_and_one_device_values_parse(tmp_path):
    opt = TrainOptions().parse(argv=["--checkpoints_dir", str(tmp_path), "--data_axis", "1",
                                     "--which_model_netD", "n_layers", "--platform", "cpu"])
    assert opt.data_axis == 1 and opt.platform == "cpu" and opt.native_loader == "auto"


def _schedules(policy, metrics, **kw):
    """The LR after each of 25 epoch ends, port and JAX, from one opt."""
    opt = dict(isTrain=True, checkpoints_dir="unused", name="x", lr=2e-4, lr_policy=policy,
               lr_decay_iters=4, niter=10, niter_decay=10, epoch_count=1, data_axis=1,
               platform="cpu")
    opt.update(kw)
    out = []
    for cls in (BaseModel, JaxBaseModel):
        m = cls()
        m.initialize(types.SimpleNamespace(**opt))
        m._set_lr_from_schedule()
        lrs = [m.lr]
        for v in metrics:
            m.update_learning_rate(v)
            lrs.append(m.lr)
        out.append(lrs)
    return out


@pytest.mark.parametrize("policy,kw", [
    ("lambda", {}), ("lambda", dict(epoch_count=3, niter=5, niter_decay=20)),
    ("step", {}), ("plateau", {})], ids=["lambda", "lambda_epoch_count", "step", "plateau"])
def test_lr_schedule_matches_jax_over_25_epochs(policy, kw):
    metrics = [1.0, 0.5, 0.51, 0.52, 0.50, 0.505, 0.51, 0.52, 0.53, 0.54, 0.2, 0.21, 0.22,
               0.23, 0.24, 0.25, 0.26, 0.27, 0.28, 0.29, 0.3, 0.31, 0.32, 0.33, 0.34]
    got, want = _schedules(policy, metrics, **kw)
    assert len(got) == 26 and got == want
    assert len(set(got)) > 1  # the schedule moved

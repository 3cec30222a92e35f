"""The pix2pix step on the zoo against dsgan_tpu's ``make_train_step`` on the
CPU at f32: resnet_6blocks (ngf 8) with ``--norm batch`` against the
multiscale D (ndf 8), pool 0, dropout off, VGG off, two steps from one set
of weights. D runs on the fake batch and then the real one
(``fuse_d_batch`` off under BatchNorm). Every loss agrees to 1e-4 and the
BatchNorm running statistics of G and D after the steps match JAX's.
Also: one step updates G's statistics once and D's three times; dropout
draws from the state's generator; the options take the zoo's flags, on
the spatial axis too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsgan_tpu.models import define_D as jax_define_D
from dsgan_tpu.models import define_G as jax_define_G
from dsgan_tpu.models import pix2pix as jax_pix2pix
from dsgan_tpu_torch.models import define_D, define_G, registry
from dsgan_tpu_torch.models.layers import BatchNorm2d, Dropout
from dsgan_tpu_torch.models.pix2pix import Pix2PixConfig, init_state, make_train_step
from dsgan_tpu_torch.options.test_options import TestOptions
from dsgan_tpu_torch.options.train_options import TrainOptions
from dsgan_tpu_torch.utils.convert import flatten, jax_from_state_dict

LR = 2e-4
SIZE, BATCH, NGF, NDF = 32, 2, 8, 8
LOSSES = ("loss_D", "loss_D_fake", "loss_D_real", "loss_G_GAN", "loss_G_L1", "loss_tv",
          "loss_ssim", "loss_G")


def _nets(use_dropout=False):
    G = define_G(3, 3, NGF, "resnet_6blocks", norm="batch", use_dropout=use_dropout,
                 dtype=torch.float32, device="cpu", seed=21, train=True)
    D = define_D(6, NDF, "multi", norm="batch", dtype=torch.float32, device="cpu", seed=22)
    return G, D


def _entries():
    return (registry.generator_entries(3, 3, NGF, "resnet_6blocks", "batch"),
            registry.discriminator_entries(6, NDF, "multi", 3, "batch"))


def _batch():
    rng = np.random.default_rng(23)
    return [rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8) for _ in range(2)]


@pytest.fixture(scope="module")
def two_steps():
    G, D = _nets()
    eg, ed = _entries()
    pg, sg = jax_from_state_dict(G.state_dict(), eg)
    pd, sd = jax_from_state_dict(D.state_dict(), ed)
    a, b = _batch()

    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    jcfg = jax_pix2pix.Pix2PixConfig(pool_size=0, use_vgg=False, compute_dtype=None,
                                     fuse_d_batch=False)
    jg = jax_define_G(3, 3, NGF, "resnet_6blocks", "batch", False, dtype=None)
    jd = jax_define_D(6, NDF, "multi", 3, "batch", False, dtype=None)
    adam = jax_pix2pix.make_adam(jcfg.beta1)
    jstate = jax_pix2pix.Pix2PixState(
        params_G=as_jax(pg), params_D=as_jax(pd), opt_G=adam.init(as_jax(pg)),
        opt_D=adam.init(as_jax(pd)), pool_images=jnp.zeros((1,)),
        pool_count=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
        step=jnp.zeros((), jnp.int32), stats_G=as_jax(sg), stats_D=as_jax(sd))
    jstep = jax.jit(jax_pix2pix.make_train_step(jg, jd, None, None, jcfg))

    cfg = Pix2PixConfig(pool_size=0, use_vgg=False, compute_dtype=None, fuse_d_batch=False)
    state = init_state(G, D, None, cfg, (SIZE, SIZE))
    step = make_train_step(cfg)
    jmetrics, metrics = [], []
    for _ in range(2):
        jstate, jm, _ = jstep(jstate, jnp.asarray(a), jnp.asarray(b), jnp.float32(LR))
        jmetrics.append({k: float(v) for k, v in jm.items()})
        m, _ = step(state, torch.from_numpy(a), torch.from_numpy(b), LR)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(jmetrics=jmetrics, metrics=metrics, jstate=jstate, state=state)


@pytest.mark.parametrize("it", [0, 1], ids=["step1", "step2"])
def test_zoo_step_losses_match_jax(two_steps, it):
    got, want = two_steps["metrics"][it], two_steps["jmetrics"][it]
    assert set(LOSSES) <= set(got)
    for k in LOSSES:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-4), (it, k, got[k], want[k])


@pytest.mark.parametrize("net", ["G", "D"])
def test_zoo_step_batchnorm_stats_match_jax(two_steps, net):
    state, jstate = two_steps["state"], two_steps["jstate"]
    eg, ed = _entries()
    module, entries, jstats = ((state.netG, eg, jstate.stats_G) if net == "G"
                               else (state.netD, ed, jstate.stats_D))
    _, got = jax_from_state_dict(module.state_dict(), entries)
    got, want = flatten(got), flatten(jax.tree_util.tree_map(np.asarray, jstats))
    assert set(got) == set(want) and got
    for k in want:
        # The multiscale D's convs keep their biases under BatchNorm, whose
        # gradient is then f32 noise: Adam moves such a bias by about +-lr
        # a step whatever the noise's sign, so the two packages' biases may
        # sit up to 2 lr apart after step 1 and 4 lr after step 2. A running
        # mean takes 0.1 of the batch mean (bias included) at each of D's 4
        # updates after the first D step: at most 0.1 * (2 + 2 + 2 + 4) lr
        # = lr apart. The variances do not see the bias.
        atol = LR if net == "D" and k.endswith("/mean") else 1e-5
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=atol, err_msg=k)
    # the two steps moved them off their start values
    assert any(not np.allclose(v, 0.0) and not np.allclose(v, 1.0) for v in got.values())


def test_step_updates_g_stats_once_and_d_stats_three_times():
    """Train-mode forwards of each BatchNorm in one step: G's forward, and
    D on the fake batch, the real batch and in the G loss; the pool, the
    metrics and the outputs run none."""
    G, D = _nets()
    cfg = Pix2PixConfig(pool_size=4, use_vgg=False, compute_dtype=None, fuse_d_batch=False)
    state = init_state(G, D, None, cfg, (SIZE, SIZE))
    counts = {"G": 0, "D": 0}
    for name, net in (("G", G), ("D", D)):
        first = next(m for m in net.modules() if isinstance(m, BatchNorm2d))

        def hook(mod, args, name=name):
            counts[name] += int(mod.training)

        first.register_forward_pre_hook(hook)
    a, b = _batch()
    make_train_step(cfg)(state, torch.from_numpy(a), torch.from_numpy(b), LR)
    assert counts == {"G": 1, "D": 3}


def test_dropout_draws_from_the_state_generator():
    G, D = _nets(use_dropout=True)
    cfg = Pix2PixConfig(pool_size=0, use_vgg=False, compute_dtype=None, fuse_d_batch=False)
    state = init_state(G, D, None, cfg, (SIZE, SIZE), seed=5)
    drops = [m for m in G.modules() if isinstance(m, Dropout)]
    assert len(drops) == 6 and all(m.generator is state.dropout for m in drops)
    x = torch.from_numpy(_batch()[0]).permute(0, 3, 1, 2).float() / 127.5 - 1.0
    start = state.dropout.get_state()
    with torch.no_grad():
        y1, y2 = G(x), G(x)
        state.dropout.set_state(start)
        y3 = G(x)
        G.eval()
        y4, y5 = G(x), G(x)
    assert not torch.equal(y1, y2) and torch.equal(y1, y3) and torch.equal(y4, y5)
    assert "dropout_generator" in state.state_dict()


def test_options_take_the_zoo_flags_and_refuse_later_items(tmp_path):
    zoo = ["--norm", "batch", "--which_model_netG", "resnet_9blocks", "--which_model_netD",
           "multi", "--init_type", "kaiming", "--checkpoints_dir", str(tmp_path)]
    for opts in (TrainOptions, TestOptions):
        opt = opts().parse(argv=zoo)
        assert (opt.norm, opt.which_model_netG, opt.which_model_netD, opt.init_type) == \
            ("batch", "resnet_9blocks", "multi", "kaiming")
    # the spatial axis runs the zoo too
    assert TrainOptions().parse(argv=zoo + ["--spatial_axis", "2"]).spatial_axis == 2
    # items 15 and 16 are ported: CycleGAN, the unaligned dataset and FID/KID parse
    opt = TrainOptions().parse(argv=zoo + ["--model", "cycle_gan", "--dataset_mode", "unaligned"])
    assert (opt.model, opt.dataset_mode, opt.lambda_identity) == ("cycle_gan", "unaligned", 0.5)
    assert TestOptions().parse(argv=zoo + ["--inception_weights", "random"]).inception_weights \
        == "random"

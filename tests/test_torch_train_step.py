"""The port's pix2pix train step (dsgan_tpu_torch.models.pix2pix) against the
JAX package's ``make_train_step`` on the CPU at f32, and the weight
carry-over of the discriminator and the VGG features.

Setup: the full-width MixConvNeXtML at 32x32, batch 2, PatchGAN ndf 8,
pool 0, VGG on, every net's random weights shared (numpy-seeded in the
port's init, carried into JAX as its own tree). Two consecutive steps:
every loss component agrees to 1e-4, and after the steps the parameters
agree except on under 0.1% of coordinates, which may sit up to 2 * lr
apart: after a step Adam's update is about -lr * sign(grad) wherever
|grad| >> eps, so a coordinate whose gradient is f32 reassociation noise
may legitimately flip (the argument of tests/test_torch_step_parity.py).
f32 "auto" GELU is erf on both sides, as the JAX package's XLA block path
computes it on the CPU.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsgan_tpu.models import define_D as jax_define_D
from dsgan_tpu.models import define_G as jax_define_G
from dsgan_tpu.models import pix2pix as jax_pix2pix
from dsgan_tpu.models.vgg import Vgg16Features as JaxVgg
from dsgan_tpu.models.vgg import load_torchvision_npz
from dsgan_tpu.utils.pth_convert import convert_nlayer_discriminator
from dsgan_tpu_torch.models import (
    define_D,
    define_G,
    define_vgg,
    init_d_params,
    init_params,
    init_vgg_params,
)
from dsgan_tpu_torch.models.pix2pix import Pix2PixConfig, init_state, make_train_step
from dsgan_tpu_torch.utils.convert import (
    d_state_dict_from_jax,
    flatten,
    nlayer_entries,
    state_dict_from_jax,
    vgg_state_dict_from_jax,
)

LR = 2e-4
SIZE, BATCH, NDF = 32, 2, 8
LOSSES = ("loss_D", "loss_D_fake", "loss_D_real", "loss_G_GAN", "loss_G_L1", "loss_vgg",
          "loss_tv", "loss_ssim", "loss_G")


def test_discriminator_state_dict_round_trips_through_the_jax_converter(tmp_path):
    params = init_d_params(6, NDF, 3, seed=4)
    net = define_D(6, NDF, "basic", dtype=torch.float32, device="cpu", params=params)
    assert [k.rsplit(".", 1)[0] for k in net.state_dict()][::2] == \
        [e[0] for e in nlayer_entries(3)] == ["model.0", "model.2", "model.5", "model.8", "model.11"]
    npz = tmp_path / "d.npz"
    np.savez(npz, **{k: v.numpy() for k, v in net.state_dict().items()})
    back, want = flatten(convert_nlayer_discriminator(str(npz))), flatten(params)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(back[k]), want[k], err_msg=k)
    sd = d_state_dict_from_jax(params)
    assert all(torch.equal(sd[k], v) for k, v in net.state_dict().items())


def test_vgg_state_dict_round_trips_through_load_torchvision_npz(tmp_path):
    params = init_vgg_params(num_taps=5, seed=6)
    net = define_vgg(num_taps=5, dtype=torch.float32, device="cpu", params=params)
    npz = tmp_path / "vgg16.npz"
    np.savez(npz, **{k: v.numpy() for k, v in net.state_dict().items()})
    back, want = flatten(load_torchvision_npz(str(npz))["params"]), flatten(params)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(back[k]), want[k], err_msg=k)
    # the 4-tap extractor the loss uses takes the first ten convs of the same tree
    sd = vgg_state_dict_from_jax(params, num_convs=10)
    four = define_vgg(num_taps=4, dtype=torch.float32, device="cpu", params=params)
    assert sorted(sd) == sorted(four.state_dict())


def test_vgg_and_discriminator_match_jax():
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, 6)).astype(np.float32)
    dp, vp = init_d_params(6, NDF, 3, seed=1), init_vgg_params(4, seed=2)
    jd = jax_define_D(6, NDF, "basic", dtype=None)
    want_d = jd.apply({"params": jax.tree_util.tree_map(jnp.asarray, dp)}, jnp.asarray(x))
    want_v = JaxVgg(dtype=None, num_taps=4).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, vp)}, jnp.asarray(x[..., :3]))
    d = define_D(6, NDF, "basic", dtype=torch.float32, device="cpu", params=dp)
    v = define_vgg(4, dtype=torch.float32, device="cpu", params=vp)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got_d, got_v = d(xt), v(xt[:, :3])
    np.testing.assert_allclose(got_d.permute(0, 2, 3, 1).numpy(), np.asarray(want_d),
                               rtol=1e-4, atol=1e-6)
    assert len(got_v) == len(want_v) == 4
    for g, w in zip(got_v, want_v):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-7)


@pytest.fixture(scope="module")
def two_steps():
    """Both packages' two consecutive steps from one set of weights, on one
    uint8 batch; the JAX step is jitted once."""
    pg, pd, pv = init_params(13), init_d_params(6, NDF, 3, seed=14), init_vgg_params(4, seed=15)
    rng = np.random.default_rng(16)
    a = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)

    jcfg = jax_pix2pix.Pix2PixConfig(pool_size=0, use_vgg=True, compute_dtype=None)
    g = jax_define_G(3, 3, 32, "MixConvNeXtML", dtype=None)
    d = jax_define_D(6, NDF, "basic", dtype=None)
    vgg = JaxVgg(dtype=None, num_taps=4)
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    adam = jax_pix2pix.make_adam(jcfg.beta1)
    jstate = jax_pix2pix.Pix2PixState(
        params_G=as_jax(pg), params_D=as_jax(pd), opt_G=adam.init(as_jax(pg)),
        opt_D=adam.init(as_jax(pd)), pool_images=jnp.zeros((1,)),
        pool_count=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
        step=jnp.zeros((), jnp.int32))
    jstep = jax.jit(jax_pix2pix.make_train_step(g, d, vgg, {"params": as_jax(pv)}, jcfg))

    cfg = Pix2PixConfig(pool_size=0, use_vgg=True, compute_dtype=None)
    G = define_G(3, 3, 32, "MixConvNeXtML", dtype=torch.float32, device="cpu", params=pg,
                 train=True)
    D = define_D(6, NDF, "basic", dtype=torch.float32, device="cpu", params=pd)
    V = define_vgg(4, dtype=torch.float32, device="cpu", params=pv)
    state = init_state(G, D, V, cfg, (SIZE, SIZE))
    step = make_train_step(cfg)

    jmetrics, metrics = [], []
    for _ in range(2):
        jstate, jm, jfake = jstep(jstate, jnp.asarray(a), jnp.asarray(b), jnp.float32(LR))
        jmetrics.append({k: float(v) for k, v in jm.items()})
        m, fake = step(state, torch.from_numpy(a), torch.from_numpy(b), LR)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(jmetrics=jmetrics, metrics=metrics, jstate=jstate, state=state,
                jfake=np.asarray(jfake), fake=fake.numpy())


@pytest.mark.parametrize("it", [0, 1], ids=["step1", "step2"])
def test_train_step_losses_match_jax(two_steps, it):
    got, want = two_steps["metrics"][it], two_steps["jmetrics"][it]
    assert set(LOSSES) <= set(got) and set(got) == set(want)
    for k in LOSSES:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-4), (it, k, got[k], want[k])
    # the uint8 metrics of a float fake: a level boundary may flip a floor
    assert got["psnr"] == pytest.approx(want["psnr"], rel=1e-3)
    assert got["ssim"] == pytest.approx(want["ssim"], abs=1e-3)


def test_train_step_fake_matches_jax(two_steps):
    assert two_steps["fake"].shape == (BATCH, SIZE, SIZE, 3)
    np.testing.assert_allclose(two_steps["fake"], two_steps["jfake"], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("net", ["G", "D"])
def test_train_step_parameters_match_jax_after_two_steps(two_steps, net):
    state, jstate = two_steps["state"], two_steps["jstate"]
    if net == "G":
        module, jtree, entries = state.netG, jstate.params_G, None
    else:
        module, jtree, entries = state.netD, jstate.params_D, nlayer_entries(3)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jtree), entries)
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    total = mismatched = 0
    worst = 0.0
    for k, w in want.items():
        diff = (got[k].double() - w.double()).abs()
        total += diff.numel()
        mismatched += int((diff > 0.5 * LR).sum())
        worst = max(worst, float(diff.max()))
    assert mismatched / total < 1e-3, f"{net}: {mismatched} of {total} off by > lr / 2"
    assert worst <= 2.2 * 2 * LR, f"{net}: worst |delta| {worst}"
    # and the steps moved the weights at all
    start = init_params(13) if net == "G" else init_d_params(6, NDF, 3, seed=14)
    moved = state_dict_from_jax(start, entries)
    assert any(not torch.equal(moved[k], got[k]) for k in got)


def test_bench_cli_prints_one_json_line(monkeypatch, capsys):
    from dsgan_tpu_torch import bench

    for k, v in (("BENCH_BATCH", "2"), ("BENCH_STEPS", "1"), ("BENCH_SIZE", "32")):
        monkeypatch.setenv(k, v)
    bench.main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "train_images_per_sec" and line["unit"] == "img/s"
    assert line["device"] == "cpu" and line["card"] is None and line["value"] > 0
    assert line["batch"] == 2 and line["size"] == 32 and np.isfinite(line["loss_G"])


def test_bench_default_device_needs_a_card():
    from dsgan_tpu_torch import bench

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])

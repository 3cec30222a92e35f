"""The port's CycleGAN step (dsgan_tpu_torch.models.cycle_gan) against the
JAX package's ``make_cyclegan_step`` on the CPU at f32, from carried
weights, consecutive steps on one uint8 batch pair: MixConvNeXtML G_A /
G_B at full width, 32x32, batch 1, PatchGAN ndf 8, LSGAN,
``lambda_identity`` 0.5, pool 0, two steps. Every loss agrees to 1e-4; the
four nets' parameters agree except on under 0.1% of coordinates, which
may sit up to 2 * lr a step apart (Adam's update is about -lr *
sign(grad), so a coordinate whose gradient is f32 reassociation noise may
flip: the argument of tests/test_torch_train_step.py). rec_A =
G_B(fake_B) sends G_B's input gradient (the autograd Functions' c1 ``dx``
and folded ``dn``) into G_A's backward, so this is the CPU proof of that
chain. ``tests/test_torch_cyclegan_zoo.py`` holds BatchNorm and the pools
with the helpers here.

The JAX step is jitted once per recipe; its weights come from the port's
numpy init (``jax_from_state_dict``), not JAX's jitted init.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsgan_tpu.models import define_D as jax_define_D
from dsgan_tpu.models import define_G as jax_define_G
from dsgan_tpu.models import cycle_gan as jax_cycle_gan
from dsgan_tpu.utils.image_pool import init_pool
from dsgan_tpu_torch.models import define_D, define_G, registry
from dsgan_tpu_torch.models.cycle_gan import CycleGANConfig, init_state, make_cyclegan_step
from dsgan_tpu_torch.utils.convert import cyclegan_state_from_jax, jax_from_state_dict

LR = 2e-4
SIZE, NDF = 32, 8
LOSSES = ("loss_G", "loss_G_A", "loss_G_B", "loss_cycle_A", "loss_cycle_B", "loss_idt_A",
          "loss_idt_B", "loss_tv", "loss_D_A", "loss_D_B")
RECIPES = {
    "mixconvnext": dict(netG="MixConvNeXtML", ngf=32, norm="instance", batch=1, pool=0,
                        steps=2),
    # the third step meets full pools: the swap draws, JAX's, handed in
    "resnet_batchnorm_pool": dict(netG="resnet_6blocks", ngf=8, norm="batch", batch=2, pool=4,
                                  steps=3),
}
NETS = ("netG_A", "netG_B", "netD_A", "netD_B")


def _entries(r):
    return (registry.generator_entries(3, 3, r["ngf"], r["netG"], r["norm"]),
            registry.discriminator_entries(3, NDF, "basic", 3, r["norm"]))


def _jax_draws(rng, n, pool_size):
    """The swap coin and the index JAX's pool_query draws for element i."""
    coins, idx = [], []
    for i in range(n):
        k_p, k_idx = jax.random.split(jax.random.fold_in(rng, i))
        coins.append(float(jax.random.uniform(k_p)))
        idx.append(int(jax.random.randint(k_idx, (), 0, pool_size)))
    return torch.tensor(coins), torch.tensor(idx)


def _run(name):
    """Both packages' steps of a recipe from one set of weights; under
    BatchNorm each step's running statistics, both sides."""
    r = RECIPES[name]
    b = r["batch"]
    nets = [define_G(3, 3, r["ngf"], r["netG"], norm=r["norm"], dtype=torch.float32,
                     device="cpu", seed=40 + i, train=True) for i in range(2)]
    nets += [define_D(3, NDF, "basic", norm=r["norm"], dtype=torch.float32, device="cpu",
                      seed=42 + i) for i in range(2)]
    eg, ed = _entries(r)
    trees = [jax_from_state_dict(n.state_dict(), e) for n, e in zip(nets, (eg, eg, ed, ed))]
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t) if t else None  # noqa: E731
    params = [as_jax(p) for p, _ in trees]
    stats = [as_jax(s) for _, s in trees]

    jcfg = jax_cycle_gan.CycleGANConfig(gan_mode="lsgan", pool_size=r["pool"])
    jg = jax_define_G(3, 3, r["ngf"], r["netG"], r["norm"], False, dtype=None)
    jd = jax_define_D(3, NDF, "basic", 3, r["norm"], False, dtype=None)
    adam = jax_cycle_gan.make_adam(jcfg.beta1)
    pool = init_pool(max(r["pool"], 0), (SIZE, SIZE, 3))
    jstate = jax_cycle_gan.CycleGANState(
        params_G_A=params[0], params_G_B=params[1], params_D_A=params[2], params_D_B=params[3],
        opt_G=adam.init((params[0], params[1])), opt_D=adam.init((params[2], params[3])),
        pool_A_images=pool[0], pool_A_count=pool[1], pool_B_images=pool[0],
        pool_B_count=pool[1], rng=jax.random.PRNGKey(3), step=jnp.zeros((), jnp.int32),
        stats_G_A=stats[0], stats_G_B=stats[1], stats_D_A=stats[2], stats_D_B=stats[3])
    jstep = jax.jit(jax_cycle_gan.make_cyclegan_step(jg, jg, jd, jd, jcfg))

    cfg = CycleGANConfig(gan_mode="lsgan", pool_size=r["pool"])
    state = init_state(*nets, cfg, (SIZE, SIZE))
    step = make_cyclegan_step(cfg)
    rng = np.random.default_rng(44)
    a = rng.integers(0, 256, (b, SIZE, SIZE, 3), dtype=np.uint8)
    bb = rng.integers(0, 256, (b, SIZE, SIZE, 3), dtype=np.uint8)
    out = dict(jmetrics=[], metrics=[], entries=(eg, ed), stats=[])
    for _ in range(r["steps"]):
        if r["pool"]:
            _, key_a, key_b, _ = jax.random.split(jstate.rng, 4)
            da, db = _jax_draws(key_a, b, r["pool"]), _jax_draws(key_b, b, r["pool"])
            state.pool_A.draws = lambda n, d=da: d
            state.pool_B.draws = lambda n, d=db: d
        jstate, jm, jvis = jstep(jstate, jnp.asarray(a), jnp.asarray(bb), jnp.float32(LR))
        out["jmetrics"].append({k: float(v) for k, v in jm.items()})
        m, vis = step(state, torch.from_numpy(a), torch.from_numpy(bb), LR)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if r["norm"] == "batch":
            jst = (jstate.stats_G_A, jstate.stats_G_B, jstate.stats_D_A, jstate.stats_D_B)
            out["stats"].append((jax.tree_util.tree_map(np.asarray, jst), [
                {k: v.clone() for k, v in getattr(state, n).state_dict().items()
                 if "running_" in k} for n in NETS]))
    out.update(jstate=jstate, state=state, jvis=jvis, vis=vis)
    return out


@pytest.fixture(scope="module")
def runs():
    return {}


def _get(runs, name):
    if name not in runs:
        runs[name] = _run(name)
    return runs[name]


def check_losses(run):
    """Every loss of every step to 1e-4, the uint8 metrics to a level."""
    for it, (got, want) in enumerate(zip(run["metrics"], run["jmetrics"])):
        assert set(got) == set(want)
        for k in LOSSES:
            assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-4), (it, k, got[k], want[k])
        assert got["psnr"] == pytest.approx(want["psnr"], rel=1e-3)
        assert got["ssim"] == pytest.approx(want["ssim"], abs=1e-3)


def test_cyclegan_losses_match_jax(runs):
    check_losses(_get(runs, "mixconvnext"))


def check_parameters(run):
    """All four nets after the steps, carried back through
    ``cyclegan_state_from_jax``: under 0.1% of the four nets' coordinates
    together more than lr / 2 apart, none more than 2 lr a step. At 32x32
    the mismatches sit in D's middle-conv biases (an InstanceNorm follows
    each: their gradient is zero in exact arithmetic) and in the CBAM
    channel-attention weights of the local stream's deepest levels."""
    state, js = run["state"], run["jstate"]
    eg, ed = run["entries"]
    tree = jax.tree_util.tree_map(np.asarray, (js.params_G_A, js.params_G_B, js.params_D_A,
                                               js.params_D_B))
    want = cyclegan_state_from_jax(*tree, g_entries=eg, d_entries=ed)
    steps = len(run["metrics"])
    total = mismatched = 0
    for net in NETS:
        got = getattr(state, net).state_dict()
        worst = 0.0
        for k, w in want[net].items():
            if "running_" in k:
                continue
            diff = (got[k].double() - w.double()).abs()
            total += diff.numel()
            mismatched += int((diff > 0.5 * LR).sum())
            worst = max(worst, float(diff.max()))
        assert worst <= 1.1 * 2 * LR * steps, f"{net}: worst |delta| {worst}"
    assert mismatched / total < 1e-3, f"{mismatched} of {total} off by > lr / 2"


def test_cyclegan_parameters_match_jax(runs):
    check_parameters(_get(runs, "mixconvnext"))


def test_cyclegan_visuals_match_jax(runs):
    run = _get(runs, "mixconvnext")
    for i, k in enumerate(("fake_B", "rec_A", "fake_A", "rec_B")):
        np.testing.assert_allclose(run["vis"][..., 3 * i:3 * i + 3].numpy(),
                                   np.asarray(run["jvis"][k]), rtol=1e-3, atol=1e-4, err_msg=k)


def test_g_loss_gives_the_discriminators_no_gradient():
    """The G pass differentiates the generators alone: after the step D's
    gradients are those of the D loss, with D frozen at its start values
    the D step's gradient equals a fresh D-loss gradient."""
    r = RECIPES["resnet_batchnorm_pool"]
    cfg = CycleGANConfig(pool_size=0)
    nets = [define_G(3, 3, r["ngf"], r["netG"], dtype=torch.float32, device="cpu", seed=i,
                     train=True) for i in range(2)]  # instance norm
    nets += [define_D(3, NDF, "basic", dtype=torch.float32, device="cpu", seed=2 + i)
             for i in range(2)]
    state = init_state(*nets, cfg, (SIZE, SIZE))
    d0 = {k: v.clone() for k, v in state.netD_A.state_dict().items()}
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8))
            for _ in range(2))
    state.opt_D.step = lambda: None  # keep D at its start values
    _, vis = make_cyclegan_step(cfg)(state, a, b, LR)
    got = {k: p.grad.clone() for k, p in state.netD_A.named_parameters()}
    from dsgan_tpu_torch import ops
    from dsgan_tpu_torch.models.pix2pix import images

    D = state.netD_A
    D.load_state_dict(d0)
    D.zero_grad(set_to_none=True)
    fake_B = vis[..., :3].permute(0, 3, 1, 2)
    real_B = images(b, None)
    loss = 0.5 * (ops.gan_loss(D(real_B), True, "lsgan") + ops.gan_loss(D(fake_B), False, "lsgan"))
    loss.backward()
    for k, p in D.named_parameters():
        torch.testing.assert_close(got[k], p.grad, rtol=1e-5, atol=1e-7)

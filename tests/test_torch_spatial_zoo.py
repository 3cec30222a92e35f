"""The rest of the zoo on the spatial axis on the CPU: image rows over gloo
ranks, spawned, f32, batch 1, pool 0, no VGG, dropout off, one pix2pix
step a recipe.

  * every generator and discriminator the earlier spatial files leave out,
    in pairs that cover them all: unet_128 (ngf 4, 128x128) against the
    ``pixel`` D, cascaded (ngf 2), unetpp (ngf 8: CBAM divides it by 8) and
    wnet under ``--norm batch`` (ngf 4, the D's BatchNorm too, D on the
    fake and the real batch apart) against the ``basic`` PatchGAN, gll (ngf
    4) against the ``multi`` D, the rest at 64x64, D ndf 8; unet_256 is
    unet_128's class with one more level (``chip_smoke.py``'s spatial phase
    runs it at 512x512). Each over ``data 1 x spatial 2`` and ``data 1 x
    spatial 4`` against the port's one process: the losses within the JAX
    suite's spatial bounds (``tests/test_parallel.py:128-129``), the ranks'
    states bit for bit, and every first-step weight gradient (and each
    net's biases and slopes, as one vector) within rel-L2 1e-5, or within
    twice the larger distance to one process of its two floors where that
    is larger: one process summing every cross-row sum over the strips' row
    blocks (``chip_smoke._row_halves``), and one process at another thread
    count. Where a gradient cancels through a norm or between the fake and
    the real batch (a U-Net's deep down convs, the pixel D's logit bias)
    those orders alone move it 1e-5 to 1e-4 in f32; with the statistics in
    f64 the strips read under 2e-7 against one process. The
    levels that stop splitting run whole: the U-Net's innermost ones,
    cascaded's coarsest pyramid levels, the multiscale D's odd heights;
  * the U-Net and cascaded recipes over ``spatial 2`` against JAX's
    single-device ``make_train_step`` on the weights carried across
    (``utils/convert.py``), the losses at the same bounds.

All of each rank count's runs take one spawn (``zoo_runs``).
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from dsgan_tpu_torch.kernels import block_core as bc
from dsgan_tpu_torch.models import define_D, define_G, pix2pix, registry
from dsgan_tpu_torch.models.layers import set_batchnorm_mesh
from dsgan_tpu_torch.parallel import multihost, resolve_mesh, shard_batch
from tests.test_torch_spatial_cyclegan import (
    TIMEOUT,
    check_losses,
    digest,
    other_threads,
    ranks_identical,
    rel_l2,
)

F32 = dict(dtype=torch.float32, device="cpu")
LR = 2e-4
STEPS = 1
NDF = 8
LOSSES = ("loss_G", "loss_D", "loss_D_fake", "loss_D_real", "loss_G_GAN", "loss_G_L1",
          "loss_tv", "loss_ssim")
RECIPES = {
    "unet_128_pixel": dict(netG="unet_128", netD="pixel", ngf=4, size=128),
    "gll_multi": dict(netG="gll", netD="multi", ngf=4, size=64),
    "cascaded_basic": dict(netG="cascaded", netD="basic", ngf=2, size=64),
    "unetpp_basic": dict(netG="unetpp", netD="basic", ngf=8, size=64),
    "wnet_batch_basic": dict(netG="wnet", netD="basic", ngf=4, size=64, norm="batch"),
}
JAX_RECIPES = ("unet_128_pixel", "cascaded_basic")


def _build(name, rows):
    r = RECIPES[name]
    norm = r.get("norm", "instance")
    G = define_G(3, 3, r["ngf"], r["netG"], norm=norm, seed=30, train=True, use_dropout=False,
                 **F32)
    D = define_D(6, NDF, r["netD"], norm=norm, seed=31, **F32)
    cfg = pix2pix.Pix2PixConfig(pool_size=0, use_vgg=False, w_vgg=0.0,
                                fuse_d_batch=norm != "batch")
    return pix2pix.init_state(G, D, None, cfg, (rows, r["size"]), seed=4), cfg


def _batches(name):
    size = RECIPES[name]["size"]
    rng = np.random.default_rng(len(name))
    return [rng.uniform(-1, 1, (1, size, size, 3)).astype(np.float32) for _ in range(2)]


def _run(name, mesh):
    """The steps on one batch pair on this rank's strip (the whole image
    without a mesh): (per-step metrics, first-step gradients, the state)."""
    state, cfg = _build(name, RECIPES[name]["size"] // (mesh.spatial if mesh else 1))
    if mesh is not None:
        for net in (state.netG, state.netD):
            set_batchnorm_mesh(net, mesh)
    step = pix2pix.make_train_step(cfg, mesh)
    a, b = _batches(name)
    if mesh is not None:
        a, b = shard_batch(a, mesh), shard_batch(b, mesh)
    a, b = torch.from_numpy(np.ascontiguousarray(a)), torch.from_numpy(np.ascontiguousarray(b))
    metrics, grads = [], None
    for _ in range(STEPS):
        m, _ = step(state, a, b, LR)
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = {n: {k: p.grad.clone() for k, p in net.named_parameters()
                         if p.grad is not None}
                     for n, net in (("netG", state.netG), ("netD", state.netD))}
    return metrics, grads, state.state_dict()


def _rank(rank, size, out):
    torch.set_num_threads(1)
    mesh = resolve_mesh(1, size, batch_size=1, height=64)
    runs = {}
    for name in RECIPES:
        metrics, grads, state = _run(name, mesh)
        runs[name] = (metrics, grads if rank == 0 else None, digest(state))
    torch.save(runs, f"{out}/rank{rank}.pt")


@pytest.fixture(scope="module")
def zoo_runs(tmp_path_factory):
    runs = {}
    for size in (2, 4):
        d = tmp_path_factory.mktemp(f"zoo{size}")
        multihost.spawn(_rank, size, (size, str(d)), timeout=TIMEOUT)
        runs[size] = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(size)]
    return runs


@functools.cache
def _one(name):
    """One process's run of a recipe, and the same at another thread count
    (a floor): once a recipe for both rank counts."""
    return _run(name, None), other_threads(_run, name, None)


def _blocks(name, size):
    """One process summing its cross-row sums over ``size`` row blocks: the
    floor's run."""
    patches = chip_smoke._row_halves(torch, bc, size)
    for p in patches:
        p.start()
    try:
        return _run(name, None)
    finally:
        for p in patches:
            p.stop()


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("name", list(RECIPES))
def test_zoo_step_on_strips_equals_one_process(zoo_runs, name, size):
    (want_m, want_g, _), threads = _one(name)
    floors = [_blocks(name, size)[1], threads[1]]
    ranks = [r[name] for r in zoo_runs[size]]
    assert all(r[0] == ranks[0][0] for r in ranks), "the ranks report different metrics"
    ranks_identical([r[2] for r in ranks])
    check_losses(ranks[0][0], want_m, LOSSES)
    got_g = ranks[0][1]
    for net, want in want_g.items():
        small = [k for k, w in want.items() if w.dim() < 2]
        vectors = {k: (lambda g, k=k: g[net][k]) for k, w in want.items() if w.dim() > 1}
        vectors["biases"] = lambda g: torch.cat([g[net][k].reshape(-1) for k in small])
        for k, get in vectors.items():
            got = rel_l2(get(got_g), get(want_g))
            limit = max(1e-5, 2 * max(rel_l2(get(f), get(want_g)) for f in floors))
            assert got <= limit, (net, k, got, limit)


def _jax_losses(name):
    """JAX's single-device pix2pix step (jitted) on the recipe's weights and
    batch pair: per-step metrics."""
    import jax
    import jax.numpy as jnp

    from dsgan_tpu.models import define_D as jax_define_D
    from dsgan_tpu.models import define_G as jax_define_G
    from dsgan_tpu.models import pix2pix as jax_pix2pix
    from dsgan_tpu_torch.utils.convert import jax_from_state_dict

    r = RECIPES[name]
    state, _ = _build(name, r["size"])
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    pg, _ = jax_from_state_dict(state.netG.state_dict(), registry.generator_entries(
        3, 3, r["ngf"], r["netG"], use_dropout=False))
    pd, _ = jax_from_state_dict(state.netD.state_dict(),
                                registry.discriminator_entries(6, NDF, r["netD"]))
    cfg = jax_pix2pix.Pix2PixConfig(pool_size=0, use_vgg=False, compute_dtype=None)
    adam = jax_pix2pix.make_adam(cfg.beta1)
    jstate = jax_pix2pix.Pix2PixState(
        params_G=as_jax(pg), params_D=as_jax(pd), opt_G=adam.init(as_jax(pg)),
        opt_D=adam.init(as_jax(pd)), pool_images=jnp.zeros((1,)),
        pool_count=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
        step=jnp.zeros((), jnp.int32))
    g = jax_define_G(3, 3, r["ngf"], r["netG"], "instance", False, dtype=None)
    d = jax_define_D(6, NDF, r["netD"], 3, "instance", False, dtype=None)
    step = jax.jit(jax_pix2pix.make_train_step(g, d, None, None, cfg))
    a, b = (jnp.asarray(v) for v in _batches(name))
    out = []
    for _ in range(STEPS):
        jstate, m, _ = step(jstate, a, b, jnp.float32(LR))
        out.append({k: float(v) for k, v in m.items()})
    return out


@pytest.mark.parametrize("name", JAX_RECIPES)
def test_zoo_spatial2_step_matches_jax(zoo_runs, name):
    check_losses(zoo_runs[2][0][name][0], _jax_losses(name), LOSSES)

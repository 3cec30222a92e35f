"""``--norm batch`` and ``--norm none`` on the spatial axis on the CPU:
image rows over gloo ranks, spawned, f32.

  * ``layers.BatchNorm2d`` on strips of 2 and 4 ranks against one process
    (forward, input and parameter gradients within rel-L2 1e-6, the
    running averages within 1e-6 and bit for bit across the ranks): on a
    strip, whose sums run over every rank and whose count is the global
    batch's B * H * W, and in a level every rank holds whole (the
    PatchGAN's stride-1 tail), whose sums run over the data group alone;
  * the pix2pix step on resnet_6blocks (ngf 8, dropout off) against the
    ``basic`` PatchGAN (ndf 8), 32x32, pool 0, no VGG, 2 steps: ``--norm
    batch`` (D on the fake and the real batch apart, ``fuse_d_batch`` off)
    over ``data 1 x spatial 2`` at batch 2 and ``--norm none`` over
    ``data 1 x spatial 4``, against the port's one process: the losses
    within the JAX suite's spatial bounds (``tests/test_parallel.py:
    128-129``), every first-step weight gradient within rel-L2 1e-5, the
    BatchNorm running averages within 1e-6, the ranks' states bit for bit;
  * ``--norm batch`` over ``data 2 x spatial 2`` at ``tests/mh_worker.py``'s
    recipe (batch 4) against JAX's single-device ``make_train_step`` on the
    weights carried across (``utils/convert.py``): the losses at the same
    bounds and the running averages at ``tests/test_torch_zoo_step.py``'s.

Every multi-rank run takes one spawn a rank count (``layer_runs``).
"""

import numpy as np
import pytest
import torch

from dsgan_tpu_torch.models import define_D, define_G, pix2pix, registry
from dsgan_tpu_torch.models.layers import BatchNorm2d, set_batchnorm_mesh
from dsgan_tpu_torch.parallel import multihost, resolve_mesh, shard_batch, spatial
from tests.test_torch_spatial_cyclegan import (
    TIMEOUT,
    check_gradients,
    check_losses,
    digest,
    other_threads,
    rel_l2,
    ranks_identical,
)

F32 = dict(dtype=torch.float32, device="cpu")
LR = 2e-4
SIZE = 32
LOSSES = ("loss_G", "loss_D", "loss_D_fake", "loss_D_real", "loss_G_GAN", "loss_G_L1",
          "loss_tv", "loss_ssim")


# -- the layer -----------------------------------------------------------------

def _layer_inputs():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 5, 16, 8)).astype(np.float32) * 2 + 0.5)
    g = torch.from_numpy(rng.standard_normal((2, 5, 16, 8)).astype(np.float32))
    return x, g


def _layer(mesh, whole):
    """BatchNorm2d in train mode on this rank's strip (``whole``: on the
    gathered image, as a level every rank holds whole), a cotangent's
    backward, twice (the running averages move twice): (output, input
    gradient, weight and bias gradients, running mean and variance)."""
    bn = BatchNorm2d(5)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 5))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, 5))
    set_batchnorm_mesh(bn, mesh)
    x, g = _layer_inputs()
    s = 1 if mesh is None else mesh.spatial
    if mesh is not None:
        x = x[:, :, mesh.strip(x.shape[2])]
        g = g if whole else g[:, :, mesh.strip(g.shape[2])]
    x = x.clone().requires_grad_(True)
    with spatial.rows(mesh):
        for _ in range(2):
            if whole and mesh is not None:
                xs = spatial.gather(x)
                with spatial.replicated():
                    y = bn(xs)
                loss = (y * g).sum() / s  # a value every rank holds whole: its share
            else:
                y = bn(x)
                loss = (y * g).sum()
            loss.backward()
    return (y.detach(), x.grad, bn.weight.grad, bn.bias.grad, bn.running_mean.clone(),
            bn.running_var.clone())


def _layer_rank(rank, size, out):
    """Every run of this file on ``size`` ranks, in one spawn: the layer on
    a strip and whole, the step of the recipe of that size
    (``STEP_RECIPES``), and on 4 ranks the batch_jax recipe over data 2 x
    spatial 2."""
    torch.set_num_threads(1)
    mesh = resolve_mesh(1, size, batch_size=2, height=16)
    res = {"layer": {w: _layer(mesh, w) for w in (False, True)}}
    name = STEP_RECIPES[size]
    res[name] = _run(name, resolve_mesh(1, size, batch_size=RECIPES[name]["batch"], height=SIZE))
    if size == 4:
        res["batch_jax"] = _run("batch_jax", resolve_mesh(2, 2, batch_size=4, height=SIZE))
    torch.save(res, f"{out}/rank{rank}.pt")


@pytest.fixture(scope="module")
def layer_runs(tmp_path_factory):
    runs = {}
    for size in (2, 4):
        d = tmp_path_factory.mktemp(f"bn{size}")
        multihost.spawn(_layer_rank, size, (size, str(d)), timeout=TIMEOUT)
        runs[size] = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(size)]
    return runs


@pytest.mark.parametrize("whole", [False, True], ids=["strip", "whole_level"])
@pytest.mark.parametrize("size", [2, 4])
def test_batchnorm_on_strips_equals_one_process(layer_runs, size, whole):
    want = _layer(None, False)
    ranks = [r["layer"][whole] for r in layer_runs[size]]
    y = ranks[0][0] if whole else torch.cat([r[0] for r in ranks], 2)
    assert rel_l2(y, want[0]) <= 1e-6
    assert rel_l2(torch.cat([r[1] for r in ranks], 2), want[1]) <= 1e-6
    for i in (2, 3):  # the parameters' gradients: partial sums over the ranks
        assert rel_l2(sum(r[i] for r in ranks), want[i]) <= 1e-6
    for i in (4, 5):  # the running averages (the variance's n / (n - 1) of B * H * W)
        assert all(torch.equal(r[i], ranks[0][i]) for r in ranks)
        torch.testing.assert_close(ranks[0][i], want[i], rtol=1e-6, atol=1e-6)


# -- the step --------------------------------------------------------------------

RECIPES = {"batch": dict(norm="batch", batch=2), "none": dict(norm="none", batch=2),
           "batch_jax": dict(norm="batch", batch=4)}
# the step recipe each rank count runs against one process
STEP_RECIPES = {2: "batch", 4: "none"}


def _build(name, rows):
    r = RECIPES[name]
    G = define_G(3, 3, 8, "resnet_6blocks", norm=r["norm"], seed=20, train=True,
                 use_dropout=False, **F32)
    D = define_D(6, 8, "basic", norm=r["norm"], seed=21, **F32)
    cfg = pix2pix.Pix2PixConfig(pool_size=0, use_vgg=False, w_vgg=0.0,
                                fuse_d_batch=r["norm"] != "batch")
    return pix2pix.init_state(G, D, None, cfg, (rows, SIZE), seed=4), cfg


def _batches(name):
    rng = np.random.default_rng(0)
    n = RECIPES[name]["batch"]
    return [[rng.uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2)]
            for _ in range(2)]


def _run(name, mesh):
    state, cfg = _build(name, SIZE // (mesh.spatial if mesh else 1))
    if mesh is not None:
        for net in (state.netG, state.netD):
            set_batchnorm_mesh(net, mesh)
    step = pix2pix.make_train_step(cfg, mesh)
    metrics, grads = [], None
    for a, b in _batches(name):
        if mesh is not None:
            a, b = shard_batch(a, mesh), shard_batch(b, mesh)
        m, _ = step(state, torch.from_numpy(np.ascontiguousarray(a)),
                    torch.from_numpy(np.ascontiguousarray(b)), LR)
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = {n: {k: p.grad.clone() for k, p in net.named_parameters()
                         if p.grad is not None}
                     for n, net in (("netG", state.netG), ("netD", state.netD))}
    return metrics, grads, state.state_dict()


@pytest.mark.parametrize("name,size", [("batch", 2), ("none", 4)])
def test_norm_step_on_strips_equals_one_process(name, size, layer_runs):
    assert STEP_RECIPES[size] == name
    want_m, want_g, want_s = _run(name, None)
    _, floor_g, _ = other_threads(_run, name, None)
    ranks = [r[name] for r in layer_runs[size]]
    assert all(r[0] == ranks[0][0] for r in ranks), "the ranks report different metrics"
    ranks_identical([digest(r[2]) for r in ranks])
    check_losses(ranks[0][0], want_m, LOSSES)
    check_gradients(ranks[0][1], want_g, floor_g, ("netG", "netD"))
    running = [(n, k) for n in ("netG", "netD") for k in want_s[n] if "running_" in k]
    assert bool(running) == (name == "batch")
    for n, k in running:
        torch.testing.assert_close(ranks[0][2][n][k], want_s[n][k], rtol=1e-6, atol=1e-6)


def _jax_run():
    """JAX's single-device pix2pix step (jitted) on the recipe's weights and
    batches: (per-step metrics, the running averages of G and D)."""
    import jax
    import jax.numpy as jnp

    from dsgan_tpu.models import define_D as jax_define_D
    from dsgan_tpu.models import define_G as jax_define_G
    from dsgan_tpu.models import pix2pix as jax_pix2pix
    from dsgan_tpu_torch.utils.convert import flatten, jax_from_state_dict

    state, _ = _build("batch_jax", SIZE)
    eg = registry.generator_entries(3, 3, 8, "resnet_6blocks", "batch", False)
    ed = registry.discriminator_entries(6, 8, "basic", 3, "batch")
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    pg, sg = jax_from_state_dict(state.netG.state_dict(), eg)
    pd, sd = jax_from_state_dict(state.netD.state_dict(), ed)
    cfg = jax_pix2pix.Pix2PixConfig(pool_size=0, use_vgg=False, compute_dtype=None,
                                    fuse_d_batch=False)
    adam = jax_pix2pix.make_adam(cfg.beta1)
    jstate = jax_pix2pix.Pix2PixState(
        params_G=as_jax(pg), params_D=as_jax(pd), opt_G=adam.init(as_jax(pg)),
        opt_D=adam.init(as_jax(pd)), pool_images=jnp.zeros((1,)),
        pool_count=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
        step=jnp.zeros((), jnp.int32), stats_G=as_jax(sg), stats_D=as_jax(sd))
    g = jax_define_G(3, 3, 8, "resnet_6blocks", "batch", False, dtype=None)
    d = jax_define_D(6, 8, "basic", 3, "batch", False, dtype=None)
    step = jax.jit(jax_pix2pix.make_train_step(g, d, None, None, cfg))
    out = []
    for a, b in _batches("batch_jax"):
        jstate, m, _ = step(jstate, jnp.asarray(a), jnp.asarray(b), jnp.float32(LR))
        out.append({k: float(v) for k, v in m.items()})
    stats = {n: flatten(jax.tree_util.tree_map(np.asarray, s))
             for n, s in (("netG", jstate.stats_G), ("netD", jstate.stats_D))}
    return out, stats, (eg, ed)


def test_batchnorm_data2_spatial2_step_matches_jax(layer_runs):
    from dsgan_tpu_torch.utils.convert import flatten, jax_from_state_dict

    ranks = [r["batch_jax"] for r in layer_runs[4]]
    assert all(r[0] == ranks[0][0] for r in ranks), "the ranks report different metrics"
    ranks_identical([digest(r[2]) for r in ranks])
    want_m, want_stats, entries = _jax_run()
    check_losses(ranks[0][0], want_m, LOSSES)
    for n, e in zip(("netG", "netD"), entries):
        got = flatten(jax_from_state_dict(ranks[0][2][n], e)[1])
        assert set(got) == set(want_stats[n]) and got
        for k, w in want_stats[n].items():
            np.testing.assert_allclose(got[k], w, rtol=1e-3, atol=1e-5, err_msg=f"{n} {k}")

"""``--remat`` (``models/mixconvnext.py``: every ConvNeXt block under
``torch.utils.checkpoint``) on the CPU, f32, K1-K4 through their plain
versions.

  * one process: the pix2pix step on the full-width MixConvNeXtML (PatchGAN
    ndf 8, pool 0, no VGG, 32x32, batch 2) with ``remat`` True and "dots"
    (``define_G(remat=...)``) against the step without it, bit for bit:
    every gradient, the metrics and the updated state; each block's forward
    runs twice a step under remat, once without;
  * two gloo ranks (``data 1 x spatial 2``, 48x48, batch 1, one step;
    level 4 of 3 rows runs whole on both ranks, so its recompute re-enters
    that context): the remat step against the same ranks' step without
    remat, bit for bit, and the tally of the collectives grows by exactly
    the blocks' forward exchanges and all-reduces (the recompute's);
  * the remat step on those two ranks against JAX's single-device
    ``make_train_step`` with ``define_G(remat=True)`` on the weights
    carried across, the losses at ``tests/test_parallel.py:128-129``'s
    bounds.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from dsgan_tpu_torch.models import define_D, define_G, init_d_params, init_params, pix2pix
from dsgan_tpu_torch.models.mixconvnext import ConvNeXtBlock
from dsgan_tpu_torch.parallel import comms, multihost, resolve_mesh, shard_batch
from tests.test_torch_spatial_cyclegan import TIMEOUT, check_losses, digest, ranks_identical

F32 = dict(dtype=torch.float32, device="cpu")
LR = 2e-4
NDF = 8
LOSSES = ("loss_G", "loss_D", "loss_D_fake", "loss_D_real", "loss_G_GAN", "loss_G_L1",
          "loss_tv", "loss_ssim")


def _state(remat, size, rows):
    G = define_G(3, 3, 32, "MixConvNeXtML", params=init_params(13), train=True, remat=remat,
                 **F32)
    D = define_D(6, NDF, "basic", params=init_d_params(6, NDF, 3, seed=14), **F32)
    cfg = pix2pix.Pix2PixConfig(pool_size=0, use_vgg=False, w_vgg=0.0)
    return pix2pix.init_state(G, D, None, cfg, (rows, size), seed=4), cfg


def _batches(size, batch, steps):
    rng = np.random.default_rng(16)
    return [[rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32) for _ in range(2)]
            for _ in range(steps)]


def _grads(state):
    return {n: {k: p.grad.clone() for k, p in net.named_parameters() if p.grad is not None}
            for n, net in (("netG", state.netG), ("netD", state.netD))}


def _run(remat, mesh=None, size=32, batch=2, steps=1):
    """The steps on this rank's strip (the whole image without a mesh):
    (per-step metrics, the first-step gradients' and the state's
    ``digest``s, per-step tallies, the ConvNeXt blocks' forward tally of
    the first step)."""
    state, cfg = _state(remat, size, size // (mesh.spatial if mesh else 1))
    step = pix2pix.make_train_step(cfg, mesh)
    blocks = {}

    def before(mod, args):
        mod._tally = comms.collective_stats(mesh)

    def after(mod, args, out):
        for kind, v in comms.collective_stats(mesh).items():
            was = mod._tally.get(kind, {"count": 0, "bytes": 0})
            entry = blocks.setdefault(kind, {"count": 0, "bytes": 0})
            entry["count"] += v["count"] - was["count"]
            entry["bytes"] += v["bytes"] - was["bytes"]

    hooks = []
    if mesh is not None:
        for m in state.netG.modules():
            if isinstance(m, ConvNeXtBlock):
                hooks += [m.register_forward_pre_hook(before), m.register_forward_hook(after)]
    metrics, grads, tallies = [], None, []
    for a, b in _batches(size, batch, steps):
        if mesh is not None:
            a, b = shard_batch(a, mesh), shard_batch(b, mesh)
            comms.reset(mesh)
        m, _ = step(state, torch.from_numpy(np.ascontiguousarray(a)),
                    torch.from_numpy(np.ascontiguousarray(b)), LR)
        metrics.append({k: float(v) for k, v in m.items()})
        if mesh is not None:
            tallies.append(comms.collective_stats(mesh))
            for h in hooks:
                h.remove()
            hooks = []
        if grads is None:
            grads = _grads(state)
    return metrics, digest(grads), digest(state.state_dict()), tallies, blocks


def _equal(a, b):
    """Two runs' metrics, first-step gradients and states, bit for bit."""
    assert a[0] == b[0], "the metrics differ"
    ranks_identical([a[1], b[1]])
    ranks_identical([a[2], b[2]])


@pytest.fixture(scope="module")
def without_remat():
    return _run(False)


@pytest.mark.parametrize("remat", [True, "dots"], ids=["remat", "dots"])
def test_remat_step_equals_the_step_without_it(remat, without_remat):
    want = without_remat
    calls = []
    forward = ConvNeXtBlock._forward

    def counted(self, *args):
        calls.append(self)
        return forward(self, *args)

    with mock.patch.object(ConvNeXtBlock, "_forward", counted):
        got = _run(remat)
    assert len(calls) == 18 and len(set(calls)) == 9  # c1-c5, uc1-uc4: forward and recompute
    _equal(got, want)


def test_remat_builds_for_mixconvnext_alone():
    G = define_G(3, 3, 8, "MixConvNeXtML", remat="dots", **F32)
    assert G.remat == "dots" and all(m.remat == "dots" for m in G.modules()
                                     if isinstance(m, ConvNeXtBlock))
    # the zoo ignores it, as the JAX package's define_G does
    define_G(3, 3, 8, "resnet_6blocks", remat=True, **F32)
    with pytest.raises(ValueError, match="remat"):
        ConvNeXtBlock(4, 4, remat="all")


# -- two ranks ---------------------------------------------------------------------

SIZE = 48  # level 4 (3 rows) does not split over 2 ranks: it runs whole
STEPS = 1


def _rank(rank, out):
    torch.set_num_threads(1)
    mesh = resolve_mesh(1, 2, batch_size=1, height=SIZE)
    torch.save({remat: _run(remat, mesh, SIZE, 1, STEPS) for remat in (False, True)},
               f"{out}/rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("remat")
    multihost.spawn(_rank, 2, (str(d),), timeout=TIMEOUT)
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)]


def test_remat_on_strips_equals_the_ranks_without_it(ranks):
    for r in ranks:
        _equal(r[True], r[False])
    ranks_identical([r[True][2] for r in ranks])
    # the recompute repeats the blocks' forward collectives, and nothing else
    for r in ranks:
        blocks = r[False][4]
        assert blocks["collective-permute"]["count"] > 0 and blocks["all-reduce"]["count"] > 0
        for with_remat, without in zip(r[True][3], r[False][3]):
            assert sorted(with_remat) == sorted(without)
            for kind, v in with_remat.items():
                grew = {k: v[k] - without[kind][k] for k in v}
                assert grew == blocks.get(kind, {"count": 0, "bytes": 0}), (kind, grew)


def test_remat_spatial2_step_matches_jax(ranks):
    import jax
    import jax.numpy as jnp

    from dsgan_tpu.models import define_D as jax_define_D
    from dsgan_tpu.models import define_G as jax_define_G
    from dsgan_tpu.models import pix2pix as jax_pix2pix

    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    pg, pd = as_jax(init_params(13)), as_jax(init_d_params(6, NDF, 3, seed=14))
    cfg = jax_pix2pix.Pix2PixConfig(pool_size=0, use_vgg=False, compute_dtype=None)
    adam = jax_pix2pix.make_adam(cfg.beta1)
    jstate = jax_pix2pix.Pix2PixState(
        params_G=pg, params_D=pd, opt_G=adam.init(pg), opt_D=adam.init(pd),
        pool_images=jnp.zeros((1,)), pool_count=jnp.zeros((), jnp.int32),
        rng=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32))
    g = jax_define_G(3, 3, 32, "MixConvNeXtML", dtype=None, remat=True)
    d = jax_define_D(6, NDF, "basic", dtype=None)
    step = jax.jit(jax_pix2pix.make_train_step(g, d, None, None, cfg))
    want = []
    for a, b in _batches(SIZE, 1, STEPS):
        jstate, m, _ = step(jstate, jnp.asarray(a), jnp.asarray(b), jnp.float32(LR))
        want.append({k: float(v) for k, v in m.items()})
    check_losses(ranks[0][True][0], want, LOSSES)

"""Diffusion on the spatial axis (``models/diffusion.py`` under
``parallel.spatial.rows``) on the CPU: image rows over gloo ranks,
spawned, f32 / erf GELU, DenoiseUNet nf 8, T 20, batch 2.

  * the noise draws: ``eps`` and the sampler's ``x_T`` drawn on strips are
    the strips of one process's draws, bit for bit, and ``t`` is the same
    on every rank of a row group;
  * the train step over ``data 1 x spatial 2`` and ``spatial 4`` at 32x32
    against the port's one process, 2 steps: step 1 with one whole-image
    ``t`` / ``eps`` handed to both (each rank its strip), step 2 with the
    port's own draws; the losses within the JAX suite's spatial bounds
    (``tests/test_parallel.py:128-129``), every first-step weight gradient
    within rel-L2 1e-5, the ranks' states bit for bit;
  * the step over ``spatial 2`` against JAX's single-device
    ``make_diffusion_train_step`` with JAX's own ``t`` / ``eps`` handed in,
    on the weights carried across (``utils/convert.py``): the loss within
    the same bound, the parameters after Adam as
    ``tests/test_torch_diffusion.py`` holds them;
  * a 3-step DDIM sample on strips against one process's within 1e-5:
    over 2 ranks at 32x32 and over 4 at 24x24, whose deepest level (6
    rows) does not split over 4 and runs whole on every rank.
"""

import numpy as np
import pytest
import torch

from dsgan_tpu_torch.models import diffusion
from dsgan_tpu_torch.parallel import multihost, resolve_mesh, shard_batch
from tests.test_torch_spatial_cyclegan import (
    TIMEOUT,
    check_gradients,
    check_losses,
    digest,
    other_threads,
    ranks_identical,
)

NF, T, B = 8, 20, 2
LR = 2e-3


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _strip(x, mesh, dim=2):
    """This rank's strip of a whole-image tensor (itself without a mesh)."""
    if mesh is None:
        return x
    return x.narrow(dim, mesh.row * (x.shape[dim] // mesh.spatial), x.shape[dim] // mesh.spatial)


def _batches(size):
    rng = np.random.default_rng(1)
    return [[rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8) for _ in range(2)]
            for _ in range(2)]


def _given(size):
    """Step 1's whole-image ``t`` and ``eps``, from numpy."""
    rng = np.random.default_rng(9)
    return (torch.from_numpy(rng.integers(0, T, (B,))),
            torch.from_numpy(rng.standard_normal((B, 3, size, size)).astype(np.float32)))


def _run(mesh, size=32):
    """The steps, then the port's own draws and a 3-step DDIM sample on this
    rank's strip: (metrics, first-step gradients, state, draws, sample)."""
    net = diffusion.define_denoiser(3, 3, NF, torch.float32, "cpu", seed=7)
    cfg = diffusion.DiffusionConfig(timesteps=T)
    state = diffusion.init_state(net, cfg, seed=3)
    step = diffusion.make_diffusion_train_step(cfg, mesh)
    metrics, grads = [], None
    for i, (a, b) in enumerate(_batches(size)):
        if mesh is not None:
            a, b = shard_batch(a, mesh), shard_batch(b, mesh)
        t, eps = _given(size) if i == 0 else (None, None)
        m = step(state, torch.from_numpy(np.ascontiguousarray(a)),
                 torch.from_numpy(np.ascontiguousarray(b)), LR, t=t,
                 eps=None if eps is None else _strip(eps, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = {"net": {k: p.grad.clone() for k, p in net.named_parameters()}}
    gen = torch.Generator().manual_seed(11)
    draws = (diffusion._noise((B, 3, size // (mesh.spatial if mesh else 1), size), mesh, gen,
                              "cpu"),
             torch.randint(0, T, (B,), generator=gen))
    cond = np.random.default_rng(2).integers(0, 256, (B, size, size, 3), dtype=np.uint8)
    if mesh is not None:
        cond = shard_batch(cond, mesh)
    sample = diffusion.make_ddim_sampler(cfg, 3)(
        net, torch.from_numpy(np.ascontiguousarray(cond)),
        generator=torch.Generator().manual_seed(5), mesh=mesh)
    return metrics, grads, state.state_dict(), draws, sample


def _rank(rank, size, height, out):
    torch.set_num_threads(1)
    mesh = resolve_mesh(1, size, batch_size=B, height=height)
    torch.save(_run(mesh, height), f"{out}/rank{rank}.pt")


def _ranks(size, height, tmp_path):
    multihost.spawn(_rank, size, (size, height, str(tmp_path)), timeout=TIMEOUT)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(size)]


@pytest.fixture(scope="module")
def one():
    return {32: _run(None, 32), 24: _run(None, 24)}


@pytest.mark.parametrize("size", [2, 4])
def test_diffusion_step_on_strips_equals_one_process(one, size, tmp_path):
    want_m, want_g, want_s, want_d, _ = one[32]
    _, floor_g, _, _, _ = other_threads(_run, None)
    ranks = _ranks(size, 32, tmp_path)
    assert all(r[0] == ranks[0][0] for r in ranks), "the ranks report different metrics"
    ranks_identical([digest(r[2]) for r in ranks])
    check_losses(ranks[0][0], want_m, ("loss_G",))
    check_gradients(ranks[0][1], want_g, floor_g, ("net",))
    # the draws on strips: one process's, its strips; t per image
    assert torch.equal(torch.cat([r[3][0] for r in ranks], 2), want_d[0])
    assert all(torch.equal(r[3][1], want_d[1]) for r in ranks)
    assert torch.equal(ranks[0][2]["generator"], want_s["generator"])


@pytest.mark.parametrize("size,height", [(2, 32), (4, 24)])
def test_ddim_sample_on_strips_equals_one_process(one, size, height, tmp_path):
    ranks = _ranks(size, height, tmp_path)
    got = torch.cat([r[4] for r in ranks], 1)
    want = one[height][4]
    assert got.shape == want.shape == (B, height, height, 3)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert float(got.abs().max()) <= 1.0


def _jax_rank(rank, out):
    """One step over spatial 2 with JAX's t / eps (``out/jax_draws.pt``)."""
    torch.set_num_threads(1)
    mesh = resolve_mesh(1, 2, batch_size=B, height=16)
    t, eps, a, b = torch.load(f"{out}/jax_draws.pt")
    net = diffusion.define_denoiser(3, 3, NF, torch.float32, "cpu", seed=7)
    cfg = diffusion.DiffusionConfig(timesteps=T)
    state = diffusion.init_state(net, cfg)
    m = diffusion.make_diffusion_train_step(cfg, mesh)(
        state, shard_batch(a, mesh).contiguous(), shard_batch(b, mesh).contiguous(), LR, t=t,
        eps=_strip(eps, mesh))
    torch.save((float(m["loss_G"]), net.state_dict()), f"{out}/jax_rank{rank}.pt")


def test_diffusion_spatial2_step_matches_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from dsgan_tpu.models import diffusion as jax_diffusion
    from dsgan_tpu.models.pix2pix import make_adam as jax_make_adam
    from dsgan_tpu_torch.utils.convert import diffusion_entries, flatten, jax_from_state_dict

    size = 16
    net = diffusion.define_denoiser(3, 3, NF, torch.float32, "cpu", seed=7)
    params = jax.tree_util.tree_map(
        jnp.asarray, jax_from_state_dict(net.state_dict(), diffusion_entries())[0])
    jnet = jax_diffusion.DenoiseUNet(out_nc=3, nf=NF, dtype=None)
    jcfg = jax_diffusion.DiffusionConfig(timesteps=T)
    adam = jax_make_adam(jcfg.beta1)
    jstate = jax_diffusion.DiffusionState(params=params, opt=adam.init(params),
                                          rng=jax.random.PRNGKey(5), step=jnp.zeros((), jnp.int32))
    a, b = _batches(size)[0]
    _, r_t, r_eps = jax.random.split(jstate.rng, 3)  # JAX's draws, as its step makes them
    t = np.asarray(jax.random.randint(r_t, (B,), 0, T))
    eps = np.asarray(jax.random.normal(r_eps, (B, size, size, 3), jnp.float32))
    jstate, jm = jax.jit(jax_diffusion.make_diffusion_train_step(jnet, jcfg))(
        jstate, jnp.asarray(a), jnp.asarray(b), jnp.float32(LR))
    torch.save((torch.from_numpy(t).long(), _nchw(eps), torch.from_numpy(a), torch.from_numpy(b)),
               tmp_path / "jax_draws.pt")
    multihost.spawn(_jax_rank, 2, (str(tmp_path),), timeout=TIMEOUT)
    (l0, s0), (l1, s1) = (torch.load(tmp_path / f"jax_rank{r}.pt") for r in range(2))
    assert l0 == l1 and all(torch.equal(s0[k], s1[k]) for k in s0)
    assert l0 == pytest.approx(float(jm["loss_G"]), rel=1e-5, abs=1e-6)
    got = flatten(jax_from_state_dict(s0, diffusion_entries())[0])
    ref = flatten(jax.tree_util.tree_map(np.asarray, jstate.params))
    total = mismatched = 0
    for k, w in ref.items():
        diff = np.abs(got[k].astype(np.float64) - w)
        assert diff.max() <= 1.1 * 2 * LR, k
        total += diff.size
        mismatched += int((diff > 0.5 * LR).sum())
    assert mismatched / total < 1e-3, f"{mismatched} of {total}"

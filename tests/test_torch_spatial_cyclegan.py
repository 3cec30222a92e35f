"""CycleGAN on the spatial axis (``models/cycle_gan.py`` under
``parallel.spatial.rows``) on the CPU: image rows over gloo ranks,
spawned, f32, 32x32, batch 1, LSGAN, lambda_identity 0.5.

  * the step over ``data 1 x spatial 2`` on two full-width MixConvNeXtML
    generators (the K1-K4 path's plain versions) against PatchGANs of ndf
    8, pool 0, one step, and over ``data 1 x spatial 4`` on resnet_6blocks
    (ngf 8) with a pool of 1 a side, two steps (the second meets full
    pools: their draws per image, equal on every rank), each against the
    port's one process: the losses within the JAX suite's spatial bounds
    (``tests/test_parallel.py:128-129``), every first-step weight
    gradient of the four nets within rel-L2 1e-5 (on resnet also their
    biases, as one vector a net, within 1e-5 or twice one process's
    distance to itself at another thread count), the ranks' states bit for
    bit (the pools' strips joined against one process's images);
  * the step over ``spatial 2`` on resnet_6blocks ngf 8 / PatchGAN ndf 8,
    pool 0, against JAX's single-device ``make_cyclegan_step`` on the
    weights carried across (``utils/convert.py``), the losses at the same
    bounds;
  * the model shell's checkpoint on strips: one step on two strips, the
    epoch checkpoint (both pools joined into whole images), a second step;
    two ranks resumed from that checkpoint repeat the second step bit for
    bit, and one process resumed from it takes the same step within the
    step's bounds.

Every two-strip run above shares one spawn (``two_ranks``).
"""

import hashlib

import numpy as np
import pytest
import torch

from dsgan_tpu_torch.models import define_D, define_G, registry
from dsgan_tpu_torch.models.cycle_gan import NETS, CycleGANConfig, init_state, make_cyclegan_step
from dsgan_tpu_torch.parallel import multihost, resolve_mesh, shard_batch
from tests.test_torch_spatial import _tensors as tensors
from tests.test_torch_spatial import rel_l2

F32 = dict(dtype=torch.float32, device="cpu")
TIMEOUT = 300
LR = 2e-4
SIZE = 32
# the JAX suite's spatial bounds: (rel, abs) of each loss at each step
LOSS_BOUNDS = ((1e-5, 1e-6), (1e-4, 1e-5))
LOSSES = ("loss_G", "loss_G_A", "loss_G_B", "loss_cycle_A", "loss_cycle_B", "loss_idt_A",
          "loss_idt_B", "loss_tv", "loss_D_A", "loss_D_B")
# "floor": whether the biases are held against one process at another
# thread count (a full-width MixConvNeXtML's run costs too much for it)
RECIPES = {
    "mix": dict(netG="MixConvNeXtML", ngf=32, pool=0, steps=1, floor=False),
    "resnet_pool": dict(netG="resnet_6blocks", ngf=8, pool=1, steps=2, floor=True),
    "resnet": dict(netG="resnet_6blocks", ngf=8, pool=0, steps=2, floor=True),
}


def check_losses(got, want, keys):
    """Each step's losses within LOSS_BOUNDS of one process's."""
    for i, (g, w) in enumerate(zip(got, want)):
        rel, atol = LOSS_BOUNDS[min(i, 1)]
        for k in keys:
            assert g[k] == pytest.approx(w[k], rel=rel, abs=atol), (i, k, g[k], w[k])


def check_gradients(got, want, floor, nets):
    """Every weight's first-step gradient within rel-L2 1e-5 of one
    process's; with a ``floor``, the biases and slopes of a net, as one
    vector, within 1e-5 or twice the floor's distance (one process at
    another thread count: a bias whose gradient cancels through a norm is
    rounding noise there)."""
    for net in nets:
        for k, w in want[net].items():
            if w.dim() > 1:
                assert rel_l2(got[net][k], w) <= 1e-5, (net, k, rel_l2(got[net][k], w))
        small = [k for k, w in want[net].items() if w.dim() < 2]
        if not small or floor is None:
            continue
        vec = {n: torch.cat([g[net][k].reshape(-1) for k in small])
               for n, g in (("got", got), ("want", want), ("floor", floor))}
        bound = max(1e-5, 2 * rel_l2(vec["floor"], vec["want"]))
        assert rel_l2(vec["got"], vec["want"]) <= bound, (net, rel_l2(vec["got"], vec["want"]),
                                                          bound)


def digest(state):
    """{path: a hash of the tensor's bytes} of a nested state dict: what a
    rank hands back for the bit-for-bit comparison (a full-width state is
    hundreds of MB a rank)."""
    return {k: hashlib.blake2b(t.detach().reshape(-1).contiguous().view(torch.uint8).numpy()
                               .tobytes(), digest_size=16).hexdigest()
            for k, t in tensors(state)}


def ranks_identical(digests, skip=()):
    """The ranks' states (their ``digest``s) bit for bit (``skip``: keys
    that hold strips)."""
    a = digests[0]
    for b in digests[1:]:
        assert sorted(a) == sorted(b)
        differ = [k for k in a if not any(x in k for x in skip) and a[k] != b[k]]
        assert not differ, f"the ranks' states differ: {differ[:5]}"


def other_threads(fn, *args):
    """``fn(*args)`` at another thread count (the floor's run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1 if threads > 1 else 2)
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(threads)


def _build(name, rows):
    r = RECIPES[name]
    nets = [define_G(3, 3, r["ngf"], r["netG"], seed=40 + i, train=True, use_dropout=False, **F32)
            for i in range(2)]
    nets += [define_D(3, 8, "basic", seed=42 + i, **F32) for i in range(2)]
    cfg = CycleGANConfig(gan_mode="lsgan", pool_size=r["pool"])
    return init_state(*nets, cfg, (rows, SIZE), seed=3), cfg


def _batches(steps=2):
    rng = np.random.default_rng(44)
    return [[rng.integers(0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8) for _ in range(2)]
            for _ in range(steps)]


def _run(name, mesh):
    """The recipe's steps on this rank's strip (the whole image without a
    mesh): (metrics, first-step gradients, final state)."""
    state, cfg = _build(name, SIZE // (mesh.spatial if mesh else 1))
    step = make_cyclegan_step(cfg, mesh)
    metrics, grads = [], None
    for a, b in _batches(RECIPES[name]["steps"]):
        if mesh is not None:
            a, b = shard_batch(a, mesh), shard_batch(b, mesh)
        m, _ = step(state, torch.from_numpy(np.ascontiguousarray(a)),
                    torch.from_numpy(np.ascontiguousarray(b)), LR)
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = {n: {k: p.grad.clone() for k, p in getattr(state, n).named_parameters()
                         if p.grad is not None} for n in NETS}
    return metrics, grads, state.state_dict()


def _rank(rank, name, size, out):
    """A rank's metrics, its state's digest and pools, and (rank 0, the
    gradients being equal on every rank after their all-reduce) the
    first-step gradients."""
    torch.set_num_threads(1)
    mesh = resolve_mesh(1, size, batch_size=1, height=SIZE)
    metrics, grads, state = _run(name, mesh)
    pools = {k: v for k, v in state.items() if k.startswith("pool_")}
    torch.save((metrics, grads if rank == 0 else None, digest(state), pools),
               f"{out}/rank{rank}.pt")


def _ranks(name, size, tmp_path):
    multihost.spawn(_rank, size, (name, size, str(tmp_path)), timeout=TIMEOUT)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(size)]


def _two_ranks(rank, out):
    """Everything this file runs on two strips, in one spawn: the mix and
    resnet recipes' steps (``_rank``), then the shell's run to its epoch 1
    checkpoint and a second one resumed from it (``_shell_rank``)."""
    for name in ("mix", "resnet"):
        _rank(rank, name, 2, f"{out}/{name}")
    _shell_rank(rank, out, 2, False)
    torch.distributed.barrier()  # the checkpoint is on disk before any rank reads it
    _shell_rank(rank, out, 2, True)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The root of the two-strip spawn's files (``_two_ranks``)."""
    root = tmp_path_factory.mktemp("two_ranks")
    for name in ("mix", "resnet"):
        (root / name).mkdir()
    multihost.spawn(_two_ranks, 2, (str(root),), timeout=TIMEOUT)
    return root


def _loaded(root, size):
    return [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(size)]


@pytest.mark.parametrize("name,size", [("mix", 2), ("resnet_pool", 4)])
def test_cyclegan_step_on_strips_equals_one_process(name, size, tmp_path, two_ranks):
    want_m, want_g, want_s = _run(name, None)
    floor_g = other_threads(_run, name, None)[1] if RECIPES[name]["floor"] else None
    ranks = _loaded(two_ranks / name, size) if size == 2 else _ranks(name, size, tmp_path)
    assert all(r[0] == ranks[0][0] for r in ranks), "the ranks report different metrics"
    ranks_identical([r[2] for r in ranks], skip=("_images",))
    check_losses(ranks[0][0], want_m, LOSSES)
    check_gradients(ranks[0][1], want_g, floor_g, NETS)
    for side in "AB":  # the strips of the pooled images, joined
        key = f"pool_{side}_images"
        got = torch.cat([r[3][key] for r in ranks], 2)
        assert got.shape == want_s[key].shape
        torch.testing.assert_close(got, want_s[key], rtol=1e-4, atol=2e-4)
        assert ranks[0][3][f"pool_{side}_count"] == want_s[f"pool_{side}_count"]
        # the draws: the pools' generators advanced alike
        assert torch.equal(ranks[0][3][f"pool_{side}_generator"],
                           want_s[f"pool_{side}_generator"])


def _jax_metrics():
    """JAX's single-device CycleGAN step (jitted) on the resnet recipe's
    weights and batches: per-step metrics."""
    import jax
    import jax.numpy as jnp

    from dsgan_tpu.models import cycle_gan as jax_cycle_gan
    from dsgan_tpu.models import define_D as jax_define_D
    from dsgan_tpu.models import define_G as jax_define_G
    from dsgan_tpu.utils.image_pool import init_pool
    from dsgan_tpu_torch.utils.convert import jax_from_state_dict

    state, _ = _build("resnet", SIZE)
    eg = registry.generator_entries(3, 3, 8, "resnet_6blocks", "instance", False)
    ed = registry.discriminator_entries(3, 8, "basic", 3, "instance")
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    params = [as_jax(jax_from_state_dict(getattr(state, n).state_dict(), e)[0])
              for n, e in zip(NETS, (eg, eg, ed, ed))]
    jcfg = jax_cycle_gan.CycleGANConfig(gan_mode="lsgan", pool_size=0)
    jg = jax_define_G(3, 3, 8, "resnet_6blocks", "instance", False, dtype=None)
    jd = jax_define_D(3, 8, "basic", 3, "instance", False, dtype=None)
    adam = jax_cycle_gan.make_adam(jcfg.beta1)
    pool = init_pool(0, (SIZE, SIZE, 3))
    jstate = jax_cycle_gan.CycleGANState(
        params_G_A=params[0], params_G_B=params[1], params_D_A=params[2], params_D_B=params[3],
        opt_G=adam.init((params[0], params[1])), opt_D=adam.init((params[2], params[3])),
        pool_A_images=pool[0], pool_A_count=pool[1], pool_B_images=pool[0],
        pool_B_count=pool[1], rng=jax.random.PRNGKey(3), step=jnp.zeros((), jnp.int32),
        stats_G_A=None, stats_G_B=None, stats_D_A=None, stats_D_B=None)
    jstep = jax.jit(jax_cycle_gan.make_cyclegan_step(jg, jg, jd, jd, jcfg))
    out = []
    for a, b in _batches():
        jstate, m, _ = jstep(jstate, jnp.asarray(a), jnp.asarray(b), jnp.float32(LR))
        out.append({k: float(v) for k, v in m.items()})
    return out


def test_cyclegan_spatial2_step_matches_jax(two_ranks):
    ranks = _loaded(two_ranks / "resnet", 2)
    assert ranks[0][0] == ranks[1][0], "the ranks report different metrics"
    check_losses(ranks[0][0], _jax_metrics(), LOSSES)


# -- the model shell's checkpoint on strips -------------------------------------

def _options(root, size, resume=False):
    from dsgan_tpu_torch.options.train_options import TrainOptions

    argv = ["--checkpoints_dir", f"{root}/ck", "--name", "c", "--model", "cycle_gan",
            "--dataset_mode", "unaligned", "--platform", "cpu", "--dtype", "float32",
            "--which_model_netG", "resnet_6blocks", "--ngf", "8", "--ndf", "8", "--no_dropout",
            "--pool_size", "1", "--batchSize", "1", "--seed", "5", "--loadSize_w", "32",
            "--loadSize_h", "32", "--fineSize_w", "32", "--fineSize_h", "32"]
    if size > 1:
        argv += ["--num_hosts", str(size), "--spatial_axis", str(size)]
    if resume:
        argv += ["--continue_train", "--which_epoch", "1"]
    return TrainOptions().parse(argv=argv)


def _shell_step(model, batch):
    model.set_input({"A": batch[0], "B": batch[1], "A_paths": ["a"]})
    model.optimize_parameters()
    return {k: float(v) for k, v in model.get_current_metrics().items()}


def _shell(root, size, resume):
    """The shell's steps: without ``resume`` step 1, the epoch 1 checkpoint,
    step 2; with it, the checkpoint loaded and step 2. Returns (step 2's
    metrics, the state after it, joined from the strips)."""
    from dsgan_tpu_torch.models import create_model

    opt = _options(root, size, resume)
    model = create_model(opt)
    model.setup(opt)
    batches = _batches()
    if not resume:
        _shell_step(model, batches[0])
        model.save_networks(1)
    m = _shell_step(model, batches[1])
    return m, model._checkpoint_state()


def _shell_rank(rank, root, size, resume):
    torch.set_num_threads(1)
    out = _shell(root, size, resume)
    if rank == 0:
        torch.save(out, f"{root}/shell_{int(resume)}.pt")


def test_cyclegan_checkpoint_on_strips_resumes(two_ranks):
    from dsgan_tpu_torch.utils import checkpoint as ckpt

    root = str(two_ranks)
    saved = ckpt.restore_state(f"{root}/ck/c", 1)
    for side in "AB":  # whole images, whatever the mesh
        assert saved[f"pool_{side}_images"].shape == (1, 3, SIZE, SIZE)
        assert saved[f"pool_{side}_count"] == 1
    (m_on, s_on), (m_re, s_re) = (torch.load(f"{root}/shell_{i}.pt", weights_only=False)
                                  for i in (0, 1))
    assert m_on == m_re
    ranks_identical([digest(s_on), digest(s_re)])  # resumed: the uninterrupted run's
    m_one, s_one = _shell(root, 1, True)
    check_losses([m_one], [m_on], LOSSES)
    for key in ("pool_A_images", "pool_B_images"):
        torch.testing.assert_close(s_one[key], s_on[key], rtol=1e-4, atol=2e-4)
    for net in NETS:
        for k, w in s_on[net].items():
            torch.testing.assert_close(s_one[net][k], w, rtol=0, atol=2.2 * LR)

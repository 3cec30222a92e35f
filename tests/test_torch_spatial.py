"""The spatial axis of the port (``dsgan_tpu_torch.parallel.spatial``) on
the CPU: image rows over gloo ranks, spawned.

Ops: every windowed op of the default recipe on the strips of 2 and of 4
ranks against one process on the whole image, f32, forward and input
gradient (and, where the op has weights, their gradients summed over the
ranks) within rel-L2 1e-6: the convs at each (k, s, p) the recipe uses,
the transposed convs (k3 s2 p1 op1, the U-Nets' k4 s2 p1), the pools (the
3x3 stride-2 average pool dividing by the image's padding alone), the
bilinear x2 upsample, the cascaded LayerNorm's sums and the global pools, ``instance_stats``,
``in_fold`` through the plain K2 / K4 (``block_core_in`` /
``block_core2_in``), a reflect ``Pad`` before a conv, TV, SSIM,
``ssim_uint8``, the loss means, a level that does not split (the
PatchGAN's tail; the resnet at a height whose deepest level does not;
MixConvNeXtML at 48 rows, whose levels 3 and 4 do not both split), a
halo deeper than a strip (a 9x9 window and a 3-row reflection on strips
of 2 rows, SSIM's 10 rows on strips of 8), and the dropout mask; the
whole MixConvNeXtML (~2e-6 of f32 summation noise) within the step's 1e-5,
its biases within twice one process's distance to itself at another
thread count. A
value every rank holds whole is compared on each rank, its cotangent
split over the ranks; a loss share summed over them.

Step: pix2pix on the full-width MixConvNeXtML (the K1-K4 path's plain
versions), PatchGAN ndf 8, VGG, 32x32, batch 2, f32, pool 0, over
``data 1 x spatial 2`` against one process, 2 steps: the losses within
the JAX suite's spatial bounds (``tests/test_parallel.py:128-129``: rel
1e-5 / abs 1e-6 at the first step, 1e-4 / 1e-5 at the second), every
first-step G and D weight's gradient within rel-L2 1e-5 (the gradient's
scale is what Adam hides) and the biases and slopes, as one vector, within
1e-5 or twice one process's distance to itself at another thread count,
the parameters as ``tests/test_torch_parallel.py``
holds them, the two ranks' states bit for bit. Then ``data 2 x spatial
2`` at ``tests/mh_worker.py``'s recipe (resnet_6blocks ngf 8, 32x32,
batch 4, f32, pool 0, w_vgg 0, dropout off) against JAX's single-device
``make_train_step`` on the weights carried across, losses at the JAX
suite's bounds. The forward: MixConvNeXtML at 48x48 over ``spatial 2``
and ``spatial 4`` (levels 3 and 4 of 6 and 3 rows do not both split: they
run whole) against the port's one process, within rel-L2 1e-6 or twice
the one process's own floor (its distance to itself at another thread
count), and over 2 against JAX's ``g.apply``
(``tests/test_parallel.py:245``'s rtol 2e-3 / atol 2e-4).
Outside ``spatial.rows`` the ops run their one-process code bit for bit.
Every multi-rank run takes one spawn a rank count (``op_runs``).
"""

import zlib

import numpy as np
import pytest
import torch

from dsgan_tpu_torch import ops
from dsgan_tpu_torch.kernels import block_core as bc
from dsgan_tpu_torch.models import define_D, define_G, define_vgg, init_params, pix2pix
from dsgan_tpu_torch.models.layers import Conv2d, Dropout, Pad, pad2d
from dsgan_tpu_torch.parallel import multihost, resolve_mesh, shard_batch, spatial

F32 = dict(dtype=torch.float32, device="cpu")
TIMEOUT = 300


def rel_l2(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _weights(seed, cin, cout, k, groups=1):
    rng = np.random.default_rng(seed)
    return _t(rng, cout, cin // groups, k, k, scale=0.3), _t(rng, cout, scale=0.1)


def _conv(k, s, p, groups=1, c=4):
    w, b = _weights(k * 10 + s, c, c, k, groups)
    return lambda x: ops.conv2d(x, w, b, stride=s, padding=p, groups=groups)


def _pad_conv(p):
    conv = Conv2d(4, 4, 2 * p + 1)
    with torch.no_grad():
        conv.weight.copy_(_weights(p, 4, 4, 2 * p + 1)[0])
        conv.bias.copy_(_weights(p, 4, 4, 2 * p + 1)[1])
    return lambda x: spatial.sequential([Pad(p), conv], x)


def _convt():
    w, b = _weights(7, 4, 4, 3)
    return lambda x: ops.conv_transpose2d(x, w.transpose(0, 1).contiguous(), b)


def _convt_k4():
    w, b = _weights(8, 4, 4, 4)
    return lambda x: ops.conv_transpose2d(x, w.transpose(0, 1).contiguous(), b, stride=2,
                                          padding=1, output_padding=0)


def _cascade_ln():
    from dsgan_tpu_torch.models.generators_zoo import CascadeLayerNorm

    ln = CascadeLayerNorm(4)
    with torch.no_grad():
        ln.gamma.copy_(torch.linspace(0.5, 1.5, 4))
        ln.beta.copy_(torch.linspace(-0.2, 0.2, 4))
    return ln, list(ln.parameters())


def _block_core(two):
    rng = np.random.default_rng(3)
    c1, c2, p = 4, 3, 5
    c = c1 + c2 if two else c1
    w1, b1, w2, b2, ws = (_t(rng, c, 4 * c, scale=0.3), _t(rng, 4 * c, scale=0.1),
                          _t(rng, 4 * c, p, scale=0.3), _t(rng, p, scale=0.1), _t(rng, c, p))
    ws_ = [w.requires_grad_(True) for w in (w1, b1, w2, b2, ws)]

    def fn(x):
        h = x * 1.5 + 0.25
        if two:
            return bc.block_core2_in(h[:, :c1], h[:, c1:], x[:, :c1], x[:, c1:], *ws_, gelu="erf")
        return bc.block_core_in(h, x, *ws_, gelu="erf")
    return fn, ws_, c


def _stats(x):
    mean, rsig = ops.instance_stats(x)
    return torch.cat([mean, rsig], 1)


def _pools(x):
    q = x + (torch.round(x * 2) - x).detach()  # ties across the strips; x's gradient
    return torch.cat([ops.adaptive_avg_pool(x), ops.adaptive_max_pool(q)], 1)


def _ssim_loss(x):
    return ops.ssim_loss(torch.tanh(x[:, :3]), torch.tanh(x[:, 1:4]))


def _u8(x):
    return ops.quantize_uint8(torch.tanh(x))


def _d_tail():
    D = define_D(4, 4, "basic", seed=5, **F32)
    return lambda x: D(x), list(D.parameters())


def _resnet():
    G = define_G(4, 4, 4, "resnet_6blocks", seed=6, train=True, **F32)
    set_eval = G.eval()  # dropout off: the mask test is its own case
    del set_eval
    return lambda x: G(x), list(G.parameters())


def _mixconvnext():
    G = define_G(3, 3, 32, "MixConvNeXtML", params=init_params(1), train=True, **F32)
    return lambda x: G(x), list(G.parameters())


def _dropout(x):
    d = Dropout()
    d.generator = torch.Generator().manual_seed(9)
    return d(x)


# name -> (a maker of (fn, params), kind of output, input shape (B, C, H, W));
# "split": a strip, "whole": every rank holds all of it, "share": a loss share
CASES = {
    "conv_k3_s1_p1": (lambda: (_conv(3, 1, 1), []), "split", (2, 4, 16, 8)),
    "conv_k7_p3_depthwise": (lambda: (_conv(7, 1, 3, 4), []), "split", (2, 4, 16, 8)),
    "conv_k9_p4_depthwise": (lambda: (_conv(9, 1, 4, 4), []), "split", (2, 4, 8, 8)),
    "conv_k4_s2_p1": (lambda: (_conv(4, 2, 1), []), "split", (2, 4, 16, 8)),
    "conv_k3_s2_p1": (lambda: (_conv(3, 2, 1), []), "split", (2, 4, 16, 8)),
    "conv_k1": (lambda: (_conv(1, 1, 0), []), "split", (2, 4, 16, 8)),
    "conv_transpose_k3_s2": (lambda: (_convt(), []), "split", (2, 4, 8, 8)),
    "conv_transpose_k4_s2_p1": (lambda: (_convt_k4(), []), "split", (2, 4, 8, 8)),
    "max_pool_2": (lambda: (lambda x: ops.max_pool2d(x, 2), []), "split", (2, 4, 16, 8)),
    "avg_pool_3_s2_p1_image_divisor": (
        lambda: (lambda x: ops.avg_pool2d(x, 3, 2, 1, count_include_pad=False), []), "split",
        (2, 4, 16, 8)),
    "avg_pool_2": (lambda: (lambda x: ops.avg_pool2d(x, 2), []), "split", (2, 4, 16, 8)),
    "upsample_bilinear2x": (lambda: (ops.upsample_bilinear2x, []), "split", (2, 4, 8, 8)),
    "cascade_layer_norm": (_cascade_ln, "split", (2, 4, 16, 8)),
    "global_pools": (lambda: (_pools, []), "whole", (2, 4, 16, 8)),
    "instance_stats": (lambda: (_stats, []), "whole", (2, 4, 16, 8)),
    "instance_norm": (lambda: (ops.instance_norm, []), "split", (2, 4, 16, 8)),
    "block_core_in_K1_K2": (lambda: _block_core(False)[:2], "split", (2, 4, 16, 8)),
    "block_core2_in_K3_K4": (lambda: _block_core(True)[:2], "split", (2, 7, 16, 8)),
    "reflect_pad1_conv3": (lambda: (_pad_conv(1), []), "split", (2, 4, 16, 8)),
    "reflect_pad3_conv7": (lambda: (_pad_conv(3), []), "split", (2, 4, 8, 8)),
    "tv_loss": (lambda: (lambda x: ops.tv_loss(x), []), "share", (2, 4, 16, 8)),
    "ssim_loss": (lambda: (_ssim_loss, []), "share", (2, 4, 32, 16)),
    "ssim_uint8": (lambda: (lambda x: ops.ssim_uint8(_u8(x[:, :3]), _u8(x[:, 1:4])), []),
                   "share", (2, 4, 32, 16)),
    "mse_uint8": (lambda: (lambda x: ops.mse_uint8(_u8(x[:, :3]), _u8(x[:, 1:4])), []),
                  "share", (2, 4, 16, 8)),
    "l1_and_gan_loss": (lambda: (lambda x: ops.l1_loss(x[:, :2], x[:, 2:])
                                 + ops.gan_loss(x, True) + ops.gan_loss(x, False, "lsgan"), []),
                        "share", (2, 4, 16, 8)),
    "patchgan_tail_gathered": (_d_tail, "whole", (2, 4, 32, 32)),
    "resnet_unsplit_level": (_resnet, "split", (1, 4, 24, 8)),
    "mixconvnext_unsplit_levels": (_mixconvnext, "split", (1, 3, 48, 16)),
    "dropout_mask": (lambda: (_dropout, []), "split", (2, 4, 16, 8)),
}
NO_GRAD = ("ssim_uint8", "mse_uint8")
# the whole generator (~50 layers, InstanceNorms on 3x1 levels) reads ~2e-6 in
# f32 summation noise: held at the step's gradient bound, 1e-5, and its biases
# (cancellation noise, rel-L2 ~3e-4 at another thread count) against that floor
NETWORKS = ("mixconvnext_unsplit_levels",)


def _inputs(name):
    shape = CASES[name][2]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    x = _t(rng, *shape)
    return x, rng


def _cotangent(out, name):
    rng = np.random.default_rng(11)
    return _t(rng, *out.shape)


def _run_case(name, mesh):
    """(output, input gradient, parameter gradients) of a case on this
    rank's strip (the whole image without a mesh)."""
    build, kind, _ = CASES[name]
    torch.manual_seed(0)
    fn, params = build()
    x, _ = _inputs(name)
    if mesh is not None:
        x = x[:, :, mesh.strip(x.shape[2])]
    x = x.clone().requires_grad_(name not in NO_GRAD)
    with spatial.rows(mesh):
        y = fn(x)
        if name in NO_GRAD:
            return y.detach(), None, []
        if kind == "share" or y.dim() == 0:
            loss = y
        else:
            g = _cotangent(y if mesh is None or kind == "whole" else
                           torch.empty(y.shape[0], y.shape[1], y.shape[2] * mesh.spatial,
                                       *y.shape[3:]), name)
            if mesh is not None:
                g = g / mesh.spatial if kind == "whole" else g[:, :, mesh.strip(g.shape[2])]
            loss = (y * g).sum()
        loss.backward()
    return y.detach(), x.grad, [p.grad.clone() for p in params]


def _ops_rank(rank, size, out):
    """Every run of this file on ``size`` ranks, in one spawn: the op cases,
    the generator's forward (``_forward``), and on 2 ranks the mix step, on
    4 the gathers (``_gathers``) and the resnet step over data 2 x spatial 2
    (``_run_steps``)."""
    torch.set_num_threads(1)
    mesh = resolve_mesh(1, size, batch_size=2, height=32)
    assert mesh.shape == (1, size) and mesh.row == rank
    res = {"ops": {name: _run_case(name, mesh) for name in CASES}, "forward": _forward(size)}
    if size == 2:
        res["step"] = _run_steps("mix", resolve_mesh(1, 2, batch_size=2, height=32), 2)
    else:
        res["gathers"] = _gathers(rank)
        res["step"] = _run_steps("resnet", resolve_mesh(2, 2, batch_size=4, height=32), 2)
    torch.save(res, f"{out}/rank{rank}.pt")


@pytest.fixture(scope="module")
def op_runs(tmp_path_factory):
    runs = {}
    for size in (2, 4):
        d = tmp_path_factory.mktemp(f"ops{size}")
        multihost.spawn(_ops_rank, size, (size, str(d)), timeout=TIMEOUT)
        runs[size] = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(size)]
    return runs


def _bounds(name, want_p):
    """(output, input gradient, parameters) bounds: 1e-6; for the whole
    generator 1e-5, and for its parameters also twice one process's distance
    to ``want_p`` at another thread count."""
    if name not in NETWORKS:
        return 1e-6, 1e-6, 1e-6
    threads = torch.get_num_threads()
    torch.set_num_threads(1 if threads > 1 else 2)
    try:
        _, _, p = _run_case(name, None)
    finally:
        torch.set_num_threads(threads)
    floor = rel_l2(torch.cat([v.reshape(-1) for v in p]),
                   torch.cat([v.reshape(-1) for v in want_p]))
    return 1e-5, 1e-5, max(1e-5, 2 * floor)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_op_on_strips_equals_one_process(op_runs, name, size):
    kind = CASES[name][1]
    want_y, want_g, want_p = _run_case(name, None)
    bound_y, bound_g, bound_p = _bounds(name, want_p)
    ranks = [r["ops"][name] for r in op_runs[size]]
    if kind == "split":
        got_y = torch.cat([r[0] for r in ranks], 2)
    elif kind == "whole":
        for r in ranks:
            assert rel_l2(r[0], want_y) <= 1e-6, name
        got_y = ranks[0][0]
    else:
        got_y = sum(r[0] for r in ranks)
    assert got_y.shape == want_y.shape
    assert rel_l2(got_y, want_y) <= bound_y, (name, rel_l2(got_y, want_y), bound_y)
    if want_g is None:
        return
    got_g = torch.cat([r[1] for r in ranks], 2)
    assert rel_l2(got_g, want_g) <= bound_g, (name, rel_l2(got_g, want_g), bound_g)
    if want_p:  # summed over the ranks; as one vector (a bias before a norm has a zero gradient)
        got = torch.cat([sum(r[2][i] for r in ranks).reshape(-1) for i in range(len(want_p))])
        want = torch.cat([w.reshape(-1) for w in want_p])
        assert rel_l2(got, want) <= bound_p, (name, rel_l2(got, want), bound_p)


def test_halo_plan_reaches_past_the_nearest_rank():
    """Strips of 2 rows over 4 ranks, a 4-row halo: rank 1 reads rank 3's
    rows below and only zeros above rank 0; a 3-row reflection at the top
    reads rows 1-3, two of them rank 1's."""
    _, recv, send, moves = spatial._transfers(4, 1, 2, 4, 4, "zero")
    assert moves and sorted(recv) == [0, 2, 3]
    assert recv[3] == [(8, 0, 2, 1)] and sorted(send) == [0, 2, 3]
    own, recv, _, _ = spatial._transfers(4, 0, 2, 3, 0, "reflect")
    assert own == [(2, 1, 1, 1)] and recv == {1: [(0, 1, 2, -1)]}


def test_a_pad_alone_on_a_strip_raises():
    """A strip has no rows of its own to pad H with: ``pad2d`` refuses it,
    and so does a pad that feeds anything but a stride-1 conv without
    padding; ``spatial.sequential`` hands a pad's rows to its conv."""
    from dsgan_tpu_torch.parallel import Mesh

    x = torch.zeros(1, 4, 8, 8)
    with spatial.rows(Mesh(1, 2, row_ranks=(0, 1))):
        with pytest.raises(ValueError, match="spatial.sequential"):
            pad2d(x, 1)
        with pytest.raises(ValueError, match="stride-1 conv"):
            spatial.sequential([Pad(1), Conv2d(4, 4, 3, padding=1)], x)


def _gathers(rank):
    from dsgan_tpu_torch.parallel import comms

    mesh = resolve_mesh(2, 2, batch_size=2, height=4)
    t = torch.full((1, 1), float(rank))
    return {"rows": comms.all_gather(t, mesh, group=mesh.row_group),
            "data": comms.all_gather(t, mesh)}


def test_all_gather_takes_the_group_it_is_given(op_runs):
    """On a 2 x 2 mesh (rank = d * 2 + s) a gather over the row group joins
    the ranks of this rank's data row, and with no group the data axis's
    (its column): ranks 0 and 1 gather [0, 1] and [0, 2] / [1, 3]."""
    for rank in range(4):
        got = op_runs[4][rank]["gathers"]
        d, s = divmod(rank, 2)
        assert got["rows"].flatten().tolist() == [2 * d, 2 * d + 1]
        assert got["data"].flatten().tolist() == [s, s + 2]


def test_outside_the_context_the_ops_are_unchanged():
    """Without ``spatial.rows`` (or with a mesh of no spatial axis) every
    op is its one-process code, bit for bit, on the same inputs."""
    rng = np.random.default_rng(0)
    x = _t(rng, 2, 4, 16, 8)
    w, b = _weights(1, 4, 4, 3)
    pairs = [
        (ops.conv2d(x, w, b, padding=1), torch.nn.functional.conv2d(x, w, b, padding=1)),
        (ops.max_pool2d(x, 2), torch.nn.functional.max_pool2d(x, 2, 2, 0)),
        (ops.adaptive_avg_pool(x), x.mean(dim=(2, 3), keepdim=True)),
        (ops.l1_loss(x, x * 2), (x - x * 2).abs().mean()),
        (ops.instance_stats(x)[0], x.float().mean(dim=(2, 3))),
    ]
    with spatial.rows(None):
        pairs.append((ops.tv_loss(x), ops.tv_loss(x)))
    for got, want in pairs:
        assert torch.equal(got, want)
    assert spatial.active() is None


# -- the train step -----------------------------------------------------------

LR = 2e-4
STEPS = 2


def _recipe(name, mesh, spatial_size=1):
    size = 32
    h = size // spatial_size
    if name == "mix":
        G = define_G(3, 3, 32, "MixConvNeXtML", seed=1, train=True, **F32)
        D = define_D(6, 8, "basic", seed=2, **F32)
        vgg = define_vgg(4, seed=3, **F32)
        cfg = pix2pix.Pix2PixConfig(pool_size=0)
    else:
        G = define_G(3, 3, 8, "resnet_6blocks", seed=20, train=True, use_dropout=False, **F32)
        D = define_D(6, 8, "basic", seed=21, **F32)
        vgg = None
        cfg = pix2pix.Pix2PixConfig(pool_size=0, use_vgg=False, w_vgg=0.0)
    state = pix2pix.init_state(G, D, vgg, cfg, (h, size), seed=4)
    return state, pix2pix.make_train_step(cfg, mesh), size


def _batches(name, size):
    rng = np.random.default_rng(0)
    n = 2 if name == "mix" else 4
    out = []
    for _ in range(STEPS):
        if name == "mix":
            a, b = (rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8) for _ in range(2))
            b[1, 8:20] = 128
        else:
            a, b = (rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32) for _ in range(2))
        out.append((a, b))
    return out


def _run_steps(name, mesh, spatial_size=1):
    state, step, size = _recipe(name, mesh, spatial_size)
    metrics, grads = [], None
    for a, b in _batches(name, size):
        if mesh is not None:
            a, b = shard_batch(a, mesh), shard_batch(b, mesh)
        m, _ = step(state, torch.from_numpy(a), torch.from_numpy(b), LR)
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = {n: {k: p.grad.clone() for k, p in net.named_parameters()
                         if p.grad is not None}
                     for n, net in (("netG", state.netG), ("netD", state.netD))}
    return metrics, grads, state.state_dict()


def _tensors(tree, path=""):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{path}/{i}")


def test_spatial_step_equals_one_process(op_runs):
    from tests.test_torch_parallel import check_parameters

    want_m, want_g, want_s = _run_steps("mix", None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1 if threads > 1 else 2)
    try:  # the floor: one process against itself at another thread count
        _, floor_g, _ = _run_steps("mix", None)
    finally:
        torch.set_num_threads(threads)
    (m0, g0, s0), (m1, _, s1) = (r["step"] for r in op_runs[2])
    assert m0 == m1, "the ranks report different metrics"
    a, b = dict(_tensors(s0)), dict(_tensors(s1))
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    assert not differ, f"the ranks' states differ: {differ[:5]}"
    for i, (g, w) in enumerate(zip(m0, want_m)):
        rel, atol = (1e-5, 1e-6) if i == 0 else (1e-4, 1e-5)
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=rel, abs=atol), (i, k, g[k], w[k])
    # every weight's gradient within 1e-5; the biases and slopes as one vector
    # within 1e-5 or twice the floor's distance: a bias whose gradient cancels
    # through an InstanceNorm (MidMLKA's before its gate) is rounding noise in
    # one process too, rel-L2 ~1 at another thread count
    for net in ("netG", "netD"):
        for k, w in want_g[net].items():
            if w.dim() > 1:
                assert rel_l2(g0[net][k], w) <= 1e-5, (net, k, rel_l2(g0[net][k], w))
        vec = {name: torch.cat([g[net][k].reshape(-1) for k, w in want_g[net].items()
                                if w.dim() < 2]) for name, g in (("got", g0), ("want", want_g),
                                                                 ("floor", floor_g))}
        bound = max(1e-5, 2 * rel_l2(vec["floor"], vec["want"]))
        assert rel_l2(vec["got"], vec["want"]) <= bound, (net, rel_l2(vec["got"], vec["want"]),
                                                          bound)
    check_parameters(s0, want_s, ("netG", "netD"))


def _jax_losses():
    """JAX's single-device pix2pix step (``make_train_step``, jitted) on the
    resnet recipe's weights and batches: per-step losses."""
    import jax
    import jax.numpy as jnp

    from dsgan_tpu.models import define_D as jax_define_D
    from dsgan_tpu.models import define_G as jax_define_G
    from dsgan_tpu.models import pix2pix as jax_pix2pix
    from dsgan_tpu_torch.models import registry
    from dsgan_tpu_torch.utils.convert import jax_from_state_dict

    state, _, size = _recipe("resnet", None)
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    pg, _ = jax_from_state_dict(state.netG.state_dict(),
                                registry.generator_entries(3, 3, 8, "resnet_6blocks",
                                                           use_dropout=False))
    pd, _ = jax_from_state_dict(state.netD.state_dict(),
                                registry.discriminator_entries(6, 8, "basic"))
    cfg = jax_pix2pix.Pix2PixConfig(pool_size=0, use_vgg=False, compute_dtype=None)
    adam = jax_pix2pix.make_adam(cfg.beta1)
    jstate = jax_pix2pix.Pix2PixState(
        params_G=as_jax(pg), params_D=as_jax(pd), opt_G=adam.init(as_jax(pg)),
        opt_D=adam.init(as_jax(pd)), pool_images=jnp.zeros((1,)),
        pool_count=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
        step=jnp.zeros((), jnp.int32))
    g = jax_define_G(3, 3, 8, "resnet_6blocks", "instance", False, dtype=None)
    d = jax_define_D(6, 8, "basic", 3, "instance", False, dtype=None)
    step = jax.jit(jax_pix2pix.make_train_step(g, d, None, None, cfg))
    out = []
    for a, b in _batches("resnet", size):
        jstate, m, _ = step(jstate, jnp.asarray(a), jnp.asarray(b), jnp.float32(LR))
        out.append({k: float(v) for k, v in m.items()})
    return out


def test_data2_spatial2_step_matches_jax(op_runs):
    ranks = [r["step"] for r in op_runs[4]]
    assert all(r[0] == ranks[0][0] for r in ranks), "the ranks report different metrics"
    want = _jax_losses()
    for i, (g, w) in enumerate(zip(ranks[0][0], want)):
        rel, atol = (1e-5, 1e-6) if i == 0 else (1e-4, 1e-5)
        for k in ("loss_G", "loss_D", "loss_G_L1", "loss_G_GAN", "loss_tv", "loss_ssim"):
            assert g[k] == pytest.approx(w[k], rel=rel, abs=atol), (i, k, g[k], w[k])


# -- the generator's forward ----------------------------------------------------

SIZE = 48  # level 3 (6 rows) does not split over 4 ranks, level 4 (3) over 2 or 4


def _generator():
    return define_G(3, 3, 32, "MixConvNeXtML", params=init_params(1), **F32)


def _forward(size):
    """This rank's strip of the generator's serving forward at 48 rows."""
    mesh = resolve_mesh(1, size, height=SIZE)
    G = _generator()
    x = _t(np.random.default_rng(2), 2, 3, SIZE, SIZE)[:, :, mesh.strip(SIZE)]
    with spatial.rows(mesh), torch.no_grad():
        return G(x)


@pytest.mark.parametrize("size", [2, 4])
def test_mixconvnext_forward_on_strips(size, op_runs):
    """The serving forward (the registered K1 / K3 ops with the group's
    statistics) over 2 ranks, and over 4, where level 4's 2 rows do not
    split and run whole on every rank, against one process; over 2 also
    against JAX's ``g.apply`` on the same weights."""
    got = torch.cat([r["forward"] for r in op_runs[size]], 2)
    x = _t(np.random.default_rng(2), 2, 3, SIZE, SIZE)
    G = _generator()
    threads = torch.get_num_threads()
    with torch.no_grad():
        want = G(x)
        torch.set_num_threads(1 if threads > 1 else 2)
        try:
            other = G(x)
        finally:
            torch.set_num_threads(threads)
    # a deep f32 forward is only defined to its summation order: one process
    # differs from itself by ~9e-7 at another thread count (the floor)
    floor = rel_l2(other, want)
    assert rel_l2(got, want) <= max(1e-6, 2 * floor), (rel_l2(got, want), floor)
    if size != 2:
        return
    import jax
    import jax.numpy as jnp

    from dsgan_tpu.models import define_G as jax_define_G

    g = jax_define_G(3, 3, 32, "MixConvNeXtML", dtype=None, inference=True)
    params = jax.tree_util.tree_map(jnp.asarray, init_params(1))
    jy = jax.jit(lambda v: g.apply({"params": params}, v))(
        jnp.asarray(x.permute(0, 2, 3, 1).numpy()))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(jy), rtol=2e-3,
                               atol=2e-4)

"""The port's CUDA kernels on the card: K1 and K3 (bf16 in
``csrc/block_core2_fwd_sm90.cu``, f32 in ``csrc/block_core.cu``) and K2 and
K4 (bf16 in ``csrc/block_core2_bwd_sm90.cu``, f32 in
``csrc/block_core_bwd.cu``) against their plain PyTorch versions at shapes
the generator never gives them (ragged row tiles, widths that are not
multiples of 16, unequal parts) and at every site's full channel widths,
on each route of the bf16 forward, the wrappers' refusals,
the launch counters, and the generator's kernel path against its plain
path, forward and backward. Each test needs a CUDA card and
skips without one. On the card (no JAX needed, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

from unittest import mock

import numpy as np
import pytest
import torch

from dsgan_tpu_torch.kernels import block_core as bc
from dsgan_tpu_torch.ops import instance_stats

pytestmark = pytest.mark.cuda

# bf16: the forward tolerance of tests/test_pallas.py; f32: sums in
# another order only
TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2), torch.float32: dict(rtol=2e-4, atol=2e-4)}
FLAVOURS = [(torch.bfloat16, "tanh"), (torch.float32, "erf"), (torch.float32, "tanh")]


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the block-core kernels have no CPU mode")
    # the plain versions' f32 GEMMs in full f32
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _act(rng, b, c, h, w, dtype):
    """(B, C, H, W) in channels_last memory, from numpy."""
    a = rng.standard_normal((b, h, w, c)).astype(np.float32)
    return torch.from_numpy(a).cuda().to(dtype).permute(0, 3, 1, 2)


def _weights(rng, c, p, dtype):
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
    return [t.to(dtype) for t in (mk(c, 4 * c) * 0.1, mk(4 * c), mk(4 * c, p) * 0.1, mk(p),
                                  mk(c, p) * 0.1)]


def _assert_close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# the encoder's sites c1-c5 at full channel width on 12 x 12 pixels (288
# rows: no whole number of 128-row tiles; c1 narrow, c2 and c3 fused, c4 and
# c5 two-pass), and c2's and c4's widths on enough rows for the
# two-warpgroup tiles and (c4) 256-wide pass-2 blocks
C_SHAPES = [(2, 12, 12, 3, 64), (2, 12, 12, 64, 128), (2, 12, 12, 128, 256),
            (2, 12, 12, 256, 512), (2, 12, 12, 512, 1024), (2, 100, 99, 64, 128),
            (2, 66, 66, 256, 512)]


@pytest.mark.parametrize("dtype,gelu", FLAVOURS)
@pytest.mark.parametrize("b,h,w,c,p", [(2, 5, 7, 3, 40), (1, 9, 9, 48, 24), (3, 4, 4, 17, 64)]
                         + C_SHAPES)
def test_k1_matches_plain(cuda, dtype, gelu, b, h, w, c, p):
    rng = np.random.default_rng(c * 100 + p)
    hh, x = _act(rng, b, c, h, w, dtype), _act(rng, b, c, h, w, dtype)
    ws = _weights(rng, c, p, dtype)
    mean, rsig = instance_stats(hh)
    with torch.inference_mode():
        got = bc.block_core(hh, x, mean, rsig, *ws, gelu=gelu)
        want = bc.block_core_reference(hh, x, mean, rsig, *ws, gelu=gelu)
    _assert_close(got, want, dtype)


# the decoder's sites uc1-uc4 at full channel width, on 12 x 12 pixels (288
# rows: no whole number of 128-row tiles), and uc4's widths on enough rows
# for the two-warpgroup tiles (19,800 rows)
UC_SHAPES = [(2, 12, 12, 512, 512, 512), (2, 12, 12, 256, 256, 256), (2, 12, 12, 128, 128, 128),
             (2, 12, 12, 64, 64, 64), (2, 100, 99, 64, 64, 64)]


@pytest.mark.parametrize("dtype,gelu", FLAVOURS)
@pytest.mark.parametrize("b,h,w,c1,c2,p", [(2, 5, 7, 24, 40, 32), (1, 6, 6, 5, 3, 20),
                                           (2, 8, 8, 64, 64, 64)] + UC_SHAPES)
def test_k3_matches_plain(cuda, dtype, gelu, b, h, w, c1, c2, p):
    rng = np.random.default_rng(c1 * 100 + c2)
    ha, hb = _act(rng, b, c1, h, w, dtype), _act(rng, b, c2, h, w, dtype)
    xa, xb = _act(rng, b, c1, h, w, dtype), _act(rng, b, c2, h, w, dtype)
    ws = _weights(rng, c1 + c2, p, dtype)
    with torch.inference_mode():
        got = bc.block_core2_in(ha, hb, xa, xb, *ws, gelu=gelu)
        stats = [*instance_stats(ha), *instance_stats(hb)]
        want = bc.block_core2_reference(ha, hb, xa, xb, *stats, *ws, gelu=gelu)
    _assert_close(got, want, dtype)


def test_each_launch_counts_once(cuda):
    rng = np.random.default_rng(3)
    dtype = torch.bfloat16
    h, x = _act(rng, 2, 16, 8, 8, dtype), _act(rng, 2, 16, 8, 8, dtype)
    # the kernel reads whole pixel rows of each part: a channel slice of a
    # channels_last tensor is not one, so the parts are made on their own
    ha, hb, xa, xb = (_act(rng, 2, 8, 8, 8, dtype) for _ in range(4))
    ws = _weights(rng, 16, 16, dtype)
    bc.block_core.launches = bc.block_core2.launches = 0
    with torch.inference_mode():
        for _ in range(3):
            bc.block_core_in(h, x, *ws)
        bc.block_core2_in(ha, hb, xa, xb, *ws)
        # the plain versions launch no kernel of the port
        bc.block_core_reference(h, x, *instance_stats(h), *ws)
    assert (bc.block_core.launches, bc.block_core2.launches) == (3, 1)


def test_wrappers_raise_rather_than_fall_back(cuda):
    rng = np.random.default_rng(4)
    dtype = torch.bfloat16
    h, x = _act(rng, 1, 16, 8, 8, dtype), _act(rng, 1, 16, 8, 8, dtype)
    ws = _weights(rng, 16, 16, dtype)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="channels_last"):
            bc.block_core_in(h.contiguous(), x.contiguous(), *ws)
        with pytest.raises(ValueError, match="bf16 or f32"):
            bc.block_core_in(h.half(), x.half(), *[w.half() for w in ws])
        with pytest.raises(ValueError, match="dtype"):
            bc.block_core_in(h, x.float(), *ws)
    g = _act(rng, 1, 16, 8, 8, dtype)
    stats = instance_stats(h)
    with pytest.raises(ValueError, match="channels_last"):
        bc.block_core_bwd(h, x, *stats, g.contiguous(), ws[0], ws[1], ws[2], ws[4])
    with pytest.raises(ValueError, match="cotangent"):
        bc.block_core_bwd(h, x, *stats, g[:, :8], ws[0], ws[1], ws[2], ws[4])
    # the f32 check build's row tile grows with C (bf16 K2's does not)
    f32 = torch.float32
    with pytest.raises(ValueError, match="shared memory"):
        wide = _weights(rng, 2048, 2048, f32)
        hw_, xw = _act(rng, 1, 2048, 2, 2, f32), _act(rng, 1, 2048, 2, 2, f32)
        bc.block_core_bwd(hw_, xw, *instance_stats(hw_), _act(rng, 1, 2048, 2, 2, f32),
                          wide[0], wide[1], wide[2], wide[4])


def test_generator_kernel_path_matches_plain_path(cuda):
    """The full-width generator at 64x64: every block on its kernel, then
    every block on its plain version, same weights and input."""
    from dsgan_tpu_torch.models import define_G, mixconvnext

    net = define_G(3, 3, 32, "MixConvNeXtML", dtype=torch.bfloat16, device="cuda", seed=1)
    x = _act(np.random.default_rng(5), 2, 3, 64, 64, torch.float32).clamp(-1, 1)

    def plain_in(h, x, w1, b1, w2, b2, ws, gelu="tanh", packed=None):
        return bc.block_core_reference(h, x, *instance_stats(h), w1, b1, w2, b2, ws, gelu)

    def plain2_in(ha, hb, xa, xb, w1, b1, w2, b2, ws, gelu="tanh", packed=None):
        stats = [*instance_stats(ha), *instance_stats(hb)]
        return bc.block_core2_reference(ha, hb, xa, xb, *stats, w1, b1, w2, b2, ws, gelu)

    bc.block_core.launches = bc.block_core2.launches = 0
    with torch.inference_mode():
        got = net(x)
        assert (bc.block_core.launches, bc.block_core2.launches) == (5, 4)
        with mock.patch.object(mixconvnext, "block_core_in", plain_in), \
                mock.patch.object(mixconvnext, "block_core2_in", plain2_in):
            want = net(x)
    assert (bc.block_core.launches, bc.block_core2.launches) == (5, 4)
    assert got.shape == (2, 3, 64, 64) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, **TOL[torch.bfloat16])


# bf16: the tolerances of chip_smoke.py (elementwise 2e-2 for activations,
# rel-L2 1e-2 for the sums over rows); f32: sums in another order only
BWD_TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (1e-3, 1e-4)}


def _assert_bwd_close(got, want, dtype, names):
    torch.cuda.synchronize()
    elem, rel = BWD_TOL[dtype]
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert bool(torch.isfinite(g).all()), name
        g, w = g.float(), w.float()
        if name.startswith(("dn", "dx")):
            torch.testing.assert_close(g, w, rtol=elem, atol=elem * max(1.0, float(w.abs().max())),
                                       msg=name)
        else:
            err = float((g - w).norm() / w.norm().clamp(min=1e-30))
            assert err <= rel, (name, err)


@pytest.mark.parametrize("dtype,gelu", FLAVOURS)
@pytest.mark.parametrize("b,h,w,c,p", [(2, 5, 7, 3, 40), (1, 9, 9, 48, 24), (3, 4, 4, 17, 64),
                                       (2, 33, 31, 64, 64)] + C_SHAPES[:5])
def test_k2_matches_plain(cuda, dtype, gelu, b, h, w, c, p):
    rng = np.random.default_rng(c * 100 + p + 1)
    hh, x, g = _act(rng, b, c, h, w, dtype), _act(rng, b, c, h, w, dtype), _act(rng, b, p, h, w, dtype)
    w1, b1, w2, _, ws = _weights(rng, c, p, dtype)
    stats = instance_stats(hh)
    got = bc.block_core_bwd(hh, x, *stats, g, w1, b1, w2, ws, gelu=gelu)
    want = bc.block_core_bwd_reference(hh, x, *stats, g, w1, b1, w2, ws, gelu=gelu)
    _assert_bwd_close(got, want, dtype, "dn dx dW1 db1 dW2 db2 dWs S1 S2".split())


@pytest.mark.parametrize("dtype,gelu", FLAVOURS)
@pytest.mark.parametrize("b,h,w,c1,c2,p", [(2, 5, 7, 24, 40, 32), (1, 6, 6, 5, 3, 20),
                                           (2, 17, 9, 64, 64, 64)] + UC_SHAPES)
def test_k4_matches_plain(cuda, dtype, gelu, b, h, w, c1, c2, p):
    rng = np.random.default_rng(c1 * 100 + c2 + 1)
    ha, hb = _act(rng, b, c1, h, w, dtype), _act(rng, b, c2, h, w, dtype)
    xa, xb = _act(rng, b, c1, h, w, dtype), _act(rng, b, c2, h, w, dtype)
    g = _act(rng, b, p, h, w, dtype)
    w1, b1, w2, _, ws = _weights(rng, c1 + c2, p, dtype)
    stats = [*instance_stats(ha), *instance_stats(hb)]
    got = bc.block_core2_bwd(ha, hb, xa, xb, *stats, g, w1, b1, w2, ws, gelu=gelu)
    want = bc.block_core2_bwd_reference(ha, hb, xa, xb, *stats, g, w1, b1, w2, ws, gelu=gelu)
    _assert_bwd_close(got, want, dtype,
                      "dna dnb dxa dxb dW1 db1 dW2 db2 dWs S1a S2a S1b S2b".split())


def test_backward_repeats_bit_for_bit(cuda):
    """Every sum of K2 and K4 is taken in one fixed order: two calls agree
    exactly."""
    rng = np.random.default_rng(12)
    dtype = torch.bfloat16
    parts = [_act(rng, 2, 32, 24, 24, dtype) for _ in range(4)]
    g = _act(rng, 2, 48, 24, 24, dtype)
    w1, b1, w2, _, ws = _weights(rng, 64, 48, dtype)
    stats = [*instance_stats(parts[0]), *instance_stats(parts[1])]
    one = bc.block_core2_bwd(*parts, *stats, g, w1, b1, w2, ws)
    two = bc.block_core2_bwd(*parts, *stats, g, w1, b1, w2, ws)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    h, x = _act(rng, 2, 64, 24, 24, dtype), _act(rng, 2, 64, 24, 24, dtype)
    stats = instance_stats(h)
    one = bc.block_core_bwd(h, x, *stats, g, w1, b1, w2, ws)
    two = bc.block_core_bwd(h, x, *stats, g, w1, b1, w2, ws)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_hopper_kernels_refuse_what_their_plans_cannot_take(cuda):
    """The bf16 gates, one part and two: the wgmma forward's resident
    64-row input tile past shared memory (2048 input channels), and a pack
    without the transposes."""
    rng = np.random.default_rng(14)
    dtype = torch.bfloat16
    parts = [_act(rng, 1, 1024, 2, 2, dtype) for _ in range(4)]
    stats = [*instance_stats(parts[0]), *instance_stats(parts[1])]
    w1, b1, w2, b2, ws = _weights(rng, 2048, 64, dtype)
    with pytest.raises(ValueError, match="shared memory"):
        bc.block_core2(*parts, *stats, w1, b1, w2, b2, ws)
    small = [_act(rng, 1, 8, 4, 4, dtype) for _ in range(4)]
    stats = [*instance_stats(small[0]), *instance_stats(small[1])]
    w = _weights(rng, 16, 16, dtype)
    bare = bc.pack_weights(*w, dtype, c1=8)._replace(w1t=None, w2t=None, wst=None)
    with pytest.raises(ValueError, match="transposes"):
        bc.block_core2(*small, *stats, *w, packed=bare)
    with pytest.raises(ValueError, match="transposes"):
        bc.block_core2_bwd(*small, *stats, _act(rng, 1, 16, 4, 4, dtype), w[0], w[1], w[2], w[4],
                           packed=bare)
    # one input: 2048 channels, on the fused (P = 64) and two-pass (P = 512) routes
    h, x = _act(rng, 1, 2048, 2, 2, dtype), _act(rng, 1, 2048, 2, 2, dtype)
    for p in (64, 512):
        w1, b1, w2, b2, ws = _weights(rng, 2048, p, dtype)
        with pytest.raises(ValueError, match="shared memory"):
            bc.block_core(h, x, *instance_stats(h), w1, b1, w2, b2, ws)
    # one input without the transposes (32 channels: the wgmma routes)
    h, x = _act(rng, 1, 32, 4, 4, dtype), _act(rng, 1, 32, 4, 4, dtype)
    w = _weights(rng, 32, 16, dtype)
    bare = bc.pack_weights(*w, dtype)._replace(w1t=None, w2t=None, wst=None)
    with pytest.raises(ValueError, match="transposes"):
        bc.block_core(h, x, *instance_stats(h), *w, packed=bare)
    with pytest.raises(ValueError, match="transposes"):
        bc.block_core_bwd(h, x, *instance_stats(h), _act(rng, 1, 16, 4, 4, dtype), w[0], w[1],
                          w[2], w[4], packed=bare)


def test_autograd_runs_k1_k2_and_counts_once_each(cuda):
    rng = np.random.default_rng(13)
    dtype = torch.bfloat16
    h, x = (_act(rng, 2, 16, 8, 8, dtype).requires_grad_() for _ in range(2))
    ws = [t.requires_grad_() for t in _weights(rng, 16, 24, dtype)]
    ha, hb, xa, xb = (_act(rng, 2, 8, 8, 8, dtype).requires_grad_() for _ in range(4))
    ws2 = [t.requires_grad_() for t in _weights(rng, 16, 24, dtype)]
    for f in (bc.block_core, bc.block_core2, bc.block_core_bwd, bc.block_core2_bwd):
        f.launches = 0
    loss = bc.block_core_in(h, x, *ws).float().square().sum() + \
        bc.block_core2_in(ha, hb, xa, xb, *ws2).float().square().sum()
    loss.backward()
    counts = [f.launches for f in (bc.block_core, bc.block_core2, bc.block_core_bwd,
                                   bc.block_core2_bwd)]
    assert counts == [1, 1, 1, 1]
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in (h, x, ha, hb, xa, xb, *ws, *ws2))


# the generator's gradient, kernel path vs plain path at 64x64: rel-L2 of
# each K2/K4 output at block level; median over the block weights; kernel
# path's median distance to the f32 gradient over the plain path's. Set from
# readings on an H100 (PERF.md, "Gradient gate").
GRAD_GATE = dict(block=5e-3, median=3e-2, ratio=1.10)
# faults of a known size in every K2/K4 output (see ``_faulty``), each of
# which the gate must refuse
CONTROLS = [("gain", 0.02), ("gain", 0.01), ("noise", 0.02), ("noise", 0.01)]


def _faulty(kernel, kind, size):
    def call(*args, packed=None):
        out = kernel(*args, packed=packed)
        if kind == "gain":
            return tuple((o.float() * (1 + size)).to(o.dtype) for o in out)
        return tuple((o.float() * (1 + size * torch.randn_like(o, dtype=torch.float32)))
                     .to(o.dtype) for o in out)

    call.launches = 0
    return call


def _folds(out, args, n):
    """dh of each of the n parts from a K2 / K4 output and its arguments."""
    ss = out[len(out) - 2 * n:]
    return [bc.in_fold(out[i], args[i], args[2 * n + 2 * i], args[2 * n + 2 * i + 1], ss[2 * i],
                       ss[2 * i + 1]) for i in range(n)]


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_generator_gradients_kernel_path_match_plain_path(cuda, monkeypatch, seed):
    """The full-width training generator at 64x64, bf16 compute, f32
    parameters, same weights, input and target on both paths, cuDNN held to
    deterministic algorithms. Block by block on the cotangent the kernel
    path delivers, every K2/K4 output and the folded dh within rel-L2
    GRAD_GATE["block"] of the plain version's. Over the whole generator
    bf16 rounding accumulates along the backward, so there the median
    block-weight rel-L2 has a looser limit, and the kernel path must be no
    farther than the plain path, within GRAD_GATE["ratio"], from the same
    gradient in f32 (TF32 off, the same tanh GELU). Faulty K2/K4 controls
    must fail the whole-generator part of the gate on its own. The dwconv
    biases are left out: the InstanceNorm after the depthwise conv makes
    their gradient zero in exact arithmetic. Prints its readings (``-s``)."""
    from dsgan_tpu_torch.models import define_G

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    net = define_G(3, 3, 32, "MixConvNeXtML", dtype=torch.bfloat16, device="cuda", seed=seed,
                   train=True)
    rng = np.random.default_rng(seed + 4)
    x = _act(rng, 2, 3, 64, 64, torch.float32).clamp(-1, 1)
    tgt = _act(rng, 2, 3, 64, 64, torch.float32)
    blocks = {k for k, _ in net.named_parameters()
              if k.split(".")[0][:2] in ("c1", "c2", "c3", "c4", "c5", "uc")
              and not k.endswith("dwconv.bias")}

    def grads(net=net):
        net.zero_grad(set_to_none=True)
        (net(x).float() - tgt).square().mean().backward()
        return {k: p.grad.clone() for k, p in net.named_parameters() if k in blocks}

    def held(kernel, plain, n, sink):
        def call(*args, packed=None):
            out = kernel(*args, packed=packed)
            ref = plain(*args)
            dh = zip(_folds(out, args, n), _folds(ref, args, n))
            sink.append([_rel_l2(o, r) for o, r in [*zip(out, ref), *dh]])
            return out
        call.launches = 0  # the comparison's launches stay off the real counts
        return call

    def blockwise(k2, k4, sink):
        return (mock.patch.object(bc, "block_core_bwd", held(k2, bc.block_core_bwd_reference, 1,
                                                             sink)),
                mock.patch.object(bc, "block_core2_bwd", held(k4, bc.block_core2_bwd_reference, 2,
                                                              sink)))

    for f in (bc.block_core, bc.block_core2, bc.block_core_bwd, bc.block_core2_bwd):
        f.launches = 0
    kernel_bwd, kernel_bwd2 = bc.block_core_bwd, bc.block_core2_bwd
    per_block = {"kernel": []}
    p2, p4 = blockwise(kernel_bwd, kernel_bwd2, per_block["kernel"])
    with p2, p4:
        got = {"kernel": grads()}
    assert [f.launches for f in (bc.block_core, bc.block_core2)] == [5, 4]
    # K2: dn dx, 5 weight gradients, S1 S2, dh; K4: both parts of each
    assert [len(r) for r in per_block["kernel"]] == [15] * 4 + [10] * 5
    for kind, size in CONTROLS:
        name = f"{kind} {size}"
        per_block[name] = []
        torch.cuda.manual_seed(99)
        p2, p4 = blockwise(_faulty(kernel_bwd, kind, size), _faulty(kernel_bwd2, kind, size),
                           per_block[name])
        with p2, p4:
            got[name] = grads()
    with mock.patch.object(bc, "block_core", _plain_fwd), \
            mock.patch.object(bc, "block_core2", _plain_fwd2), \
            mock.patch.object(bc, "block_core_bwd", _plain_bwd), \
            mock.patch.object(bc, "block_core2_bwd", _plain_bwd2):
        want = grads()
        truth = grads(define_G(3, 3, 32, "MixConvNeXtML", dtype=torch.float32, device="cuda",
                               seed=seed, train=True, gelu_mode="tanh"))

    def median(vals):
        vals = sorted(vals)
        return vals[len(vals) // 2]

    plain_f32 = median(_rel_l2(want[k], truth[k]) for k in truth)

    def gate(name):
        g = got[name]
        r = dict(block_worst=max(max(b) for b in per_block[name]),
                 median_vs_plain=median(_rel_l2(g[k], want[k]) for k in want),
                 ratio=median(_rel_l2(g[k], truth[k]) for k in truth) / plain_f32)
        r["whole_passes"] = (r["median_vs_plain"] <= GRAD_GATE["median"]
                             and r["ratio"] <= GRAD_GATE["ratio"])
        r["passes"] = (len(per_block[name]) == 9 and r["block_worst"] <= GRAD_GATE["block"]
                       and r["whole_passes"])
        return r

    readings = dict(seed=seed, plain_vs_f32=plain_f32, **{k: gate(k) for k in got})
    print("gradient readings:", readings)
    assert readings["kernel"]["passes"], readings
    assert not any(readings[f"{kind} {size}"]["whole_passes"] for kind, size in CONTROLS), \
        readings


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm().clamp(min=1e-30))


def _plain_fwd(*args, packed=None):
    return bc.block_core_reference(*args)


def _plain_fwd2(*args, packed=None):
    return bc.block_core2_reference(*args)


def _plain_bwd(*args, packed=None):
    return bc.block_core_bwd_reference(*args)


def _plain_bwd2(*args, packed=None):
    return bc.block_core2_bwd_reference(*args)


def _tiny_train(seed=0, size=64):
    """The default recipe at 64x64 with a pool of 2 and no VGG: (state,
    step, cfg) on the card, bf16."""
    from dsgan_tpu_torch.models import define_D, define_G
    from dsgan_tpu_torch.models.pix2pix import Pix2PixConfig, init_state, make_train_step

    cfg = Pix2PixConfig(pool_size=2, use_vgg=False, compute_dtype=torch.bfloat16)
    netG = define_G(3, 3, 32, "MixConvNeXtML", dtype=torch.bfloat16, device="cuda", seed=seed,
                    train=True)
    netD = define_D(6, 32, "basic", dtype=torch.bfloat16, device="cuda", seed=seed + 1)
    return init_state(netG, netD, None, cfg, (size, size), seed=seed), make_train_step(cfg), cfg


def _all_tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    vals = obj.values() if isinstance(obj, dict) else obj if isinstance(obj, (list, tuple)) else []
    return [t for v in vals for t in _all_tensors(v)]


def test_graph_replays_equal_eager_steps(cuda):
    """From one state (its copy loaded through state_dict), three replays of
    the captured step equal three eager steps bit for bit: parameters, Adam
    moments and steps, the pool's images and generator, the step counter,
    every metric. The capture counts one step's launches; the replays none."""
    import copy

    from dsgan_tpu_torch.models.pix2pix import chained_train_step

    rng = np.random.default_rng(0)
    batches = [[torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)).cuda()
                for _ in range(2)] for _ in range(4)]
    a, step, cfg = _tiny_train()
    eager = chained_train_step(step, cfg)
    eager.step(a, batches[0], 2e-4)  # fills the pool of 2
    assert a.pool.full
    b, _, _ = _tiny_train(seed=7)
    b.load_state_dict(copy.deepcopy(a.state_dict()))
    graph = chained_train_step(step, cfg, warmup=0)
    want = [eager.step(a, x, 2e-4, eager=True)[0].clone() for x in batches[1:]]
    for f in (bc.block_core, bc.block_core2, bc.block_core_bwd, bc.block_core2_bwd):
        f.launches = 0
    got = [graph.step(b, x, 2e-4)[0].clone() for x in batches[1:]]
    torch.cuda.synchronize()
    assert graph.counts == dict(eager=0, captured=1, replayed=3)
    assert [f.launches for f in (bc.block_core, bc.block_core2, bc.block_core_bwd,
                                 bc.block_core2_bwd)] == [5, 4, 5, 4]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    sa, sb = _all_tensors(a.state_dict()), _all_tensors(b.state_dict())
    assert len(sa) == len(sb) > 100
    assert all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(sa, sb))


def test_failed_capture_raises(cuda):
    """A step that reads a value on the host cannot be captured: the
    chained step raises, it does not run eagerly instead."""
    from dsgan_tpu_torch.models.base_model import ChainedStep

    def step(state, x, lr):
        return {"m": x.sum() * float(x.max())}, x

    chained = ChainedStep(step, warmup=0)
    with pytest.raises(RuntimeError):
        chained.step({}, [torch.ones(4, device="cuda")], 0.1)
    assert chained.counts["eager"] == 0 and chained.graph is None


def test_registered_ops_launch_the_kernels(cuda):
    """dsgan::block_core / dsgan::block_core2 on CUDA tensors launch K1 / K3
    (counted) and give the wrappers' output; their plain versions agree."""
    rng = np.random.default_rng(8)
    dtype = torch.bfloat16
    h, x = _act(rng, 2, 64, 16, 16, dtype), _act(rng, 2, 64, 16, 16, dtype)
    ha, hb, xa, xb = (_act(rng, 2, 32, 16, 16, dtype) for _ in range(4))
    ws = _weights(rng, 64, 48, dtype)
    pk = bc.pack_weights(*ws, dtype)
    pk2 = bc.pack_weights(*ws, dtype, c1=32)
    bc.block_core.launches = bc.block_core2.launches = 0
    one = torch.ops.dsgan.block_core(h, x, *instance_stats(h), *bc._op_weights(pk), "tanh")
    two = torch.ops.dsgan.block_core2(ha, hb, xa, xb, *instance_stats(ha), *instance_stats(hb),
                                      *bc._op_weights(pk2), "tanh")
    assert (bc.block_core.launches, bc.block_core2.launches) == (1, 1)
    torch.testing.assert_close(one, bc.block_core(h, x, *instance_stats(h), *ws, packed=pk),
                               rtol=0, atol=0)
    _assert_close(one, bc.block_core_reference(h, x, *instance_stats(h), *ws), dtype)
    stats = [*instance_stats(ha), *instance_stats(hb)]
    _assert_close(two, bc.block_core2_reference(ha, hb, xa, xb, *stats, *ws), dtype)
    with pytest.raises(ValueError, match="channels_last"):
        torch.ops.dsgan.block_core(h.contiguous(), x, *instance_stats(h), *bc._op_weights(pk),
                                   "tanh")


def test_artifact_on_the_card_matches_serving_fn(cuda, tmp_path):
    """The full-width bf16 generator exported at 64x64, loaded on the card
    (the default device): 5 K1 + 4 K3 launches a forward, the serving
    function's output (at most 0.1% of pixels one level off), float and w8."""
    from dsgan_tpu_torch import export, serve
    from dsgan_tpu_torch.models import define_G

    net = define_G(3, 3, 32, "MixConvNeXtML", dtype=torch.bfloat16, device="cuda", seed=2)
    program, meta = export.export_generator(net, 64, 64, 3)
    call, _ = export.load_artifact(export.save_artifact(str(tmp_path / "g.pt2"), program, meta))
    x = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (3, 64, 64, 3),
                                                           dtype=np.uint8)).cuda()
    for quantize in (None, "w8"):
        if quantize:
            net32 = define_G(3, 3, 32, "MixConvNeXtML", dtype=torch.bfloat16, device="cuda",
                             seed=2, train=True).eval()
            program, meta = export.export_generator(net32, 64, 64, 3, quantize=quantize)
            call, _ = export.load_artifact(export.save_artifact(str(tmp_path / "q.pt2"), program,
                                                                meta))
        bc.block_core.launches = bc.block_core2.launches = 0
        got = call(x)
        torch.cuda.synchronize()
        assert (bc.block_core.launches, bc.block_core2.launches) == (5, 4)
        assert got.dtype == torch.uint8 and got.shape == (3, 64, 64, 3)
        if quantize is None:
            d = (got.int() - serve.serving_fn(net)(x).int()).abs()
            assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3


GENERATORS = [("resnet_9blocks", 64), ("resnet_6blocks", 64), ("unet_128", 128),
              ("unet_256", 256), ("gll", 64), ("cascaded", 64), ("unetpp", 64), ("wnet", 64)]


@pytest.mark.parametrize("name,size", GENERATORS)
def test_zoo_forward_on_the_card_matches_the_cpu(cuda, monkeypatch, name, size):
    """Each zoo generator (ngf 8, BatchNorm running statistics moved): f32 on
    the card against f32 on the CPU (TF32 off), and a finite bf16 forward;
    no block-core kernel runs."""
    from dsgan_tpu_torch.models import define_G

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x = torch.from_numpy(np.random.default_rng(10).uniform(-1, 1, (2, 3, size, size))
                         .astype(np.float32))
    norm = "instance" if name == "cascaded" else "batch"
    outs = {}
    bc.block_core.launches = bc.block_core2.launches = 0
    for dev in ("cpu", "cuda"):
        net = define_G(3, 3, 8, name, norm=norm, dtype=torch.float32, device=dev, seed=4,
                       train=True)
        with torch.no_grad():
            net(x.to(dev))  # one train forward: running statistics off their start
            outs[dev] = net.eval()(x.to(dev)).cpu()
    torch.testing.assert_close(outs["cuda"], outs["cpu"], rtol=1e-3, atol=1e-4)
    net.compute_dtype = torch.bfloat16
    with torch.no_grad():
        y = net(x.cuda())
    assert y.dtype == torch.float32 and bool(torch.isfinite(y).all())
    assert (bc.block_core.launches, bc.block_core2.launches) == (0, 0)


@pytest.mark.parametrize("window,stride,padding", [(3, 2, 1), (2, 2, 0)])
def test_average_pool_gradient_on_the_card_matches_the_cpu(cuda, window, stride, padding):
    """``ops.avg_pool2d`` on a channels_last CUDA tensor (the multiscale D's
    and gll's 3x3 stride-2 pyramids, cascaded's 2x2 one): its input gradient
    matches the CPU's. torch's own overlapping pool on channels_last memory
    does not on torch 2.11 + CUDA 12.8 (rel-L2 ~1), which ``ops.pool_avg``
    steps around."""
    from dsgan_tpu_torch import ops

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 6, 64, 64)).astype(np.float32))

    def grad(t):
        t = t.detach().clone().requires_grad_(True)
        y = ops.avg_pool2d(t, window, stride, padding, count_include_pad=False)
        g = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(np.float32))
        y.backward(g.to(t.device))
        return y.detach().cpu(), t.grad.cpu()

    rng = np.random.default_rng(7)
    want = grad(x)
    rng = np.random.default_rng(7)
    got = grad(x.to(cuda).contiguous(memory_format=torch.channels_last))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("recipe,size", [("gll_multi", 64), ("cycle_unet_multi", 128)])
def test_card_vs_cpu_small_recipes_read_under_the_limit(cuda, monkeypatch, recipe, size):
    """``chip_smoke.cvc_compare`` on the card at a small size (ngf 8): one
    f32 step against the port's CPU path, every module's output held at
    the CPU's, every reading under the card_vs_cpu phase's limit; on
    cuDNN's deterministic algorithms, TF32 off."""
    import chip_smoke

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    line, read, _ = chip_smoke.cvc_compare(torch, np, recipe, "cuda", size, 1, ngf=8)
    print(recipe, {k: v["reading"] for k, v in line["worst"].items()})
    assert not line["over"], line["over"]
    assert len(read) == line["readings"] > 40


def test_conv_bias_gradient_on_the_card_is_the_sum(cuda):
    """``ops.conv2d``'s fused bias on the card: its gradient is the
    cotangent's sum to float32's rounding, on a 3-channel output at 256x256
    in channels_last memory and the cotangent of signs an L1 term hands
    back (the CPU's fused bias lands about 1e-5 off it: the card_vs_cpu
    phase reads that as the card's distance, PERF.md §6)."""
    from dsgan_tpu_torch import ops

    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((1, 16, 256, 256)).astype(np.float32)).to(cuda)
    x = x.contiguous(memory_format=torch.channels_last)
    w = torch.from_numpy((0.05 * rng.standard_normal((3, 16, 3, 3))).astype(np.float32)).to(cuda)
    b = torch.zeros(3, device=cuda, requires_grad=True)
    y = ops.conv2d(x, w, b, padding=1)
    g = (np.sign(rng.standard_normal(tuple(y.shape)))
         + 0.01 * rng.standard_normal(tuple(y.shape))) / y[0, 0].numel()
    g = torch.from_numpy(g.astype(np.float32)).to(cuda)
    g = g.contiguous(memory_format=torch.channels_last)
    y.backward(g)
    exact = g.double().sum(dim=(0, 2, 3))
    assert float((b.grad.double() - exact).norm() / exact.norm()) <= 1e-6

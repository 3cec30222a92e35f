"""The block-core backward (dsgan_tpu_torch.kernels.block_core) on the CPU:
the plain versions of K2/K4 against the JAX package's Pallas backward
kernels (``_bwd_impl`` / ``_bwd2_impl`` in interpret mode), the autograd
Functions against ``jax.grad`` of ``block_core_in`` / ``block_core2_in``
(interpret) and of the XLA block path (erf), and the backward's shared
memory gate at every block of the full-width generator. The CUDA kernels
themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsgan_tpu import ops as jops
from dsgan_tpu_torch.kernels import block_core as bc
from dsgan_tpu_torch.ops import instance_stats

# the module: dsgan_tpu.pallas re-exports a function under its name
jbc = importlib.import_module("dsgan_tpu.pallas.block_core")

FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)


def _mk(rng):
    return lambda *s: rng.standard_normal(s).astype(np.float32)


def _weights(mk, c, p):
    return mk(c, 4 * c) * 0.05, mk(4 * c), mk(4 * c, p) * 0.05, mk(p), mk(c, p) * 0.05


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, name, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=name, **(tol or GRAD_TOL))


def _close_raw(got, want, name):
    """A kernel output at an unit-scale cotangent: sums of up to 4C
    products of scale 10, taken in another order, so the absolute slack
    follows the output's scale."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("c,p,hw", [(64, 64, 16), (128, 64, 16), (64, 128, 16)])
def test_plain_k2_matches_pallas_bwd(c, p, hw):
    mk = _mk(np.random.default_rng(21))
    h, x = mk(2, hw, hw, c), mk(2, hw, hw, c)
    w1, b1, w2, b2, ws = _weights(mk, c, p)
    g = mk(2, hw, hw, p)  # an honest random cotangent
    mean, rsig = instance_stats(_nchw(h))
    want = jbc._bwd_impl(*map(jnp.asarray, (h, x, mean.numpy(), rsig.numpy(), w1, b1, w2, b2, ws, g)),
                         True)
    got = bc.block_core_bwd_reference(_nchw(h), _nchw(x), mean, rsig, _nchw(g),
                                      *map(torch.from_numpy, (w1, b1, w2, ws)), gelu="tanh")
    names = "dn dx dW1 db1 dW2 db2 dWs S1 S2".split()
    for name, gt, wt in zip(names, got, want):
        _close_raw(_nhwc(gt) if gt.dim() == 4 else gt.numpy(), wt, name)


@pytest.mark.parametrize("c1,c2,p", [(64, 64, 64), (32, 96, 64)])
def test_plain_k4_matches_pallas_bwd2(c1, c2, p):
    mk = _mk(np.random.default_rng(41))
    hw = 16
    ha, hb, xa, xb = mk(2, hw, hw, c1), mk(2, hw, hw, c2), mk(2, hw, hw, c1), mk(2, hw, hw, c2)
    w1, b1, w2, b2, ws = _weights(mk, c1 + c2, p)
    g = mk(2, hw, hw, p)
    ma, ra = instance_stats(_nchw(ha))
    mb, rb = instance_stats(_nchw(hb))
    stats = [t.numpy() for t in (ma, ra, mb, rb)]
    want = jbc._bwd2_impl(*map(jnp.asarray, (ha, hb, xa, xb, *stats, w1, b1, w2, ws, g)), True)
    got = bc.block_core2_bwd_reference(
        *map(_nchw, (ha, hb, xa, xb)), ma, ra, mb, rb, _nchw(g),
        *map(torch.from_numpy, (w1, b1, w2, ws)), gelu="tanh")
    names = "dna dnb dxa dxb dW1 db1 dW2 db2 dWs S1a S2a S1b S2b".split()
    for name, gt, wt in zip(names, got, want):
        _close_raw(_nhwc(gt) if gt.dim() == 4 else gt.numpy(), wt, name)


def _torch_grads(fn, arrays, tgt):
    """Output and the gradient of mean((fn(...) - tgt)^2) for every input."""
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    loss = (out - tgt).square().mean()
    return out.detach(), torch.autograd.grad(loss, ts)


def test_function_grads_match_pallas_block_core_in():
    """K1 + K2 + the InstanceNorm fold against jax.grad of the Pallas
    block_core_in (interpret), tanh flavour: output and every cotangent."""
    mk = _mk(np.random.default_rng(31))
    c, p, hw = 64, 32, 16
    h, x = mk(2, hw, hw, c), mk(2, hw, hw, c)
    args = (h, x, *_weights(mk, c, p))
    tgt = mk(2, hw, hw, p)

    def jax_loss(a):
        return jnp.mean(jnp.square(jbc.block_core_in(*a, True) - tgt))

    jargs = tuple(map(jnp.asarray, args))
    want_out = jbc.block_core_in(*jargs, True)
    want = jax.grad(jax_loss)(jargs)

    def port(h, x, *w):
        return bc.block_core_in(h.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), *w,
                                gelu="tanh").permute(0, 2, 3, 1)

    out, got = _torch_grads(port, args, torch.from_numpy(tgt))
    _close(out.numpy(), want_out, "out", **FWD_TOL)
    for name, gt, wt in zip("h x w1 b1 w2 b2 ws".split(), got, want):
        _close(gt.numpy(), wt, name)


@pytest.mark.parametrize("c1,c2,p", [(64, 64, 64), (32, 96, 64)])
def test_function_grads_match_pallas_block_core2_in(c1, c2, p):
    mk = _mk(np.random.default_rng(41))
    hw = 16
    args = (mk(2, hw, hw, c1), mk(2, hw, hw, c2), mk(2, hw, hw, c1), mk(2, hw, hw, c2),
            *_weights(mk, c1 + c2, p))
    tgt = mk(2, hw, hw, p)
    jargs = tuple(map(jnp.asarray, args))
    want_out = jbc.block_core2_in(*jargs, True)
    want = jax.grad(lambda a: jnp.mean(jnp.square(jbc.block_core2_in(*a, True) - tgt)))(jargs)

    def port(ha, hb, xa, xb, *w):
        parts = [t.permute(0, 3, 1, 2) for t in (ha, hb, xa, xb)]
        return bc.block_core2_in(*parts, *w, gelu="tanh").permute(0, 2, 3, 1)

    out, got = _torch_grads(port, args, torch.from_numpy(tgt))
    _close(out.numpy(), want_out, "out", **FWD_TOL)
    for name, gt, wt in zip("ha hb xa xb w1 b1 w2 b2 ws".split(), got, want):
        _close(gt.numpy(), wt, name)


def _jax_xla_block(h, x, w1, b1, w2, b2, ws):
    """The JAX package's f32 XLA block path (mixconvnext.py:200-205), exact GELU."""
    hn = jops.instance_norm(h) @ w1 + b1
    return x @ ws + (jax.nn.gelu(hn, approximate=False) @ w2 + b2)


@pytest.mark.parametrize("two", [False, True], ids=["one_input", "two_input"])
def test_function_grads_match_the_xla_block_path_in_erf(two):
    """gelu="erf": the Functions' plain forward and backward (the f32 path
    the CPU train step runs) against jax.grad of the XLA block path."""
    mk = _mk(np.random.default_rng(5))
    c1, c2, p, hw = 24, 40, 48, 8
    ha, hb, xa, xb = mk(2, hw, hw, c1), mk(2, hw, hw, c2), mk(2, hw, hw, c1), mk(2, hw, hw, c2)
    w = _weights(mk, c1 + c2, p)
    tgt = mk(2, hw, hw, p)

    def jax_loss(a):
        ha, hb, xa, xb, *w = a
        out = _jax_xla_block(jnp.concatenate([ha, hb], -1), jnp.concatenate([xa, xb], -1), *w)
        return jnp.mean(jnp.square(out - tgt))

    want = jax.grad(jax_loss)(tuple(map(jnp.asarray, (ha, hb, xa, xb, *w))))

    def port(ha, hb, xa, xb, *w):
        parts = [t.permute(0, 3, 1, 2) for t in (ha, hb, xa, xb)]
        if two:
            out = bc.block_core2_in(*parts, *w, gelu="erf")
        else:
            out = bc.block_core_in(torch.cat(parts[:2], 1), torch.cat(parts[2:], 1), *w,
                                   gelu="erf")
        return out.permute(0, 2, 3, 1)

    _, got = _torch_grads(port, (ha, hb, xa, xb, *w), torch.from_numpy(tgt))
    for name, gt, wt in zip("ha hb xa xb w1 b1 w2 b2 ws".split(), got, want):
        _close(gt.numpy(), wt, name)


def test_cpu_backward_runs_the_plain_versions_without_counting():
    mk = _mk(np.random.default_rng(7))
    h, x = (torch.from_numpy(mk(2, 8, 4, 4)).requires_grad_() for _ in range(2))
    w = [torch.from_numpy(a).requires_grad_() for a in _weights(mk, 8, 16)]
    before = (bc.block_core_bwd.launches, bc.block_core2_bwd.launches)
    bc.block_core_in(h, x, *w).square().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (h, x, *w))
    assert (bc.block_core_bwd.launches, bc.block_core2_bwd.launches) == before


# (site, input channels of each part, P) of every ConvNeXt block at full width
SITES = [("c1", (3,), 64), ("c2", (64,), 128), ("c3", (128,), 256), ("c4", (256,), 512),
         ("c5", (512,), 1024), ("uc1", (512, 512), 512), ("uc2", (256, 256), 256),
         ("uc3", (128, 128), 128), ("uc4", (64, 64), 64)]


@pytest.mark.parametrize("site,parts,p", SITES, ids=[s[0] for s in SITES])
def test_backward_tile_fits_shared_memory_at_full_width(site, parts, p):
    """Every block's backward fits shared memory in the 32-row f32 check
    build of block_core_bwd.cu (K2 and K4 in f32): the wrapper's gate
    (bwd_rows, mirroring row_smem_bytes) finds a row tile, 16 rows only for
    c5 and uc1. bf16 runs the Hopper kernel on k4_plan, held below."""
    cp = sum(bc._ceil16(c) for c in parts)
    h4p, pp = bc._ceil16(4 * sum(parts)), bc._ceil16(p)
    hc = bc._hidden_chunk(h4p)
    tm = bc.bwd_rows(cp, hc, pp)
    assert bc.bwd_smem_bytes(tm, cp, hc, pp) <= bc.MAX_SMEM
    assert tm == (16 if site in ("c5", "uc1") else 32), (site, tm)


# bf16 K2 / K4 at batch 16 per site (side of the 256x256 generator's
# feature map, C, P): workspace bytes, and the row splits of the weight
# pass's dW1 / dW2 / dWs products
K4_PLANS = {"c1": (256, 3, 64, 140325888, (261, 261, 261)),
            "c2": (128, 64, 128, 373555200, (128, 128, 256)),
            "c3": (64, 128, 256, 220463104, (64, 32, 128)),
            "c4": (32, 256, 512, 137371648, (16, 9, 32)),
            "c5": (16, 512, 1024, 105381888, (5, 3, 8)),
            "uc1": (32, 1024, 512, 416579584, (2, 3, 9)),
            "uc2": (64, 512, 256, 734593024, (5, 9, 32)),
            "uc3": (128, 256, 128, 1407975424, (17, 33, 128)),
            "uc4": (256, 128, 64, 2746646528, (66, 66, 261))}


@pytest.mark.parametrize("site", list(K4_PLANS))
def test_k4_plan_at_full_width(site):
    """The plan of the bf16 K2 / K4 kernel (mirroring make_plan in
    csrc/block_core2_bwd_sm90.cu): 128-row tiles that never cross an
    image, a weight pass split to give each of the 132 SMs a block or more, and
    the workspace: a and x side by side, ag and dg1, the partial sums."""
    side, c, p, nbytes, splits = K4_PLANS[site]
    hw = side * side
    cp, h4p, pp = bc._ceil16(c), bc._ceil16(4 * c), bc._ceil16(p)
    plan = bc.k4_plan(16, hw, cp, h4p, p, pp)
    assert plan.timg == hw // 128 and plan.tiles == 16 * hw // 128 and not plan.gcopy
    assert plan.workspace == nbytes
    assert tuple(j.nsplit for j in plan.jobs) == splits
    m = 16 * hw
    # the scratch (a, x, ag, dg1) is most of it
    assert plan.workspace >= m * (2 * cp + 2 * h4p) * 2
    for job in plan.jobs:
        tiles = -(-job.rows // 128) * -(-job.cols // job.bn)
        assert job.rps % 64 == 0 and job.nsplit == -(-m // job.rps)
        assert tiles * job.nsplit >= bc.SMS  # every SM has a block
    assert plan.smem <= bc.MAX_SMEM


def test_k4_plan_pads_g_and_raises_past_its_indices():
    # P = 20: g's rows are 40 bytes, not whole 16-byte units, so K4 pads it
    assert bc.k4_plan(1, 36, 16, 32, 20, 32).gcopy
    with pytest.raises(ValueError, match="2\\^31"):
        bc.k4_plan(64, 1 << 20, 64, 256, 64, 64)


def test_backward_gate_raises_past_shared_memory():
    # uc1, 16 rows: 16 * 4 * (1028 + 2 * 132 + 1028 + 516) bytes
    assert bc.bwd_smem_bytes(16, 1024, 128, 512) == 181504
    with pytest.raises(ValueError, match="shared memory"):
        bc.bwd_rows(2048, 128, 2048)


def test_k2_k4_run_in_chunks_of_images_past_their_indices():
    """A batch whose matrices reach 2^31 elements (uc4 at 1024x1024: its
    (B * HW, 512) hidden from 4 images) runs K2 / K4 as launches of as many
    images as ``k4_plan`` takes; the joined outputs (dn, dx and the S sums
    along the batch, the weight gradients summed) are one call's, here with
    the plain version as each launch."""
    hw, cp, h4p, pp = 1024 * 1024, 128, 512, 64
    chunks = bc.image_chunks(16, hw, cp, h4p, pp)
    assert chunks == [(0, 3), (3, 6), (6, 9), (9, 12), (12, 15), (15, 16)]
    for i, j in chunks:
        bc.k4_plan(j - i, hw, cp, h4p, pp, pp)
    with pytest.raises(ValueError, match="2\\^31"):
        bc.k4_plan(4, hw, cp, h4p, pp, pp)
    assert bc.image_chunks(16, 256 * 256, cp, h4p, pp) == [(0, 16)]
    assert bc.image_chunks(16, hw, cp, h4p, pp, bf16=False) == [(0, 16)]

    mk = _mk(np.random.default_rng(5))
    c1, c2, p = 4, 3, 5
    ha, hb, xa, xb = (_nchw(mk(3, 4, 4, c)) for c in (c1, c2, c1, c2))
    g = _nchw(mk(3, 4, 4, p))
    w1, b1, w2, _, ws = map(torch.from_numpy, _weights(mk, c1 + c2, p))
    (ma, ra), (mb, rb) = instance_stats(ha), instance_stats(hb)
    want = bc.block_core2_bwd_reference(ha, hb, xa, xb, ma, ra, mb, rb, g, w1, b1, w2, ws)
    got = bc.in_chunks(lambda i, j: bc.block_core2_bwd_reference(
        ha[i:j], hb[i:j], xa[i:j], xb[i:j], ma[i:j], ra[i:j], mb[i:j], rb[i:j], g[i:j], w1, b1,
        w2, ws), [(0, 1), (1, 3)], (0, 1, 2, 3, 9, 10, 11, 12))
    assert len(got) == len(want) == 13
    for k, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=f"output {k}")

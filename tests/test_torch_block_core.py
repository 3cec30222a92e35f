"""The block-core kernel module (dsgan_tpu_torch.kernels.block_core) on the
CPU: its plain versions against the JAX package's Pallas kernels (run in
interpret mode), the CPU dispatch of the wrappers, and the weight packing
the CUDA kernels read. The kernels themselves run only on the card
(``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dsgan_tpu.pallas.block_core import block_core2_in as jax_block_core2_in
from dsgan_tpu.pallas.block_core import block_core_in as jax_block_core_in
from dsgan_tpu_torch.kernels import block_core as bc
from dsgan_tpu_torch.ops import instance_stats

TOL = dict(rtol=2e-4, atol=2e-4)


def _weights(rng, c, p):
    h4 = 4 * c
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return mk(c, h4) * 0.05, mk(h4), mk(h4, p) * 0.05, mk(p), mk(c, p) * 0.05


def _t(a):
    return torch.from_numpy(a)


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


@pytest.mark.parametrize("c,p,hw", [(64, 64, 16), (128, 64, 16), (64, 128, 16)])
def test_block_core_reference_matches_pallas_k1(c, p, hw):
    rng = np.random.default_rng(21)
    h = rng.standard_normal((2, hw, hw, c)).astype(np.float32)
    x = rng.standard_normal((2, hw, hw, c)).astype(np.float32)
    ws = _weights(rng, c, p)
    want = jax_block_core_in(jnp.asarray(h), jnp.asarray(x), *map(jnp.asarray, ws), True)
    mean, rsig = instance_stats(_nchw(h))
    got = bc.block_core_reference(_nchw(h), _nchw(x), mean, rsig, *map(_t, ws), gelu="tanh")
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("c1,c2,p", [(64, 64, 64), (32, 96, 64)])
def test_block_core2_reference_matches_pallas_k3(c1, c2, p):
    rng = np.random.default_rng(41)
    hw = 16
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    ha, hb, xa, xb = mk(2, hw, hw, c1), mk(2, hw, hw, c2), mk(2, hw, hw, c1), mk(2, hw, hw, c2)
    ws = _weights(rng, c1 + c2, p)
    want = jax_block_core2_in(*map(jnp.asarray, (ha, hb, xa, xb, *ws)), True)
    ma, ra = instance_stats(_nchw(ha))
    mb, rb = instance_stats(_nchw(hb))
    got = bc.block_core2_reference(_nchw(ha), _nchw(hb), _nchw(xa), _nchw(xb),
                                   ma, ra, mb, rb, *map(_t, ws), gelu="tanh")
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


def test_erf_flavour_matches_the_xla_block_path():
    """gelu="erf" is the JAX package's f32 XLA block path
    (mixconvnext.py:200-205): IN -> Dense -> exact GELU -> Dense + shortcut."""
    from dsgan_tpu import ops as jops

    rng = np.random.default_rng(5)
    c, p = 32, 48
    h = rng.standard_normal((2, 8, 8, c)).astype(np.float32)
    x = rng.standard_normal((2, 8, 8, c)).astype(np.float32)
    w1, b1, w2, b2, ws = _weights(rng, c, p)
    hn = jops.instance_norm(jnp.asarray(h)) @ w1 + b1
    import jax

    want = jnp.asarray(x) @ ws + (jax.nn.gelu(hn, approximate=False) @ w2 + b2)
    got = bc.block_core_in(_nchw(h), _nchw(x), *map(_t, (w1, b1, w2, b2, ws)), gelu="erf")
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


def test_cpu_wrappers_run_the_plain_versions_without_counting():
    rng = np.random.default_rng(7)
    c1, c2, p = 8, 24, 16
    mk = lambda *s: _nchw(rng.standard_normal(s).astype(np.float32))
    ha, hb, xa, xb = mk(2, 4, 4, c1), mk(2, 4, 4, c2), mk(2, 4, 4, c1), mk(2, 4, 4, c2)
    ws = [_t(w) for w in _weights(rng, c1 + c2, p)]
    before = (bc.block_core.launches, bc.block_core2.launches)
    one = bc.block_core_in(torch.cat([ha, hb], 1), torch.cat([xa, xb], 1), *ws)
    two = bc.block_core2_in(ha, hb, xa, xb, *ws)
    np.testing.assert_allclose(two.numpy(), one.numpy(), rtol=1e-5, atol=1e-5)
    assert (bc.block_core.launches, bc.block_core2.launches) == before


@pytest.mark.parametrize("c1,c2,p", [(3, 0, 64), (64, 64, 64), (20, 12, 40)])
def test_packed_weights_reproduce_the_block(c1, c2, p):
    """The padded, per-part layout the kernels read: the kernel's GEMMs
    (one over the side-by-side padded parts) on the packed weights give the
    plain block's output."""
    rng = np.random.default_rng(9)
    c = c1 + c2
    w1, b1, w2, b2, ws = (_t(w) for w in _weights(rng, c, p))
    pk = bc.pack_weights(w1, b1, w2, b2, ws, torch.float32, c1=c1 if c2 else None)
    cp, h4p = pk.w1.shape
    assert cp % 16 == 0 and h4p % 16 == 0 and pk.w2.shape[1] % 16 == 0
    assert bc._hidden_chunk(h4p) in (16, 32, 64, 128) and h4p % bc._hidden_chunk(h4p) == 0

    a = rng.standard_normal((32, c)).astype(np.float32)
    xr = rng.standard_normal((32, c)).astype(np.float32)

    def side_by_side(v):
        out = torch.zeros((v.shape[0], cp))
        out[:, :c1] = _t(v[:, :c1])
        out[:, pk.c1p: pk.c1p + c2] = _t(v[:, c1:])
        return out

    hid = F.gelu(side_by_side(a) @ pk.w1 + pk.b1, approximate="tanh")
    got = (hid @ pk.w2 + pk.b2 + side_by_side(xr) @ pk.ws)[:, :p]
    want = F.gelu(_t(a) @ w1 + b1, approximate="tanh") @ w2 + b2 + _t(xr) @ ws
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_model_shapes_fit_shared_memory():
    """Every block of the generator at full width fits one thread block's
    shared memory where it runs the 32-row kernels of block_core.cu: K1 in
    both storage types, K3 in f32 (bf16 K3 runs on k3_plan, held below)."""
    shapes = [(3, 64, (2, 4)), (64, 128, (2, 4)), (128, 256, (2, 4)), (256, 512, (2, 4)),
              (512, 1024, (2, 4)), (1024, 512, (4,)), (512, 256, (4,)), (256, 128, (4,)),
              (128, 64, (4,))]
    for c, p, itemsizes in shapes:
        cp, h4p, pp = bc._ceil16(c), bc._ceil16(4 * c), bc._ceil16(p)
        hc = bc._hidden_chunk(h4p)
        for itemsize in itemsizes:
            assert bc.smem_bytes(itemsize, cp, hc, pp) <= bc.MAX_SMEM, (c, p, itemsize)
    # c5 in f32: (1024 + 4 + 128 + 4) * 4 * 32 + (512 + 4) * 4 * 32 bytes
    assert bc.smem_bytes(4, 512, 128, 1024) == 214528


# (site, H = W at 256x256, C = both parts, P) of the decoder's blocks
UC = [("uc1", 32, 1024, 512), ("uc2", 64, 512, 256), ("uc3", 128, 256, 128), ("uc4", 256, 128, 64)]
# bf16 K3 per site at batch 1 and 16: (consumer warpgroups, output columns a
# block, hidden chunk, ring stages, shared memory bytes, column splits)
K3_PLANS = {
    "uc1": {1: (1, 256, 64, 3, 230448, 2), 16: (1, 256, 64, 3, 230448, 2)},
    "uc2": {1: (1, 256, 64, 4, 197696, 1), 16: (2, 256, 64, 3, 230448, 1)},
    "uc3": {1: (1, 128, 128, 4, 99392, 1), 16: (2, 128, 128, 4, 132160, 1)},
    "uc4": {1: (2, 64, 128, 4, 99392, 1), 16: (2, 64, 128, 4, 99392, 1)},
}


@pytest.mark.parametrize("site,side,c,p", UC, ids=[u[0] for u in UC])
@pytest.mark.parametrize("batch", [1, 16])
def test_k3_plan_at_full_width(site, side, c, p, batch):
    """The bf16 K3 kernel's tiles at each decoder site (mirroring
    csrc/block_core2_fwd_sm90.cu): 128-row blocks where they fit shared
    memory and fill the 132 SMs, 64 otherwise (uc1 always: its 1024-wide
    input tile); P = 512 split over two blocks; the batch-1 grids of
    uc2/uc3 on 64-row tiles."""
    plan = bc.k3_plan(batch * side * side, bc._ceil16(c), bc._ceil16(p))
    assert tuple(plan) == K3_PLANS[site][batch]
    assert plan.smem <= bc.MAX_SMEM
    assert plan.smem == bc.k3_smem_bytes(64 * plan.nwg, c, plan.pn, plan.hc, plan.stages)
    assert plan.pn * plan.splits >= p and plan.pn <= 256
    rows = 64 * plan.nwg
    blocks = -(-batch * side * side // rows) * plan.splits
    assert blocks >= bc.SMS or plan.nwg == 1


def test_k3_plan_raises_past_shared_memory():
    # 2048 input channels: the resident 64-row input tile alone is 256 KB
    assert bc.k3_smem_bytes(64, 2048, 256, 64, 2) == 1024 + 32 * 64 * 128 + 2 * 32768 + 32
    with pytest.raises(ValueError, match="shared memory"):
        bc.k3_plan(16 * 32 * 32, 2048, 512)
    # 1280 channels are the most that fit: 64 rows, two stages
    assert bc.k3_plan(16 * 32 * 32, 1280, 512)[:4] == (1, 256, 64, 2)
    with pytest.raises(ValueError, match="shared memory"):
        bc.k3_plan(16 * 32 * 32, 1344, 512)

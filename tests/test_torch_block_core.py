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
    assert pk.w1t is None  # f32 runs the check builds, which read no transposes
    # every bf16 pack, one part or two, carries the transposes the Hopper
    # kernels read as K-major operands
    pk16 = bc.pack_weights(w1, b1, w2, b2, ws, torch.bfloat16, c1=c1 if c2 else None)
    for t, w in ((pk16.w1t, pk16.w1), (pk16.w2t, pk16.w2), (pk16.wst, pk16.ws)):
        assert t.dtype == torch.bfloat16 and t.is_contiguous() and torch.equal(t, w.t())

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
    shared memory in the 32-row f32 check build of block_core.cu (K1 and K3
    in f32; bf16 runs on fwd_plan, held below)."""
    shapes = [(3, 64), (64, 128), (128, 256), (256, 512), (512, 1024), (1024, 512), (512, 256),
              (256, 128), (128, 64)]
    for c, p in shapes:
        cp, h4p, pp = bc._ceil16(c), bc._ceil16(4 * c), bc._ceil16(p)
        assert bc.smem_bytes(cp, bc._hidden_chunk(h4p), pp) <= bc.MAX_SMEM, (c, p)
    # c5: (1024 + 4 + 128 + 4 + 512 + 4) * 4 * 32 bytes
    assert bc.smem_bytes(512, 128, 1024) == 214528


# (site, H = W at 256x256, C, P) of the encoder's one-input blocks
C_SITES = [("c1", 256, 3, 64), ("c2", 128, 64, 128), ("c3", 64, 128, 256), ("c4", 32, 256, 512),
           ("c5", 16, 512, 1024)]
# bf16 K1 per site at batch 1 and 16: (route, consumer warpgroups, output
# columns a block, hidden chunk, ring stages, shared memory bytes, splits,
# hidden chunks a slice)
K1_PLANS = {
    "c1": {1: ("narrow", 0, 0, 0, 0, 24128, 1, 0), 16: ("narrow", 0, 0, 0, 0, 24128, 1, 0)},
    "c2": {1: ("fused", 2, 128, 128, 4, 83008, 1, 0), 16: ("fused", 2, 128, 128, 4, 83008, 1, 0)},
    "c3": {1: ("fused", 1, 256, 64, 4, 148544, 1, 0), 16: ("fused", 2, 256, 64, 4, 164928, 1, 0)},
    "c4": {1: ("two_pass", 1, 128, 128, 4, 132160, 8, 1),
           16: ("two_pass", 2, 256, 128, 4, 197696, 2, 4)},
    "c5": {1: ("two_pass", 1, 128, 128, 4, 132160, 16, 1),
           16: ("two_pass", 2, 128, 128, 4, 197696, 4, 4)},
}


def _check_plan(plan, m, cp, h4p, pp):
    """What every route's plan must satisfy: it fits shared memory, and its
    work items cover the rows and the output (fused) or the hidden
    (two_pass) columns."""
    assert plan.smem <= bc.MAX_SMEM
    if plan.route == "narrow":
        assert cp == 16 and h4p == 16 and plan.smem == bc.narrow_smem_bytes(pp)
        return
    rows = 64 * plan.nwg
    front = bc.fwd_smem_bytes(rows, cp, 64 if plan.route == "two_pass" else plan.pn, plan.hc,
                              plan.stages)
    assert plan.smem >= front
    # 128-row tiles only where they take fewer waves of work items over the
    # SMs than 64-row tiles: fused items are (row tile, column block),
    # pass-1 items (row tile, hidden slice)
    parts = plan.splits if plan.route == "fused" else -(-h4p // 128)
    if plan.nwg == 2:
        assert -(-(-(-m // 128) * parts) // bc.SMS) < -(-(-(-m // 64) * parts) // bc.SMS)
    if plan.route == "fused":
        assert plan.smem == front and plan.pn * plan.splits >= pp and plan.pn <= 256
    else:
        assert plan.hc == 128 and plan.cps * plan.splits >= -(-h4p // 128)
        assert plan.cps * (plan.splits - 1) < -(-h4p // 128)  # no empty slice
        assert plan.smem == max(front, bc.FWD_OUT_SMEM[plan.pn])


@pytest.mark.parametrize("site,side,c,p", C_SITES, ids=[s[0] for s in C_SITES])
@pytest.mark.parametrize("batch", [1, 16])
def test_fwd_plan_one_input_at_full_width(site, side, c, p, batch):
    """The bf16 K1's route and tiles at each encoder site (mirroring
    csrc/block_core2_fwd_sm90.cu): c1 (C = 3) on the narrow FMA kernel, c2
    and c3 on the fused wgmma kernel (c2 at batch 1 on 128-row tiles: one
    wave of 128 items rather than two of 256), c4 and c5 (P > 256) in two
    passes."""
    m, cp, h4p, pp = batch * side * side, bc._ceil16(c), bc._ceil16(4 * c), bc._ceil16(p)
    plan = bc.fwd_plan(m, c, 0, h4p, pp)
    assert tuple(plan) == K1_PLANS[site][batch]
    _check_plan(plan, m, cp, h4p, pp)


# (site, H = W at 256x256, C = both parts, P) of the decoder's blocks
UC = [("uc1", 32, 1024, 512), ("uc2", 64, 512, 256), ("uc3", 128, 256, 128), ("uc4", 256, 128, 64)]
# bf16 K3 per site at batch 1 and 16, as K1_PLANS
K3_PLANS = {
    "uc1": {1: ("two_pass", 1, 128, 128, 4, 197696, 8, 4),
            16: ("two_pass", 1, 256, 128, 4, 197696, 1, 32)},
    "uc2": {1: ("fused", 1, 256, 64, 4, 197696, 1, 0), 16: ("fused", 2, 256, 64, 3, 230448, 1, 0)},
    "uc3": {1: ("fused", 2, 128, 128, 4, 132160, 1, 0), 16: ("fused", 2, 128, 128, 4, 132160, 1, 0)},
    "uc4": {1: ("fused", 2, 64, 128, 4, 99392, 1, 0), 16: ("fused", 2, 64, 128, 4, 99392, 1, 0)},
}


@pytest.mark.parametrize("site,side,c,p", UC, ids=[u[0] for u in UC])
@pytest.mark.parametrize("batch", [1, 16])
def test_k3_plan_at_full_width(site, side, c, p, batch):
    """The bf16 K3 kernel's tiles at each decoder site (mirroring
    csrc/block_core2_fwd_sm90.cu): uc1 (P = 512) in two passes, on 64-row
    tiles (its 1024-wide input tile); uc2-uc4 fused, on 128-row blocks
    where they fit shared memory and take fewer waves than 64-row ones
    (uc2 at batch 1 on 64: one wave either way)."""
    m = batch * side * side
    plan = bc.fwd_plan(m, c // 2, c // 2, 4 * c, p)
    assert tuple(plan) == K3_PLANS[site][batch]
    _check_plan(plan, m, c, 4 * c, p)


def test_k3_plan_raises_past_shared_memory():
    # 2048 input channels: the resident 64-row input tile alone is 256 KB
    assert bc.fwd_smem_bytes(64, 2048, 256, 64, 2) == 1024 + 32 * 64 * 128 + 2 * 32768 + 32
    m = 16 * 32 * 32
    with pytest.raises(ValueError, match="shared memory"):
        bc.fwd_plan(m, 1024, 1024, 8192, 256)
    # 1280 channels are the most that fit: 64 rows, two stages
    assert bc.fwd_plan(m, 640, 640, 5120, 256)[:5] == ("fused", 1, 256, 64, 2)
    with pytest.raises(ValueError, match="shared memory"):
        bc.fwd_plan(m, 672, 672, 5376, 256)
    # one input: the same tile, on both wgmma routes
    with pytest.raises(ValueError, match="shared memory"):
        bc.fwd_plan(m, 2048, 0, 8192, 64)
    with pytest.raises(ValueError, match="shared memory"):
        bc.fwd_plan(m, 2048, 0, 8192, 512)
    # the narrow kernel keeps its weights and its output rows in shared
    # memory: P is bounded, 320 + 84 * Pp + 128 * (2 * Pp + 16) bytes
    assert bc.narrow_smem_bytes(672) == 2368 + 340 * 672 <= bc.MAX_SMEM
    assert bc.fwd_plan(m, 3, 0, 16, 672).route == "narrow"
    with pytest.raises(ValueError, match="shared memory"):
        bc.fwd_plan(m, 3, 0, 16, 688)

"""The ConvNeXt block core after the depthwise conv, with its backward:

    out = gelu(IN(h) @ W1 + b1) @ W2 + b2 + x @ Ws

with IN the parameter-free InstanceNorm of h. Port of
``dsgan_tpu/pallas/block_core.py``. The forward wrappers ``block_core``
(K1, ``csrc/block_core.cu: block_core_fwd``) and ``block_core2`` (K3,
``block_core2_fwd``, the two-input form that reads the decoder's
(upsampled, skip) pair without materializing their concat) take the
InstanceNorm statistics as inputs; the backward wrappers
``block_core_bwd`` (K2, ``csrc/block_core_bwd.cu``) and ``block_core2_bwd``
(K4) return the cotangents of the normalized input and of x, the weight
gradients in f32, and the per-(image, channel) sums S1 = sum(dn),
S2 = sum(dn * (h - mean)). Each wrapper counts its launches in
``.launches``. ``block_core_in`` / ``block_core2_in`` are the entries the
model calls. Where autograd records, they are autograd Functions that
compute the statistics, run K1 / K3 forward and K2 / K4 backward, and fold
S1, S2 into the closed-form InstanceNorm cotangent (``in_fold``), as
``_in_vjp_bwd`` / ``_in2_vjp_bwd`` do in the JAX package. Where it does
not (``no_grad``, inference mode, a ``torch.export`` trace), they call the
forwards registered as the custom ops ``dsgan::block_core`` (K1) and
``dsgan::block_core2`` (K3), so that an exported graph holds the kernels:
the CUDA implementation launches the kernel, the CPU implementation is the
plain version, and the fake implementation gives the channels_last output
the kernel writes. The ops take the packed weights; a caller that keeps no
pack gets one made by plain (traceable) ops.

In bf16 all four run the Hopper kernels: K1 and K3
``csrc/block_core2_fwd_sm90.cu`` (wgmma fed by TMA, 128-row tiles, and
for one input of at most 16 channels an FMA kernel shaped for
bandwidth), K2 and K4 ``csrc/block_core2_bwd_sm90.cu`` (the one-input
form is the two-part kernel with no part b). In f32 they run the FMA
check builds of ``block_core.cu`` / ``block_core_bwd.cu``. ``fwd_plan``
and ``k4_plan`` mirror the routes, tiles, shared-memory and workspace
plans of the bf16 kernels and raise on what they cannot take.

Activations are NCHW tensors. On a CUDA tensor a wrapper launches its
kernel, which needs them contiguous in ``torch.channels_last`` order (the
kernels read (H*W, C) pixel rows), or raises; it never falls back. On a
CPU tensor it runs the plain PyTorch version (``block_core_reference``,
``block_core_bwd_reference``, ...), which repeats the kernel's
arithmetic. The InstanceNorm statistics and the fold are plain PyTorch in
both cases, as they are XLA in the JAX package.

Weights use the JAX orientation: ``w1 (C, 4C)``, ``w2 (4C, P)``,
``ws (C, P)``. The kernels take them packed (``pack_weights``): in the
activations' dtype, zero-padded to multiples of 16, each input part padded
on its own. A caller whose weights stay put between calls packs once and
passes ``packed``.

Numerics (``gelu``): ``"tanh"`` applies the tanh approximation to the
hidden rounded to the storage dtype in the forward, as the TPU kernel
does (the bf16 path), and its backward recomputes the hidden in f32 with
one tanh for the value and the derivative; ``"erf"`` applies exact GELU
to the f32 hidden and differentiates it exactly, as the JAX package's XLA
block path does in f32. Sums accumulate in f32, and each activation
output is rounded once.
"""

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from dsgan_tpu_torch.ops.norm import instance_stats
from dsgan_tpu_torch.parallel import spatial

# Shared memory a block may use on Hopper (232,448 bytes).
MAX_SMEM = 227 * 1024
SMS = 132  # streaming multiprocessors of the H100
ROWS_PER_BLOCK = 32  # TM of the f32 forward check build
BWD_ROWS = (32, 16)  # row-pass tiles of the f32 backward check build, the first that fits
CL = torch.channels_last
_K0, _K1 = 0.7978845608028654, 0.044715  # sqrt(2 / pi), the tanh GELU's cubic


def _ceil16(n):
    return (n + 15) // 16 * 16


class PackedWeights(NamedTuple):
    w1: torch.Tensor   # (Cp, H4p)
    b1: torch.Tensor   # (H4p,)
    w2: torch.Tensor   # (H4p, Pp)
    b2: torch.Tensor   # (Pp,)
    ws: torch.Tensor   # (Cp, Pp)
    c1: int            # channels of part a (all channels for one input)
    c1p: int           # padded rows of part a; part b starts here
    h4: int
    p: int
    # bf16 packs only: the transposes (H4p, Cp), (Pp, H4p), (Pp, Cp) that
    # the Hopper kernels read as K-major operands
    w1t: torch.Tensor = None
    w2t: torch.Tensor = None
    wst: torch.Tensor = None


def _padded(w, shape, dtype):
    """``w`` in ``dtype``, contiguous, zero-padded at the end of each axis
    to ``shape``; no copy where it already is all of that (the generator's
    widths but c1's need no padding, so its packs are mostly views)."""
    if tuple(w.shape) == tuple(shape):
        return (w if w.dtype == dtype else w.to(dtype)).contiguous()
    out = w.new_zeros(shape, dtype=dtype)
    out[tuple(slice(0, n) for n in w.shape)] = w
    return out


def pack_weights(w1, b1, w2, b2, ws, dtype, c1=None):
    """Pad the block weights for the kernel. ``c1`` splits the input
    channels into parts a = [0, c1) and b = [c1, C) for ``block_core2_in``."""
    c, h4 = w1.shape
    p = w2.shape[1]
    c1 = c if c1 is None else c1
    c1p, c2p = _ceil16(c1), _ceil16(c - c1)
    h4p, pp = _ceil16(h4), _ceil16(p)

    def rows_split(w, ncols):
        if c1p == c1 and c2p == c - c1:
            return _padded(w, (c, ncols), dtype)
        return torch.cat([_padded(w[:c1], (c1p, ncols), dtype),
                          _padded(w[c1:], (c2p, ncols), dtype)])

    w1p, wsp = rows_split(w1, h4p), rows_split(ws, pp)
    w2p = _padded(w2, (h4p, pp), dtype)
    b1p, b2p = _padded(b1, (h4p,), dtype), _padded(b2, (pp,), dtype)
    tr = {}
    if dtype == torch.bfloat16:
        def transposed(w, wp):
            """wp's transpose, from w's own where no padding came between."""
            if wp.shape == w.shape:
                return _padded(w.t(), wp.t().shape, dtype)
            return wp.t().contiguous()

        tr = dict(w1t=transposed(w1, w1p), w2t=transposed(w2, w2p), wst=transposed(ws, wsp))
    return PackedWeights(w1p, b1p, w2p, b2p, wsp, c1, c1p, h4, p, **tr)


def block_core_reference(h, x, mean, rsig, w1, b1, w2, b2, ws, gelu="tanh"):
    """Plain PyTorch version of the kernels (``block_core.py:374-383`` of
    the JAX package): normalized input rounded to the storage dtype, f32
    GEMMs, the hidden rounded before the tanh GELU, one final rounding."""
    dt = h.dtype
    a = ((h.float() - mean[:, :, None, None]) * rsig[:, :, None, None]).to(dt)
    h1 = a.permute(0, 2, 3, 1).float() @ w1.float() + b1.float()
    if gelu == "tanh":
        g = F.gelu(h1.to(dt).float(), approximate="tanh")
    elif gelu == "erf":
        g = F.gelu(h1)
    else:
        raise ValueError(f"unknown gelu flavour [{gelu}]")
    out = (g.to(dt).float() @ w2.float() + b2.float()
           + x.permute(0, 2, 3, 1).float() @ ws.float())
    return out.to(dt).permute(0, 3, 1, 2)


def block_core2_reference(ha, hb, xa, xb, ma, ra, mb, rb, w1, b1, w2, b2, ws, gelu="tanh"):
    """Plain version of the two-input kernel: the one-input block on the
    channel concat of the parts (weights in the concat layout)."""
    return block_core_reference(
        torch.cat([ha, hb], 1), torch.cat([xa, xb], 1), torch.cat([ma, mb], 1),
        torch.cat([ra, rb], 1), w1, b1, w2, b2, ws, gelu)


def _rows(t):
    """(B, C, H, W) -> (B, H*W, C) pixel rows."""
    return t.permute(0, 2, 3, 1).reshape(t.shape[0], -1, t.shape[1])


def _unrows(t, like):
    """(B, H*W, C) pixel rows -> (B, C, H, W) in channels_last memory."""
    b, _, hh, ww = like.shape
    return t.reshape(b, hh, ww, t.shape[-1]).permute(0, 3, 1, 2)


def _gelu_parts(h1, gelu):
    """GELU of the f32 hidden and its derivative: one tanh for both in the
    tanh flavour (``_bwd_kernel``, ``block_core.py:160-168`` of the JAX
    package), the exact pair in the erf flavour."""
    if gelu == "tanh":
        th = torch.tanh(_K0 * (h1 + _K1 * h1 * h1 * h1))
        dgelu = 0.5 * (1.0 + th) + 0.5 * h1 * (1.0 - th * th) * (_K0 * (1.0 + 3.0 * _K1 * h1 * h1))
        return 0.5 * h1 * (1.0 + th), dgelu
    if gelu == "erf":
        cdf = 0.5 * (1.0 + torch.erf(h1 * 0.7071067811865476))
        return h1 * cdf, cdf + h1 * 0.3989422804014327 * torch.exp(-0.5 * h1 * h1)
    raise ValueError(f"unknown gelu flavour [{gelu}]")


def block_core_bwd_reference(h, x, mean, rsig, g, w1, b1, w2, ws, gelu="tanh"):
    """Plain PyTorch version of K2 (``_bwd_kernel`` of the JAX package):
    given the cotangent ``g`` (B, P, H, W) of ``block_core``'s output, returns

        dn, dx                          (B, C, H, W), h's dtype
        dW1, db1, dW2, db2, dWs         f32
        S1 = sum dn, S2 = sum dn * (h - mean)   (B, C) f32 over H, W

    where dn is the cotangent of the normalized input. The hidden is
    recomputed from h in f32; ``ag`` is the GELU of that f32 hidden
    rounded to the storage dtype; dg1 is rounded to it before the dW1 and
    dn products; every sum is in f32."""
    dt = h.dtype
    hm = _rows(h).float() - mean[:, None, :]
    a = (hm * rsig[:, None, :]).to(dt).float()
    gf = _rows(g).float()
    h1 = a @ w1.float() + b1.float()
    act, dgelu = _gelu_parts(h1, gelu)
    dg1 = (gf @ w2.float().t()) * dgelu
    dg1_t = dg1.to(dt).float()
    dn = dg1_t @ w1.float().t()

    def flat(t):
        return t.reshape(-1, t.shape[-1])

    dw1 = flat(a).t() @ flat(dg1_t)
    dw2 = flat(act.to(dt).float()).t() @ flat(gf)
    dws = flat(_rows(x).float()).t() @ flat(gf)
    dx = (gf @ ws.float().t()).to(dt)
    return (_unrows(dn.to(dt), h), _unrows(dx, x), dw1, dg1.sum((0, 1)), dw2, gf.sum((0, 1)),
            dws, dn.sum(1), (dn * hm).sum(1))


def block_core2_bwd_reference(ha, hb, xa, xb, ma, ra, mb, rb, g, w1, b1, w2, ws, gelu="tanh"):
    """Plain version of K4: the one-input backward on the channel concat
    of the parts, split back into them. Returns dna, dnb, dxa, dxb, dW1,
    db1, dW2, db2, dWs (dW1, dWs in the concat layout), S1a, S2a, S1b, S2b."""
    c1 = ha.shape[1]
    dn, dx, dw1, db1, dw2, db2, dws, s1, s2 = block_core_bwd_reference(
        torch.cat([ha, hb], 1), torch.cat([xa, xb], 1), torch.cat([ma, mb], 1),
        torch.cat([ra, rb], 1), g, w1, b1, w2, ws, gelu)
    return (dn[:, :c1], dn[:, c1:], dx[:, :c1], dx[:, c1:], dw1, db1, dw2, db2, dws,
            s1[:, :c1], s2[:, :c1], s1[:, c1:], s2[:, c1:])


def in_fold(dn, h, mean, rsig, s1, s2, hw=None):
    """The InstanceNorm cotangent of h from the kernel's dn, S1, S2
    (``_in_fold`` of the JAX package):

        dh = rsig * dn - rsig * S1 / HW - rsig^3 * S2 / HW * (h - mean)
           = dn * rsig - h * c3 + (mean * c3 - rsig * S1 / HW)

    with per-(image, channel) f32 coefficients and one elementwise pass in
    h's dtype. ``hw``: the image's H * W where h is a strip of it (S1 and
    S2 then the image's sums), else h's own."""
    hw = h.shape[2] * h.shape[3] if hw is None else hw
    c3 = rsig ** 3 * s2 / hw
    c0 = mean * c3 - rsig * s1 / hw

    def col(v):
        return v[:, :, None, None].to(h.dtype)

    return dn * col(rsig) - h * col(c3) + col(c0)


SOURCES = ("block_core", "block_core_bwd", "block_core2_fwd_sm90", "block_core2_bwd_sm90")


class _Entries(NamedTuple):
    fwd: object        # the f32 K1 check build
    fwd2: object       # the f32 K3 check build
    bwd: object        # the f32 K2 / K4 check build
    fwd2_sm90: object  # bf16 K1 / K3, fused route
    fwd_two_pass: object  # bf16 K1 / K3, two-pass route
    fwd_narrow: object    # bf16 K1, narrow route
    bwd2_sm90: object  # bf16 K2 / K4


@functools.cache
def _lib():
    """The kernels' C entries, every source built at first use (in parallel)."""
    from dsgan_tpu_torch.kernels import _build

    _build.build(list(SOURCES))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    size = ctypes.POINTER(ctypes.c_ulonglong)
    lib = _build.load("block_core")
    fwd, fwd2 = lib.block_core_fwd, lib.block_core2_fwd
    fwd.argtypes = [i, i] + [p] * 10 + [ll] + [i] * 7 + [p]
    fwd2.argtypes = [i, i] + [p] * 14 + [ll] + [i] * 9 + [p]
    bwd = _build.load("block_core_bwd").block_core_bwd
    bwd.argtypes = [i] * 3 + [p] * 26 + [i] * 11 + [p, size, p]
    sm90 = _build.load("block_core2_fwd_sm90")
    fwd2_sm90, two_pass, narrow = (sm90.block_core2_fwd_sm90, sm90.block_core_fwd_sm90_two_pass,
                                   sm90.block_core_fwd_narrow)
    fwd2_sm90.argtypes = [i] + [p] * 14 + [ll] + [i] * 13 + [p]
    two_pass.argtypes = [i] + [p] * 15 + [ll] + [i] * 13 + [p]
    narrow.argtypes = [i] + [p] * 10 + [ll] + [i] * 4 + [p]
    bwd2_sm90 = _build.load("block_core2_bwd_sm90").block_core2_bwd_sm90
    bwd2_sm90.argtypes = [i] + [p] * 27 + [i] * 11 + [p, size, p]
    entries = _Entries(fwd, fwd2, bwd, fwd2_sm90, two_pass, narrow, bwd2_sm90)
    for f in entries:
        f.restype = i
    return entries


def _hidden_chunk(h4p):
    """Hidden columns made per step: the largest of 128/64/32/16 dividing H4p."""
    return next(hc for hc in (128, 64, 32, 16) if h4p % hc == 0)


def smem_bytes(cp, hc, pp):
    """Shared memory of one thread block of the f32 forward check build,
    ROWS_PER_BLOCK rows (mirrors ``smem_bytes`` in ``csrc/block_core.cu``):
    the accumulator, the hidden chunk and the input tile, every row padded
    by 16 bytes."""
    return 4 * ROWS_PER_BLOCK * (pp + 4 + hc + 4 + cp + 4)


def bwd_smem_bytes(tm, cp, hc, pp):
    """Shared memory of one row-pass block of the f32 backward check build
    (mirrors ``row_smem_bytes`` in ``csrc/block_core_bwd.cu``): the dn
    accumulator, the hidden and da chunks, the normalized input and the
    cotangent tile; every row padded by 16 bytes."""
    return 4 * tm * ((cp + 4) + 2 * (hc + 4) + (cp + 4) + (pp + 4))


def bwd_rows(cp, hc, pp):
    """Rows of the f32 backward's row-pass tile: the first of ``BWD_ROWS``
    whose tile fits a block's shared memory; raises if none does."""
    for tm in BWD_ROWS:
        if bwd_smem_bytes(tm, cp, hc, pp) <= MAX_SMEM:
            return tm
    need = bwd_smem_bytes(BWD_ROWS[-1], cp, hc, pp)
    raise ValueError(f"block core backward tile needs {need} B of shared memory (> {MAX_SMEM})")


def _cdiv(a, b):
    return -(-a // b)


def _align256(n):
    return _cdiv(n, 256) * 256


class FwdPlan(NamedTuple):
    """The bf16 forward's route and tiles (``csrc/block_core2_fwd_sm90.cu``)."""
    route: str   # "fused", "two_pass" or "narrow"
    nwg: int     # consumer warpgroups of 64 rows (two_pass: pass 1's; narrow: 0)
    pn: int      # output columns a block (two_pass: pass 2's)
    hc: int      # hidden columns a GEMM1 chunk
    stages: int  # weight tiles in flight (two_pass: pass 1's; pass 2 has FWD_OUT_STAGES)
    smem: int    # shared memory of the largest block, bytes
    splits: int  # blocks over one row tile: output column blocks, or (two_pass) hidden slices
    cps: int     # two_pass: hidden chunks a slice


FWD_OUT_STAGES = 4
FWD_OUT_SMEM = {bn: 1024 + FWD_OUT_STAGES * (16384 + bn * 128) + 16 * FWD_OUT_STAGES
                for bn in (128, 256)}


def fwd_smem_bytes(rows, cp, pn, hc, stages):
    """Mirrors ``smem_bytes`` in ``csrc/block_core2_fwd_sm90.cu``: the
    resident A tile (rows x Cp rounded up to 64, bf16), the ring of weight
    tiles, the barriers, alignment slack."""
    return 1024 + _cdiv(cp, 64) * rows * 128 + stages * max(pn, hc) * 128 + 16 * stages


NARROW_C = 4  # the narrow route: one input of at most 4 channels (H4p = 16)
NARROW_THREADS = 128  # rows a block of the narrow forward


def narrow_route(c1, c2):
    """Whether K1 / K2 take their narrow kernels (``csrc/block_core2_fwd_sm90
    .cu``, ``csrc/block_core2_bwd_sm90.cu``): one input of at most 4
    channels, whose whole hidden is one 16-wide tile (c1: C = 3)."""
    return c2 == 0 and c1 <= NARROW_C


def narrow_smem_bytes(pp):
    """Mirrors ``narrow_smem_bytes`` in ``csrc/block_core2_fwd_sm90.cu``:
    W1 (NARROW_C x 16), b1, W2 (16 x Pp), Ws (NARROW_C x Pp) and b2 in f32,
    then the block's bf16 output rows, each padded by 16 bytes."""
    return 4 * (NARROW_C * 16 + 16 + (16 + NARROW_C + 1) * pp) + NARROW_THREADS * (2 * pp + 16)


def _tiles(m, cp, pn, hc, parts):
    """(warpgroups, stages, shared memory) of the fused kernel's front: 128
    rows where that tile fits shared memory and takes fewer waves of work
    items over the SMs than 64-row tiles would (a warpgroup's work per item
    is 64 rows either way), else 64; the deepest ring (4 stages at most)
    that fits; None where not even 64 rows fit."""
    for nwg in (2, 1):
        if nwg == 2 and _cdiv(_cdiv(m, 128) * parts, SMS) >= _cdiv(_cdiv(m, 64) * parts, SMS):
            continue
        for stages in (4, 3, 2):
            smem = fwd_smem_bytes(64 * nwg, cp, pn, hc, stages)
            if smem <= MAX_SMEM:
                return nwg, stages, smem
    return None


def _fused_plan(m, cp, pp):
    """The fused route: output columns in blocks of at most 256 (a wider P
    splits, each block recomputing GEMM1)."""
    pn = 64 if pp <= 64 else 128 if pp <= 128 else 256
    hc = 64 if pn == 256 else 128
    splits = _cdiv(pp, pn)
    tiles = _tiles(m, cp, pn, hc, splits)
    if tiles is None:
        need = fwd_smem_bytes(64, cp, pn, hc, 2)
        raise ValueError(f"block core forward tile needs {need} B of shared memory (> {MAX_SMEM})")
    nwg, stages, smem = tiles
    return FwdPlan("fused", nwg, pn, hc, stages, smem, splits, 0)


def _two_pass_plan(m, cp, h4p, pp):
    """The two-pass route: pass 1 cuts each row tile's hidden into as many
    slices of 128-wide chunks as fill the SMs; pass 2 takes 256-wide column
    blocks where they fill the SMs, else 128."""
    nj = _cdiv(h4p, 128)
    tiles = _tiles(m, cp, 64, 128, nj)
    if tiles is None:
        need = fwd_smem_bytes(64, cp, 64, 128, 2)
        raise ValueError(f"block core forward tile needs {need} B of shared memory (> {MAX_SMEM})")
    nwg, stages, smem = tiles
    cps = _cdiv(nj, min(nj, _cdiv(SMS, _cdiv(m, 64 * nwg))))
    bn = 256 if _cdiv(m, 128) * _cdiv(pp, 256) >= SMS else 128
    return FwdPlan("two_pass", nwg, bn, 128, stages, max(smem, FWD_OUT_SMEM[bn]), _cdiv(nj, cps),
                   cps)


@functools.lru_cache(maxsize=256)
def fwd_plan(m, c1, c2, h4p, pp):
    """The bf16 forward's route for ``m`` rows of parts of ``c1`` and
    ``c2`` channels (``c2 = 0``: one input), hidden ``h4p`` and output
    ``pp`` wide (padded): narrow (``narrow_route``); two passes where P >
    256 and the parts may be read by TMA (widths multiples of 8); fused
    otherwise. Raises where the tiles do not fit shared memory."""
    cp = _ceil16(c1) + _ceil16(c2)
    if narrow_route(c1, c2):
        smem = narrow_smem_bytes(pp)
        if smem > MAX_SMEM:
            raise ValueError(f"block core narrow forward needs {smem} B of shared memory "
                             f"(> {MAX_SMEM})")
        return FwdPlan("narrow", 0, 0, 0, 0, smem, 1, 0)
    if pp > 256 and c1 % 8 == 0 and c2 % 8 == 0:
        return _two_pass_plan(m, cp, h4p, pp)
    return _fused_plan(m, cp, pp)


# the bf16 K4 kernel (csrc/block_core2_bwd_sm90.cu): STAGES-deep rings;
# R1 / R2 stages hold a 128 x 64 A box and a 128 x 64 B box, plus 4 KB for
# the column sums; weight-pass stages two 64 x 64 A boxes and BN / 64 B boxes
K4_STAGES = 4
K4_ROW_SMEM = 1024 + K4_STAGES * 32768 + 16 * K4_STAGES + 8 * 128 * 4
K4_W_SMEM = {bn: 1024 + K4_STAGES * (16384 + bn * 128) + 16 * K4_STAGES for bn in (64, 128)}


class K4Job(NamedTuple):
    rows: int    # output rows (R) of the product over the pixel rows
    cols: int    # padded output columns (N)
    bn: int      # output tile width
    nsplit: int  # splits of the pixel rows
    rps: int     # pixel rows a split


class K4Plan(NamedTuple):
    timg: int            # 128-row tiles a image
    tiles: int           # in all
    gcopy: bool          # g padded into the workspace (P % 8 != 0)
    jobs: tuple          # K4Job of dW1, dW2, dWs
    workspace: int       # bytes
    smem: int            # shared memory of the largest block, bytes


def _reduce_tmp(groups, terms, cols):
    """Floats the first level of a two-level reduce keeps (64 terms a sum)."""
    return groups * _cdiv(terms, 64) * cols if terms > 64 else 0


def k4_plan(b, hw, cp, h4p, p, pp):
    """Mirrors ``make_plan`` in ``csrc/block_core2_bwd_sm90.cu`` (the bf16
    K2 and K4): the row tiles, the splits of the weight pass and the
    workspace (a and x side by side, g padded where P % 8 != 0, ag, dg1, the
    partial sums, the reduce's first level). Its tiles, hence its shared
    memory, do not depend on C; it raises where the kernels' 32-bit indices
    cannot take the call."""
    m = b * hw
    if m * max(cp, h4p, pp) >= 2 ** 31:
        raise ValueError(f"block core K4 takes fewer than 2^31 elements a matrix, not {m} rows")
    timg = _cdiv(hw, 128)
    tiles = b * timg
    gcopy = p % 8 != 0
    total = 0
    for nbytes in (m * cp * 2, m * cp * 2, m * pp * 2 if gcopy else 0, m * h4p * 2, m * h4p * 2,
                   4 * tiles * h4p, 4 * tiles * pp, 4 * tiles * cp, 4 * tiles * cp):
        total = _align256(total + nbytes)
    jobs, tmp = [], 0
    for r, n in ((cp, h4p), (h4p, pp), (cp, pp)):
        bn = 128 if n > 64 else 64
        tiles_out = _cdiv(r, 128) * _cdiv(n, bn)
        ns = max(1, min(_cdiv(2 * SMS, tiles_out), _cdiv(m, 512)))
        rps = _cdiv(_cdiv(m, ns), 64) * 64
        nsplit = _cdiv(m, rps)
        jobs.append(K4Job(r, n, bn, nsplit, rps))
        total = _align256(total + 4 * r * nsplit * n)
        tmp = max(tmp, _reduce_tmp(r, nsplit, n))
    tmp = max(tmp, _reduce_tmp(1, tiles, h4p), _reduce_tmp(1, tiles, pp), _reduce_tmp(b, timg, cp))
    total = _align256(total + 4 * tmp)
    return K4Plan(timg, tiles, gcopy, tuple(jobs), total, max(K4_ROW_SMEM, *K4_W_SMEM.values()))


def _check(parts, packed, g=None):
    """What the kernels take: one device and one dtype (bf16 or f32) for the
    parts [(h, x, mean, rsig), ...], the cotangent ``g`` and the packed
    weights; each part's x shaped as its h, the parts sharing batch and
    spatial size, f32 (B, C) statistics of each h; channels_last-contiguous
    activations; ``packed`` laid out for these parts. Raises ValueError."""
    h0 = parts[0][0]
    dtype, dev = h0.dtype, h0.get_device()
    if dtype is not torch.bfloat16 and dtype is not torch.float32:
        raise ValueError(f"block core kernel takes bf16 or f32, not {dtype}")
    c2 = parts[1][0].shape[1] if len(parts) > 1 else 0
    if packed.c1 != h0.shape[1] or packed.w1.shape[0] != packed.c1p + _ceil16(c2):
        raise ValueError(f"packed weights do not match a block of {h0.shape[1]} + {c2} input channels")
    s0 = h0.shape
    acts = [g] if g is not None else []
    for h, x, mean, rsig in parts:
        hs = h.shape
        if len(hs) != 4 or x.shape != hs:
            raise ValueError(f"h {tuple(hs)} and x {tuple(x.shape)} must be one (B, C, H, W)")
        if hs[0] != s0[0] or hs[2:] != s0[2:]:
            raise ValueError("the two parts must share batch and spatial size")
        for st in (mean, rsig):
            if st.dtype is not torch.float32 or st.shape != hs[:2] or st.get_device() != dev:
                raise ValueError("statistics must be f32 (B, C) tensors on h's device")
        acts += (h, x)
    for t in acts:
        if t.dtype is not dtype or t.get_device() != dev:
            raise ValueError("block core inputs must share one device and dtype")
        if not t.is_contiguous(memory_format=CL):
            raise ValueError("block core kernel needs channels_last-contiguous activations")
    for w in packed[:5]:
        if w.dtype is not dtype or w.get_device() != dev or not w.is_contiguous():
            raise ValueError("packed weights must be contiguous, in the activations' dtype and device")


def _check_transposes(packed):
    """The bf16 wgmma kernels read the transposed weights."""
    if packed.w1t is None:
        raise ValueError("packed weights lack the transposes of a bf16 pack_weights")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned16(t):
    """``t``, copied where TMA could not read it (a base not on 16 bytes)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone(memory_format=CL)


def _vec(tensors, c1, c2):
    """Whether the kernels may read the parts' rows 16 bytes at a time."""
    return int(c1 % 8 == 0 and c2 % 8 == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors if t is not None))


def _parts4(parts):
    """[(h, x, mean, rsig)] or two such parts -> (ha, hb, xa, xb), (ma, ra,
    mb, rb), with None for a missing part b."""
    (ha, xa, ma, ra), (hb, xb, mb, rb) = parts[0], (parts[1] if len(parts) > 1 else (None,) * 4)
    stats = tuple(None if s is None else s.contiguous() for s in (ma, ra, mb, rb))
    return (ha, hb, xa, xb), stats


def _launch_fwd_sm90(parts, packed, gelu, plan):
    """The bf16 forward (``csrc/block_core2_fwd_sm90.cu``) on one or two
    parts [(h, x, mean, rsig), ...], on the route and tiles of ``plan``."""
    (ha, hb, xa, xb), stats = _parts4(parts)
    b, c1, hh, ww = ha.shape
    c2 = 0 if hb is None else hb.shape[1]
    cp, h4p = packed.w1.shape
    pp, m, hw = packed.w2.shape[1], b * hh * ww, hh * ww
    dev = ha.device
    out = torch.empty((b, packed.p, hh, ww), dtype=torch.bfloat16, device=dev, memory_format=CL)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tanh = int(gelu == "tanh")
    if plan.route == "narrow":
        err = _lib().fwd_narrow(tanh, ha.data_ptr(), xa.data_ptr(), *map(_ptr, stats[:2]),
                                *(t.data_ptr() for t in (packed.w1, packed.b1, packed.w2,
                                                         packed.b2, packed.ws, out)),
                                m, hw, c1, packed.p, pp, stream)
    else:
        _check_transposes(packed)
        acts = (ha, hb, xa, xb)
        vec = _vec((*acts, *stats), c1, c2)
        weights = (packed.w1t, packed.b1, packed.w2t, packed.b2, packed.wst)
        dims = [hw, c1, c2, packed.c1p, cp, h4p, packed.p, pp]
        if plan.route == "fused":
            err = _lib().fwd2_sm90(tanh, *map(_ptr, (*acts, *stats, *weights, out)), m, *dims,
                                   plan.nwg, plan.pn, plan.hc, plan.stages, vec, stream)
        else:  # two passes: pass 2 reads x by TMA
            acts = (ha, hb, _aligned16(xa), _aligned16(xb))
            hid = torch.empty((m, h4p), dtype=torch.bfloat16, device=dev)
            err = _lib().fwd_two_pass(tanh, *map(_ptr, (*acts, *stats, *weights, hid, out)), m,
                                      *dims, plan.nwg, plan.cps, plan.pn, plan.stages, vec, stream)
    if err:
        raise RuntimeError(f"block core forward ({plan.route}) launch failed: error {err}")
    return out


def _launch(fn, acts, stats, packed, gelu, shape, c2):
    """The f32 check build of K1 (``fn`` = fwd) or K3 (fwd2)."""
    b, c1, hh, ww = shape
    cp, h4p = packed.w1.shape
    pp = packed.w2.shape[1]
    hc = _hidden_chunk(h4p)
    smem = smem_bytes(cp, hc, pp)
    if smem > MAX_SMEM:
        raise ValueError(f"block core tile needs {smem} B of shared memory (> {MAX_SMEM})")
    out = torch.empty((b, packed.p, hh, ww), dtype=torch.float32, device=acts[0].device,
                      memory_format=CL)
    stream = torch.cuda.current_stream(acts[0].device).cuda_stream
    stats = [s.contiguous() for s in stats]
    ptrs = [t.data_ptr() for t in (*acts, *stats)]
    wptrs = [t.data_ptr() for t in (packed.w1, packed.b1, packed.w2, packed.b2, packed.ws)]
    dims = [b * hh * ww, hh * ww, c1] + ([c2, packed.c1p] if c2 else []) + [cp, h4p, hc, packed.p, pp]
    err = fn(0, int(gelu == "tanh"), *ptrs, *wptrs, out.data_ptr(), *dims, stream)
    if err:
        raise RuntimeError(f"block core kernel launch failed: CUDA error {err}")
    return out


def _forward(parts, packed, gelu):
    """K1 (one part) or K3 (two): checks, then in bf16 the Hopper kernel on
    ``fwd_plan``'s route, in f32 the FMA check build."""
    if gelu not in ("tanh", "erf"):
        raise ValueError(f"unknown gelu flavour [{gelu}]")
    _check(parts, packed)
    ha, hb = parts[0][0], (parts[1][0] if len(parts) > 1 else None)
    b, c1, hh, ww = ha.shape
    c2 = 0 if hb is None else hb.shape[1]
    if ha.dtype == torch.bfloat16:
        plan = fwd_plan(b * hh * ww, c1, c2, packed.w1.shape[1], packed.w2.shape[1])
        return _launch_fwd_sm90(parts, packed, gelu, plan)
    (ha, hb, xa, xb), stats = _parts4(parts)
    if c2:
        return _launch(_lib().fwd2, (ha, hb, xa, xb), stats, packed, gelu, ha.shape, c2)
    return _launch(_lib().fwd, (ha, xa), stats[:2], packed, gelu, ha.shape, 0)


def block_core(h, x, mean, rsig, w1, b1, w2, b2, ws, gelu="tanh", packed=None):
    """K1 with the InstanceNorm statistics given: ``h``, ``x`` (B, C, H, W);
    ``mean``, ``rsig`` (B, C) f32. Returns (B, P, H, W)."""
    if h.device.type == "cpu":
        return block_core_reference(h, x, mean, rsig, w1, b1, w2, b2, ws, gelu)
    if packed is None:
        packed = pack_weights(w1, b1, w2, b2, ws, h.dtype)
    out = _forward([(h, x, mean, rsig)], packed, gelu)
    block_core.launches += 1
    return out


def block_core2(ha, hb, xa, xb, ma, ra, mb, rb, w1, b1, w2, b2, ws, gelu="tanh",
                packed=None):
    """K3 with the statistics of each part given."""
    if ha.device.type == "cpu":
        return block_core2_reference(ha, hb, xa, xb, ma, ra, mb, rb, w1, b1, w2, b2, ws, gelu)
    if packed is None:
        packed = pack_weights(w1, b1, w2, b2, ws, ha.dtype, c1=ha.shape[1])
    out = _forward([(ha, xa, ma, ra), (hb, xb, mb, rb)], packed, gelu)
    block_core2.launches += 1
    return out


def _launch_bwd(parts, g, packed, gelu):
    """K2 (one part) or K4 (two parts); ``parts``: [(h, x, mean, rsig), ...].
    Allocates the outputs and the kernel's workspace (the scratch and the
    f32 partial sums), then runs every pass on the current stream: in bf16
    the Hopper kernel's (``k4_plan``), in f32 the check build's."""
    (ha, hb, xa, xb), stats = _parts4(parts)
    b, c1, hh, ww = ha.shape
    c2 = hb.shape[1] if hb is not None else 0
    dtype, dev = ha.dtype, ha.device
    if gelu not in ("tanh", "erf"):
        raise ValueError(f"unknown gelu flavour [{gelu}]")
    if g.shape != (b, packed.p, hh, ww):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match the output {(b, packed.p, hh, ww)}")
    _check(parts, packed, g)
    cp, h4p = packed.w1.shape
    pp = packed.w2.shape[1]
    sm90 = dtype == torch.bfloat16
    if sm90:
        plan = k4_plan(b, hh * ww, cp, h4p, packed.p, pp)
        _check_transposes(packed)
    else:
        hc = _hidden_chunk(h4p)
        tm = bwd_rows(cp, hc, pp)

    def act(c):
        return torch.empty((b, c, hh, ww), dtype=dtype, device=dev, memory_format=CL)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    h4, p, c = packed.h4, packed.p, c1 + c2
    dna, dxa = act(c1), act(c1)
    dnb, dxb = (act(c2), act(c2)) if c2 else (None, None)
    dw1, db1, dw2, db2, dws = f32(c, h4), f32(h4), f32(h4, p), f32(p), f32(c, p)
    s1a, s2a = f32(b, c1), f32(b, c1)
    s1b, s2b = (f32(b, c2), f32(b, c2)) if c2 else (None, None)

    outs = (dna, dnb, dxa, dxb, dw1, db1, dw2, db2, dws, s1a, s2a, s1b, s2b)
    if sm90:
        g = _aligned16(g)  # TMA reads g's rows from a 16-byte aligned base
        tensors = (ha, hb, xa, xb, g, *stats, packed.w1, packed.w1t, packed.b1, packed.w2,
                   packed.ws, *outs)
        head = [int(gelu == "tanh")] + [_ptr(t) for t in tensors]
        dims = [b, hh * ww, c1, c2, packed.c1p, cp, h4, h4p, p, pp,
                _vec((ha, hb, xa, xb, *stats), c1, c2)]
        fn = _lib().bwd2_sm90
    else:
        tensors = (ha, hb, xa, xb, g, *stats, packed.w1, packed.b1, packed.w2, packed.ws, *outs)
        head = [0, int(gelu == "tanh"), tm] + [_ptr(t) for t in tensors]
        dims = [b, hh * ww, c1, c2, packed.c1p, cp, h4, h4p, hc, p, pp]
        fn = _lib().bwd
    size = ctypes.c_ulonglong(0)
    fn(*head, *dims, None, ctypes.byref(size), None)
    if sm90 and size.value != plan.workspace:
        raise RuntimeError(f"K4 workspace {size.value} B disagrees with k4_plan ({plan.workspace} B)")
    work = torch.empty((size.value,), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*head, *dims, work.data_ptr(), ctypes.byref(size), stream)
    if err:
        raise RuntimeError(f"block core backward launch failed: CUDA error {err}")
    if c2:
        return dna, dnb, dxa, dxb, dw1, db1, dw2, db2, dws, s1a, s2a, s1b, s2b
    return dna, dxa, dw1, db1, dw2, db2, dws, s1a, s2a


def _bwd_pack(w1, b1, w2, ws, dtype, c1=None):
    """The packed weights the backward reads (it never reads b2)."""
    return pack_weights(w1, b1, w2, w2.new_zeros(w2.shape[1]), ws, dtype, c1=c1)


def image_chunks(b, hw, cp, h4p, pp, bf16=True):
    """The images [i, j) of each launch K2 / K4 take a batch of ``b`` in:
    the Hopper kernels index each of their matrices with 32 bits
    (``k4_plan``), so a batch whose B * HW rows reach 2^31 elements in one
    of them (uc4 at 1024x1024 from 4 images) runs as several launches of
    as many images as fit; the f32 check build in one."""
    per = (2 ** 31 - 1) // (hw * max(cp, h4p, pp)) if bf16 else b
    if per < 1:
        raise ValueError(f"block core K4 takes fewer than 2^31 elements a matrix: one image "
                         f"of {hw} pixels gives {hw * max(cp, h4p, pp)}")
    return [(i, min(i + per, b)) for i in range(0, b, per)]


def in_chunks(run, chunks, per_image):
    """``run(i, j)`` (K2's or K4's outputs on images [i, j)) over
    ``chunks``, joined: the outputs ``per_image`` (dn, dx, the S sums)
    along the batch, the weight gradients summed in chunk order."""
    outs = [run(i, j) for i, j in chunks]
    if len(outs) == 1:
        return outs[0]
    joined = []
    for k, parts in enumerate(zip(*outs)):
        if k in per_image:
            t = torch.cat(parts, 0)
            joined.append(t.contiguous(memory_format=CL) if t.dim() == 4 else t)
        else:
            total = parts[0]
            for t in parts[1:]:
                total = total + t
            joined.append(total)
    return tuple(joined)


def _chunks_of(h, packed):
    cp, h4p = packed.w1.shape
    return image_chunks(h.shape[0], h.shape[2] * h.shape[3], cp, h4p, packed.w2.shape[1],
                        h.dtype == torch.bfloat16)


def block_core_bwd(h, x, mean, rsig, g, w1, b1, w2, ws, gelu="tanh", packed=None):
    """K2: the backward of ``block_core`` at the cotangent ``g`` (B, P, H, W).
    Returns what ``block_core_bwd_reference`` returns. A batch past the
    kernel's 32-bit indices runs in chunks of images (``image_chunks``),
    each a launch."""
    if h.device.type == "cpu":
        return block_core_bwd_reference(h, x, mean, rsig, g, w1, b1, w2, ws, gelu)
    if packed is None:
        packed = _bwd_pack(w1, b1, w2, ws, h.dtype)

    def run(i, j):
        out = _launch_bwd([(h[i:j], x[i:j], mean[i:j], rsig[i:j])], g[i:j], packed, gelu)
        block_core_bwd.launches += 1
        return out
    return in_chunks(run, _chunks_of(h, packed), (0, 1, 7, 8))


def block_core2_bwd(ha, hb, xa, xb, ma, ra, mb, rb, g, w1, b1, w2, ws, gelu="tanh",
                    packed=None):
    """K4: the backward of ``block_core2``. Returns what
    ``block_core2_bwd_reference`` returns; in chunks of images as K2."""
    if ha.device.type == "cpu":
        return block_core2_bwd_reference(ha, hb, xa, xb, ma, ra, mb, rb, g, w1, b1, w2, ws, gelu)
    if packed is None:
        packed = _bwd_pack(w1, b1, w2, ws, ha.dtype, c1=ha.shape[1])

    def run(i, j):
        out = _launch_bwd([(ha[i:j], xa[i:j], ma[i:j], ra[i:j]), (hb[i:j], xb[i:j], mb[i:j],
                                                                  rb[i:j])], g[i:j], packed, gelu)
        block_core2_bwd.launches += 1
        return out
    return in_chunks(run, _chunks_of(ha, packed), (0, 1, 2, 3, 9, 10, 11, 12))


# Launches of each kernel since the last reset (a caller sets them to 0).
block_core.launches = 0
block_core2.launches = 0
block_core_bwd.launches = 0
block_core2_bwd.launches = 0


def _cotangent(g, like):
    """The output cotangent as the backward kernels read it: the forward's
    dtype, channels_last (a CPU tensor passes as it is)."""
    if g.device.type == "cpu":
        return g.to(like.dtype)
    return g.to(like.dtype).contiguous(memory_format=CL)


def _reduce_s(rows, *sums):
    """K2's / K4's per-(image, channel) S sums of a strip summed over its
    row group (one all-reduce), as the fold needs the image's; the sums
    themselves without a spatial axis."""
    if rows is None:
        return sums
    return spatial.sum_rows(torch.stack(sums), rows).unbind()


def _fold_hw(rows, h):
    """The H * W the fold divides by: the image's, of which h is a strip."""
    return None if rows is None else h.shape[2] * rows.size * h.shape[3]


class _BlockCoreIn(torch.autograd.Function):
    """``block_core_in`` with its backward: K1 forward, K2 backward, then
    the InstanceNorm fold (``_in_vjp_fwd`` / ``_in_vjp_bwd`` of the JAX
    package). The weights come unpacked and cast, so that autograd carries
    their gradients to the parameters; ``packed`` is their kernel layout.
    On a strip of the spatial axis the statistics are the image's, S1 and
    S2 are summed over the row group before the fold, and the weight
    gradients are this strip's part."""

    @staticmethod
    def forward(ctx, h, x, w1, b1, w2, b2, ws, gelu, packed):
        mean, rsig = instance_stats(h)
        out = block_core(h, x, mean, rsig, w1, b1, w2, b2, ws, gelu, packed=packed)
        ctx.save_for_backward(h, x, mean, rsig, w1, b1, w2, ws)
        ctx.gelu, ctx.packed, ctx.b2_dtype = gelu, packed, b2.dtype
        ctx.rows = spatial.active()
        return out

    @staticmethod
    def backward(ctx, g):
        h, x, mean, rsig, w1, b1, w2, ws = ctx.saved_tensors
        dn, dx, dw1, db1, dw2, db2, dws, s1, s2 = block_core_bwd(
            h, x, mean, rsig, _cotangent(g, h), w1, b1, w2, ws, ctx.gelu, packed=ctx.packed)
        s1, s2 = _reduce_s(ctx.rows, s1, s2)
        return (in_fold(dn, h, mean, rsig, s1, s2, _fold_hw(ctx.rows, h)), dx, dw1.to(w1.dtype),
                db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(ctx.b2_dtype), dws.to(ws.dtype), None,
                None)


class _BlockCore2In(torch.autograd.Function):
    """``block_core2_in`` with its backward: K3 forward, K4 backward, each
    part folded on its own (``_in2_vjp_fwd`` / ``_in2_vjp_bwd``); on a
    strip, its four S sums summed over the row group first."""

    @staticmethod
    def forward(ctx, ha, hb, xa, xb, w1, b1, w2, b2, ws, gelu, packed):
        ma, ra = instance_stats(ha)
        mb, rb = instance_stats(hb)
        out = block_core2(ha, hb, xa, xb, ma, ra, mb, rb, w1, b1, w2, b2, ws, gelu,
                          packed=packed)
        ctx.save_for_backward(ha, hb, xa, xb, ma, ra, mb, rb, w1, b1, w2, ws)
        ctx.gelu, ctx.packed, ctx.b2_dtype = gelu, packed, b2.dtype
        ctx.rows = spatial.active()
        return out

    @staticmethod
    def backward(ctx, g):
        ha, hb, xa, xb, ma, ra, mb, rb, w1, b1, w2, ws = ctx.saved_tensors
        (dna, dnb, dxa, dxb, dw1, db1, dw2, db2, dws, s1a, s2a, s1b, s2b) = block_core2_bwd(
            ha, hb, xa, xb, ma, ra, mb, rb, _cotangent(g, ha), w1, b1, w2, ws, ctx.gelu,
            packed=ctx.packed)
        if ctx.rows is not None:  # the parts' widths differ: one flat all-reduce
            ca = s1a.shape[1]
            s1, s2 = _reduce_s(ctx.rows, torch.cat([s1a, s1b], 1), torch.cat([s2a, s2b], 1))
            s1a, s1b, s2a, s2b = s1[:, :ca], s1[:, ca:], s2[:, :ca], s2[:, ca:]
        hw = _fold_hw(ctx.rows, ha)
        return (in_fold(dna, ha, ma, ra, s1a, s2a, hw), in_fold(dnb, hb, mb, rb, s1b, s2b, hw),
                dxa, dxb, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(ctx.b2_dtype), dws.to(ws.dtype), None, None)


def _unpack(packed, c2=0):
    """(w1, b1, w2, b2, ws) out of a pack: the padding dropped, the parts'
    rows joined (the concat layout)."""
    pk = packed

    def rows(w):
        return torch.cat([w[:pk.c1], w[pk.c1p:pk.c1p + c2]]) if c2 else w[:pk.c1]

    return (rows(pk.w1)[:, :pk.h4], pk.b1[:pk.h4], pk.w2[:pk.h4, :pk.p], pk.b2[:pk.p],
            rows(pk.ws)[:, :pk.p])


def _fake_out(h, p):
    """The output the forward kernels write: (B, P, H, W) in h's dtype,
    channels_last."""
    b, _, hh, ww = h.shape
    return torch.empty((b, p, hh, ww), dtype=h.dtype, device=h.device, memory_format=CL)


@torch.library.custom_op("dsgan::block_core", mutates_args=(), device_types="cuda")
def block_core_op(h: torch.Tensor, x: torch.Tensor, mean: torch.Tensor, rsig: torch.Tensor,
                  w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                  ws: torch.Tensor, w1t: Optional[torch.Tensor], w2t: Optional[torch.Tensor],
                  wst: Optional[torch.Tensor], c1p: int, h4: int, p: int,
                  gelu: str) -> torch.Tensor:
    """K1 as a registered op, on the packed weights (``pack_weights``'s
    fields): on a CUDA tensor the kernel, counted in ``block_core.launches``."""
    packed = PackedWeights(w1, b1, w2, b2, ws, h.shape[1], c1p, h4, p, w1t, w2t, wst)
    return block_core(h, x, mean, rsig, None, None, None, None, None, gelu, packed=packed)


@block_core_op.register_kernel("cpu")
def _block_core_op_cpu(h, x, mean, rsig, w1, b1, w2, b2, ws, w1t, w2t, wst, c1p, h4, p, gelu):
    packed = PackedWeights(w1, b1, w2, b2, ws, h.shape[1], c1p, h4, p)
    return block_core_reference(h, x, mean, rsig, *_unpack(packed), gelu)


@block_core_op.register_fake
def _block_core_op_fake(h, x, mean, rsig, w1, b1, w2, b2, ws, w1t, w2t, wst, c1p, h4, p, gelu):
    return _fake_out(h, p)


@torch.library.custom_op("dsgan::block_core2", mutates_args=(), device_types="cuda")
def block_core2_op(ha: torch.Tensor, hb: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor,
                   ma: torch.Tensor, ra: torch.Tensor, mb: torch.Tensor, rb: torch.Tensor,
                   w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                   ws: torch.Tensor, w1t: Optional[torch.Tensor], w2t: Optional[torch.Tensor],
                   wst: Optional[torch.Tensor], c1p: int, h4: int, p: int,
                   gelu: str) -> torch.Tensor:
    """K3 as a registered op, on the packed weights: on a CUDA tensor the
    kernel, counted in ``block_core2.launches``."""
    packed = PackedWeights(w1, b1, w2, b2, ws, ha.shape[1], c1p, h4, p, w1t, w2t, wst)
    return block_core2(ha, hb, xa, xb, ma, ra, mb, rb, None, None, None, None, None, gelu,
                       packed=packed)


@block_core2_op.register_kernel("cpu")
def _block_core2_op_cpu(ha, hb, xa, xb, ma, ra, mb, rb, w1, b1, w2, b2, ws, w1t, w2t, wst, c1p,
                        h4, p, gelu):
    packed = PackedWeights(w1, b1, w2, b2, ws, ha.shape[1], c1p, h4, p)
    return block_core2_reference(ha, hb, xa, xb, ma, ra, mb, rb, *_unpack(packed, hb.shape[1]),
                                 gelu)


@block_core2_op.register_fake
def _block_core2_op_fake(ha, hb, xa, xb, ma, ra, mb, rb, w1, b1, w2, b2, ws, w1t, w2t, wst, c1p,
                         h4, p, gelu):
    return _fake_out(ha, p)


def _op_weights(packed):
    """A pack as the ops' weight arguments."""
    return (packed.w1, packed.b1, packed.w2, packed.b2, packed.ws, packed.w1t, packed.w2t,
            packed.wst, packed.c1p, packed.h4, packed.p)


def _records(*tensors):
    """Whether autograd records an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def block_core_in(h, x, w1, b1, w2, b2, ws, gelu="tanh", packed=None):
    """InstanceNorm(h) -> MLP -> + x @ Ws. ``h``, ``x``: (B, C, H, W). Where
    autograd records: differentiable, K1 forward, K2 backward. Otherwise
    the op ``dsgan::block_core`` on ``packed``, or on a pack made here."""
    if _records(h, x, w1, b1, w2, b2, ws):
        return _BlockCoreIn.apply(h, x, w1, b1, w2, b2, ws, gelu, packed)
    if packed is None:
        packed = pack_weights(w1, b1, w2, b2, ws, h.dtype)
    return torch.ops.dsgan.block_core(h, x, *instance_stats(h), *_op_weights(packed), gelu)


def block_core2_in(ha, hb, xa, xb, w1, b1, w2, b2, ws, gelu="tanh", packed=None):
    """The two-input block core on the parts a = (ha, xa), b = (hb, xb),
    equal to ``block_core_in`` on their channel concat: K3 forward, K4
    backward where autograd records, else the op ``dsgan::block_core2``."""
    if _records(ha, hb, xa, xb, w1, b1, w2, b2, ws):
        return _BlockCore2In.apply(ha, hb, xa, xb, w1, b1, w2, b2, ws, gelu, packed)
    if packed is None:
        packed = pack_weights(w1, b1, w2, b2, ws, ha.dtype, c1=ha.shape[1])
    return torch.ops.dsgan.block_core2(ha, hb, xa, xb, *instance_stats(ha), *instance_stats(hb),
                                       *_op_weights(packed), gelu)

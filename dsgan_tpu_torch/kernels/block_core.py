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
model calls: autograd Functions that compute the statistics, run K1 / K3
forward and K2 / K4 backward, and fold S1, S2 into the closed-form
InstanceNorm cotangent (``in_fold``), as ``_in_vjp_bwd`` /
``_in2_vjp_bwd`` do in the JAX package.

K3 and K4 in bf16 run the Hopper kernels ``csrc/block_core2_fwd_sm90.cu``
and ``csrc/block_core2_bwd_sm90.cu`` (wgmma fed by TMA, 128-row tiles);
in f32 they run the FMA check builds of ``block_core.cu`` /
``block_core_bwd.cu``. ``k3_plan`` and ``k4_plan`` mirror the tile,
shared-memory and workspace plans of the bf16 kernels and raise on what
they cannot take.

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
from typing import NamedTuple

import torch
import torch.nn.functional as F

from dsgan_tpu_torch.ops.norm import instance_stats

# Shared memory a block may use on Hopper (232,448 bytes).
MAX_SMEM = 227 * 1024
SMS = 132  # streaming multiprocessors of the H100
ROWS_PER_BLOCK = 32  # TM of the forward in the CUDA source
BWD_ROWS = (32, 16)  # row-pass tiles of the backward, the first that fits
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
    # bf16 two-part packs only: the transposes (H4p, Cp), (Pp, H4p), (Pp, Cp)
    # that the Hopper kernels read as K-major operands
    w1t: torch.Tensor = None
    w2t: torch.Tensor = None
    wst: torch.Tensor = None


def pack_weights(w1, b1, w2, b2, ws, dtype, c1=None):
    """Pad the block weights for the kernel. ``c1`` splits the input
    channels into parts a = [0, c1) and b = [c1, C) for ``block_core2_in``."""
    c, h4 = w1.shape
    p = w2.shape[1]
    c1 = c if c1 is None else c1
    c1p, c2p = _ceil16(c1), _ceil16(c - c1)
    h4p, pp = _ceil16(h4), _ceil16(p)

    def rows_split(w, ncols):
        out = w.new_zeros((c1p + c2p, ncols), dtype=dtype)
        out[:c1, : w.shape[1]] = w[:c1]
        out[c1p: c1p + c - c1, : w.shape[1]] = w[c1:]
        return out

    w2p = w2.new_zeros((h4p, pp), dtype=dtype)
    w2p[:h4, :p] = w2
    b1p = b1.new_zeros((h4p,), dtype=dtype)
    b1p[:h4] = b1
    b2p = b2.new_zeros((pp,), dtype=dtype)
    b2p[:p] = b2
    w1p, wsp = rows_split(w1, h4p), rows_split(ws, pp)
    tr = {}
    if dtype == torch.bfloat16 and c1 < c:
        tr = dict(w1t=w1p.t().contiguous(), w2t=w2p.t().contiguous(), wst=wsp.t().contiguous())
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


def in_fold(dn, h, mean, rsig, s1, s2):
    """The InstanceNorm cotangent of h from the kernel's dn, S1, S2
    (``_in_fold`` of the JAX package):

        dh = rsig * dn - rsig * S1 / HW - rsig^3 * S2 / HW * (h - mean)
           = dn * rsig - h * c3 + (mean * c3 - rsig * S1 / HW)

    with per-(image, channel) f32 coefficients and one elementwise pass in
    h's dtype."""
    hw = h.shape[2] * h.shape[3]
    c3 = rsig ** 3 * s2 / hw
    c0 = mean * c3 - rsig * s1 / hw

    def col(v):
        return v[:, :, None, None].to(h.dtype)

    return dn * col(rsig) - h * col(c3) + col(c0)


SOURCES = ("block_core", "block_core_bwd", "block_core2_fwd_sm90", "block_core2_bwd_sm90")


class _Entries(NamedTuple):
    fwd: object    # K1 and the f32 K3
    fwd2: object
    bwd: object    # K2 and the f32 K4
    fwd2_sm90: object
    bwd2_sm90: object


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
    fwd2_sm90 = _build.load("block_core2_fwd_sm90").block_core2_fwd_sm90
    fwd2_sm90.argtypes = [i] + [p] * 14 + [ll] + [i] * 13 + [p]
    bwd2_sm90 = _build.load("block_core2_bwd_sm90").block_core2_bwd_sm90
    bwd2_sm90.argtypes = [i] + [p] * 27 + [i] * 11 + [p, size, p]
    for f in (fwd, fwd2, bwd, fwd2_sm90, bwd2_sm90):
        f.restype = i
    return _Entries(fwd, fwd2, bwd, fwd2_sm90, bwd2_sm90)


def _hidden_chunk(h4p):
    """Hidden columns made per step: the largest of 128/64/32/16 dividing H4p."""
    return next(hc for hc in (128, 64, 32, 16) if h4p % hc == 0)


def smem_bytes(itemsize, cp, hc, pp):
    """Shared memory of one thread block of ROWS_PER_BLOCK rows (mirrors
    ``smem_bytes`` in the CUDA source): f32 accumulator and hidden chunk,
    the input tile, and in bf16 the activated hidden; every row padded by
    16 bytes."""
    tm, pad = ROWS_PER_BLOCK, 16 // itemsize
    s = 4 * tm * (pp + 4 + hc + 4) + itemsize * tm * (cp + pad)
    if itemsize != 4:
        s += itemsize * tm * (hc + pad)
    return s


def bwd_smem_bytes(itemsize, tm, cp, hc, pp):
    """Shared memory of one row-pass block of the backward (mirrors
    ``row_smem_bytes`` in ``csrc/block_core_bwd.cu``): the f32 dn
    accumulator and the hidden and da chunks, then in the storage dtype
    the normalized input, the cotangent tile and the rounded dg1 chunk;
    every row padded by 16 bytes."""
    pad = 16 // itemsize
    return 4 * tm * ((cp + 4) + 2 * (hc + 4)) + itemsize * tm * ((cp + pad) + (pp + pad) + (hc + pad))


def bwd_rows(itemsize, cp, hc, pp):
    """Rows of the backward's row-pass tile: the first of ``BWD_ROWS``
    whose tile fits a block's shared memory; raises if none does."""
    for tm in BWD_ROWS:
        if bwd_smem_bytes(itemsize, tm, cp, hc, pp) <= MAX_SMEM:
            return tm
    need = bwd_smem_bytes(itemsize, BWD_ROWS[-1], cp, hc, pp)
    raise ValueError(f"block core backward tile needs {need} B of shared memory (> {MAX_SMEM})")


def _cdiv(a, b):
    return -(-a // b)


def _align256(n):
    return _cdiv(n, 256) * 256


class K3Plan(NamedTuple):
    """Tiles of the bf16 K3 kernel (``csrc/block_core2_fwd_sm90.cu``)."""
    nwg: int     # consumer warpgroups of 64 rows: 128 or 64 rows a block
    pn: int      # output columns a block
    hc: int      # hidden columns a GEMM1 chunk
    stages: int  # weight tiles in flight
    smem: int    # shared memory a block, bytes
    splits: int  # blocks over the output columns of one row tile


def k3_smem_bytes(rows, cp, pn, hc, stages):
    """Mirrors ``smem_bytes`` in ``csrc/block_core2_fwd_sm90.cu``: the
    resident A tile (rows x Cp rounded up to 64, bf16), the ring of weight
    tiles, the barriers, alignment slack."""
    return 1024 + _cdiv(cp, 64) * rows * 128 + stages * max(pn, hc) * 128 + 16 * stages


def k3_plan(m, cp, pp):
    """K3's tiles for ``m`` rows: output columns in blocks of at most 256
    (P = 512 splits in two, each block recomputing GEMM1), 128 rows a
    block where that tile fits shared memory and still gives every SM a
    block, else 64; the deepest ring (4 stages at most) that fits. Raises
    where not even 64 rows fit."""
    pn = 64 if pp <= 64 else 128 if pp <= 128 else 256
    hc = 64 if pn == 256 else 128
    splits = _cdiv(pp, pn)
    for nwg in (2, 1):
        if nwg == 2 and _cdiv(m, 128) * splits < SMS:
            continue
        for stages in (4, 3, 2):
            smem = k3_smem_bytes(64 * nwg, cp, pn, hc, stages)
            if smem <= MAX_SMEM:
                return K3Plan(nwg, pn, hc, stages, smem, splits)
    need = k3_smem_bytes(64, cp, pn, hc, 2)
    raise ValueError(f"block core K3 tile needs {need} B of shared memory (> {MAX_SMEM})")


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
    """Mirrors ``make_plan`` in ``csrc/block_core2_bwd_sm90.cu``: the row
    tiles, the splits of the weight pass and the workspace (a and x side
    by side, g padded where P % 8 != 0, ag, dg1, the partial sums, the
    reduce's first level). Its tiles, hence its shared memory, do not
    depend on C; it raises where the kernels' 32-bit indices cannot take
    the call."""
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


def _check_shapes(parts):
    """Each part: x shaped as h, f32 (B, C) statistics of h."""
    for h, x, mean, rsig in parts:
        if h.dim() != 4 or x.shape != h.shape:
            raise ValueError(f"h {tuple(h.shape)} and x {tuple(x.shape)} must be one (B, C, H, W)")
        for s in (mean, rsig):
            if s.shape != h.shape[:2] or s.dtype != torch.float32 or s.device != h.device:
                raise ValueError("statistics must be f32 (B, C) tensors on h's device")


def _check_packed(packed, ha, hb=None):
    """``packed`` is laid out for these parts, and the parts agree in batch
    and spatial size."""
    c1, c2 = ha.shape[1], (0 if hb is None else hb.shape[1])
    if packed.c1 != c1 or packed.w1.shape[0] != packed.c1p + _ceil16(c2):
        raise ValueError(f"packed weights do not match a block of {c1} + {c2} input channels")
    if hb is not None and (hb.shape[0] != ha.shape[0] or hb.shape[2:] != ha.shape[2:]):
        raise ValueError("the two parts must share batch and spatial size")


def _check_cuda(acts, packed, dtype):
    for t in acts:
        if t.device != acts[0].device or t.dtype != dtype:
            raise ValueError("block core inputs must share one device and dtype")
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("block core kernel needs channels_last-contiguous activations")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"block core kernel takes bf16 or f32, not {dtype}")
    for w in (packed.w1, packed.b1, packed.w2, packed.b2, packed.ws):
        if w.device != acts[0].device or w.dtype != dtype or not w.is_contiguous():
            raise ValueError("packed weights must be contiguous, in the activations' dtype and device")


def _check_transposes(packed):
    """The bf16 K3 / K4 kernels read the transposed weights."""
    if packed.w1t is None:
        raise ValueError("packed weights lack the transposes of a bf16 two-part pack_weights")


def _vec(acts, stats, c1, c2):
    """Whether the kernels may read the parts' rows 16 bytes at a time."""
    return int(c1 % 8 == 0 and c2 % 8 == 0
               and all(t.data_ptr() % 16 == 0 for t in (*acts, *stats)))


def _launch_k3_sm90(acts, stats, packed, gelu, shape, c2):
    """The bf16 K3 kernel (``csrc/block_core2_fwd_sm90.cu``) on its plan."""
    b, c1, hh, ww = shape
    cp, h4p = packed.w1.shape
    pp = packed.w2.shape[1]
    m = b * hh * ww
    plan = k3_plan(m, cp, pp)
    _check_transposes(packed)
    out = torch.empty((b, packed.p, hh, ww), dtype=acts[0].dtype, device=acts[0].device,
                      memory_format=CL)
    stream = torch.cuda.current_stream(acts[0].device).cuda_stream
    stats = [s.contiguous() for s in stats]
    ptrs = [t.data_ptr() for t in (*acts, *stats, packed.w1t, packed.b1, packed.w2t, packed.b2,
                                   packed.wst, out)]
    dims = [hh * ww, c1, c2, packed.c1p, cp, h4p, packed.p, pp, plan.nwg, plan.pn, plan.hc,
            plan.stages, _vec(acts, stats, c1, c2)]
    err = _lib().fwd2_sm90(int(gelu == "tanh"), *ptrs, m, *dims, stream)
    if err:
        raise RuntimeError(f"block core K3 launch failed: error {err}")
    return out


def _launch(fn, acts, stats, packed, gelu, shape, c2):
    b, c1, hh, ww = shape
    dtype = acts[0].dtype
    is_bf16 = int(dtype == torch.bfloat16)
    if gelu not in ("tanh", "erf"):
        raise ValueError(f"unknown gelu flavour [{gelu}]")
    cp, h4p = packed.w1.shape
    pp = packed.w2.shape[1]
    hc = _hidden_chunk(h4p)
    smem = smem_bytes(2 if is_bf16 else 4, cp, hc, pp)
    if smem > MAX_SMEM:
        raise ValueError(f"block core tile needs {smem} B of shared memory (> {MAX_SMEM})")
    out = torch.empty((b, packed.p, hh, ww), dtype=dtype, device=acts[0].device,
                      memory_format=torch.channels_last)
    stream = torch.cuda.current_stream(acts[0].device).cuda_stream
    stats = [s.contiguous() for s in stats]
    ptrs = [t.data_ptr() for t in (*acts, *stats)]
    wptrs = [t.data_ptr() for t in (packed.w1, packed.b1, packed.w2, packed.b2, packed.ws)]
    dims = [b * hh * ww, hh * ww, c1] + ([c2, packed.c1p] if c2 else []) + [cp, h4p, hc, packed.p, pp]
    err = fn(is_bf16, int(gelu == "tanh"), *ptrs, *wptrs, out.data_ptr(), *dims, stream)
    if err:
        raise RuntimeError(f"block core kernel launch failed: CUDA error {err}")
    return out


def block_core(h, x, mean, rsig, w1, b1, w2, b2, ws, gelu="tanh", packed=None):
    """K1 with the InstanceNorm statistics given: ``h``, ``x`` (B, C, H, W);
    ``mean``, ``rsig`` (B, C) f32. Returns (B, P, H, W)."""
    if h.device.type == "cpu":
        return block_core_reference(h, x, mean, rsig, w1, b1, w2, b2, ws, gelu)
    if packed is None:
        packed = pack_weights(w1, b1, w2, b2, ws, h.dtype)
    _check_packed(packed, h)
    _check_shapes(((h, x, mean, rsig),))
    _check_cuda((h, x), packed, h.dtype)
    out = _launch(_lib().fwd, (h, x), (mean, rsig), packed, gelu, h.shape, 0)
    block_core.launches += 1
    return out


def block_core2(ha, hb, xa, xb, ma, ra, mb, rb, w1, b1, w2, b2, ws, gelu="tanh",
                packed=None):
    """K3 with the statistics of each part given."""
    if ha.device.type == "cpu":
        return block_core2_reference(ha, hb, xa, xb, ma, ra, mb, rb, w1, b1, w2, b2, ws, gelu)
    if packed is None:
        packed = pack_weights(w1, b1, w2, b2, ws, ha.dtype, c1=ha.shape[1])
    _check_packed(packed, ha, hb)
    _check_shapes(((ha, xa, ma, ra), (hb, xb, mb, rb)))
    _check_cuda((ha, hb, xa, xb), packed, ha.dtype)
    acts, stats = (ha, hb, xa, xb), (ma, ra, mb, rb)
    if ha.dtype == torch.bfloat16:  # the Hopper kernel
        if gelu not in ("tanh", "erf"):
            raise ValueError(f"unknown gelu flavour [{gelu}]")
        out = _launch_k3_sm90(acts, stats, packed, gelu, ha.shape, hb.shape[1])
    else:  # the FMA check build
        out = _launch(_lib().fwd2, acts, stats, packed, gelu, ha.shape, hb.shape[1])
    block_core2.launches += 1
    return out


def _launch_bwd(parts, g, packed, gelu):
    """K2 (one part) or K4 (two parts); ``parts``: [(h, x, mean, rsig), ...].
    Allocates the outputs and the kernel's workspace (the scratch and the
    f32 partial sums), then runs every pass on the current stream: in bf16
    K4 the Hopper kernel's (``k4_plan``), else the 32-row kernel's."""
    (ha, xa, ma, ra), (hb, xb, mb, rb) = parts[0], (parts[1] if len(parts) > 1 else (None,) * 4)
    b, c1, hh, ww = ha.shape
    c2 = hb.shape[1] if hb is not None else 0
    dtype, dev = ha.dtype, ha.device
    if gelu not in ("tanh", "erf"):
        raise ValueError(f"unknown gelu flavour [{gelu}]")
    if g.shape != (b, packed.p, hh, ww):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match the output {(b, packed.p, hh, ww)}")
    _check_shapes(parts)
    _check_cuda([t for pt in parts for t in pt[:2]] + [g], packed, dtype)
    cp, h4p = packed.w1.shape
    pp = packed.w2.shape[1]
    sm90 = c2 and dtype == torch.bfloat16  # K4 in bf16: the Hopper kernel
    if sm90:
        plan = k4_plan(b, hh * ww, cp, h4p, packed.p, pp)
        _check_transposes(packed)
    else:
        hc = _hidden_chunk(h4p)
        tm = bwd_rows(ha.element_size(), cp, hc, pp)

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

    def ptr(t):
        return None if t is None else t.data_ptr()

    stats = [None if t is None else t.contiguous() for t in (ma, ra, mb, rb)]
    outs = (dna, dnb, dxa, dxb, dw1, db1, dw2, db2, dws, s1a, s2a, s1b, s2b)
    if sm90:
        if g.data_ptr() % 16:  # TMA reads g's rows from a 16-byte aligned base
            g = g.clone(memory_format=CL)
        tensors = (ha, hb, xa, xb, g, *stats, packed.w1, packed.w1t, packed.b1, packed.w2,
                   packed.ws, *outs)
        head = [int(gelu == "tanh")] + [ptr(t) for t in tensors]
        dims = [b, hh * ww, c1, c2, packed.c1p, cp, h4, h4p, p, pp,
                _vec((ha, hb, xa, xb), stats, c1, c2)]
        fn = _lib().bwd2_sm90
    else:
        tensors = (ha, hb, xa, xb, g, *stats, packed.w1, packed.b1, packed.w2, packed.ws, *outs)
        head = [int(dtype == torch.bfloat16), int(gelu == "tanh"), tm] + [ptr(t) for t in tensors]
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


def block_core_bwd(h, x, mean, rsig, g, w1, b1, w2, ws, gelu="tanh", packed=None):
    """K2: the backward of ``block_core`` at the cotangent ``g`` (B, P, H, W).
    Returns what ``block_core_bwd_reference`` returns."""
    if h.device.type == "cpu":
        return block_core_bwd_reference(h, x, mean, rsig, g, w1, b1, w2, ws, gelu)
    if packed is None:
        packed = _bwd_pack(w1, b1, w2, ws, h.dtype)
    _check_packed(packed, h)
    out = _launch_bwd([(h, x, mean, rsig)], g, packed, gelu)
    block_core_bwd.launches += 1
    return out


def block_core2_bwd(ha, hb, xa, xb, ma, ra, mb, rb, g, w1, b1, w2, ws, gelu="tanh",
                    packed=None):
    """K4: the backward of ``block_core2``. Returns what
    ``block_core2_bwd_reference`` returns."""
    if ha.device.type == "cpu":
        return block_core2_bwd_reference(ha, hb, xa, xb, ma, ra, mb, rb, g, w1, b1, w2, ws, gelu)
    if packed is None:
        packed = _bwd_pack(w1, b1, w2, ws, ha.dtype, c1=ha.shape[1])
    _check_packed(packed, ha, hb)
    out = _launch_bwd([(ha, xa, ma, ra), (hb, xb, mb, rb)], g, packed, gelu)
    block_core2_bwd.launches += 1
    return out


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


class _BlockCoreIn(torch.autograd.Function):
    """``block_core_in`` with its backward: K1 forward, K2 backward, then
    the InstanceNorm fold (``_in_vjp_fwd`` / ``_in_vjp_bwd`` of the JAX
    package). The weights come unpacked and cast, so that autograd carries
    their gradients to the parameters; ``packed`` is their kernel layout."""

    @staticmethod
    def forward(ctx, h, x, w1, b1, w2, b2, ws, gelu, packed):
        mean, rsig = instance_stats(h)
        out = block_core(h, x, mean, rsig, w1, b1, w2, b2, ws, gelu, packed=packed)
        ctx.save_for_backward(h, x, mean, rsig, w1, b1, w2, ws)
        ctx.gelu, ctx.packed, ctx.b2_dtype = gelu, packed, b2.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        h, x, mean, rsig, w1, b1, w2, ws = ctx.saved_tensors
        dn, dx, dw1, db1, dw2, db2, dws, s1, s2 = block_core_bwd(
            h, x, mean, rsig, _cotangent(g, h), w1, b1, w2, ws, ctx.gelu, packed=ctx.packed)
        return (in_fold(dn, h, mean, rsig, s1, s2), dx, dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(ctx.b2_dtype), dws.to(ws.dtype), None, None)


class _BlockCore2In(torch.autograd.Function):
    """``block_core2_in`` with its backward: K3 forward, K4 backward, each
    part folded on its own (``_in2_vjp_fwd`` / ``_in2_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, ha, hb, xa, xb, w1, b1, w2, b2, ws, gelu, packed):
        ma, ra = instance_stats(ha)
        mb, rb = instance_stats(hb)
        out = block_core2(ha, hb, xa, xb, ma, ra, mb, rb, w1, b1, w2, b2, ws, gelu,
                          packed=packed)
        ctx.save_for_backward(ha, hb, xa, xb, ma, ra, mb, rb, w1, b1, w2, ws)
        ctx.gelu, ctx.packed, ctx.b2_dtype = gelu, packed, b2.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        ha, hb, xa, xb, ma, ra, mb, rb, w1, b1, w2, ws = ctx.saved_tensors
        (dna, dnb, dxa, dxb, dw1, db1, dw2, db2, dws, s1a, s2a, s1b, s2b) = block_core2_bwd(
            ha, hb, xa, xb, ma, ra, mb, rb, _cotangent(g, ha), w1, b1, w2, ws, ctx.gelu,
            packed=ctx.packed)
        return (in_fold(dna, ha, ma, ra, s1a, s2a), in_fold(dnb, hb, mb, rb, s1b, s2b), dxa, dxb,
                dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(ctx.b2_dtype),
                dws.to(ws.dtype), None, None)


def block_core_in(h, x, w1, b1, w2, b2, ws, gelu="tanh", packed=None):
    """InstanceNorm(h) -> MLP -> + x @ Ws, differentiable: K1 forward, K2
    backward. ``h``, ``x``: (B, C, H, W)."""
    return _BlockCoreIn.apply(h, x, w1, b1, w2, b2, ws, gelu, packed)


def block_core2_in(ha, hb, xa, xb, w1, b1, w2, b2, ws, gelu="tanh", packed=None):
    """The two-input block core on the parts a = (ha, xa), b = (hb, xb),
    equal to ``block_core_in`` on their channel concat: K3 forward, K4
    backward."""
    return _BlockCore2In.apply(ha, hb, xa, xb, w1, b1, w2, b2, ws, gelu, packed)

"""The spatial axis: image rows over the ranks of a row group (what GSPMD
does for ``dsgan_tpu``'s ``spatial`` mesh axis, written out).

JAX shards H over the ``spatial`` mesh axis and XLA's partitioner inserts
the halo exchanges of every windowed op and the reductions of every sum
over H and W. The port has no partitioner: a step or a forward that runs
on a strip enters ``rows(mesh)``, and inside it the port's ops read the
row group from here (``active``) and do what the partitioner would:

  * ``halo``: the rows above and below a strip from the ranks that own
    them (``HaloExchange``: point-to-point, as deep as the window asks,
    past the nearest rank if the strip is shorter; zeros, a reflection or
    a replication past the image's top and bottom, never at a strip's
    edge); its backward sends each halo row's cotangent to its owner,
    which adds it to the row's;
  * ``conv2d`` (any kernel, stride and padding whose output height splits
    over the group; a reflect or replicate pad before it hands the conv
    its rows, ``sequential``), ``conv_transpose2d`` (any kernel, stride and
    padding: the k3 s2 p1 op1 and k4 s2 p1 upsamples), ``max_pool2d`` on
    whole windows, ``avg_pool2d`` (whole windows, and the 3x3 stride-2
    pool of the pyramids, its divisor from the image's padding alone),
    ``upsample_bilinear2x``;
  * ``sum_rows`` / ``max_rows``: sums and maxima over the group, with
    their gradients (a maximum's cotangent to the rows that hold it);
  * ``mean`` / ``share``: a rank's share of a global mean, so that the
    shares of a row group add up to its value.

A strip of a tensor whose global height is ``Hg`` holds rows ``[s * Hg /
S, (s + 1) * Hg / S)``. A level whose height does not split over the S
ranks (``Hg % S``: the PatchGAN's stride-1 tail, a deep level of a small
image) is gathered (``gather``) and computed whole on every rank, under
``replicated()``, where the ops run as in one process; where the height
splits again (an upsample) each rank takes its rows back (``take``). A
replicated computation's cotangent is then partial on each rank (the
loss shares are), so its weight gradients are partial sums like every
other's, and the gather's backward sums the group's cotangents.
``sequential`` does this for a chain of layers, ``levels`` for the
generator's pyramid of levels.

Outside ``rows(mesh)`` (``active()`` is None) every op runs the code it
runs in one process.
"""

import contextlib
import functools

import torch
import torch.nn.functional as F
from torch import nn

from dsgan_tpu_torch.parallel import comms

_active = None        # the split context's Rows, or None
_replicated = False   # inside it, whether every rank holds the whole image


class Rows:
    """This rank's row group: ``size`` ranks, this one at ``index``, their
    global ranks ``ranks``, the group ``group`` of ``mesh``."""

    def __init__(self, mesh):
        self.mesh, self.size, self.index = mesh, mesh.spatial, mesh.row
        self.ranks, self.group = tuple(mesh.row_ranks), mesh.row_group

    @property
    def last(self):
        return self.index == self.size - 1


@contextlib.contextmanager
def rows(mesh):
    """Run the ops on this rank's strip of ``mesh``'s row group; nothing
    changes without a spatial axis (``mesh`` None or ``spatial`` 1)."""
    global _active, _replicated
    if mesh is None or mesh.spatial == 1:
        yield None
        return
    prev = _active, _replicated
    _active, _replicated = Rows(mesh), False
    try:
        yield _active
    finally:
        _active, _replicated = prev


def active():
    """The row group the ops split over, or None (one process, or a
    replicated level)."""
    return None if _replicated else _active


def context():
    """The split context as it stands (the row group, and whether every rank
    holds the whole image), to re-enter later with ``entered``."""
    return _active, _replicated


@contextlib.contextmanager
def entered(ctx):
    """Run inside a split context taken by ``context``: a forward recomputed
    in the backward (``torch.utils.checkpoint``) runs outside the one it
    first ran in."""
    global _active, _replicated
    prev = _active, _replicated
    _active, _replicated = ctx
    try:
        yield
    finally:
        _active, _replicated = prev


@contextlib.contextmanager
def replicated(on=True):
    """Inside a split context: every rank holds the whole image (``on``), or
    its strip (``on`` False). Outside one: nothing."""
    global _replicated
    prev = _replicated
    _replicated = bool(on)
    try:
        yield
    finally:
        _replicated = prev


# -- halo exchange ----------------------------------------------------------

def _source(g, hg, mode):
    """The image row that padded row ``g`` reads, or None (a zero)."""
    if 0 <= g < hg:
        return g
    if mode == "zero":
        return None
    if mode == "reflect":
        g = -g if g < 0 else 2 * (hg - 1) - g
        if not 0 <= g < hg:
            raise ValueError(f"a reflection {g} rows deep exceeds the image's {hg} rows")
        return g
    if mode == "replicate":
        return min(max(g, 0), hg - 1)
    raise ValueError(f"unknown padding mode {mode}")


def _runs(pairs):
    """[(pos, src)] in pos order as runs (pos0, src0, n, step): ``n``
    consecutive positions reading rows src0, src0 + step, ..."""
    runs = []
    for pos, src in pairs:
        if runs:
            p0, s0, n, st = runs[-1]
            step = st or (src - s0 if abs(src - s0) == 1 else 0)
            if pos == p0 + n and step and src == s0 + step * n:
                runs[-1] = (p0, s0, n + 1, step)
                continue
        runs.append((pos, src, 1, 0))
    return [(p, s, n, st or 1) for p, s, n, st in runs]


@functools.cache
def _plan(size, h, top, bottom, mode):
    """For each rank of a group of ``size`` strips of ``h`` rows: its halo
    rows (positions in the padded strip) as {owner: [(pos, owner's local
    row)]}."""
    hg = size * h
    plans = []
    for r in range(size):
        lo = r * h
        own = {}
        for pos, g in [(i, lo - top + i) for i in range(top)] + \
                      [(top + h + i, lo + h + i) for i in range(bottom)]:
            src = _source(g, hg, mode)
            if src is not None:
                own.setdefault(src // h, []).append((pos, src % h))
        plans.append(own)
    return plans


@functools.cache
def _transfers(size, index, h, top, bottom, mode):
    """Rank ``index``'s part of the exchange: (runs it fills from its own
    rows, {peer: runs it receives}, {peer: runs it sends, positions in the
    peer's padded strip}), and whether any rank moves a row."""
    plans = _plan(size, h, top, bottom, mode)
    mine = plans[index]
    recv = {q: _runs(p) for q, p in sorted(mine.items()) if q != index}
    send = {r: _runs(plans[r][index]) for r in range(size) if r != index and index in plans[r]}
    moves = any(q != r for r, p in enumerate(plans) for q in p)
    return _runs(mine.get(index, [])), recv, send, moves


def _rows_of(x, src, n, step):
    """Rows src, src + step, .. (n of them) of ``x`` along dim 2."""
    if step > 0:
        return x.narrow(2, src, n)
    return x.narrow(2, src - n + 1, n).flip(2)


def _add_rows(x, src, n, step, piece):
    """Add ``piece`` to rows src, src + step, .. of ``x`` in place."""
    if step > 0:
        x.narrow(2, src, n).add_(piece)
    else:
        x.narrow(2, src - n + 1, n).add_(piece.flip(2))


def _like(x, shape):
    """A zero tensor of ``shape`` in ``x``'s dtype, device and memory order."""
    cl = x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last) \
        and not x.is_contiguous()
    return x.new_zeros(shape).contiguous(memory_format=torch.channels_last if cl
                                         else torch.contiguous_format)


def _exchange(rows, sends, recvs):
    """Move the pieces: ``sends`` {peer index: tensor}, ``recvs`` {peer
    index: buffer}."""
    comms.exchange([(rows.ranks[r], t) for r, t in sends.items()],
                   [(rows.ranks[q], b) for q, b in recvs.items()], rows.mesh, rows.group)


class HaloExchange(torch.autograd.Function):
    """A strip with ``top`` rows above and ``bottom`` below from the ranks
    that own them (``mode`` past the image's edges: zero, reflect,
    replicate); the backward adds each halo row's cotangent to its owner's
    row, in a fixed order (no atomic adds)."""

    @staticmethod
    def forward(ctx, x, rows, top, bottom, mode):
        b, c, h, w = x.shape
        own, recv, send, moves = _transfers(rows.size, rows.index, h, top, bottom, mode)
        ctx.rows, ctx.plan, ctx.top, ctx.h, ctx.moves = rows, (own, recv, send), top, h, moves
        out = _like(x, (b, c, top + h + bottom, w))
        out.narrow(2, top, h).copy_(x)
        for pos, src, n, step in own:
            out.narrow(2, pos, n).copy_(_rows_of(x, src, n, step))
        if moves:
            sends = {r: torch.cat([_rows_of(x, s, n, st) for _, s, n, st in runs], 2)
                     for r, runs in send.items()}
            bufs = {q: x.new_empty((b, c, sum(r[2] for r in runs), w)) for q, runs in recv.items()}
            _exchange(rows, sends, bufs)
            for q, runs in recv.items():
                for (pos, _, n, _), piece in zip(runs, bufs[q].split([r[2] for r in runs], 2)):
                    out.narrow(2, pos, n).copy_(piece)
        return out

    @staticmethod
    def backward(ctx, g):
        own, recv, send = ctx.plan
        gx = g.narrow(2, ctx.top, ctx.h).clone()
        for pos, src, n, step in own:
            _add_rows(gx, src, n, step, g.narrow(2, pos, n))
        if ctx.moves:
            b, c, _, w = g.shape
            back = {q: torch.cat([g.narrow(2, pos, n) for pos, _, n, _ in runs], 2)
                    for q, runs in recv.items()}
            bufs = {r: g.new_empty((b, c, sum(x[2] for x in runs), w)) for r, runs in send.items()}
            _exchange(ctx.rows, back, bufs)
            for r, runs in send.items():
                for (_, src, n, step), piece in zip(runs, bufs[r].split([x[2] for x in runs], 2)):
                    _add_rows(gx, src, n, step, piece)
        return gx, None, None, None, None


def halo(x, top, bottom, mode="zero", rows=None):
    """``x`` (NCHW, this rank's strip) with ``top`` rows above it and
    ``bottom`` below; a negative count drops that many of its own rows."""
    rows = rows or active()
    t, b = max(top, 0), max(bottom, 0)
    out = HaloExchange.apply(x, rows, t, b, mode) if t or b else x
    if top < 0 or bottom < 0:
        out = out.narrow(2, -min(top, 0), out.shape[2] + min(top, 0) + min(bottom, 0))
    return out


# -- gathering and taking a level -------------------------------------------

class GatherRows(torch.autograd.Function):
    """The whole image on every rank from the group's strips, in the
    strip's memory format (the convs after it then take one process's
    algorithms: a channels_last and a contiguous input give cuDNN
    different sums, which a gradient that cancels shows); the backward sums
    the ranks' cotangents and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, rows):
        ctx.rows, ctx.h = rows, x.shape[2]
        out = comms.all_gather(x, rows.mesh, group=rows.group, dim=2)
        return _like(x, out.shape).copy_(out)

    @staticmethod
    def backward(ctx, g):
        r = ctx.rows
        g = comms.all_reduce(g.contiguous().clone(), r.mesh, group=r.group)
        return g.narrow(2, r.index * ctx.h, ctx.h), None


class TakeRows(torch.autograd.Function):
    """This rank's strip of a whole (replicated) image; the backward puts
    the strip's cotangent in its place among zeros."""

    @staticmethod
    def forward(ctx, x, rows):
        h = x.shape[2] // rows.size
        ctx.rows, ctx.shape = rows, x.shape
        return x.narrow(2, rows.index * h, h)

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        h = g.shape[2]
        out.narrow(2, ctx.rows.index * h, h).copy_(g)
        return out, None


def gather(x, rows=None):
    return GatherRows.apply(x, rows or _active)


def take(x, rows=None):
    return TakeRows.apply(x, rows or _active)


# -- reductions over the group ----------------------------------------------

def sum_rows(t, rows=None):
    """``t`` (a partial sum over this rank's rows) summed over the group,
    with its gradient; ``t`` itself outside a split context."""
    rows = rows or active()
    if rows is None:
        return t
    return comms.SumOverRanks.apply(t, rows.mesh, rows.group)


class MaxRows(torch.autograd.Function):
    """The (B, C, 1, 1) maximum over H and W of the group's strips; the
    cotangent, summed over the group (every rank's loss reads the
    maximum), goes to the elements equal to it, split evenly among all of
    them on every rank, as ``amax``'s backward splits it in one process."""

    @staticmethod
    def forward(ctx, x, rows):
        m = comms.all_reduce(x.amax(dim=(2, 3), keepdim=True).contiguous(), rows.mesh,
                             group=rows.group, op=torch.distributed.ReduceOp.MAX)
        ctx.save_for_backward(x, m)
        ctx.rows = rows
        return m

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        g = comms.all_reduce(g.contiguous().clone(), ctx.rows.mesh, group=ctx.rows.group)
        mask = (x == m).to(g.dtype)
        count = comms.all_reduce(mask.sum(dim=(2, 3), keepdim=True).contiguous(), ctx.rows.mesh,
                                 group=ctx.rows.group)
        return g * mask / count, None


def max_rows(x, rows=None):
    return MaxRows.apply(x, rows or active())


def mean(t):
    """The mean of ``t``, or on a strip this rank's share of the global
    mean: its mean over the group's size, the strips being equal (a
    replicated tensor's share is its mean over the size too)."""
    rows = active()
    return t.mean() if rows is None else t.mean() / rows.size


def share(v):
    """This rank's share of a value every rank of the group holds whole."""
    rows = active()
    return v if rows is None else v / rows.size


# -- windowed ops on a strip ------------------------------------------------

def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _out_height(hg, k, stride, padding):
    return (hg + 2 * padding - k) // stride + 1


def _conv_splits(x, k, stride, padding, rows):
    """Whether a conv's output on this strip is a strip: its global height
    splits over the group."""
    return _out_height(x.shape[2] * rows.size, k, stride, padding) % rows.size == 0


def conv2d(x, w, b, stride, padding, groups, rows, mode="zero"):
    """``F.conv2d`` on a strip: the rows its output strip reads, fetched
    (``mode`` past the image's top and bottom: zero, reflect, replicate),
    then the conv with no padding along H (W's zero ``padding`` as in one
    process)."""
    (sh, sw), (ph, pw), kh = _pair(stride), _pair(padding), w.shape[2]
    h = x.shape[2]
    ho_g = _out_height(h * rows.size, kh, sh, ph)
    if ho_g % rows.size:
        raise ValueError(f"a k{kh} s{sh} p{ph} conv's output height {ho_g} does not split over "
                         f"{rows.size} ranks: gather its input first")
    ho = ho_g // rows.size
    a, lo = rows.index * ho, rows.index * h
    top = lo - (sh * a - ph)
    bottom = sh * (a + ho - 1) - ph + kh - (lo + h)
    return F.conv2d(halo(x, top, bottom, mode, rows), w, b, stride=(sh, sw), padding=(0, pw),
                    groups=groups)


def conv_transpose2d(x, w, b, stride, padding, output_padding, rows):
    """A transposed conv on a strip (the generator's k3 s2 p1 op1, the
    U-Nets' k4 s2 p1): output rows ``[s a, s (a + h))`` read input rows
    from ``ceil((s a + p - k + 1) / s)`` to ``floor((s (a + h) - 1 + p) /
    s)``, fetched (zeros past the image), the conv run with no padding
    along H, and this rank's rows kept."""
    (sh, sw), (ph, pw), (oh, ow), kh = (_pair(stride), _pair(padding), _pair(output_padding),
                                        w.shape[2])
    h = x.shape[2]
    ho_g = (h * rows.size - 1) * sh - 2 * ph + kh + oh
    if ho_g != sh * h * rows.size:
        raise ValueError(f"a k{kh} s{sh} p{ph} op{oh} transposed conv's output height {ho_g} is "
                         f"not {sh} times its input's: gather its input first")
    ho = sh * h
    a, lo = rows.index * ho, rows.index * h
    first = -((ph - kh + 1 + a) // -sh)  # ceil((a + p - k + 1) / s)
    last = (a + ho - 1 + ph) // sh
    y = F.conv_transpose2d(halo(x, lo - first, last - (lo + h - 1), rows=rows), w, b,
                           stride=(sh, sw), padding=(0, pw), output_padding=(0, ow))
    return y.narrow(2, a + ph - sh * first, ho)


def max_pool2d(x, window, stride, padding, rows):
    """A max pool of whole windows on a strip whose rows tile them."""
    if stride != window or padding or x.shape[2] % window:
        raise ValueError(f"a {window}x{window} pool on a strip of {x.shape[2]} rows does not "
                         "tile: gather the level first")
    return F.max_pool2d(x, window, window, 0)


def avg_pool2d(x, window, stride, padding, count_include_pad, rows):
    """``F.avg_pool2d`` on a strip: whole windows as they are; otherwise
    the rows its output strip reads, fetched from within the image, and the
    pool run with the image's own padding rows where the strip reaches its
    top or bottom, so that ``count_include_pad=False`` divides each window
    by the positions it covers in the image (3 rows at a strip's edge, 2 at
    the image's top for a 3x3 window of padding 1), never by the strip's."""
    if stride == window and not padding and x.shape[2] % window == 0:
        return F.avg_pool2d(x, window, window, 0)
    h = x.shape[2]
    hg = h * rows.size
    ho_g = _out_height(hg, window, stride, padding)
    if ho_g % rows.size:
        raise ValueError(f"a {window}x{window} average pool's output height {ho_g} does not "
                         f"split over {rows.size} ranks: gather its input first")
    ho = ho_g // rows.size
    # the input rows its output strip reads, the same count on every rank
    first = stride * rows.index * ho - padding
    last = stride * (rows.index * ho + ho - 1) - padding + window - 1
    lo = rows.index * h
    top, bottom = lo - first, last - (lo + h - 1)
    pad_top, pad_bottom = max(-first, 0), max(last - (hg - 1), 0)  # past the image
    if pad_bottom > pad_top:
        raise ValueError("an average pool padded below its strip alone is not supported")
    from dsgan_tpu_torch.ops.conv import pool_avg

    xh = halo(x, top, bottom, rows=rows)  # zeros past the image: dropped, the pool pads there
    xh = xh.narrow(2, pad_top, xh.shape[2] - pad_top - pad_bottom)
    return pool_avg(xh, window, stride, (pad_top, padding), count_include_pad).narrow(2, 0, ho)


def upsample_bilinear2x(x, rows):
    """Bilinear upsampling to twice the height and width on a strip
    (``align_corners=False``): output rows ``[2 a, 2 (a + h))`` read input
    rows a - 1 to a + h, the image's edge rows replicated as the one
    process clamps them. At the image's top the replicated row above is
    dropped, so that the first rows take the one process's weights."""
    h, w = x.shape[2], x.shape[3]
    top = 0 if rows.index == 0 else 1
    xh = halo(x, 1, 1, "replicate", rows).narrow(2, 1 - top, h + top + 1)
    y = F.interpolate(xh, size=(2 * (h + top + 1), 2 * w), mode="bilinear", align_corners=False)
    return y.narrow(2, 2 * top, 2 * h)


def valid_rows(x, k):
    """For a VALID window of ``k`` rows on a strip: the strip with the k - 1
    rows below it (zeros past the image), and how many of the window's
    output rows this rank owns (those whose first input row is its)."""
    rows = active()
    h, hg = x.shape[2], x.shape[2] * rows.size
    if hg < k:  # no window along H (the filters skip it)
        return x, h
    keep = min(max(hg - (k - 1) - rows.index * h, 0), h)
    return halo(x, 0, k - 1), keep


def sequential(layers, x):
    """``layers`` (a Sequential's modules) on a strip: a pad (a layer with
    ``pad_w``, ``layers.Pad``) pads W and hands its rows and mode to the
    stride-1 conv after it, which fetches them (``conv2d``); a conv whose
    output height does not split over the group runs on the gathered
    image, the layers after it stay replicated until a transposed conv
    gives a height that splits again, whose rows each rank takes back."""
    rows = active()
    if rows is None:
        for layer in layers:
            x = layer(x)
        return x
    rep, pad = False, None
    for layer in layers:
        if not rep and hasattr(layer, "pad_w"):
            pad = layer
            continue
        if pad is not None:
            if not isinstance(layer, nn.Conv2d) or layer.padding[0] or layer.stride[0] != 1:
                raise ValueError(f"a pad on a strip must feed a stride-1 conv without padding, "
                                 f"not {layer}")
            x, pad = layer(pad.pad_w(x), pad=(pad.p, pad.mode)), None
            continue
        if (not rep and isinstance(layer, nn.Conv2d)
                and not _conv_splits(x, layer.kernel_size[0], layer.stride[0],
                                     layer.padding[0], rows)):
            x, rep = gather(x, rows), True
        if not rep:
            x = layer(x)
            continue
        with replicated():
            x = layer(x)
        if isinstance(layer, nn.ConvTranspose2d) and x.shape[2] % rows.size == 0:
            x, rep = take(x, rows), False
    return x


class Levels:
    """A pyramid of levels (level k at 1 / 2^k of the input's height) on a
    strip: ``rep[k]`` where level k's height does not split over the group.
    Outside a split context every level is the one process's."""

    def __init__(self, h, depth):
        self.rows = active()
        hg = h * (self.rows.size if self.rows else 1)
        self.rep = [bool(self.rows) and (hg >> k) % self.rows.size != 0 for k in range(depth)]

    def at(self, k):
        """The ops' context at level k."""
        return replicated(self.rep[k]) if self.rows else contextlib.nullcontext()

    def pool(self, t, k, fn=None):
        """``t`` at level k pooled by 2 into level k + 1 (``fn``, default
        ``ops.max_pool2d(t, 2)``), gathered first where level k splits and
        k + 1 does not."""
        from dsgan_tpu_torch.ops.conv import max_pool2d

        if self.rows and self.rep[k + 1] and not self.rep[k]:
            t = gather(t, self.rows)
        with self.at(k + 1):
            return (fn or (lambda v: max_pool2d(v, 2)))(t)

    def up(self, fn, t, k):
        """``fn`` (an upsample into level k - 1) on ``t`` at level k; where
        level k is replicated and k - 1 splits, computed whole and this
        rank's rows taken."""
        with self.at(k):
            out = fn(t)
        if self.rows and self.rep[k] and not self.rep[k - 1]:
            out = take(out, self.rows)
        return out

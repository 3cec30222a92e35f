"""The mesh's collectives and their accounting (port of
``dsgan_tpu/parallel/comms.py``).

JAX tallies the collectives that XLA's partitioner inserted by parsing
the partitioned HLO of a step. The port has no HLO: each collective is an
explicit call through the wrappers here, and each wrapper adds its
payload to the tally of the mesh it runs on (``Mesh.stats``), in the
shape of JAX's ``collective_stats``: ``{kind: {"count": n, "bytes": b}}``,
the kinds named as the HLO names them. ``bytes`` is the payload on this
rank: the reduced tensor of an all-reduce, the gathered result of an
all-gather, the tensor of a broadcast, as JAX counts each op's result
shape. A replayed CUDA graph runs its collectives without Python, so the
tally counts eager and captured steps only, as the kernels' launch
counts do. The host group's control operations (``any_rank``,
``barrier``) move no data of the step and are left out of the tally, as
JAX's HLO count holds only the step's collectives.

Each wrapper runs on the mesh's group of all its ranks unless given
another (``group``): the spatial axis's row group
(``Mesh.row_group``) or the data axis's (``Mesh.data_group``). The
neighbour exchange of image rows (``exchange``, the spatial axis's
halos) is point-to-point and tallied under the name of the HLO op GSPMD
emits for it, ``collective-permute``.

A gloo group moves host tensors only; given device tensors (two ranks
sharing one card, which NCCL refuses) the wrappers copy them through the
host. NCCL collectives run on the device's stream and are captured into
a CUDA graph with the step.
"""

import torch
import torch.distributed as dist


def _tally(mesh, kind, nbytes):
    entry = mesh.stats.setdefault(kind, {"count": 0, "bytes": 0})
    entry["count"] += 1
    entry["bytes"] += int(nbytes)


def _bytes(t):
    return t.numel() * t.element_size()


def collective_stats(mesh):
    """This rank's tally since the last ``reset``: {kind: {count, bytes}}."""
    return {k: dict(v) for k, v in mesh.stats.items()}


def reset(mesh):
    mesh.stats.clear()


def _host(mesh, t, group=None):
    """``t`` where the group can move it: a host copy under gloo."""
    gloo = mesh.gloo if group is None else dist.get_backend(group) == "gloo"
    return t.cpu() if gloo and t.is_cuda else t


def all_reduce(t, mesh, average=False, group=None, op=None):
    """Sum ``t`` (or reduce it by ``op``) over the mesh's ranks, or over
    ``group``, in place (then divide by the data axis's size with
    ``average``); returns ``t``."""
    _tally(mesh, "all-reduce", _bytes(t))
    h = _host(mesh, t, group)
    dist.all_reduce(h, op=op or dist.ReduceOp.SUM, group=mesh.group if group is None else group)
    if h is not t:
        t.copy_(h)
    if average:
        t.div_(mesh.data)
    return t


def all_gather(t, mesh, group=None, dim=0):
    """The ranks' ``t`` joined along ``dim`` in rank order, over ``group``
    (None: the data axis's group, which gives (data * n, ...))."""
    if group is None:
        group = mesh.data_group
    h = _host(mesh, t.contiguous(), group)
    parts = [torch.empty_like(h) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, h, group=group)
    out = torch.cat(parts, dim).to(t.device)
    _tally(mesh, "all-gather", _bytes(out))
    return out


def exchange(sends, recvs, mesh, group):
    """Point-to-point transfers within ``group``: each ``(peer, tensor)`` of
    ``sends`` sent, each ``(peer, buffer)`` of ``recvs`` received into its
    contiguous buffer (peers are global ranks). Under NCCL one
    ``batch_isend_irecv`` on the current stream, whose waits hold the
    stream and not the host. Tallied as one ``collective-permute`` of the
    bytes this rank receives."""
    _tally(mesh, "collective-permute", sum(_bytes(b) for _, b in recvs))
    if not sends and not recvs:
        return
    gloo = dist.get_backend(group) == "gloo"
    staged = [(p, b.new_empty(b.shape, device="cpu") if gloo and b.is_cuda else b)
              for p, b in recvs]
    ops = [dist.P2POp(dist.isend, _host(mesh, t.contiguous(), group), p, group)
           for p, t in sends]
    ops += [dist.P2POp(dist.irecv, b, p, group) for p, b in staged]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for (_, b), (_, h) in zip(recvs, staged):
        if h is not b:
            b.copy_(h)


def broadcast(t, mesh, src=0):
    """``t`` from rank ``src`` of the data axis, in place; returns ``t``."""
    _tally(mesh, "collective-broadcast", _bytes(t))
    h = _host(mesh, t)
    dist.broadcast(h, src=src, group=mesh.group)
    if h is not t:
        t.copy_(h)
    return t


def any_rank(flag, mesh):
    """Whether ``flag`` is true on any rank (a MAX all-reduce on the host
    group: it does not wait for the device, and is not tallied);
    ``flag`` itself without a mesh."""
    if mesh is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return bool(t.item())


def barrier(mesh):
    """Every rank of the mesh reaches this point (on the host group)."""
    dist.barrier(group=mesh.host_group)


class SumOverRanks(torch.autograd.Function):
    """``sum over ranks of x`` with its gradient: the backward sums the
    cotangent over the ranks too, since every rank's loss reads the sum.
    Over the mesh's ranks, or over ``group`` (the spatial axis's row
    group)."""

    @staticmethod
    def forward(ctx, x, mesh, group=None):
        ctx.mesh, ctx.group = mesh, group
        return all_reduce(x.clone(), mesh, group=group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.mesh, group=ctx.group), None, None


def predict_step_comms_seconds(stats, mesh_shape, bytes_per_s):
    """Lower-bound wire time of a step from its tally (JAX's ring model,
    ``dsgan_tpu/parallel/comms.py:111-133``): a ring all-reduce moves
    2 (n - 1) / n of its payload per rank, an all-gather or reduce-scatter
    (n - 1) / n, anything else its payload. ``bytes_per_s`` is the link's
    one-way rate, which the caller states with its source; it has no
    default."""
    if not bytes_per_s or bytes_per_s <= 0:
        raise ValueError("bytes_per_s: give the link's measured or published rate")
    data, spatial = mesh_shape
    n = max(data, spatial)
    t = 0.0
    for op, s in stats.items():
        b = s["bytes"]
        if op == "all-reduce":
            t += 2 * (n - 1) / n * b / bytes_per_s
        elif op in ("all-gather", "reduce-scatter"):
            t += (n - 1) / n * b / bytes_per_s
        else:
            t += b / bytes_per_s
    return t

"""The data axis: rank-parallel train steps over ``torch.distributed``
(port of ``dsgan_tpu/parallel/mesh.py``).

JAX builds a (data, spatial) mesh of devices, replicates the state,
shards the batch and lets XLA insert the gradient all-reduces. The port
runs one process per card, so a mesh "device" is a rank: ``resolve_mesh``
counts ranks where JAX counts ``jax.devices()``. Every rank holds the
whole state (broadcast from rank 0 once, ``replicate``), loads the same
global batch from the same ``--seed`` and keeps its rows of it
(``shard_batch``), and runs the step on them. Where the step's math spans
the batch, the step calls the functions here so that each rank's result
is the one process's on the global batch:

  * the gradients: one all-reduce of each optimizer's gradients,
    flattened into one buffer in parameter order, between ``backward``
    and ``step`` (``reduce_gradients``); an average, since every loss is
    a mean over the rows;
  * the TV loss is a sum, not a mean: the step scales its rank's term by
    the data size (``data_size``), so that the average is the sum;
  * the metrics are averaged in one all-reduce, PSNR from the averaged
    uint8 MSE (``reduce_metrics``);
  * the replay pool is replicated state queried on the global batch: the
    rows are gathered, the pool queried with its generator (seeded alike
    on every rank) and each rank keeps its rows (``query_pool``);
  * BatchNorm takes its statistics over the global batch
    (``models/layers.py::BatchNorm2d`` with ``set_batchnorm_mesh``).

The networks are not wrapped in ``DistributedDataParallel``: the pix2pix
and CycleGAN steps take G's gradient through ``fake.backward(dfake)`` and
``backward(inputs=)``, which DDP's reducer does not follow, and a step
captured in a CUDA graph holds an explicit NCCL call on its stream.

The spatial axis: rank ``d * spatial + s`` (JAX's ``get_mesh`` order)
holds rows ``[s * H / S, (s + 1) * H / S)`` of every image of data row
``d`` (``shard_batch``); the ranks of one data row form its row group,
those of one ``s`` its data group. The step runs under
``parallel.spatial.rows(mesh)``, where the windowed ops exchange halo
rows within the row group and the reductions over H and W sum over it.
Every loss term and metric a rank reports is then its share, the shares
of a row group summing to its data row's value, so that one all-reduce
over all the ranks divided by ``data`` gives the global batch's value,
and the same all-reduce of the gradients sums a row group's partial
weight gradients and averages the data rows' (``reduce_gradients``,
``reduce_metrics``). BatchNorm sums its statistics over every rank on a
strip, and over the data group alone in a level that every rank of a row
group holds whole (``layers.BatchNorm2d``). A pool draws per image, its
draws equal on every rank, so each rank swaps its strip of the same
images. The spatial axis runs every model (pix2pix, CycleGAN, diffusion
and the eval build), every generator and discriminator of the registry
and every ``--norm``.
"""

import dataclasses

import torch
import torch.distributed as dist

from dsgan_tpu_torch.ops.metrics import psnr_from_mse
from dsgan_tpu_torch.parallel import comms, multihost

@dataclasses.dataclass
class Mesh:
    """A (data, spatial) mesh of ranks as this rank sees it: ``rank`` is its
    coordinate on the data axis and ``row`` on the spatial axis, ``group``
    the group of all the mesh's ranks (None: the default group),
    ``data_group`` / ``row_group`` this rank's groups along each axis
    (a mesh without a spatial axis has neither: its data axis is
    ``group``),
    ``row_ranks`` the global ranks of its row group in row order,
    ``host_group`` the gloo group of flags and barriers, ``stats`` the
    collectives' tally (``comms``)."""
    data: int
    spatial: int = 1
    rank: int = 0
    group: object = None
    host_group: object = None
    stats: dict = dataclasses.field(default_factory=dict)
    row: int = 0
    data_group: object = None
    row_group: object = None
    row_ranks: tuple = (0,)

    @property
    def gloo(self):
        """Whether the mesh's group is gloo (which moves host tensors)."""
        return dist.get_backend(self.group) == "gloo"

    @property
    def shape(self):
        return (self.data, self.spatial)

    def rows(self, n):
        """This rank's rows of a global batch of ``n``."""
        per = n // self.data
        return slice(self.rank * per, (self.rank + 1) * per)

    def strip(self, h):
        """This rank's image rows of a global height ``h``."""
        per = h // self.spatial
        return slice(self.row * per, (self.row + 1) * per)


def mesh_shape(data_axis=0, spatial_axis=1, batch_size=None, height=None, ranks=1):
    """(data, spatial) of the --data_axis / --spatial_axis flags over
    ``ranks`` ranks, under JAX's rules and with its messages
    (``dsgan_tpu/parallel/mesh.py:25-69``): ``data_axis`` 0 is all ranks
    over ``spatial_axis``, reduced until it divides ``batch_size``; an
    explicit axis that does not divide is an error, as is a mesh larger
    than the ranks."""
    n = ranks
    spatial = max(int(spatial_axis or 1), 1)
    if spatial > n:
        raise ValueError(f"--spatial_axis {spatial} exceeds the {n} visible devices")
    if height is not None and spatial > 1 and height % spatial != 0:
        raise ValueError(f"--spatial_axis {spatial} must divide the image height {height}")
    data = int(data_axis or 0)
    if data <= 0:
        data = max(n // spatial, 1)
        if batch_size is not None:
            while data > 1 and batch_size % data != 0:
                data -= 1
    elif batch_size is not None and batch_size % data != 0:
        raise ValueError(f"--batchSize {batch_size} must be divisible by --data_axis {data}")
    if data * spatial > n:
        raise ValueError(f"mesh {data}x{spatial} needs more than the {n} visible devices")
    return data, spatial


def resolve_mesh(data_axis=0, spatial_axis=1, batch_size=None, height=None):
    """The flags' mesh over this process's group, or None for 1x1 (the
    plain single-process step). Every rank of the group must be a device
    of the mesh: the port does not leave a started process idle."""
    n = multihost.process_count()
    data, spatial = mesh_shape(data_axis, spatial_axis, batch_size, height, n)
    if data * spatial == 1:
        return None
    if data * spatial != n:
        raise ValueError(f"mesh {data}x{spatial} uses {data * spatial} of the {n} ranks: start "
                         f"{data * spatial} processes, or give a --batchSize that {n} divides")
    rank = dist.get_rank()
    if spatial == 1:
        return Mesh(data, spatial, rank, None, multihost.host_group())
    return _spatial_mesh(data, spatial, rank)


def _spatial_mesh(data, spatial, rank):
    """The (data, spatial) mesh with its row and data groups, every group
    built on every rank (``dist.new_group`` asks it) and warmed by one
    all-reduce, so that its first exchange is no rank's first call."""
    d, s = divmod(rank, spatial)
    rows = [tuple(range(i * spatial, (i + 1) * spatial)) for i in range(data)]
    cols = [tuple(range(j, data * spatial, spatial)) for j in range(spatial)]
    row_groups = [dist.new_group(list(r)) for r in rows]
    data_groups = [dist.new_group(list(c)) for c in cols]
    mesh = Mesh(data, spatial, d, None, multihost.host_group(), row=s,
                data_group=data_groups[s], row_group=row_groups[d], row_ranks=rows[d])
    dev = torch.device("cuda", torch.cuda.current_device()) if not mesh.gloo else "cpu"
    for g in (mesh.row_group, mesh.data_group):
        dist.all_reduce(torch.zeros(1, device=dev), group=g)
    return mesh


def data_size(mesh):
    """Ranks on the data axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.data


def _check_rows(n, h, mesh, what):
    if n % mesh.data != 0 or h % mesh.spatial != 0:
        raise ValueError(
            f"{what} does not tile onto the {mesh.data}x{mesh.spatial} (data x spatial) mesh: "
            f"N must divide by {mesh.data}" + (f" and H by {mesh.spatial}" if mesh.spatial > 1
                                                else "")
            + ". The train loader guarantees full batches "
            "(drop_last); direct model-API drives must feed batches of exactly --batchSize, "
            "or build the model with matching axes.")


def shard_batch(batch, mesh):
    """This rank's rows of an NHWC global batch (numpy or torch), and its
    strip of their image rows on a spatial axis."""
    _check_rows(batch.shape[0], batch.shape[1], mesh, f"batch {tuple(batch.shape)}")
    out = batch[mesh.rows(batch.shape[0])]
    return out if mesh.spatial == 1 else out[:, mesh.strip(batch.shape[1])]


def shard_chunk(chunk, mesh):
    """This rank's rows (and strip) of a k-stacked (k, N, H, W, C) chunk."""
    _check_rows(chunk.shape[1], chunk.shape[2], mesh, f"chunk {tuple(chunk.shape)}")
    out = chunk[:, mesh.rows(chunk.shape[1])]
    return out if mesh.spatial == 1 else out[:, :, mesh.strip(chunk.shape[2])]


def gather_image_rows(t, mesh, dim=2):
    """The row group's strips of ``t`` joined along ``dim`` (the image rows:
    2 in NCHW, 1 in NHWC); ``t`` itself without a spatial axis. Numpy in,
    numpy out."""
    if mesh is None or mesh.spatial == 1:
        return t
    host = not isinstance(t, torch.Tensor)
    x = torch.from_numpy(t) if host else t
    out = comms.all_gather(x, mesh, group=mesh.row_group, dim=dim)
    return out.numpy() if host else out


def gather_batch(y, mesh):
    """A whole NHWC batch from this rank's part of it: the strips over the
    row group, then the rows over the data axis."""
    y = gather_image_rows(y, mesh, dim=1)
    return comms.all_gather(y, mesh) if mesh.data > 1 else y


def replicate(modules, mesh):
    """Every parameter and buffer of ``modules`` broadcast from rank 0 (the
    ranks build them from one seed; this makes them equal whatever the
    build did)."""
    with torch.no_grad():
        for m in modules:
            for t in [*m.parameters(), *m.buffers()]:
                comms.broadcast(t.data, mesh)


def reduce_gradients(opt, mesh):
    """The gradients of ``opt``'s parameters summed over the mesh's ranks
    and divided by the data axis's size: one all-reduce of one flat f32
    buffer, in parameter order. A row group's gradients are partial sums
    of its data row's (each rank's loss is its share), so this sums them
    and averages the data rows. A no-op without a mesh."""
    if mesh is None:
        return
    grads = [p.grad for g in opt.param_groups for p in g["params"] if p.grad is not None]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    comms.all_reduce(flat, mesh, average=True)
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def reduce_metrics(metrics, mesh, mse=None):
    """A step's 0-d metrics as one process on the global batch reports
    them, f32 and detached: each summed over the mesh's ranks and divided
    by the data axis's size (one all-reduce of their vector; a rank's
    values are its shares on a spatial axis), and with ``mse`` (the uint8
    MSE) a ``psnr`` from the reduced MSE (the mean of the ranks' PSNRs is
    not the PSNR of the batch)."""
    metrics = {k: v.detach().float() for k, v in metrics.items()}
    extra = [] if mse is None else [mse.detach().float().reshape(())]
    if mesh is not None:
        keys = list(metrics)
        vec = torch.stack([metrics[k].reshape(()) for k in keys] + extra)
        comms.all_reduce(vec, mesh, average=True)
        metrics = dict(zip(keys, vec[:len(keys)].unbind()))
        extra = vec[len(keys):].unbind()
    if extra:
        metrics["psnr"] = psnr_from_mse(extra[0])
    return metrics


def query_pool(pool, batch, mesh):
    """``pool.query(batch)`` as one process queries it on the global batch:
    the ranks' rows gathered over the data axis, the replicated pool
    queried with its own draws (equal on every rank), this rank's rows
    kept, in ``batch``'s memory format. On a spatial axis the pool holds
    this rank's strip of each image: its draws are per image, so the
    strips of an image stay together."""
    if mesh is None or pool.pool_size <= 0 or mesh.data == 1:
        return pool.query(batch)
    out = pool.query(comms.all_gather(batch, mesh))[mesh.rows(batch.shape[0] * mesh.data)]
    cl = batch.dim() == 4 and batch.is_contiguous(memory_format=torch.channels_last)
    return out.contiguous(memory_format=torch.channels_last if cl else torch.contiguous_format)

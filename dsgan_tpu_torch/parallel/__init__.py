"""Rank-parallel training (port of ``dsgan_tpu/parallel``): the (data,
spatial) mesh over ``torch.distributed`` (``mesh``), the spatial axis's
ops on strips of image rows (``spatial``), joining the processes of a run
(``multihost``), and the collectives' accounting (``comms``). The JAX
package's sharded-jit factories (``make_parallel_step`` and the chained
and inference forms, ``batch_sharding``, ``chunk_sharding``) have no
counterpart: each rank runs the plain step on its rows and its strip of
them, and the step and the ops call the mesh's collectives themselves.

The names load on first use, so that the ops and kernels, which import
``spatial`` (and through it ``comms``), do not import ``mesh``, which
imports the ops."""

import importlib

_MESH = ("Mesh", "data_size", "gather_batch", "gather_image_rows",
         "mesh_shape", "query_pool", "reduce_gradients", "reduce_metrics", "replicate",
         "resolve_mesh", "shard_batch", "shard_chunk")
_MODULES = ("comms", "mesh", "multihost", "spatial")

__all__ = sorted(_MESH + _MODULES)


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _MESH:
        return getattr(importlib.import_module(f"{__name__}.mesh"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

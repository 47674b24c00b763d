"""Device mesh and sharding policy: data parallelism over the batch, the
vocabulary-sized tables split over the model axis (port of
``icek_tpu/parallel/mesh.py``).

One process per card: the mesh is a ``torch.distributed`` ``DeviceMesh``
with dims ("data", "model") over the world, rank ``d * model + m`` at
coordinate (d, m).  A batch shards over "data" (ranks of one data index
hold the same rows); the word and predicate embeddings, the vocab head and
the predicate projection shard over "model", every other leaf replicates.
Where XLA inserts the collectives for a JAX mesh, the port calls them
itself: ``train/step.py`` all-gathers the sharded tables for its forward
and all-reduces the gradients, ``sharded_row_gather`` reads a row-sharded
token cache, ``gather_for_host`` reassembles the tables for a checkpoint.

A spec is a plain tuple with one entry per dim, the mesh axis that dim
splits over or None (``("model", None)``; ``()`` replicates), comparable
with JAX's ``PartitionSpec``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from icek_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(data: Optional[int] = None, model: int = 1, device=None):
    """A (data, model) ``DeviceMesh`` over the world; `data` defaults to the
    world size over `model`.  The world must be ``data * model`` processes.
    Without a process group, one of a single rank is started on `device`
    (default "cuda": NCCL; "cpu": gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        distributed.ensure_initialized(device or "cuda")
    kind = distributed.device_type()
    if device is not None and torch.device(device).type != kind:
        raise ValueError(f"make_mesh: device {device!r} does not match the process "
                         f"group's backend ({dist.get_backend()})")
    world = dist.get_world_size()
    if data is None:
        data = world // model
    if data * model != world or data < 1 or model < 1:
        raise ValueError(f"make_mesh: a ({data}, {model}) mesh needs {data * model} "
                         f"processes, the world has {world}")
    return init_device_mesh(kind, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on `axis`."""
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def is_mesh(obj) -> bool:
    return getattr(obj, "mesh_dim_names", None) == (DATA_AXIS, MODEL_AXIS)


# --------------------------------------------------------------------------
# sharding policy
# --------------------------------------------------------------------------

def _spec_for_path(path) -> tuple:
    """Sharding rule for one captioner param leaf, keyed by its tree path.

    The vocabulary-sized tables shard over the model axis; all transformer
    weights replicate (at d_model=300 splitting them would leave each card
    slivers of work narrower than a tensor-core tile)."""
    top = path[0] if path else None
    leaf = path[-1] if path else None
    if top in ("word_embedding", "predicate_embedding"):
        return (MODEL_AXIS, None)
    if top == "fc_vocab":
        return (None, MODEL_AXIS) if leaf == "w" else (MODEL_AXIS,)
    if top == "fc_predicate":
        return (MODEL_AXIS, None) if leaf == "w" else ()
    return ()


def _fits(spec: tuple, shape, mesh) -> bool:
    """True when every sharded dim divides evenly by its mesh axis size."""
    for dim, axis in enumerate(spec):
        if axis is not None and shape[dim] % axis_size(mesh, axis):
            return False
    return True


def _map(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(tree, path)


def map_specs(tree, other, fn):
    """fn(leaf, the matching leaf of `other`) over a tree and a tree of the
    same structure (its specs, say)."""
    if isinstance(tree, dict):
        return {k: map_specs(v, other[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_specs(v, o, fn) for v, o in zip(tree, other)]
    return fn(tree, other)


def param_specs(params, mesh=None) -> dict:
    """Spec tree (same structure as the FULL params).  With a mesh, specs
    whose sharded dims do not divide by the axis size (tiny test
    vocabularies) fall back to replication."""
    def spec(x, path):
        s = _spec_for_path(path)
        if mesh is not None and not _fits(s, tuple(np.shape(x)), mesh):
            return ()
        return s

    return _map(params, spec)


def sharded_dim(spec: tuple) -> Optional[int]:
    """The dim a spec splits over the model axis, or None."""
    for dim, axis in enumerate(spec):
        if axis == MODEL_AXIS:
            return dim
    return None


def shard_params(params, mesh):
    """(this rank's params, their specs): each sharded leaf's block of its
    model-axis index (a contiguous range, as JAX's ``NamedSharding`` lays it
    out), every leaf on the rank's device."""
    specs = param_specs(params, mesh)
    m, M = axis_index(mesh, MODEL_AXIS), axis_size(mesh, MODEL_AXIS)
    device = mesh_device(mesh)

    def local(x, spec):
        x = torch.as_tensor(x)
        dim = sharded_dim(spec)
        if dim is not None:
            n = x.shape[dim] // M
            x = x.narrow(dim, m * n, n)
        return x.detach().to(device).contiguous().clone()

    return map_specs(params, specs, local), specs


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """`t` of every rank of `group` (default: the world) concatenated along
    `dim` in rank order.  A collective."""
    size = dist.get_world_size(group)
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_table(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """A sharded leaf all-gathered over the model axis to its full shape
    (the leaf itself when its spec replicates it).  A collective."""
    dim = sharded_dim(spec)
    if dim is None:
        return t
    return all_gather(t.detach(), axis_group(mesh, MODEL_AXIS), dim)


def gather_for_host(tree, mesh, specs):
    """The tree with every leaf full-size on every rank: the sharded leaves
    all-gathered over the model axis, the others as they are.  `specs` is
    the spec tree ``shard_params`` returned (it also fits a tree of the same
    structure such as Adam's moments).  A collective: EVERY rank must call
    it, even if only the primary writes the result."""
    return map_specs(tree, specs, lambda t, spec: gather_table(t, spec, mesh))


def local_slice(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of a full-size leaf under `spec`."""
    dim = sharded_dim(spec)
    if dim is None:
        return full
    M = axis_size(mesh, MODEL_AXIS)
    n = full.shape[dim] // M
    return full.narrow(dim, axis_index(mesh, MODEL_AXIS) * n, n)


# --------------------------------------------------------------------------
# batches
# --------------------------------------------------------------------------

def data_rows(mesh, batch_size: int) -> tuple:
    """(first row, row count) of this rank's slice of a global batch of
    `batch_size` rows: data index d holds rows [d * b, (d + 1) * b)."""
    S = axis_size(mesh, DATA_AXIS)
    if batch_size % S:
        raise ValueError(f"global batch size {batch_size} is not divisible by the "
                         f"data axis ({S})")
    b = batch_size // S
    return axis_index(mesh, DATA_AXIS) * b, b


def shard_batch(batch, mesh):
    """This rank's rows of a global batch (numpy arrays or tensors), on the
    rank's device: the single-process path, every rank holding the whole
    batch."""
    B = next(iter(batch.values())).shape[0]
    r0, b = data_rows(mesh, B)
    device = mesh_device(mesh)
    return {k: torch.as_tensor(np.asarray(v[r0:r0 + b]) if not torch.is_tensor(v)
                               else v[r0:r0 + b]).to(device)
            for k, v in batch.items()}


# --------------------------------------------------------------------------
# row-sharded token cache
# --------------------------------------------------------------------------

def shard_rows(source, mesh, dtype=None):
    """This rank's block of a row-sharded token cache: rows
    [d * R, (d + 1) * R) of `source` (numpy array or h5py dataset) with
    ``R = ceil(n / S)`` rows per data shard, read as ONE contiguous range,
    the tail past ``n`` zero-padded (those rows are never referenced), put
    on the rank's device in `dtype` (a torch dtype; default: the source's).
    Host peak memory is one block, never the whole source."""
    S = axis_size(mesh, DATA_AXIS)
    n = len(source)
    R = -(-n // S)
    lo = axis_index(mesh, DATA_AXIS) * R
    take = max(0, min(lo + R, n) - lo)
    block = np.zeros((R,) + tuple(source.shape[1:]), dtype=source.dtype)
    if take:
        block[:take] = source[lo:lo + take]
    t = torch.from_numpy(block).to(mesh_device(mesh))
    return t if dtype is None else t.to(dtype)


def check_gather_rows(n_rows: int, mesh) -> None:
    """The row count of a (micro)batch that gathers from a row-sharded cache
    must divide by the data axis."""
    S = axis_size(mesh, DATA_AXIS)
    if n_rows % S:
        raise ValueError(
            f"sharded token-cache gather needs the batch (or microbatch) "
            f"row count {n_rows} divisible by the data axis ({S}); "
            f"pick batch_size / grad_accum_steps accordingly"
        )


def sharded_row_gather(cache_block: torch.Tensor, rows: torch.Tensor, mesh):
    """``cache[rows]`` where the cache is row-sharded over the data axis
    (this rank holds `cache_block`, ``shard_rows``) and `rows` are this
    rank's (B_local,) GLOBAL row ids, which may reference ANY shard (the
    loaders shuffle globally).

    The exchange never moves the cache: all-gather the small id vector over
    the data axis, pick the owned rows locally under an ownership mask, and
    reduce-scatter (sum) the contributions back to the ranks that asked.
    Every output row gets exactly one non-zero contribution (ownership is a
    partition), so the result equals a host gather bit for bit.  A
    collective over the data axis."""
    R = cache_block.shape[0]
    group = axis_group(mesh, DATA_AXIS)
    rows = rows.to(device=cache_block.device, dtype=torch.int64)
    all_rows = all_gather(rows, group, 0)
    local_idx = all_rows - axis_index(mesh, DATA_AXIS) * R
    own = (local_idx >= 0) & (local_idx < R)
    picked = cache_block.index_select(0, local_idx.clamp(0, R - 1))
    mask = own.reshape(own.shape + (1,) * (picked.dim() - 1))
    contrib = torch.where(mask, picked, torch.zeros((), dtype=picked.dtype,
                                                    device=picked.device))
    out = torch.empty((rows.shape[0],) + tuple(picked.shape[1:]), dtype=picked.dtype,
                      device=picked.device)
    dist.reduce_scatter_tensor(out, contrib.contiguous(), op=dist.ReduceOp.SUM,
                               group=group)
    return out

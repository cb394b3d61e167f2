"""The data mesh over torch.distributed (sunerf_tpu/parallel/mesh.py).

The workload is embarrassingly parallel over rays, so the parallel design is
a 1-D data mesh: each rank takes its contiguous rows of the global ray batch,
the parameters are replicated, and the gradients are averaged by one
all-reduce a step. Where JAX's mesh is one process over many devices, here
each rank is a process (launched by torchrun, or given an init method) and a
Mesh is that rank's view: the process group, its rank, the world size and
its device.

By default rank r runs on cuda:LOCAL_RANK over NCCL. `devices` places the
ranks explicitly, as JAX's `devices` argument does: [cuda:0, cuda:0] puts two
ranks on one card and [cpu, cpu] on the CPU; both use gloo, which NCCL's one
rank a device forbids and which takes CUDA tensors in all-reduce, broadcast
and all-gather (staged through the host). The backend follows from the
devices.

A run's data is built once, by rank 0 (build_on_rank0); each rank reads its
own rows of every global batch from the shared shards (ShardedRows). Renders
are tiled over the ranks chunk by chunk and gathered once (render_tiled).
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = 'data'


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the 1-D data mesh (the DATA_AXIS of JAX's mesh)
    over the default process group; host_group is a gloo group for
    host-side flags (None where the default group is gloo, or has one
    rank)."""
    rank: int
    size: int
    device: torch.device
    backend: str
    host_group: Optional[object] = None


def mesh_device(mesh: Mesh, device) -> torch.device:
    """The device of an entry point given a mesh: the mesh's, which the
    entry point's `device` must name ('cuda', its default, names any card;
    a mesh on the CPU takes 'cpu')."""
    if torch.device(device) not in (mesh.device, torch.device(mesh.device.type)):
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


def _cuda_device(device: torch.device, rank: int) -> torch.device:
    index = 0 if device.index is None else device.index
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if index >= count:
        raise RuntimeError(f'rank {rank} runs on cuda:{index}, which this machine lacks '
                           f'({count} CUDA devices); pass devices=[...] to place the ranks '
                           "(torch.device('cpu') for the CPU)")
    return torch.device('cuda', index)


def _default_backend(devices: Optional[list]) -> str:
    """NCCL where every rank has a card of its own, else gloo."""
    if devices is None:
        return 'nccl'
    cuda = [d for d in devices if d.type == 'cuda']
    return 'nccl' if len(cuda) == len(devices) and len(set(cuda)) == len(cuda) else 'gloo'


def make_mesh(devices: Optional[Sequence] = None, init_method: Optional[str] = None,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              timeout: Optional[timedelta] = None) -> Mesh:
    """This rank's Mesh, joining the default process group (or reusing the
    one that exists).

    rank / world_size default to torchrun's RANK / WORLD_SIZE, init_method to
    'env://' (MASTER_ADDR / MASTER_PORT); a FileStore or TCP address
    ('file:///path', 'tcp://host:port') with rank and world_size forms a
    group without torchrun. devices: one device a rank, indexed by rank;
    None = cuda:LOCAL_RANK, which raises where the machine has no such card
    (never the CPU, never a shared card). The backend is NCCL where every
    rank has its own card, else gloo. timeout: the process group's
    collective timeout."""
    if dist.is_initialized():
        rank, world_size = dist.get_rank(), dist.get_world_size()
    else:
        rank = int(os.environ.get('RANK', 0)) if rank is None else int(rank)
        world_size = (int(os.environ.get('WORLD_SIZE', 1)) if world_size is None
                      else int(world_size))
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len(devices) != world_size:
            raise ValueError(f'{len(devices)} devices for a world of {world_size} ranks')
        devices = [_cuda_device(d, r) if d.type == 'cuda' else d
                   for r, d in enumerate(devices)]
        device = devices[rank]
    else:
        device = _cuda_device(torch.device('cuda', int(os.environ.get('LOCAL_RANK', rank))),
                              rank)
    backend = _default_backend(devices)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend and have == 'nccl':
            raise ValueError(f'the process group is {have}; this mesh needs {backend}')
        backend = have
    else:
        dist.init_process_group(backend, init_method=init_method or 'env://', rank=rank,
                                world_size=world_size,
                                **({} if timeout is None else {'timeout': timeout}))
    host_group = None
    if backend == 'nccl' and world_size > 1:
        host_group = dist.new_group(backend='gloo',
                                    **({} if timeout is None else {'timeout': timeout}))
    return Mesh(rank=rank, size=world_size, device=device, backend=backend,
                host_group=host_group)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None):
    """Form the default process group (NCCL: the card) before make_mesh();
    a no-op when it exists. With no arguments it reads torchrun's
    environment.

    Failure policy, as in the JAX package: when the caller passed the
    coordinator's arguments they asked for a multi-process run, so a failed
    init raises rather than training alone; a failed auto-detection (no
    arguments) warns and goes on in one process."""
    if dist.is_initialized():
        return
    explicit = any(a is not None for a in (coordinator_address, num_processes,
                                           process_id))
    try:
        if explicit:
            dist.init_process_group('nccl', init_method=f'tcp://{coordinator_address}',
                                    world_size=num_processes, rank=process_id)
        else:
            dist.init_process_group('nccl', init_method='env://')
    except Exception as e:  # the policy's boundary: raise or warn, never pass
        if explicit:
            raise RuntimeError(
                'multi-process init failed with explicit coordinator args '
                f'(coordinator_address={coordinator_address!r}, '
                f'num_processes={num_processes}, process_id={process_id}); '
                'refusing to silently train in one process') from e
        warnings.warn(f'torch.distributed auto-detect failed ({e!r}); continuing '
                      'in one process', RuntimeWarning, stacklevel=2)


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's contiguous rows of a global batch (numpy arrays or
    tensors, left where they are): rank r of n takes rows [r B/n, (r+1) B/n),
    the rows NamedSharding(P('data')) places on device r. Raises when a
    batch size does not divide by the mesh size."""
    out = {}
    for k, x in batch.items():
        n = x.shape[0]
        if n % mesh.size:
            raise ValueError(f'batch {k!r} has {n} rows, not a multiple of the mesh '
                             f'size {mesh.size}')
        rows = n // mesh.size
        out[k] = x[mesh.rank * rows:(mesh.rank + 1) * rows]
    return out


def global_batch_size(per_chip_batch: int, mesh: Optional[Mesh] = None) -> int:
    """global batch = per-rank batch x mesh size (the world size without a
    mesh, 1 without a process group)."""
    n = mesh.size if mesh is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    return per_chip_batch * n


class ShardedRows:
    """A mesh rank's rows of each batch of a dataset (MmapDataset or
    ArrayDataset): of dataset[idx], the rows shard_batch keeps, read
    without copying the other ranks' rows. The batches, their count and
    their order are the dataset's, so iterate_batches with one seed walks
    the same global batches on every rank."""

    def __init__(self, mesh: Mesh, dataset):
        self.mesh = mesh
        self.dataset = dataset
        self.batch_size = dataset.batch_size
        self._n_rows = dataset._n_rows

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> dict:
        lo = idx * self.batch_size
        n = min(lo + self.batch_size, self._n_rows) - lo
        if n % self.mesh.size:
            raise ValueError(f'batch {idx} has {n} rows, not a multiple of the mesh '
                             f'size {self.mesh.size}')
        rows = n // self.mesh.size
        lo += self.mesh.rank * rows
        return self.dataset.rows(lo, lo + rows)


def build_on_rank0(mesh: Optional[Mesh], build):
    """build() on rank 0 alone (or without a mesh), so that a data set's
    shards are written once; every other rank returns rank 0's result,
    which it receives pickled once rank 0 has finished (its on-disk shards
    then map the same files: MmapDataset pickles as its paths)."""
    if mesh is None or mesh.size == 1:
        return build()
    box = [build() if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0, group=mesh.host_group)
    return box[0]


# ------------------------------------------------------------ collectives

def all_mean_(mesh: Mesh, tensors: list) -> None:
    """Replace each tensor by its mean over the ranks (pmean), in place: one
    all-reduce of one flat buffer a dtype."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.all_reduce(flat)
        flat.div_(mesh.size)
        with torch.no_grad():
            torch._foreach_copy_(group, [v.view_as(t) for v, t in
                                         zip(flat.split([t.numel() for t in group]), group)])


def gather_tiles(mesh: Mesh, local: list, rows: int) -> list:
    """The whole of a tiled render, on every rank: rank r's [chunks * rows,
    ...] tensors (the same shapes on every rank) hold, as their chunk i,
    rows [(i size + r) rows, (i size + r + 1) rows) of the whole. One
    all-gather of one flat buffer a dtype, then the rank-major [size,
    chunks, rows] order back to the whole's."""
    out = [None] * len(local)
    by_dtype = {}
    for i, t in enumerate(local):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        n = local[idx[0]].shape[0]
        widths = [local[i][0].numel() if n else 0 for i in idx]
        flat = torch.cat([local[i].reshape(n, -1) for i in idx], dim=1).contiguous()
        parts = [torch.empty_like(flat) for _ in range(mesh.size)]
        dist.all_gather(parts, flat)
        whole = torch.stack(parts).reshape(mesh.size, -1, rows, flat.shape[1]).transpose(0, 1)
        whole = whole.reshape(mesh.size * n, flat.shape[1])
        for i, col in zip(idx, whole.split(widths, dim=1)):
            out[i] = col.reshape(mesh.size * n, *local[i].shape[1:])
    return out


def render_tiled(mesh: Optional[Mesh], inputs: dict, chunk: int, render,
                 fill: Optional[dict] = None, pad: bool = False) -> list:
    """render(rows) -> a list of [m, ...] tensors, run over `inputs` ({key:
    [n, ...] tensor}) in chunks of `chunk` rows; returns its outputs [n,
    ...] in the inputs' order. On a mesh of more than one rank each chunk is
    tiled over the ranks (rank r renders rows [r chunk/size, (r + 1)
    chunk/size) of it), the inputs padded to whole chunks with fill.get(key,
    0.0), and one all-gather (gather_tiles) gives every rank the whole; pad
    pads to whole chunks without a mesh too. chunk must divide by the mesh
    size."""
    size, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    if chunk % size:
        raise ValueError(f'a chunk of {chunk} rows does not divide by the mesh size {size}')
    n = next(iter(inputs.values())).shape[0]
    extra = (-n) % chunk if pad or size > 1 else 0
    if extra:
        fill = fill or {}
        inputs = {k: torch.cat([v, v.new_full((extra,) + v.shape[1:], fill.get(k, 0.0))])
                  for k, v in inputs.items()}
    rows = chunk // size
    parts = []
    for i in range(0, n + extra, chunk):
        lo = i + rank * rows
        parts.append(render({k: v[lo:lo + rows] for k, v in inputs.items()}))
    local = [torch.cat(p) for p in zip(*parts)]
    if size > 1:
        local = gather_tiles(mesh, local, rows)
    return [x[:n] for x in local]


def host_first(mesh: Mesh, value: float) -> float:
    """Rank 0's `value` on every rank (a host-side broadcast over gloo; no
    device work)."""
    if mesh.size == 1:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64)
    dist.broadcast(t, 0, group=mesh.host_group)
    return float(t.item())


def host_any(mesh: Mesh, flag: bool) -> bool:
    """True on every rank when `flag` is true on any rank (a host-side
    all-reduce over gloo; no device work)."""
    if mesh.size == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return bool(t.item())


def _collect(obj, tensors: list, scalars: list, owner=None, name=None):
    """The tensors and the numeric fields of a state, in a fixed order:
    nested dicts, lists, tuples and dataclasses are walked, a torch
    optimizer by its state in the order of its parameters."""
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _collect(v, tensors, scalars, obj, k)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _collect(v, tensors, scalars)
    elif isinstance(obj, torch.optim.Optimizer):
        for group in obj.param_groups:
            for p in group['params']:
                for k in sorted(obj.state.get(p, {})):
                    tensors.append(obj.state[p][k])
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _collect(getattr(obj, f.name), tensors, scalars, obj, f.name)
    elif isinstance(obj, (int, float, np.floating, np.integer)) and not isinstance(obj, bool) \
            and owner is not None:
        scalars.append((owner, name, type(obj)))


def replicate(mesh: Mesh, state):
    """Broadcast rank 0's state to every rank, in place, and return it: a
    nested dict of tensors, or a TrainState with its parameters, Adam's
    moments and counts, the spike guard's EMA, snapshot and trips, and the
    EMA average. Every rank must hold a state of the same structure (checked:
    the counts of tensors and elements and the scalars' number)."""
    tensors, scalars = [], []
    _collect(state, tensors, scalars)
    header = torch.tensor([len(tensors), sum(t.numel() for t in tensors), len(scalars)],
                          dtype=torch.float64, device=mesh.device)
    ref = header.clone()
    dist.broadcast(ref, 0)
    if not torch.equal(ref, header):
        raise ValueError(f'rank {mesh.rank} holds a state of another structure than rank 0 '
                         f'(tensors, elements, scalars: {header.tolist()} against '
                         f'{ref.tolist()})')
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1).to(mesh.device) for t in group])
            dist.broadcast(flat, 0)
            # one copy a tensor: Adam's counts stay on the CPU
            for v, t in zip(flat.split([t.numel() for t in group]), group):
                t.copy_(v.view_as(t))
        if scalars:
            values = torch.tensor([float(_get(o, k)) for o, k, _ in scalars],
                                  dtype=torch.float64, device=mesh.device)
            dist.broadcast(values, 0)
            for (o, k, kind), v in zip(scalars, values.tolist()):
                _set(o, k, kind(v))
    return state


def _get(owner, key):
    return owner[key] if isinstance(owner, dict) else getattr(owner, key)


def _set(owner, key, value):
    if isinstance(owner, dict):
        owner[key] = value
    else:
        setattr(owner, key, value)

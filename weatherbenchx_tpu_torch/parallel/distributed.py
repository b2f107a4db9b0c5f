"""Collectives over ``torch.distributed``: the port's multi-device layer.

It takes the place of ``jax.distributed`` and
``jax.experimental.multihost_utils`` in the JAX package, in PyTorch's own
idiom: one process per device, each a rank of the default process group,
which the caller initialises (``torch.distributed.init_process_group``,
with its address, world size and rank). A chunk sharded over a device mesh
is a ``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names``
are the axes that ``dim_to_axis`` names.

* ``rank``, ``world_size`` and ``barrier`` of the default group;
  ``require_process_group`` refuses to run a distributed evaluation as one
  process when no group was initialised.
* ``allgather_bytes`` and ``allgather_sum_states``: the cross-process
  monoid sum of the JAX pipeline (``_allgather_bytes``,
  ``_allgather_sum_states``), on the host over the group's CPU path: a
  length exchange, then one padded ``uint8`` gather, then the zero-filled
  outer-join sum of the deserialised states.
* ``gather_dim`` and ``all_reduce_sum``: a sharded dim made whole on every
  rank of a mesh axis, and partial sums added over one. Under NCCL the
  gather is ``all_gather_into_tensor``; under gloo, which takes CUDA
  tensors only in ``all_reduce`` and ``broadcast``, each rank writes its
  slice into a zero-filled buffer of the whole size and the buffers are
  all-reduced (adding zeros is exact).
* ``group_mesh``: a per-group mesh for ``distributed`` together with a
  mesh: the world split into groups of ``prod(shape)`` consecutive ranks.

``BYTES_GATHERED`` counts the bytes each call moved into this rank
(gathers and reductions alike), for the port's measurements.
"""

import collections
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from weatherbenchx_tpu_torch import aggregation as aggregation_lib
from weatherbenchx_tpu_torch import io as io_lib

# Bytes received by this rank per collective kind, since the last reset.
BYTES_GATHERED: collections.Counter = collections.Counter()


def require_process_group() -> None:
  """Raises unless the default process group is initialised."""
  if not (dist.is_available() and dist.is_initialized()):
    raise RuntimeError(
        'distributed=True needs torch.distributed.init_process_group() to '
        'have been called in every process (its address, world size and '
        'rank); it does not fall back to one process')


def rank() -> int:
  """This process's rank in the default group."""
  require_process_group()
  return dist.get_rank()


def world_size() -> int:
  """The number of processes in the default group."""
  require_process_group()
  return dist.get_world_size()


def barrier() -> None:
  """Waits for every rank of the default group."""
  require_process_group()
  dist.barrier()


def _backend(group, device: torch.device) -> str:
  """The backend that ``group`` uses for tensors on ``device``: a group
  made with ``'cpu:gloo,cuda:nccl'`` answers per device type."""
  name = str(dist.get_backend(group))
  if ':' not in name:
    return name
  per_device = dict(part.split(':') for part in name.split(','))
  return per_device.get(device.type, name)


def allgather_bytes(payload: bytes) -> list[bytes]:
  """One variable-length byte string from every rank, in rank order.

  Two collectives on CPU tensors: a length exchange, then one padded
  ``uint8`` gather.
  """
  n = world_size()
  length = torch.tensor([len(payload)], dtype=torch.int64)
  lengths = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
  dist.all_gather(lengths, length)
  lengths = [int(x.item()) for x in lengths]
  max_len = max(max(lengths), 1)
  padded = torch.zeros(max_len, dtype=torch.uint8)
  if payload:
    padded[:len(payload)] = torch.frombuffer(bytearray(payload),
                                             dtype=torch.uint8)
  parts = [torch.empty(max_len, dtype=torch.uint8) for _ in range(n)]
  dist.all_gather(parts, padded)
  BYTES_GATHERED['allgather_bytes'] += n * max_len + 8 * n
  return [p[:k].numpy().tobytes() for p, k in zip(parts, lengths)]


def allgather_sum_states(state: aggregation_lib.AggregationState,
                         contribute: bool = True
                         ) -> aggregation_lib.AggregationState:
  """The monoid sum of every rank's state, the same on every rank.

  Each state is serialised on the host (``to_host``, then
  ``io.dumps_dataset``), the bytes are all-gathered, and the states are
  summed by the zero-filled outer join, so ragged layouts (other station
  sets, other preserved coords) combine. A rank that got no chunks, or one
  that is told not to ``contribute`` (a mesh rank other than its group's
  first, whose state its group's first rank already holds), sends
  ``b''``.
  """
  payload = (b'' if not contribute or state.sum_weighted_statistics is None
             else io_lib.dumps_dataset(state.to_host().to_dataset()))
  parts = [aggregation_lib.AggregationState.from_dataset(
      io_lib.loads_dataset(blob)) for blob in allgather_bytes(payload) if blob]
  return aggregation_lib.AggregationState.sum(parts)


def gather_dim(t: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
  """``t``, sharded along ``dim`` over the mesh axis ``axis``, made whole
  on every rank of that axis (slices in the axis's rank order)."""
  group = mesh.get_group(axis)
  n = mesh.size(mesh.mesh_dim_names.index(axis))
  if t.dtype == torch.bool:  # no collective reduces bool under gloo
    return gather_dim(t.to(torch.uint8), dim, mesh, axis).bool()
  k = t.shape[dim]
  shape = list(t.shape)
  shape[dim] = k * n
  BYTES_GATHERED['gather_dim'] += t.numel() * t.element_size() * n
  if _backend(group, t.device) == 'nccl':
    front = t.movedim(dim, 0).contiguous()
    out = torch.empty((k * n,) + tuple(front.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, dim)
  out = torch.zeros(shape, dtype=t.dtype, device=t.device)
  out.narrow(dim, mesh.get_local_rank(axis) * k, k).copy_(t)
  dist.all_reduce(out, group=group)
  return out


def all_reduce_sum(t: torch.Tensor, mesh, axes: Sequence[str]
                   ) -> torch.Tensor:
  """``t`` summed over the ranks of each mesh axis in ``axes``."""
  out = t.clone()
  for axis in axes:
    BYTES_GATHERED['all_reduce'] += out.numel() * out.element_size()
    dist.all_reduce(out, group=mesh.get_group(axis))
  return out


def group_mesh(device_type: str, shape: Sequence[int],
               names: Sequence[str]):
  """The mesh of this rank's group: the world split into groups of
  ``prod(shape)`` consecutive ranks, each a mesh of ``shape`` with axes
  ``names``. Every rank calls it (it creates the groups' collectives)."""
  from torch.distributed.device_mesh import init_device_mesh
  size = int(np.prod(shape))
  world = world_size()
  if world % size:
    raise ValueError(f'a world of {world} ranks does not split into meshes '
                     f'of {size}')
  full = init_device_mesh(device_type, (world // size,) + tuple(shape),
                          mesh_dim_names=('_group',) + tuple(names))
  return full[tuple(names)] if len(names) > 1 else full[names[0]]


def mesh_group(mesh) -> tuple[int, int]:
  """(this rank's group index, number of groups) for a mesh that covers
  ``mesh.size()`` consecutive ranks of the world."""
  size = mesh.size()
  world, me = world_size(), rank()
  ranks = sorted(int(r) for r in mesh.mesh.reshape(-1).tolist())
  first = me - me % size
  if world % size or ranks != list(range(first, first + size)):
    raise ValueError(
        f'the mesh covers ranks {ranks}: a mesh under distributed=True must '
        f'be {size} consecutive ranks of the {world}, starting at a multiple '
        f'of {size} (distributed.group_mesh builds one)')
  return me // size, world // size

"""Device mesh and sharding rules over ``torch.distributed``.

Port of ``thunder_tpu/parallel/mesh.py``:

- a ``(data, model)`` mesh over the ranks of the initialized process group
  (``torch.distributed.device_mesh.init_device_mesh``), ``model`` the fast
  axis: consecutive ranks share a data index, as the JAX module's
  ``reshape(n // m, m)`` of the device list puts them;
- batches shard along ``data``: every rank reads the same global batch and
  keeps its data index's contiguous block of rows (:func:`batch_sharding`),
  the JAX package's ``P("data")``;
- tensors may shard along ``model`` under the JAX package's channel rule
  (:func:`param_shardings`): the last axis, the output channels of the WIO
  conv and ``(in, out)`` Dense kernels, when it is at least
  ``min_channels`` and divides by the model size. :func:`shard_variables`
  keeps each rank's slice; :mod:`thunder_tpu_torch.parallel.spmd` computes
  with the slices.

Multi-process: call ``torch.distributed.init_process_group`` (NCCL for the
card, gloo for the CPU) in every process before :func:`make_mesh`; the same
program then runs on every rank.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist
from torch import nn

from thunder_tpu_torch.parallel.spmd import Shard, local_slice, mark_shard, shard_of

__all__ = [
    "Mesh",
    "make_mesh",
    "batch_sharding",
    "stacked_batch_sharding",
    "replicated",
    "param_shardings",
    "shard_variables",
    "unshard_variables",
    "full_state",
    "gather_whole",
    "DATA_AXIS",
    "MODEL_AXIS",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"

_BACKEND_FOR = {"cuda": "nccl", "cpu": "gloo"}


class Mesh:
    """A ``(data, model)`` mesh of this process group's ranks: the device mesh, this rank's coordinates and the
    two process groups (the ranks that share this rank's model index, and those that share its data index)."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.data_group = device_mesh.get_group(DATA_AXIS)
        self.model_group = device_mesh.get_group(MODEL_AXIS)
        self.data_rank, self.model_rank = (int(c) for c in device_mesh.get_coordinate())

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.device_mesh.mesh_dim_names, self.device_mesh.shape))

    @property
    def data_size(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def model_size(self) -> int:
        return self.shape[MODEL_AXIS]

    def axis(self, name: str) -> Tuple[object, int, int]:
        """``(group, index, size)`` of this rank along the axis ``name``."""
        if name not in self.shape:
            raise ValueError(f"the mesh has no axis {name!r} (axes: {list(self.shape)})")
        index = (self.data_rank, self.model_rank)[(DATA_AXIS, MODEL_AXIS).index(name)]
        return self.device_mesh.get_group(name), index, self.shape[name]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device}, data_rank={self.data_rank}, model_rank={self.model_rank})"


def _local_rank() -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() % max(torch.cuda.device_count(), 1)


def make_mesh(model_parallel: int = 1, device=None) -> Mesh:
    """Mesh over every rank of the process group: data axis x model axis.

    ``model_parallel`` consecutive ranks form the model axis; the rest is data-parallel. ``device`` is this
    rank's card (``cuda:<local rank>``) unless the caller asks for the CPU. The process group's backend must
    carry the device's tensors (NCCL for CUDA, gloo for the CPU): the mesh never moves tensors to suit it.

    Raises:
        RuntimeError: no process group is initialized.
        ValueError: the world does not divide by ``model_parallel``, or the backend does not fit the device.
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a process group: call torch.distributed.init_process_group(...) first")
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if model_parallel < 1 or n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    device = torch.device(device) if device is not None else torch.device("cuda", _local_rank())
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", _local_rank())
    want = _BACKEND_FOR.get(device.type)
    backend = str(dist.get_backend())
    if want is None or want not in backend:
        raise ValueError(f"a mesh on {device.type} tensors needs the {want or 'nccl or gloo'} backend, the process "
                         f"group runs {backend!r}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    device_mesh = init_device_mesh(device.type, (n // model_parallel, model_parallel),
                                   mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(device_mesh, device)


def _rows_of(n: int, mesh: Mesh) -> Tuple[int, int]:
    d = mesh.data_size
    if n % d:
        raise ValueError(f"batch {n} must divide the mesh's {DATA_AXIS!r} axis ({d})")
    per = n // d
    return mesh.data_rank * per, per


def batch_sharding(mesh: Mesh):
    """``shard(x)``: this rank's contiguous block of rows of a global batch's leading axis."""

    def shard(x):
        start, per = _rows_of(x.shape[0], mesh)
        return x[start: start + per]

    return shard


def stacked_batch_sharding(mesh: Mesh):
    """``shard(x)``: this rank's rows of axis 1 of a ``(steps, batch, ...)`` stack."""

    def shard(x):
        start, per = _rows_of(x.shape[1], mesh)
        return x[:, start: start + per]

    return shard


def replicated(mesh: Mesh):
    """``place(x)``: the whole tensor on every rank."""
    return lambda x: x


def _spec_for_param(shape, model_size: int, min_channels: int) -> tuple:
    """The JAX module's channel rule: shard the trailing (output-channel) axis when it is large; conv kernels
    ``(k, in/groups, out)`` and Dense kernels ``(in, out)`` both end in their output channels, and biases and
    norm vectors shard along their only axis."""
    if len(shape) == 0:
        return ()
    last = shape[-1]
    if model_size > 1 and last >= min_channels and last % model_size == 0:
        return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
    return ()


def _state(module_or_state) -> Mapping[str, torch.Tensor]:
    return module_or_state.state_dict() if isinstance(module_or_state, nn.Module) else module_or_state


def param_shardings(module_or_state, mesh: Mesh, min_channels: int = 256) -> Dict[str, tuple]:
    """The partition spec of each ``state_dict`` entry under the channel rule: ``()`` replicated, else ``(None,
    ..., "model")`` (the JAX ``PartitionSpec`` as a tuple)."""
    return {k: _spec_for_param(tuple(v.shape), mesh.model_size, min_channels)
            for k, v in _state(module_or_state).items()}


def _shard(mesh: Mesh) -> Shard:
    return Shard(mesh.model_group, mesh.model_rank, mesh.model_size)


def shard_variables(module_or_state, mesh: Mesh, min_channels: int = 256):
    """Keep on this rank only its model index's slice of each tensor the rule shards; replicate the rest.

    A module is sharded in place (its parameters and running statistics become their slices, marked for
    :mod:`~thunder_tpu_torch.parallel.spmd`; an optimizer built afterwards holds slices too) and returned; a
    ``state_dict`` gives a new dict of slices.
    """
    specs = param_shardings(module_or_state, mesh, min_channels)
    shard = _shard(mesh)
    if not isinstance(module_or_state, nn.Module):
        return {k: local_slice(v, shard).clone() if specs[k] else v for k, v in module_or_state.items()}
    for name, t in _named_tensors(module_or_state):
        if specs[name]:
            t.data = local_slice(t.data, shard).clone()
            mark_shard(t, shard)
    return module_or_state


def _named_tensors(module: nn.Module):
    yield from module.named_parameters()
    yield from module.named_buffers()


def gather_whole(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The whole tensor of the slice ``t`` of ``shard`` (an all-gather over its model group; no gradient)."""
    parts = [torch.empty_like(t) for _ in range(shard.size)]
    dist.all_gather(parts, t.detach().contiguous(), group=shard.group)
    return torch.cat(parts, dim=-1)


def unshard_variables(module: nn.Module) -> nn.Module:
    """Gather every sharded tensor of ``module`` back to its whole in place (a collective over each model
    group); the module is then the meshless one."""
    for _, t in list(_named_tensors(module)):
        shard = shard_of(t)
        if shard is not None:
            t.data = gather_whole(t.data, shard)
            mark_shard(t, None)
    return module


def full_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's ``state_dict`` with each sharded tensor gathered to its whole (a collective over each model
    group); whole tensors as they are."""
    tensors = dict(_named_tensors(module))
    return {k: v if shard_of(tensors.get(k)) is None else gather_whole(v, shard_of(tensors[k]))
            for k, v in module.state_dict().items()}

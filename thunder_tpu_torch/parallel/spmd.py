"""How a rank of a ``(data, model)`` mesh computes with its rows and its slices.

The port's counterpart of what GSPMD does for the JAX package's sharded
``jit``: every rank runs the same program on its own rows of the global batch
(the ``data`` axis) and on its own slices of the channel-sharded tensors (the
``model`` axis), and a few collectives, each a small
``torch.autograd.Function`` with its backward stated, make the result that of
the single-device program on the global batch.

The loss these collectives are written for:

- over the ``data`` axis each rank holds a *share* of the loss (its rows'
  weighted sum over the global weight sum, :func:`share_factor`), and the
  total is the sum of the shares. A sum over the data group in the forward
  (:func:`data_sum`, BatchNorm's statistics) therefore sums the cotangents
  in its backward, and the trainer sums the gradients over the data group;
- over the ``model`` axis the ranks of a group hold the same rows and compute
  the same loss, replicated. A tensor gathered along channels
  (:func:`gathered`) takes its own slice of the cotangent in the backward
  (every rank holds the full one), and the input of a column-parallel
  product (:func:`column_parallel`) sums the cotangent over the group in its
  backward, since each rank's slice of output channels contributes its part.

``torch.distributed.nn.functional`` is not used: its all-gather reduces the
cotangents in the backward, which counts a replicated loss once a rank.

A sharded tensor carries its model group as the attribute ``_thunder_shard``
(set by :func:`thunder_tpu_torch.parallel.shard_variables`); code that reads a
parameter goes through :func:`gathered` or :func:`column_parallel`, which are
the identity on a tensor without it, so the meshless path runs as before.

:func:`rows` is the context of one data-parallel step: this rank's first row
in the global batch and the global row count. Inside it :func:`draw_rows`
makes a draw at the global batch's shape and keeps this rank's rows, so that
every random number of a step equals the single-device step's for the same
rows and the training generator advances alike on every rank;
:func:`row_offset` gives the first row to the training kernels, which hash a
row's global index into their dropout masks.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

__all__ = [
    "Shard",
    "shard_of",
    "mark_shard",
    "local_slice",
    "gathered",
    "column_parallel",
    "data_sum",
    "all_gather_rows",
    "Rows",
    "rows",
    "current_rows",
    "row_offset",
    "draw_rows",
    "share_factor",
]

SHARD_ATTR = "_thunder_shard"


@dataclass(frozen=True)
class Shard:
    """A tensor's slice of the last axis: ``index`` of ``size`` equal slices over the model ``group``."""

    group: object
    index: int
    size: int


def shard_of(t: Optional[torch.Tensor]) -> Optional[Shard]:
    """The :class:`Shard` a tensor carries, None for a whole (replicated) tensor."""
    return None if t is None else getattr(t, SHARD_ATTR, None)


def mark_shard(t: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    setattr(t, SHARD_ATTR, shard)
    return t


def local_slice(full: torch.Tensor, shard: Shard) -> torch.Tensor:
    """``shard``'s slice of the last axis of the whole tensor ``full``."""
    n = full.shape[-1] // shard.size
    return full.narrow(-1, shard.index * n, n)


def _gather_last(x: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=-1)


class _GatherLast(torch.autograd.Function):
    """Forward: the slices of the model group concatenated along the last axis. Backward: this rank's slice of
    the cotangent (the loss is replicated over the group, so each rank holds the whole cotangent)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _gather_last(x.contiguous(), shard.group)

    @staticmethod
    def backward(ctx, grad):
        return local_slice(grad, ctx.shard).contiguous(), None


class _ModelInput(torch.autograd.Function):
    """Forward: the identity. Backward: the cotangent summed over the model group (each rank's slice of output
    channels contributes its part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _DataSum(torch.autograd.Function):
    """Forward: the sum over the data group. Backward: the cotangents summed over the group (each rank's loss
    share depends on the sum, and the total loss is the sum of the shares)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def gathered(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The whole tensor of a sharded one, all-gathered at its use (backward: this rank's slice); the tensor itself
    when it is whole."""
    shard = shard_of(t)
    return t if shard is None else _GatherLast.apply(t, shard)


def column_parallel(fn: Callable, x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor], *args,
                    **kwargs) -> torch.Tensor:
    """``fn(x, kernel, bias, *args, **kwargs)``, a product whose last output axis is the kernel's last axis.

    With a sharded kernel (and bias) the rank computes its slice of output channels from the whole input, and
    the slices are all-gathered along the last axis; the input passes through an identity whose backward sums
    over the model group. With a whole kernel it is ``fn`` itself.
    """
    shard = shard_of(kernel)
    if shard is None:
        return fn(x, kernel, bias, *args, **kwargs)
    y = fn(_ModelInput.apply(x, shard.group), kernel, bias, *args, **kwargs)
    return _GatherLast.apply(y, shard)


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group of the running step (:func:`rows`); ``x`` itself outside one."""
    r = current_rows()
    return x if r is None else _DataSum.apply(x, r.group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' equal-sized ``x`` of the group concatenated along the leading axis, in rank order (no
    gradient)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


@dataclass(frozen=True)
class Rows:
    """A data-parallel step's rows: this rank's ``offset`` in the global batch of ``total`` rows, and the data
    ``group`` the step's sums run over."""

    offset: int
    total: int
    group: object


_ROWS: contextvars.ContextVar[Optional[Rows]] = contextvars.ContextVar("thunder_tpu_torch_rows", default=None)


@contextlib.contextmanager
def rows(r: Optional[Rows]):
    """Run the body as a data-parallel step over ``r`` (None: a single-device step)."""
    token = _ROWS.set(r)
    try:
        yield r
    finally:
        _ROWS.reset(token)


def current_rows() -> Optional[Rows]:
    return _ROWS.get()


def row_offset() -> int:
    """The first global row of this rank's rows (0 outside a data-parallel step)."""
    r = _ROWS.get()
    return 0 if r is None else r.offset


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape) -> torch.Tensor:
    """``draw(shape)``, or inside a data-parallel step this rank's rows of ``draw`` at the global batch's shape
    (``shape[0]`` is the rank's row count)."""
    r = _ROWS.get()
    shape = tuple(shape)
    if r is None:
        return draw(shape)
    return draw((r.total, *shape[1:]))[r.offset: r.offset + shape[0]]


def share_factor(local_weight: float, total_weight: float) -> float:
    """A rank's share of the loss is its rows' weighted mean times this factor, the fraction of the global weight
    its rows hold (float64 on the host); the shares sum to the global mean. It is exactly 1 on a mesh of one, where
    the loss is the meshless one.

    A captured step multiplies by it as a float32 scalar tensor on the loss's device, written anew before each
    replay; a float32 product rounds a host number to float32 once, as the tensor holds it, so both give the same
    bits."""
    return local_weight / max(total_weight, 1.0)

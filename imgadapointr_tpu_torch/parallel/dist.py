"""The port's collectives, all in one place.

The JAX package has no counterpart: XLA inserts its collectives from the
shardings (``imgadapointr_tpu/parallel/mesh.py``). Here every collective of
the multi-GPU paths (the data-parallel step, BatchNorm's global moments,
the tensor-parallel layers, the point-axis ops, the pipeline) goes through
this module, and this module uses two ``torch.distributed`` calls only:
``all_reduce`` (sum, max, min) and ``broadcast``. Those two are the
collectives gloo runs on CUDA tensors, so one code path serves NCCL (one
process a card) and gloo (several processes on one card, or the CPU).

- :func:`all_reduce` sums across a group; its gradient is the sum of the
  cotangents across the group (the adjoint of a sum), or, with
  ``backward="identity"``, the rank's own cotangent: the gradient of one
  value that every rank holds (a loss every rank reports alike).
- :func:`all_gather` concatenates the group's tensors along a dimension:
  an all-reduce of a zero-filled buffer in which each rank fills its own
  slot. Adding zeros is exact, so the result is the gathered tensor bit for
  bit. Its gradient is the all-reduce of the cotangent, sliced to the
  rank's own slot.
- :func:`broadcast` copies the source rank's tensor to the group.

Every gradient here is the exact adjoint of its forward. A replicated
value that every rank of a group computes alike therefore collects, on
each rank, its share of the gradient of the sum of every rank's loss;
``parallel/mesh.py:reduce_gradients`` turns those shares into the
gradient of the global batch's mean.

A :class:`Group` of size 1 with no process group behind it makes every
call the identity, so the single-process paths run no collective at all.

:func:`data_parallel` marks the span of a train step whose batch is
sharded over a data group. Inside it, BatchNorm takes the global batch's
moments (``nn/layers.py``), and :func:`global_draw` draws a random tensor
shaped by the batch at the global batch's shape from a generator seeded
alike on every rank and keeps the rank's slice: the draws of a step at
``dp`` ranks are those of one process on the global batch, as a JAX
program draws global arrays.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as tdist

_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


@dataclass(frozen=True)
class Group:
    """A set of ranks that run collectives together: ``handle`` (a
    ``torch.distributed`` process group, or None for the one-rank group of
    a single process), ``ranks`` (global ranks in group order) and this
    process's index in it (``rank``)."""

    handle: object
    ranks: tuple
    rank: int

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def active(self) -> bool:
        """True when calls go through ``torch.distributed`` (a process group
        exists, even of one rank)."""
        return self.handle is not None


SOLO = Group(None, (0,), 0)


def _op(op: str):
    return getattr(tdist.ReduceOp, _OPS[op])


def all_reduce_(t: torch.Tensor, group: Group, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group`` (no gradient); returns ``t``."""
    if group.active:
        tdist.all_reduce(t, op=_op(op), group=group.handle)
    return t


def broadcast_(t: torch.Tensor, group: Group, src: int = 0) -> torch.Tensor:
    """In-place broadcast of ``t`` from the group's ``src``-th rank (no
    gradient); returns ``t``."""
    if group.active:
        tdist.broadcast(t, src=group.ranks[src], group=group.handle)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, adjoint):
        ctx.group, ctx.adjoint = group, adjoint
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return (all_reduce_(g.clone(), ctx.group) if ctx.adjoint else g), None, None


def all_reduce(t: torch.Tensor, group: Group, op: str = "sum", backward: str = "sum") -> torch.Tensor:
    """A new tensor: ``t`` reduced over ``group`` by ``op`` (sum, max or
    min). A sum carries a gradient: the same sum of the cotangents
    (``backward="sum"``, its adjoint), or the rank's own cotangent
    (``backward="identity"``: the result is one value every rank holds, and
    each rank's cotangent is that value's); max and min carry none."""
    if op == "sum":
        if backward not in ("sum", "identity"):
            raise ValueError(f"backward must be sum|identity, got {backward!r}")
        return _AllReduceSum.apply(t, group, backward == "sum") if group.active else t
    return all_reduce_(t.detach().clone(), group, op)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        buf = torch.zeros((group.size,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        buf[group.rank] = x
        all_reduce_(buf, group)
        return torch.cat(buf.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return g.chunk(ctx.group.size, dim=ctx.dim)[ctx.group.rank].contiguous(), None, None


def all_gather(t: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """The group's tensors (equal shapes) concatenated along ``dim`` in
    group order, bit for bit; differentiable (see the module docstring)."""
    if not group.active:
        return t
    return _AllGather.apply(t, dim % t.dim(), group)


def broadcast(t: torch.Tensor, group: Group, src: int = 0) -> torch.Tensor:
    """A new tensor holding the group's ``src``-th rank's ``t`` (no gradient)."""
    return broadcast_(t.detach().clone().contiguous(), group, src)


# ------------------------------------------------------------ the data span
_DATA: Group | None = None


@contextlib.contextmanager
def data_parallel(group: Group):
    """Within the block, the batch is this rank's shard of a global batch
    split over ``group`` (contiguous, in group order)."""
    global _DATA
    prev, _DATA = _DATA, group
    try:
        yield
    finally:
        _DATA = prev


def data_group() -> Group | None:
    """The data group of the enclosing :func:`data_parallel` block, if its
    size is above 1."""
    return _DATA if _DATA is not None and _DATA.size > 1 else None


def global_draw(draw, shape, **kwargs) -> torch.Tensor:
    """``draw(shape, **kwargs)`` (``torch.rand``, ``torch.randn``, or a
    ``functools.partial`` of ``torch.randint``) for a tensor whose first
    dimension is the batch. Inside :func:`data_parallel` over ``dp`` ranks it
    draws ``(dp * B, ...)`` and returns this rank's ``B`` rows; elsewhere
    it is ``draw(shape)``."""
    group = data_group()
    shape = tuple(shape)
    if group is None or not shape:
        return draw(shape, **kwargs)
    B = shape[0]
    full = draw((B * group.size,) + shape[1:], **kwargs)
    return full[group.rank * B:(group.rank + 1) * B]

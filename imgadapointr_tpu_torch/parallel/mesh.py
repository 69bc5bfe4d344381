"""The device mesh of the port's multi-GPU paths, and its sharding rules.

Counterpart of ``imgadapointr_tpu/parallel/mesh.py``. The JAX runner
builds a ``('data', 'model'[, 'points'])`` mesh over every device and lets
XLA shard the step; here one process runs on each card (``torchrun``), and
:func:`make_mesh` gives this process its coordinates and the process
groups of the three axes, in the JAX layout: the world's ranks reshaped to
``(dp, tp, sp)`` in rank order (``parallel/mesh.py:21-35``), so rank
``r = (d * tp + m) * sp + s``.

- :func:`shard_batch`: this rank's rows of a global batch over the data
  axis; the train path is strict (a batch that does not divide raises).
- :func:`param_sharding_rules`: the parameters that the JAX rule column-
  shards over the model axis (a 2-D flax leaf of at least 65,536 entries
  whose output dimension divides ``tp``), decided on the flax leaf through
  the converter's mapping (``tools/convert.py``), so that exactly the JAX
  set of leaves is sharded.
- :class:`TensorParallel`: applies those rules. A sharded leaf holds its
  rank's slice of output rows; its layer computes its slice of the output
  and all-gathers it (``parallel/dist.py``); its gradient is the slice's.
  A checkpoint holds whole tensors: :meth:`TensorParallel.unsharded`
  gathers the weights, the optimizer's moments and a pending gradient
  before a save or a load and slices them again after it, so a ``.pth``
  is the same file at any ``tp`` and a JAX ``.ckpt`` still loads.
- :func:`reduce_gradients` and :func:`clip_grad_norm`: the data-parallel
  update's all-reduce of every gradient and its global clip.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as tdist

from .dist import SOLO, Group, all_reduce_, broadcast_

MIN_SHARD_SIZE = 1 << 16  # the JAX rule's min_size


@dataclass(frozen=True)
class Mesh:
    """This process's place in a ``(dp, tp, sp)`` mesh: its coordinates
    ``(d, m, s)`` and the groups of ranks that differ only in the data
    coordinate (``data``), only in the model coordinate (``model``), only
    in the points coordinate (``points``), or that share the model
    coordinate (``replica``: the ranks that hold the same slice of a
    sharded leaf); ``world`` is every rank."""

    dp: int
    tp: int
    sp: int
    coords: tuple
    data: Group
    model: Group
    points: Group
    replica: Group
    world: Group

    @property
    def size(self) -> int:
        return self.dp * self.tp * self.sp

    @property
    def rank(self) -> int:
        return self.world.rank

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes checkpoints, logs and scalars."""
        return self.world.rank == 0


def _rank(d: int, m: int, s: int, tp: int, sp: int) -> int:
    return (d * tp + m) * sp + s


def make_mesh(tp: int = 1, sp: int = 1) -> Mesh:
    """The mesh of the initialised ``torch.distributed`` world (every rank
    calls it, in the same order), or a one-process mesh of ``SOLO`` groups
    when no process group is initialised. Raises when ``tp * sp`` does not
    divide the world."""
    if not (tdist.is_available() and tdist.is_initialized()):
        if tp != 1 or sp != 1:
            raise ValueError(f"--tp {tp} --sp {sp}: one process holds only a 1 x 1 x 1 mesh")
        return Mesh(1, 1, 1, (0, 0, 0), SOLO, SOLO, SOLO, SOLO, SOLO)
    world, rank = tdist.get_world_size(), tdist.get_rank()
    if tp < 1 or sp < 1 or world % (tp * sp):
        raise ValueError(f"{world} ranks are not divisible by tp={tp} x sp={sp}")
    dp = world // (tp * sp)
    coords = (rank // (tp * sp), rank // sp % tp, rank % sp)
    axes = range(dp), range(tp), range(sp)

    def groups(members) -> Group:
        """Make every group of ``members(fixed)`` (all ranks take part in
        each new_group, in one order) and return this rank's."""
        mine = None
        for fixed in members:
            ranks = tuple(fixed)
            handle = tdist.new_group(list(ranks))
            if rank in ranks:
                mine = Group(handle, ranks, ranks.index(rank))
        return mine

    data = groups([_rank(d, m, s, tp, sp) for d in axes[0]] for m in axes[1] for s in axes[2])
    model = groups([_rank(d, m, s, tp, sp) for m in axes[1]] for d in axes[0] for s in axes[2])
    points = groups([_rank(d, m, s, tp, sp) for s in axes[2]] for d in axes[0] for m in axes[1])
    replica = groups([_rank(d, m, s, tp, sp) for d in axes[0] for s in axes[2]] for m in axes[1])
    world_group = Group(tdist.group.WORLD, tuple(range(world)), rank)
    return Mesh(dp, tp, sp, coords, data, model, points, replica, world_group)


def data_coords(tp: int = 1, sp: int = 1) -> tuple[int, int]:
    """(data width, this rank's data coordinate) of the initialised world
    for ``tp`` and ``sp``, without making any group: (1, 0) for one
    process. The loaders shard by it before the runner makes its mesh."""
    if not (tdist.is_available() and tdist.is_initialized()):
        return 1, 0
    world, rank = tdist.get_world_size(), tdist.get_rank()
    if tp < 1 or sp < 1 or world % (tp * sp):
        raise ValueError(f"{world} ranks are not divisible by tp={tp} x sp={sp}")
    return world // (tp * sp), rank // (tp * sp)


def shard_batch(batch: dict, mesh: Mesh, strict: bool = False) -> dict:
    """This rank's rows of a global ``batch`` (tensors or arrays with a
    leading batch dimension) over the data axis, contiguous in data-rank
    order. A leading dimension that does not divide the data axis is kept
    whole (the batch-1 eval protocol), unless ``strict`` (the train path),
    where it raises (``imgadapointr_tpu/parallel/mesh.py:71-94``)."""
    n, d = mesh.dp, mesh.coords[0]

    def put(x):
        if not hasattr(x, "shape") or len(x.shape) == 0:
            return x
        if x.shape[0] % n:
            if strict:
                raise ValueError(
                    f"train batch dim {x.shape[0]} does not divide the data axis ({n} ranks): "
                    "adjust total_bs so every rank gets an equal shard")
            return x
        b = x.shape[0] // n
        return x[d * b:(d + 1) * b]

    return {k: put(v) for k, v in batch.items()}


# ------------------------------------------------------- tensor parallelism
def _flax_leaves(model: torch.nn.Module, config) -> list:
    """[(torch parameter name, kind, [(flax path, flax shape)])] of the
    2-D flax kernels the converter maps onto the model's weights: a Dense
    kernel is (in, out) where the port's weight is (out, in[, 1]); a
    ConcatDense's parts are (width_i, out); a packed ``in_proj_weight``'s
    q, k and v kernels are (in, out) each."""
    from ..tools.convert import _mapping

    params = dict(model.named_parameters())
    out = []
    for tkey, kind, path, _ in _mapping(config):
        p = params.get(tkey)
        if p is None or kind not in ("linear", "concat", "stack"):
            continue
        n_out, n_in = p.shape[0], p.shape[1]
        if kind == "linear":
            out.append((tkey, kind, [(path, (n_in, n_out))]))
        elif kind == "concat":
            widths = model.get_submodule(tkey.rsplit(".", 1)[0]).widths
            out.append((tkey, kind, [(fp, (w, n_out)) for fp, w in zip(path, widths)]))
        else:
            out.append((tkey, kind, [(fp, (n_in, n_out // len(path))) for fp in path]))
    return out


def _rule(shape: tuple, tp: int, min_size: int) -> bool:
    """The JAX rule (``parallel/mesh.py:47-68``) on a flax leaf's shape."""
    return tp > 1 and len(shape) == 2 and shape[0] * shape[1] >= min_size and shape[-1] % tp == 0


def param_sharding_rules(model: torch.nn.Module, config, tp: int,
                         min_size: int = MIN_SHARD_SIZE) -> dict:
    """{torch parameter name: (kind, [sharded?] per flax leaf)} for every
    weight with at least one leaf that the JAX rule column-shards over a
    model axis of ``tp``; every other parameter is replicated."""
    plan = {}
    for tkey, kind, leaves in _flax_leaves(model, config):
        flags = [_rule(shape, tp, min_size) for _, shape in leaves]
        if any(flags):
            plan[tkey] = (kind, flags)
    return plan


def sharded_flax_leaves(model: torch.nn.Module, config, tp: int,
                        min_size: int = MIN_SHARD_SIZE) -> set:
    """The flax paths (tuples) that :func:`param_sharding_rules` shards."""
    return {path for _, _, leaves in _flax_leaves(model, config)
            for path, shape in leaves if _rule(shape, tp, min_size)}


class TensorParallel:
    """The model axis of a mesh applied to a model by
    :func:`param_sharding_rules`. A weight whose every leaf is sharded
    (a Linear's, a ConcatDense's whose parts all are, a packed
    ``in_proj_weight``) keeps only its rank's rows (of each of q, k and v
    for a packed one): it is "sliced". A ConcatDense with sharded and
    replicated parts keeps its whole weight and its plain forward, which
    gives the same product and gradient; it is reduced as a replicated
    tensor."""

    def __init__(self, model: torch.nn.Module, config, mesh: Mesh, min_size: int = MIN_SHARD_SIZE):
        from ..nn.layers import ConcatDense, Linear, MultiheadAttention

        self.group = mesh.model
        self.tp = mesh.tp
        self.plan = param_sharding_rules(model, config, mesh.tp, min_size) if mesh.tp > 1 else {}
        self.sliced = {}  # parameter name -> kind ('linear', 'concat' or 'stack')
        params = dict(model.named_parameters())
        for name, (kind, flags) in self.plan.items():
            module = model.get_submodule(name.rsplit(".", 1)[0])
            if kind == "linear" and isinstance(module, Linear):
                module.tp = self.group
            elif kind == "concat" and isinstance(module, ConcatDense):
                if not all(flags):
                    continue  # some parts replicated: the whole weight, the plain forward
                module.tp = self.group
            elif kind == "stack" and isinstance(module, MultiheadAttention):
                module.tp = self.group
            else:
                raise TypeError(f"{name}: no tensor-parallel form for {type(module).__name__}")
            self.sliced[name] = kind
            p = params[name]
            p.data = self._local(kind, p.data)
        self.names = {id(p): n for n, p in model.named_parameters()}
        self.params = params

    # the layouts of a sliced tensor
    def _local(self, kind: str, full: torch.Tensor) -> torch.Tensor:
        r = self.group.rank
        if kind == "stack":
            return torch.cat([q.chunk(self.tp, 0)[r] for q in full.chunk(3, 0)], 0).contiguous()
        return full.chunk(self.tp, 0)[r].contiguous()

    def _full(self, kind: str, local: torch.Tensor) -> torch.Tensor:
        from .dist import all_gather

        with torch.no_grad():
            gathered = all_gather(local.contiguous(), self.group, dim=0)
        if kind == "stack":  # [q_0 k_0 v_0 q_1 ...] -> [q_0 q_1 .. k_0 ..]
            per_rank = [c.chunk(3, 0) for c in gathered.chunk(self.tp, 0)]
            return torch.cat([torch.cat([pr[i] for pr in per_rank], 0) for i in range(3)], 0)
        return gathered

    def is_sliced(self, p: torch.Tensor) -> bool:
        return self.names.get(id(p)) in self.sliced

    def _tensors(self, optimizer) -> list:
        """(kind, owner, key) of every tensor laid out like a sliced
        parameter: its data, its grad, and its optimizer state of its shape."""
        out = []
        for name, kind in self.sliced.items():
            p = self.params[name]
            out.append((kind, p, "data"))
            if p.grad is not None:
                out.append((kind, p, "grad"))
            state = optimizer.state.get(p, {}) if optimizer is not None else {}
            out += [(kind, state, key) for key, v in state.items()
                    if torch.is_tensor(v) and v.shape == p.shape]
        return out

    @staticmethod
    def _swap(tensors: list, fn) -> None:
        for kind, owner, key in tensors:  # a parameter's data before its grad
            if isinstance(owner, dict):
                owner[key] = fn(kind, owner[key])
            elif key == "data":
                owner.data = fn(kind, owner.data)
            else:
                owner.grad = fn(kind, owner.grad)

    @contextlib.contextmanager
    def unsharded(self, optimizer=None):
        """Within the block every sliced parameter (its data, its
        ``grad`` and its optimizer state tensors of its shape) holds the
        whole tensor, as on one rank, for a save or a load; the block's
        end slices whatever they hold then. No forward runs inside it.
        Every rank of the model group must enter it."""
        if not self.sliced:
            yield
            return
        self._swap(self._tensors(optimizer), self._full)
        try:
            yield
        finally:
            self._swap(self._tensors(optimizer), self._local)

    def local_share(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """What this rank's pending gradient of ``name`` must hold so that
        :func:`reduce_gradients` turns the ranks' shares back into
        ``whole`` (the reduced, whole-tensor pending gradient of a
        checkpoint): ``whole`` for a replicated tensor, ``tp`` times its
        slice for a sliced one (the replica group holds ``size / tp`` ranks)."""
        if name not in self.sliced:
            return whole
        return self._local(self.sliced[name], whole) * self.tp


def broadcast_state(model: torch.nn.Module, group: Group) -> None:
    """Every parameter and buffer from the group's first rank: the state
    starts from one init on every rank."""
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            broadcast_(t.data, group, 0)


def reduce_gradients(params, mesh: Mesh, tp: TensorParallel | None = None) -> None:
    """The data-parallel reduction, in place: each rank's gradients are
    its shares of the gradient of the sum of every rank's loss
    (``parallel/dist.py``), so the global batch's mean gradient is their
    sum over the ranks that hold the tensor, over the world size. Every
    gradient that is not None goes, in parameter order, into one flat
    buffer a group: the world's for a replicated tensor, the replica
    group's for a sliced one. On one rank without a process group nothing
    runs."""
    reduce_tensors([(p.grad, tp is not None and tp.is_sliced(p)) for p in params if p.grad is not None],
                   mesh)


def reduce_tensors(pairs, mesh: Mesh) -> None:
    """:func:`reduce_gradients` on ``[(tensor, sliced?)]``, in place."""
    if not mesh.world.active:
        return
    buckets = {}
    for t, sliced in pairs:
        group = mesh.replica if sliced else mesh.world
        buckets.setdefault(group.ranks, (group, []))[1].append(t)
    for group, ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce_(flat, group)
        flat.div_(mesh.size)
        for t, g in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(g.view_as(t))


def clip_grad_norm(params, max_norm: float, mesh: Mesh, tp: TensorParallel | None = None) -> torch.Tensor:
    """``torch.nn.utils.clip_grad_norm_`` over the whole model: a sliced
    tensor's squared norm is summed over the model group. Without a sliced
    tensor it is torch's own call."""
    params = [p for p in params if p.grad is not None]
    if tp is None or not any(tp.is_sliced(p) for p in params):
        return torch.nn.utils.clip_grad_norm_(params, max_norm)
    sq = [torch.linalg.vector_norm(p.grad, dtype=torch.float64).square() for p in params]
    whole = sum(s for s, p in zip(sq, params) if not tp.is_sliced(p))
    sliced = sum(s for s, p in zip(sq, params) if tp.is_sliced(p))
    total = torch.sqrt(whole + all_reduce_(sliced.clone(), tp.group)).to(params[0].grad.dtype)
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    torch._foreach_mul_([p.grad for p in params], coef.to(params[0].grad.device))
    return total


def reduce_max(value: float, mesh: Mesh) -> float:
    """The maximum of a host number over every rank (the world group)."""
    if not mesh.world.active:
        return value
    device = torch.device("cuda", torch.cuda.current_device()) if tdist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([value], dtype=torch.float64, device=device)
    return float(all_reduce_(t, mesh.world, "max").item())


def reduce_mean(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The group's mean of a tensor (no gradient): the logged losses."""
    if not group.active:
        return t
    return all_reduce_(t.detach().clone(), group).div_(group.size)

"""GPipe pipeline parallelism over the ranks of a 'pipe' group.

Counterpart of ``imgadapointr_tpu/parallel/pipeline.py:54-204``. Stage
``s`` runs on rank ``s`` of the pipe group; microbatches stream through
the stages over ``S + M - 1`` ticks. Every tick every stage runs its
computation on its current activation (bubble ticks compute on zeros and
their results are dropped), then passes the result to the next stage.
The combinator reorders no arithmetic inside a stage: its output is bit
for bit the same stages run one after another on the same microbatches,
and so are its gradients when those stages' gradients are summed over the
microbatches in order (``tests/test_torch_parallel.py``).

- Activations pass between neighbours by ``broadcast`` in the 2-rank group
  of each adjacent pair (``parallel/dist.py``): one code path for NCCL and
  for gloo, whose ``send``/``recv`` do not take CUDA tensors.
- The output is gathered from the last stage to every rank of the pipe
  group, as JAX's ``psum`` replicates it. Its gradient is one global
  value's: the backward takes the cotangent of the last stage's rank
  (every rank that takes the same loss of the output holds the same one),
  runs the stages' backward in the reverse order, microbatch 0 first (each
  stage recomputes its forward from the saved input), and returns the
  input's gradient and the stacked parameters' to every rank.
- ``stage_fn(params, h, shared)`` must keep ``h``'s shape and be total on
  zeros, as in JAX. ``shared`` is handed to every stage; its gradient is
  the sum over the stages.

No runner flag drives it: the JAX runner has none either.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as tdist

from .dist import SOLO, Group, all_reduce_, broadcast_

PIPE_AXIS = "pipe"


@dataclass(frozen=True)
class PipeMesh:
    """This process's place in a ``(dp, pipe)`` mesh (ranks in row-major
    order, ``r = d * pipe + s``): its coordinates ``(d, s)``, its data and
    pipe groups, and the 2-rank groups of its pipe's adjacent stages
    (``links[k]`` joins stages ``k`` and ``k + 1``)."""

    dp: int
    pipe: int
    coords: tuple
    data: Group
    pipe_group: Group
    links: tuple


def make_pipe_mesh(pipe: int | None = None, dp: int = 1) -> PipeMesh:
    """The ``(dp, pipe)`` mesh of the initialised world (every rank calls
    it, in the same order); ``pipe`` defaults to ``world / dp``. Without a
    process group: the one-stage mesh of one process."""
    if not (tdist.is_available() and tdist.is_initialized()):
        if (pipe or 1) != 1 or dp != 1:
            raise ValueError("one process holds only a 1 x 1 pipe mesh")
        return PipeMesh(1, 1, (0, 0), SOLO, SOLO, ())
    world, rank = tdist.get_world_size(), tdist.get_rank()
    pipe = pipe if pipe is not None else world // dp
    if dp * pipe != world:
        raise ValueError(f"{world} ranks != dp {dp} x pipe {pipe}")
    d, s = divmod(rank, pipe)

    def make(ranks) -> Group | None:
        ranks = tuple(ranks)
        handle = tdist.new_group(list(ranks))
        return Group(handle, ranks, ranks.index(rank)) if rank in ranks else None

    data = [make(i * pipe + j for i in range(dp)) for j in range(pipe)][s]
    pipes = [make(i * pipe + j for j in range(pipe)) for i in range(dp)][d]
    links = [[make((i * pipe + k, i * pipe + k + 1)) for k in range(pipe - 1)] for i in range(dp)][d]
    return PipeMesh(dp, pipe, (d, s), data, pipes, tuple(links))


def stack_stage_params(params: dict, names) -> dict:
    """Stack identically shaped per-stage parameter dicts ``params[name]``
    (name -> {key: tensor}) stage-major: every tensor gains a leading S axis."""
    subs = [params[n] for n in names]
    return {k: torch.stack([sub[k] for sub in subs]) for k in subs[0]}


class _TakeStage(torch.autograd.Function):
    """Row ``s`` of a stacked tensor every rank holds; the gradient of the
    whole stack is every rank's row, gathered (zeros added, exact)."""

    @staticmethod
    def forward(ctx, stacked, s, group):
        ctx.s, ctx.group, ctx.shape = s, group, stacked.shape
        return stacked[s]

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[ctx.s] = g
        return all_reduce_(full, ctx.group), None, None


def _exchange(mesh: PipeMesh, send: torch.Tensor, recv: torch.Tensor, forward: bool) -> torch.Tensor:
    """One tick's hand-over: each stage's ``send`` to the next stage
    (``forward``) or to the previous one; returns what this stage received
    (into ``recv``). Links are taken in the direction of the flow, so no
    rank waits on one that waits on it."""
    s, S = mesh.coords[1], mesh.pipe
    order = range(S - 1) if forward else reversed(range(S - 1))
    for k in order:
        link = mesh.links[k]
        if link is None:
            continue
        src = 0 if forward else 1  # stage k sends forward, stage k + 1 backward
        mine = (s == k) == forward
        if mine:
            broadcast_(send.contiguous(), link, src)
        else:
            broadcast_(recv, link, src)
    return recv


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, mesh, microbatches, keys, shared_keys, x, *tensors):
        S, s = mesh.pipe, mesh.coords[1]
        M = microbatches
        params = dict(zip(keys, tensors))
        shared = _shared(shared_keys, tensors[len(keys):])
        xm = x.chunk(M, dim=0)
        zeros = torch.zeros_like(xm[0])
        held = zeros.clone()  # the activation this stage takes at the current tick
        inputs, outs = [None] * M, [None] * M
        for t in range(S + M - 1):
            m = t - s
            active = 0 <= m < M
            h = (xm[m] if active else zeros) if s == 0 else held
            out = stage_fn(params, h, shared)
            if active:
                inputs[m] = h
                if s == S - 1:
                    outs[m] = out
            held = _exchange(mesh, out if active else zeros, torch.empty_like(zeros), forward=True)
        y = torch.cat(outs, 0) if s == S - 1 else torch.empty_like(x)
        broadcast_(y, mesh.pipe_group, S - 1)
        ctx.stage_fn, ctx.mesh, ctx.M = stage_fn, mesh, M
        ctx.keys, ctx.shared_keys = keys, shared_keys
        ctx.inputs = inputs
        ctx.tensors = tensors
        ctx.x_needs_grad = x.requires_grad
        return y

    @staticmethod
    def backward(ctx, g):
        mesh, M = ctx.mesh, ctx.M
        S, s = mesh.pipe, mesh.coords[1]
        g = broadcast_(g.contiguous().clone(), mesh.pipe_group, S - 1)
        gm = g.chunk(M, dim=0)
        tensors = ctx.tensors
        n_params = len(ctx.keys)
        params = dict(zip(ctx.keys, tensors))
        shared = _shared(ctx.shared_keys, tensors[n_params:])
        wrt = [t for t in tensors if t.requires_grad]
        acc = [None] * len(wrt)
        dx = [None] * M
        zeros = torch.zeros_like(gm[0])
        held = zeros.clone()
        for t in range(S + M - 1):
            m = t - (S - 1 - s)
            active = 0 <= m < M
            send = zeros
            if active:
                cot = gm[m] if s == S - 1 else held
                need_h = s > 0 or ctx.x_needs_grad
                with torch.enable_grad():
                    h = ctx.inputs[m].detach().requires_grad_(need_h)
                    out = ctx.stage_fn(params, h, shared)
                    grads = torch.autograd.grad(out, ([h] if need_h else []) + wrt, cot, allow_unused=True)
                if need_h:
                    send, grads = grads[0], grads[1:]
                    if s == 0:
                        dx[m] = send
                for i, gi in enumerate(grads):
                    if gi is not None:
                        acc[i] = gi if acc[i] is None else acc[i] + gi
            held = _exchange(mesh, send, torch.empty_like(zeros), forward=False)
        out = []
        if ctx.x_needs_grad:
            gx = torch.cat(dx, 0) if s == 0 else torch.empty_like(g)
            out.append(broadcast_(gx, mesh.pipe_group, 0))
        else:
            out.append(None)
        it = iter(acc)
        for i, t in enumerate(tensors):
            if not t.requires_grad:
                out.append(None)
                continue
            gi = next(it)
            if gi is None:
                gi = torch.zeros_like(t)
            if i >= n_params:  # shared: every stage's share summed
                gi = all_reduce_(gi.contiguous().clone(), mesh.pipe_group)
            out.append(gi)
        return (None, None, None, None, None, *out)


def _shared(keys, tensors):
    if keys is None:
        return None
    if keys == "tensor":
        return tensors[0]
    return dict(zip(keys, tensors))


def pipeline_apply(stage_fn, stage_params, x: torch.Tensor, shared, mesh: PipeMesh, *,
                   microbatches: int) -> torch.Tensor:
    """GPipe over the pipe group of ``mesh``.

    - ``stage_fn(params, h, shared) -> h'``: one stage, same shape in and out.
    - ``stage_params``: a stacked dict (:func:`stack_stage_params`, a leading
      S axis on every tensor, S = the pipe width) or a sequence of S dicts of
      tensors; rank ``s`` hands stage ``s``'s to ``stage_fn`` (a stage whose
      function closes over its own modules may hand their parameters).
    - ``x``: (B, ...) with B divisible by ``microbatches``; ``shared``: None,
      a tensor or a dict of tensors handed to every stage.

    Returns the (B, ...) output on every rank of the pipe group.
    Differentiable in ``x``, the stage parameters and ``shared``."""
    S, s = mesh.pipe, mesh.coords[1]
    if x.shape[0] % microbatches:
        raise ValueError(f"batch {x.shape[0]} is not divisible into {microbatches} microbatches")
    if isinstance(stage_params, dict):
        mine = {k: _TakeStage.apply(v, s, mesh.pipe_group) for k, v in stage_params.items()}
        if any(v.shape[0] != S for v in stage_params.values()):
            raise ValueError(f"stacked parameters need a leading axis of {S} stages")
    else:
        if len(stage_params) != S:
            raise ValueError(f"{len(stage_params)} stages for a pipe of {S}")
        mine = dict(stage_params[s])
    if shared is None:
        shared_keys, shared_tensors = None, []
    elif torch.is_tensor(shared):
        shared_keys, shared_tensors = "tensor", [shared]
    else:
        shared_keys, shared_tensors = list(shared), list(shared.values())
    return _Pipeline.apply(stage_fn, mesh, microbatches, list(mine), shared_keys, x, *mine.values(),
                           *shared_tensors)


def _pure_attn(block) -> bool:
    """A position-free 'attn' block: global attention and MLP only."""
    return (block.attn is not None and getattr(block, "local_attn", None) is None
            and getattr(block, "merge_map", None) is None and not block.onebyone)


def encoder_pipeline_apply(enc, x: torch.Tensor, pos: torch.Tensor, mesh: PipeMesh, *,
                           microbatches: int) -> torch.Tensor:
    """A ``PointTransformerEncoder`` with block 0 (the 'attn-graph' block,
    which needs the kNN index of ``pos``) run whole on every rank and the
    pure-'attn' tail pipelined: the tail's blocks split into contiguous
    stages, one a rank of the pipe (JAX requires one block a stage; here a
    stage may hold several, so the flagship's five tail blocks run in two
    stages of 3 and 2). Equals ``enc`` on each microbatch with block 0 on
    the whole batch, bit for bit."""
    from ..ops import knn_point

    blocks = list(enc.blocks.blocks)
    tail = blocks[1:]
    if len(tail) < mesh.pipe:
        raise ValueError(f"encoder tail of {len(tail)} blocks for {mesh.pipe} stages")
    if not all(_pure_attn(b) for b in tail):
        raise ValueError("the pipelined tail must be pure 'attn' (position-free) blocks")
    idx = knn_point(enc.k, pos, pos)
    x = blocks[0](x, pos, idx=idx)
    bounds = np.cumsum([0] + [len(c) for c in np.array_split(np.arange(len(tail)), mesh.pipe)])
    stages = [tail[bounds[i]:bounds[i + 1]] for i in range(mesh.pipe)]

    def stage_fn(_params, h, _shared):
        for blk in stages[mesh.coords[1]]:
            h = blk(h, None)
        return h

    params = [{f"{i}.{n}": p for i, blk in enumerate(st) for n, p in blk.named_parameters()}
              for st in stages]
    return pipeline_apply(stage_fn, params, x, None, mesh, microbatches=microbatches)

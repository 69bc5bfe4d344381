"""The grouped 3-NN interpolation of the deformable gather, on the CPU.

``ops.three_nn_interpolate_grouped`` computes every channel group's
interpolation in one call on the model's (B, S, C) layout; on the card one
kernel (``csrc/three_nn_interpolate.cu``) folds in the copies that the
deformable gather made around the ungrouped op. Its plain version, which the
CPU runs, must be that old composition (``_old_interpolation`` below, as
``nn/local_attention.py:grouped_deform_gather`` wrote it), bit for bit:

- outputs in float32 and float64, at g in {1, 2, 3}, with a group width that
  is not a multiple of 4 and queries that sit on known points; its ``idx``
  and ``w`` are the old (B g, S, 3) ones;
- the gradient in ``v`` (the ``dfeats`` plain version reading the (B, S, C)
  cotangent by groups), and ``grouped_deform_gather`` with and without
  ``scale_by_bbox``, forward and gradient;
- the gradient against JAX's ``_three_nn_interpolate_fused`` custom VJP on
  the Pallas interpreter in float32 (1e-5 of the largest entry, the bound of
  ``tests/test_torch_deform.py``), and ``grouped_deform_gather`` against the
  JAX ``_grouped_deform_gather`` in float64 (1e-9) with the same
  numpy-seeded offset net.
"""

import contextlib

import einops
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from imgadapointr_tpu.nn import local_attention as jla
from imgadapointr_tpu.ops import pointops as jpo
from imgadapointr_tpu_torch import ops
from imgadapointr_tpu_torch.nn import local_attention
from test_torch_seg import one_torch_thread  # noqa: F401  (a fixture)

B, N, K_NBR, M = 2, 24, 5, 40
DTYPES = {"float32": torch.float32, "float64": torch.float64}


@contextlib.contextmanager
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _inputs(seed: int, g: int, cg: int, dtype: torch.dtype):
    """(local_v_pos (B, N, k, 3), offset (B, g, N, k, 3), v_pos (B, M, 3), v
    (B, M, g cg)) from numpy: the first neighbour of every token sits on a
    known point with a zero offset (distance 0), the rest are known points
    moved by up to 0.05 and shifted by offsets of up to 0.1."""
    rng = np.random.RandomState(seed)
    v_pos = rng.randn(B, M, 3) * 0.3
    pick = rng.randint(0, M, (B, N, K_NBR))
    local = np.take_along_axis(v_pos[:, None], pick[..., None], axis=2)
    local = local + (rng.rand(B, N, K_NBR, 3) - 0.5) * 0.1 * (np.arange(K_NBR) > 0)[:, None]
    offset = (rng.rand(B, g, N, K_NBR, 3) - 0.5) * 0.2
    offset[:, :, :, 0] = 0.0
    v = rng.randn(B, M, g * cg)
    return [torch.from_numpy(a).to(dtype) for a in (local, offset, v_pos, v)]


def _old_interpolation(local_v_pos, offset, v_pos, v, scale_by_bbox=False):
    """The deformable gather's interpolation before the grouped op: the
    positions expanded and the values copied into group-major order for the
    ungrouped op, its (B g, N k, cg) result permuted back; returns it with
    that op's (B g, N k, 3) ``idx`` and ``w``."""
    Bv, Nv, k, _ = local_v_pos.shape
    g, (Mv, C) = offset.shape[1], v.shape[1:]
    cg = C // g
    pos = local_v_pos[:, None].expand(Bv, g, Nv, k, 3)
    if scale_by_bbox:
        extent = pos.amax(dim=-2) - pos.amin(dim=-2)
        offset = offset * (0.5 * extent[..., None, :])
    shift = (pos + offset).detach().reshape(Bv * g, Nv * k, 3)
    v_pos_g = v_pos[:, None].expand(Bv, g, Mv, 3).reshape(Bv * g, Mv, 3)
    v_g = v.reshape(Bv, Mv, g, cg).permute(0, 2, 1, 3).reshape(Bv * g, Mv, cg)
    interp = ops.three_nn_interpolate(shift, v_pos_g, v_g)
    _, idx, w = ops.three_nn_interpolate_plain(shift, v_pos_g.contiguous(), v_g.contiguous())
    return interp.reshape(Bv, g, Nv, k, cg).permute(0, 2, 3, 1, 4).reshape(Bv, Nv, k, C), idx, w


def _offset_params(rng, in_dim: int, dim: int) -> dict:
    """A flax ``OffsetNet`` tree from numpy, with offsets of about 0.1."""
    return {"Dense_0": {"kernel": rng.randn(in_dim, dim) * 0.3, "bias": rng.randn(dim) * 0.1},
            "LayerNorm_0": {"scale": 1.0 + 0.1 * rng.randn(dim), "bias": 0.1 * rng.randn(dim)},
            "Dense_1": {"kernel": rng.randn(dim, 3) * 0.05}}


def _load_offset_net(params: dict, in_dim: int, dim: int, dtype: torch.dtype) -> torch.nn.Module:
    """The port's ``offset_net`` holding the flax tree ``params``."""
    net = local_attention.offset_net(in_dim, dim).to(dtype)
    sub = {"0": "Dense_0", "1": "LayerNorm_0", "3": "Dense_1"}
    sd = {}
    for name in net.state_dict():
        i, leaf = name.split(".")
        node = params[sub[i]]
        w = (node["kernel"].T if "kernel" in node else node["scale"]) if leaf == "weight" else node["bias"]
        sd[name] = torch.from_numpy(np.ascontiguousarray(w)).to(dtype)
    net.load_state_dict(sd, strict=True)
    return net


def _offset_net(rng, in_dim: int, dim: int, dtype: torch.dtype) -> torch.nn.Module:
    return _load_offset_net(_offset_params(rng, in_dim, dim), in_dim, dim, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("g,cg", [(1, 7), (2, 5), (3, 6)])
def test_grouped_plain_equals_the_old_composition(dtype, g, cg):
    local, offset, v_pos, v = _inputs(10 * g + cg, g, cg, DTYPES[dtype])
    want, want_idx, want_w = _old_interpolation(local, offset, v_pos, v)
    pos, off = local.reshape(B, N * K_NBR, 3), offset.reshape(B, g, N * K_NBR, 3)
    out, idx, w = ops.three_nn_interpolate_grouped_plain(pos, off, v_pos, v)
    assert out.dtype == DTYPES[dtype] and out.shape == (B, N * K_NBR, g * cg)
    assert torch.equal(out.reshape(B, N, K_NBR, g * cg), want)
    assert idx.shape == w.shape == (B, g, N * K_NBR, 3)
    assert torch.equal(idx.reshape(B * g, N * K_NBR, 3), want_idx)
    assert torch.equal(w.reshape(B * g, N * K_NBR, 3), want_w)
    # the queries on known points: the point itself first, weight about 1
    on = idx.reshape(B, g, N, K_NBR, 3)[:, :, :, 0, 0]
    assert bool((w.reshape(B, g, N, K_NBR, 3)[:, :, :, 0, 0] > 1 - 1e-5).all())
    assert torch.equal(torch.gather(v_pos, 1, on.reshape(B, -1, 1).expand(-1, -1, 3)),
                       local[:, :, 0][:, None].expand(B, g, N, 3).reshape(B, -1, 3))
    # the autograd entry is the plain version on the CPU
    assert torch.equal(ops.three_nn_interpolate_grouped(pos, off, v_pos, v), out)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("g,cg", [(1, 7), (2, 5), (3, 6)])
def test_grouped_gradient_equals_the_old_composition(dtype, g, cg):
    local, offset, v_pos, v = _inputs(20 + g, g, cg, DTYPES[dtype])
    cot = torch.from_numpy(np.random.RandomState(3 + g).randn(B, N, K_NBR, g * cg)).to(v.dtype)
    grads = []
    for run in ("old", "new"):
        vv = v.clone().requires_grad_()
        if run == "old":
            out = _old_interpolation(local, offset, v_pos, vv)[0]
        else:
            out = ops.three_nn_interpolate_grouped(local.reshape(B, -1, 3), offset.reshape(B, g, -1, 3),
                                                   v_pos, vv).reshape(B, N, K_NBR, g * cg)
        out.backward(cot)
        grads.append(vv.grad)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("g,scale_by_bbox", [(1, True), (2, False), (2, True), (3, False)])
def test_grouped_deform_gather_equals_the_old_one(dtype, g, scale_by_bbox):
    """The module's deformable core, offsets from a seeded offset net: the
    output and the gradient in ``v`` bit-equal to the old composition's;
    the offset net gets no gradient either way."""
    cg = 4 if g == 2 else 5
    C = g * cg
    rng = np.random.RandomState(30 + g)
    local, _, v_pos, v = _inputs(40 + g, g, cg, DTYPES[dtype])
    q = torch.from_numpy(rng.randn(B, N, C)).to(v.dtype)
    v_off = torch.from_numpy(rng.randn(B, N, K_NBR, C)).to(v.dtype)
    net = _offset_net(rng, 2 * cg, C, v.dtype)
    cot = torch.from_numpy(rng.randn(B, N, K_NBR, C)).to(v.dtype)
    outs, grads = [], []
    for run in ("old", "new"):
        vv = v.clone().requires_grad_()
        if run == "old":
            cgv = C // g
            off_local = v_off.reshape(B, N, K_NBR, g, cgv).permute(0, 3, 1, 2, 4)
            group_q = q.reshape(B, N, g, cgv).permute(0, 2, 1, 3)
            feat = torch.cat([off_local, group_q[:, :, :, None].expand(B, g, N, K_NBR, cgv)], dim=-1)
            out = _old_interpolation(local, net(feat), v_pos, vv, scale_by_bbox)[0]
        else:
            out = local_attention.grouped_deform_gather(net, q, vv, v_off, local, v_pos, g, scale_by_bbox)
        out.backward(cot)
        outs.append(out.detach())
        grads.append(vv.grad)
        assert all(p.grad is None for p in net.parameters())
    assert torch.equal(outs[0], outs[1]) and torch.equal(grads[0], grads[1])


def test_grouped_gradient_matches_jax_custom_vjp(one_torch_thread):
    """float32: the gradient in ``v`` of a loss through the grouped op
    against ``jax.grad`` through the fused custom VJP (the Pallas kernel in
    the interpreter) on JAX's own group-major copies."""
    g, cg = 2, 12
    local, offset, v_pos, v = _inputs(5, g, cg, torch.float32)
    pos, off = local.reshape(B, -1, 3), offset.reshape(B, g, -1, 3)
    S = pos.shape[1]

    def loss(vj):
        shift = einops.rearrange(jnp.asarray(pos.numpy())[:, None] + jnp.asarray(off.numpy()),
                                 "b g s c -> (b g) s c")
        known = einops.repeat(jnp.asarray(v_pos.numpy()), "b m c -> (b g) m c", g=g)
        vg = einops.rearrange(vj, "b m (g c) -> (b g) m c", g=g)
        with pltpu.force_tpu_interpret_mode():
            out = jpo._three_nn_interpolate_fused(shift, known, vg, 1e-8)
        return jnp.sum(jnp.sin(einops.rearrange(out, "(b g) s c -> b s (g c)", g=g)))

    want = np.asarray(jax.grad(loss)(jnp.asarray(v.numpy())))
    vt = v.clone().requires_grad_()
    torch.sin(ops.three_nn_interpolate_grouped(pos, off, v_pos, vt)).sum().backward()
    assert vt.grad.shape == (B, M, g * cg) and S == N * K_NBR
    assert float(np.abs(vt.grad.numpy() - want).max() / np.abs(want).max()) < 1e-5


@pytest.mark.parametrize("g,scale_by_bbox", [(2, False), (1, True)])
def test_grouped_deform_gather_matches_jax_fp64(g, scale_by_bbox):
    """float64: the port's ``grouped_deform_gather`` against the JAX
    ``_grouped_deform_gather`` (its XLA 3-NN chain on the CPU) with the same
    numpy-seeded offset net weights."""
    cg = 6
    C, dim = g * cg, 16
    rng = np.random.RandomState(50 + g)
    local, _, v_pos, v = _inputs(60 + g, g, cg, torch.float64)
    q, v_off = rng.randn(B, N, C), rng.randn(B, N, K_NBR, C)
    params = _offset_params(rng, 2 * cg, dim)
    with x64():
        jnet = jla.OffsetNet(dim)
        want = np.asarray(jla._grouped_deform_gather(
            lambda x: jnet.apply({"params": params}, x), jnp.asarray(q), jnp.asarray(v.numpy()),
            jnp.asarray(v_off), jnp.asarray(local.numpy()), jnp.asarray(v_pos.numpy()), g, scale_by_bbox))
    net = _load_offset_net(params, 2 * cg, dim, torch.float64)
    got = local_attention.grouped_deform_gather(net, torch.from_numpy(q), v, torch.from_numpy(v_off),
                                                local, v_pos, g, scale_by_bbox)
    assert got.shape == want.shape == (B, N, K_NBR, C)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-9)


def test_grouped_op_refuses_what_it_cannot_take():
    local, offset, v_pos, v = _inputs(1, 2, 4, torch.float32)
    pos, off = local.reshape(B, -1, 3), offset.reshape(B, 2, -1, 3)
    with pytest.raises(ValueError, match="C % g"):
        ops.three_nn_interpolate_grouped(pos, off, v_pos, v[..., :7])
    with pytest.raises(ValueError, match="expected"):
        ops.three_nn_interpolate_grouped(pos, off[:, :, 1:], v_pos, v)
    with pytest.raises(ValueError, match="at least 3"):
        ops.three_nn_interpolate_grouped(pos, off, v_pos[:, :2], v[:, :2])
    # the dfeats plain version by groups is the ungrouped one on group-major copies
    w = torch.rand(B * 2, pos.shape[1], 3)
    idx = torch.randint(0, M, (B * 2, pos.shape[1], 3))
    cot = torch.randn(B, pos.shape[1], 8)
    got = ops.weighted_gather_sum_dfeats(w, idx, cot, M, groups=2)
    flat = cot.reshape(B, -1, 2, 4).permute(0, 2, 1, 3).reshape(B * 2, -1, 4)
    want = ops.weighted_gather_sum_dfeats(w, idx, flat, M).reshape(B, 2, M, 4).permute(0, 2, 1, 3)
    assert torch.equal(got, want.reshape(B, M, 8))
    with pytest.raises(ValueError, match="expected"):
        ops.weighted_gather_sum_dfeats(w, idx, cot[..., :7], M, groups=2)

"""The contracts of the deterministic row scatter-add and of the matmul-form
eval argmin on the tensor cores, on the CPU.

Scatter-add (``ops.scatter_add_rows``; kernel ``csrc/scatter_add_rows.cu``):
the card's kernel is held to the plain version's bits, so the plain version
must sum each output element in increasing source order. Here it is held,
bit for bit, to a Python loop that adds the sources one by one, and to the
kernel's two passes in numpy (a stable sort of the sources by destination
with each destination's offset, then a sum of each row in that order); and
to the JAX package's Pallas kernel in the interpreter
within float32 rounding (1e-5 of each element's sum of absolute
contributions: the one-hot matmuls add in another order).

Matmul-form argmin (``ops.nn_argmin_bidir_mxu``; kernel
``csrc/nn_bidir_mxu.cu``): the tensor cores add the cross term's nine
products in an order of their own, so the kernel is held to the plain
version by the JAX package's band (``tests/test_pallas_kernels.py:145``,
``benchmarks/kernels.py:180-197``): at least 99.9 % of the indices equal in
each direction, every selected distance within sqrt-abs 2e-3 of the exact
minimum, CD-L1 and CD-L2 x1000 recomputed from the indices within 1e-3.
Here the plain version with its cross term summed in float64 and rounded
once (the most exact order there is) must stay in that band, and on lattice
clouds (coordinates k/64, |k| <= 64: bf16-exact, so every product and sum
is exact in any order) the plain version must equal the Pallas interpreter
exactly, ties and first index included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from imgadapointr_tpu.ops.pallas.nn_distance import nn_argmin_bidir_mxu as jax_mxu
from imgadapointr_tpu.ops.pallas.scatter_rows import scatter_add_rows_pallas
from imgadapointr_tpu_torch import ops
from imgadapointr_tpu_torch.ops import chamfer
from test_torch_seg import one_torch_thread  # noqa: F401  (a fixture)

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- scatter-add


def _loop_sum(n_rows, idx, vals):
    """out[b, clamp(idx[b, s])] += vals[b, s], one source at a time in
    increasing s, in float32."""
    B, S, C = vals.shape
    out = torch.zeros(B, n_rows, C, dtype=torch.float32)
    d = idx.clamp(0, n_rows - 1)
    for b in range(B):
        for s in range(S):
            out[b, d[b, s]] += vals[b, s]
    return out


def _kernel_sum(n_rows, idx, vals):
    """The kernel's two passes in numpy/torch: each batch element's sources
    sorted stably by clamped destination (perm) with each destination's
    first place (offsets), then each row's sources added in perm order (all
    rows at once, position by position, so each row's sum keeps its
    order)."""
    B, S, C = vals.shape
    out = torch.zeros(B, n_rows, C, dtype=torch.float32)
    d = idx.clamp(0, n_rows - 1).numpy()
    for b in range(B):
        perm = np.argsort(d[b], kind="stable")
        offsets = np.concatenate([[0], np.cumsum(np.bincount(d[b], minlength=n_rows))])
        length = offsets[1:] - offsets[:-1]
        for k in range(int(length.max(initial=0))):
            rows = np.nonzero(length > k)[0]
            out[b, rows] += vals[b, perm[offsets[rows] + k]]
    return out


@pytest.mark.parametrize("B,rows,C,S,lo,hi", [
    (2, 512, 3, 16384, 0, 512),  # the coarse chamfer cross term: about 32 sources a row
    (2, 512, 3, 16384, 7, 8),  # every index equal: 16384 sources in one row
    (2, 100, 32, 3000, -5, 105),  # out-of-range indices clamp to the end rows
    (1, 4096, 384, 200, 0, 4096),  # most rows receive nothing
    (2, 2048, 32, 8192, 0, 2048),
    (3, 37, 64, 2000, 0, 37),
    (1, 5, 3, 1500, 0, 5),  # fewer rows than bins
])
def test_scatter_plain_sums_in_source_order(B, rows, C, S, lo, hi, one_torch_thread):
    rng = np.random.RandomState(rows + C + S)
    idx = _t(rng.randint(lo, hi, (B, S)))
    vals = _t(rng.randn(B, S, C).astype(np.float32))
    got = ops.scatter_add_rows(rows, idx, vals)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, rows, C)
    assert torch.equal(got, _loop_sum(rows, idx, vals))
    assert torch.equal(got, _kernel_sum(rows, idx, vals))


@pytest.mark.parametrize("B,rows,C,S,idx_hi", [(2, 512, 3, 2048, 512), (1, 300, 8, 1000, 40)])
def test_scatter_agrees_with_pallas_interpreter_within_rounding(B, rows, C, S, idx_hi):
    rng = np.random.RandomState(S)
    idx = rng.randint(0, idx_hi, (B, S))
    vals = rng.randn(B, S, C).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(scatter_add_rows_pallas(rows, jnp.asarray(idx, jnp.int32), jnp.asarray(vals)))
    got = ops.scatter_add_rows(rows, _t(idx), _t(vals)).numpy()
    room = 1e-5 * ops.scatter_add_rows(rows, _t(idx), _t(np.abs(vals))).numpy()
    assert np.all(np.abs(got - want) <= room)


# -------------------------------------------------- matmul-form argmin band


def _lattice(rng, b, n):
    return (rng.randint(-64, 65, (b, n, 3)) / 64).astype(np.float32)


def _sphere(rng, b, n):
    v = rng.randn(b, n, 3)
    return (0.5 * v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("B,N,M", [(2, 300, 420), (1, 700, 1500), (2, 1025, 130)])
def test_mxu_plain_equals_pallas_on_lattices(B, N, M):
    """Lattices are dense in ties (N + M points on 129^3 sites, many at equal
    distances), so this pins the first index both ways."""
    rng = np.random.RandomState(N + M)
    x, y = _lattice(rng, B, N), _lattice(rng, B, M)
    h = N // 2
    x[:, N - h:] = x[:, :h]  # exact duplicates: the first copy wins
    with pltpu.force_tpu_interpret_mode():
        j1, j2 = (np.asarray(a) for a in jax_mxu(jnp.asarray(x), jnp.asarray(y)))
    i1, i2 = (a.numpy() for a in ops.nn_argmin_bidir_mxu(_t(x), _t(y)))
    np.testing.assert_array_equal(i1, j1)
    np.testing.assert_array_equal(i2, j2)
    assert np.all(i2 < N - h)


def _float64_cross_argmin(x, y):
    """The plain version with its cross term summed in float64 and rounded
    once to float32: what the tensor cores would give if they added the
    nine products exactly."""
    xh, xl, xs = chamfer._mxu_split(x)
    yh, yl, ys = chamfer._mxu_split(y)
    d64 = lambda a, b: torch.einsum("bnc,bmc->bnm", a.double(), b.double())  # noqa: E731
    cross = (d64(xh, yh) + d64(xh, yl) + d64(xl, yh)).float()
    d = (xs[:, :, None] - 2.0 * cross) + ys[:, None, :]
    return d.argmin(-1), d.argmin(1)


def _band(x, y, i1, i2, p1, p2):
    """Assert the JAX package's band of (i1, i2) against (p1, p2)."""
    assert float((i1 == p1).double().mean()) >= 0.999 and float((i2 == p2).double().mean()) >= 0.999
    xd, yd = x.double(), y.double()
    e1, e2 = ops.nn_bidir_argmin(xd, yd)

    def sel(q, r, i):
        return ((q - torch.gather(r, 1, i[..., None].expand(-1, -1, 3))) ** 2).sum(-1)

    d1, d2, t1, t2 = sel(xd, yd, i1), sel(yd, xd, i2), sel(xd, yd, e1), sel(yd, xd, e2)
    assert max(float((d1.sqrt() - t1.sqrt()).abs().max()), float((d2.sqrt() - t2.sqrt()).abs().max())) < 2e-3
    cd_l1 = lambda a, b: float((a.sqrt().mean() + b.sqrt().mean()) / 2 * 1000)  # noqa: E731
    cd_l2 = lambda a, b: float((a.mean() + b.mean()) * 1000)  # noqa: E731
    assert abs(cd_l1(d1, d2) - cd_l1(t1, t2)) < 1e-3
    assert abs(cd_l2(d1, d2) - cd_l2(t1, t2)) < 1e-3


@pytest.mark.parametrize("kind,B,N,M", [("sphere", 2, 1024, 1100), ("sphere", 1, 4096, 4095),
                                        ("random", 2, 257, 1500), ("lattice", 2, 600, 700)])
def test_mxu_band_covers_any_accumulation_order(kind, B, N, M):
    rng = np.random.RandomState(N * M)
    make = {"sphere": _sphere, "lattice": _lattice,
            "random": lambda r, b, n: r.randn(b, n, 3).astype(np.float32)}[kind]
    x, y = _t(make(rng, B, N)), _t(make(rng, B, M))
    p1, p2 = ops.nn_argmin_bidir_mxu(x, y)
    f1, f2 = _float64_cross_argmin(x, y)
    _band(x, y, f1, f2, p1, p2)
    if kind == "lattice":  # every sum exact: the same indices, whatever the order
        assert torch.equal(f1, p1) and torch.equal(f2, p2)

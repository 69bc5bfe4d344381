"""The port's gridding ops (``imgadapointr_tpu_torch/ops/gridding.py``) against
``imgadapointr_tpu/ops/gridding.py``, on the CPU in float64.

Clouds reach past the grid (coordinates up to 1.3 where the grid spans
[-1, 1]) and carry zero-padded rows; every value is held to 1e-12 and
every VJP (of a fixed random weighting of the output) to 1e-12 of its
largest entry. GRNet's 3-D convolutions are held to flax's here too: a
``ConvTranspose3d`` carrying a flax ``ConvTranspose(k4, s2, 'SAME')`` kernel
through the converter's flip, and ``Conv3d(k=4, padding=2)`` growing a
volume by one before the floor pool, on odd-sized volumes.
"""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from imgadapointr_tpu_torch.ops import gridding as pg
from imgadapointr_tpu_torch.tools.convert import conv3d_weight, conv_transpose3d_weight
from test_torch_seg import x64

jg = importlib.import_module("imgadapointr_tpu.ops.gridding")  # the package exports a function of that name
ATOL = 1e-12


def cloud(seed: int, B: int = 2, N: int = 60, reach: float = 1.3, zeros: int = 7) -> np.ndarray:
    """B clouds of N points in [-reach, reach]³, the last ``zeros`` rows of
    the first cloud zero (padding)."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-reach, reach, (B, N, 3))
    pts[0, N - zeros:] = 0.0
    return pts


def vjp_pair(jax_fn, torch_fn, args, wrt, seed: int):
    """(JAX value, port value, JAX VJP, port VJP) of ``sum(out * W)`` for a
    numpy-seeded W, in the arguments ``wrt``."""
    with x64():
        jargs = [jnp.asarray(a) for a in args]
        want = jax_fn(*jargs)
        weight = np.asarray(np.random.RandomState(seed).randn(*want.shape))

        def loss(*ws):
            full = list(jargs)
            for i, w in zip(wrt, ws):
                full[i] = w
            return jnp.sum(jax_fn(*full) * weight)

        jgrads = jax.grad(loss, argnums=tuple(range(len(wrt))))(*[jargs[i] for i in wrt])
    targs = [torch.tensor(a, requires_grad=i in wrt) for i, a in enumerate(args)]
    got = torch_fn(*targs)
    (got * torch.from_numpy(weight)).sum().backward()
    return np.asarray(want), got.detach().numpy(), [np.asarray(g) for g in jgrads], [targs[i].grad.numpy()
                                                                                     for i in wrt]


def assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * max(float(np.abs(want).max()), 1.0))


@pytest.mark.parametrize("scale", [8, 16])
def test_gridding_values_and_vjp(scale):
    pts = cloud(scale)
    want, got, jgrad, pgrad = vjp_pair(lambda p: jg.gridding(p, scale), lambda p: pg.gridding(p, scale),
                                       [pts], [0], seed=1)
    assert got.shape == (2, scale, scale, scale)
    assert_close(got, want)
    assert_close(pgrad[0], jgrad[0])
    # points past the grid lose corners; a zero row adds nothing and gets no gradient
    inside = np.abs(pts * (scale // 2)).max(-1) < scale // 2 - 1
    assert 0 < inside.sum() < pts.shape[0] * pts.shape[1] - 7
    assert float(np.abs(pgrad[0][0, -7:]).max()) == 0.0
    np.testing.assert_allclose(got.sum(axis=(1, 2, 3)), want.sum(axis=(1, 2, 3)), rtol=1e-12)


def test_gridding_reverse_values_and_vjp():
    s = 8
    rng = np.random.RandomState(3)
    grid = rng.uniform(0, 1, (2, s, s, s)) * (rng.uniform(0, 1, (2, s, s, s)) < 0.3)  # mostly empty cells
    want, got, jgrad, pgrad = vjp_pair(lambda g: jg.gridding_reverse(g, s), lambda g: pg.gridding_reverse(g, s),
                                       [grid], [0], seed=4)
    assert got.shape == (2, s**3, 3)
    assert_close(got, want)
    assert_close(pgrad[0], jgrad[0])
    assert 0 < int((np.abs(got).sum(-1) == 0).sum()) < 2 * s**3  # empty cells give (0, 0, 0)


@pytest.mark.parametrize("s,C", [(8, 5), (4, 3)])
def test_cubic_feature_sampling_values_and_vjp(s, C):
    pts = cloud(s + C, N=40, reach=1.2)
    feats = np.random.RandomState(5).randn(2, s, s, s, C)
    want, got, jgrad, pgrad = vjp_pair(jg.cubic_feature_sampling, pg.cubic_feature_sampling,
                                       [pts, feats], [1], seed=6)
    assert got.shape == (2, 40, 8, C)
    assert_close(got, want)
    assert_close(pgrad[0], jgrad[0])
    assert int((got == 0).all(-1).sum()) > 0  # vertices past the grid read 0


def test_gridding_distance_and_loss():
    pred, gt = cloud(11, N=50, reach=0.9), cloud(12, N=70, reach=0.9, zeros=0)
    for scale in (8, 16):
        with x64():
            wp, wg, wn = jg.gridding_distance(jnp.asarray(pred), jnp.asarray(gt), scale)
        gp, gg, n = pg.gridding_distance(torch.from_numpy(pred), torch.from_numpy(gt), scale)
        assert_close(gp.numpy(), np.asarray(wp))
        assert_close(gg.numpy(), np.asarray(wg))
        assert float(n) == float(wn)
    want, got, jgrad, pgrad = vjp_pair(
        lambda p, g: jg.gridding_loss(p, g, [8, 16], [0.1, 0.3]),
        lambda p, g: pg.gridding_loss(p, g, [8, 16], [0.1, 0.3]), [pred, gt], [0], seed=0)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert float(want) > 0
    assert_close(pgrad[0], jgrad[0])
    # a box past the static buffer warns (the JAX op prints)
    far = pred.copy()
    far[0, 0] = 3.0
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        pg.gridding_distance(torch.from_numpy(far), torch.from_numpy(gt), 8)
    assert any("exceeds the buffer" in str(w.message) for w in seen)


@pytest.mark.parametrize("D", [5, 7])
def test_conv3d_layers_match_flax(D):
    """Conv3d(k=4, padding=2) then the 2x floor pool, and ConvTranspose3d(k4,
    s2, p1) with the converter's weights against flax Conv and
    ConvTranspose(k4, s2, 'SAME'), on (1, D, D+2, D+1, 3) volumes."""
    rng = np.random.RandomState(D)
    x = rng.randn(1, D, D + 2, D + 1, 3)
    k_conv, b_conv = rng.randn(4, 4, 4, 3, 6), rng.randn(6)
    k_t = rng.randn(4, 4, 4, 3, 5)
    with x64():
        jx = jnp.asarray(x)
        conv = fnn.Conv(6, (4, 4, 4), padding=2).apply({"params": {"kernel": jnp.asarray(k_conv),
                                                                    "bias": jnp.asarray(b_conv)}}, jx)
        want_conv = np.asarray(fnn.max_pool(conv, (2, 2, 2), strides=(2, 2, 2)))
        want_t = np.asarray(fnn.ConvTranspose(5, (4, 4, 4), strides=(2, 2, 2), padding="SAME", use_bias=False)
                            .apply({"params": {"kernel": jnp.asarray(k_t)}}, jx))
    tx = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    c = torch.nn.Conv3d(3, 6, 4, padding=2).double()
    t = torch.nn.ConvTranspose3d(3, 5, 4, stride=2, padding=1, bias=False).double()
    with torch.no_grad():
        c.weight.copy_(torch.from_numpy(conv3d_weight(k_conv).copy()))
        c.bias.copy_(torch.from_numpy(b_conv))
        t.weight.copy_(torch.from_numpy(conv_transpose3d_weight(k_t).copy()))
        grown = c(tx)
        got_conv = torch.nn.functional.max_pool3d(grown, 2).permute(0, 2, 3, 4, 1).numpy()
        got_t = t(tx).permute(0, 2, 3, 4, 1).numpy()
    assert tuple(grown.shape[2:]) == (D + 1, D + 3, D + 2)
    assert got_conv.shape == want_conv.shape == (1, (D + 1) // 2, (D + 3) // 2, (D + 2) // 2, 6)
    assert got_t.shape == want_t.shape == (1, 2 * D, 2 * D + 4, 2 * D + 2, 5)
    np.testing.assert_allclose(got_conv, want_conv, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_t, want_t, rtol=0, atol=1e-12)

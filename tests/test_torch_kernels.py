"""The port's ten CUDA kernels against their plain PyTorch versions.

These need an NVIDIA GPU and ``nvcc`` (the kernels are built from
``imgadapointr_tpu_torch/csrc`` at first use); elsewhere each test skips
with its reason. The file imports neither JAX nor the JAX package, so on a
machine with a card it runs on its own:

    python -m pytest tests/test_torch_kernels.py -q --noconftest

Tolerance: none, but for the scatter-add and the weighted gather-sum with
its two backward kernels. Every other kernel repeats its plain version's
arithmetic (diff-form distances without FMA contraction, first index on
ties), so indices are equal and values bit-equal. The scatter-add and the
gather-sum's ``dfeats`` sum with float32 atomics in no fixed order: they
are held to 1e-5 of each element's sum of absolute contributions, and the
scatter-add to bit-equality where every row receives one contribution. The
weighted gather-sum and its ``dweights`` add with fused multiply-adds in a
fixed order, the plain versions with PyTorch's reductions: 1e-5 of each
element's sum of absolute terms.
"""

import pytest
import torch

from imgadapointr_tpu_torch import ops
from imgadapointr_tpu_torch.ops import _build


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cloud(g, *shape, device):
    return torch.randn(*shape, generator=g).to(device)


def _sphere(g, b, n, device):
    v = torch.randn(b, n, 3, generator=g)
    return (0.5 * v / v.norm(dim=-1, keepdim=True)).to(device)


def _launched(kernel, fn):
    before = _build.launches()[kernel]
    out = fn()
    torch.cuda.synchronize()
    assert _build.launches()[kernel] == before + 1
    return out


@pytest.mark.parametrize("B,S,M,k", [(2, 2048, 2048, 16), (2, 512, 256, 8), (3, 100, 70, 64), (1, 33, 5, 5)])
def test_knn_kernel_equals_plain(dev, B, S, M, k):
    g = torch.Generator().manual_seed(S + M + k)
    ref, q = _cloud(g, B, M, 3, device=dev), _cloud(g, B, S, 3, device=dev)
    d, i = _launched("knn", lambda: ops.knn_with_distance(k, ref, q))
    pd, pi = ops.knn_plain(k, ref, q)
    assert torch.equal(i, pi)
    assert torch.equal(d, pd)


def test_knn_kernel_ties_and_limits(dev):
    base = torch.randn(1, 6, 3, generator=torch.Generator().manual_seed(0))
    ref = base.repeat(1, 4, 1).to(dev)  # every point four times
    d, i = ops.knn_with_distance(12, ref, ref[:, :6].contiguous())
    pd, pi = ops.knn_plain(12, ref, ref[:, :6])
    assert torch.equal(i, pi)
    with pytest.raises(ValueError):
        ops.knn_with_distance(65, ref.repeat(1, 4, 1), ref)  # k > 64
    with pytest.raises(ValueError):
        ops.knn_with_distance(25, ref, ref)  # k > M
    with pytest.raises(TypeError):
        ops.knn_with_distance(4, ref.double(), ref.double())
    with pytest.raises(ValueError):  # a host pointer never reaches the kernel
        ops.knn_with_distance(4, ref, ref.cpu())


@pytest.mark.parametrize("B,N,npoint", [(4, 2048, 512), (4, 512, 256), (2, 2048, 256), (3, 5000, 64)])
def test_fps_kernel_equals_plain(dev, B, N, npoint):
    xyz = _cloud(torch.Generator().manual_seed(N), B, N, 3, device=dev)
    got = _launched("fps", lambda: ops.furthest_point_sample(xyz, npoint))
    assert torch.equal(got, ops.fps_plain(xyz, npoint))


def test_fps_kernel_identical_points(dev):
    xyz = torch.ones(2, 2048, 3, device=dev)
    assert torch.equal(ops.furthest_point_sample(xyz, 64), torch.zeros(2, 64, dtype=torch.int64, device=dev))


@pytest.mark.parametrize("M,C,S", [(2048, 3, 4096), (512, 64, 8192), (256, 384, 2048), (16384, 3, 16384), (100, 5, 300)])
def test_gather_kernel_clamps_like_plain(dev, M, C, S):
    g = torch.Generator().manual_seed(M + C)
    table = _cloud(g, 2, M, C, device=dev)
    idx = torch.randint(-3, M + 3, (2, S), generator=g).to(dev)
    idx[:, :3] = torch.tensor([-1, M, M + 1000])
    got = _launched("gather_rows", lambda: ops.gather_rows(table, idx))
    assert torch.equal(got, ops.gather_rows_plain(table, idx))
    assert torch.equal(got[:, 0], table[:, 0]) and torch.equal(got[:, 1], table[:, M - 1])


def test_gather_kernel_refuses_what_it_cannot_take(dev):
    table = torch.zeros(1, 8, 4, device=dev)
    idx = torch.zeros(1, 3, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        ops.gather_rows(table.double(), idx)
    with pytest.raises(ValueError):
        ops.gather_rows(table.transpose(1, 2), idx)
    with pytest.raises(ValueError):
        ops.gather_rows(table, idx.cpu())


@pytest.mark.parametrize("kind", ["random", "sphere"])
def test_nn_bidir_kernel_equals_plain(dev, kind):
    g = torch.Generator().manual_seed(7)
    if kind == "random":
        x, y = _cloud(g, 2, 16384, 3, device=dev), _cloud(g, 2, 12000, 3, device=dev)
    else:
        x, y = _sphere(g, 2, 16384, dev), _sphere(g, 2, 16384, dev)
    i1, i2 = _launched("nn_bidir_argmin", lambda: ops.nn_bidir_argmin(x, y))
    p1, p2 = ops.nn_bidir_argmin_plain(x, y)
    assert torch.equal(i1, p1) and torch.equal(i2, p2)


def test_nn_bidir_kernel_identical_clouds(dev):
    x = _cloud(torch.Generator().manual_seed(1), 2, 16384, 3, device=dev)
    i1, i2 = ops.nn_bidir_argmin(x, x.clone())
    ident = torch.arange(16384, device=dev).expand(2, -1)
    assert torch.equal(i1, ident) and torch.equal(i2, ident)
    assert float(ops.chamfer_l1(x, x.clone())) < 1e-9


@pytest.mark.parametrize("rows,C,S", [(16384, 3, 16384), (512, 3, 16384), (2048, 32, 8192),
                                      (256, 384, 4608), (100, 5, 300)])
def test_scatter_add_kernel_agrees_with_plain(dev, rows, C, S):
    g = torch.Generator().manual_seed(rows + C)
    idx = torch.randint(-3, rows + 3, (2, S), generator=g).to(dev)  # clamped like the gather
    vals = _cloud(g, 2, S, C, device=dev)
    got = _launched("scatter_add_rows", lambda: ops.scatter_add_rows(rows, idx, vals))
    want = ops.scatter_add_rows_plain(rows, idx, vals)
    room = 1e-5 * ops.scatter_add_rows_plain(rows, idx, vals.abs())
    assert bool(((got - want).abs() <= room).all())


@pytest.mark.parametrize("n,C", [(16384, 3), (4096, 384), (777, 7)])
def test_scatter_add_kernel_permutation_is_bit_equal(dev, n, C):
    g = torch.Generator().manual_seed(n)
    idx = torch.stack([torch.randperm(n, generator=g) for _ in range(2)]).to(dev)
    vals = _cloud(g, 2, n, C, device=dev)
    got = ops.scatter_add_rows(n, idx, vals)
    assert torch.equal(got, ops.scatter_add_rows_plain(n, idx, vals))
    assert torch.equal(ops.gather_rows(got, idx), vals)


def test_scatter_add_kernel_refuses_what_it_cannot_take(dev):
    idx = torch.zeros(1, 3, dtype=torch.int64, device=dev)
    vals = torch.zeros(1, 3, 4, device=dev)
    with pytest.raises(TypeError):
        ops.scatter_add_rows(8, idx, vals.double())
    with pytest.raises(ValueError):
        ops.scatter_add_rows(8, idx.cpu(), vals)
    with pytest.raises(ValueError):
        ops.scatter_add_rows(8, idx, vals.transpose(1, 2).contiguous().transpose(1, 2))


def test_gather_kernel_backward_is_the_scatter_kernel(dev):
    g = torch.Generator().manual_seed(3)
    table = _cloud(g, 2, 512, 64, device=dev).requires_grad_()
    idx = torch.randint(0, 512, (2, 4096), generator=g).to(dev)
    weight = _cloud(g, 2, 4096, 64, device=dev)
    out = ops.gather_rows(table, idx)
    _launched("scatter_add_rows", lambda: out.backward(weight))
    want = ops.scatter_add_rows_plain(512, idx, weight)
    room = 1e-5 * ops.scatter_add_rows_plain(512, idx, weight.abs())
    assert bool(((table.grad - want).abs() <= room).all())


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_nn_one_direction_kernel_equals_plain(dev, masked):
    g = torch.Generator().manual_seed(11)
    x, y = _sphere(g, 2, 16384, dev), _sphere(g, 2, 12000, dev)
    wy = (torch.rand(2, 12000, generator=g) > 0.5).float().to(dev) if masked else None
    got = _launched("nn_one_direction", lambda: ops.nn_one_direction(x, y, wy))
    assert torch.equal(got, ops.nn_one_direction_plain(x, y, wy))
    if masked:
        assert bool(wy.gather(1, got).eq(1).all())
        assert bool(ops.nn_one_direction(x, y, torch.zeros_like(wy)).eq(0).all())
    else:  # the same device code as the bidirectional kernel: the same index
        assert torch.equal(got, ops.nn_bidir_argmin(x, y)[0])


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_nn_distance_gradients_agree_with_plain_path(dev, masked):
    """Values and both input gradients of ``nn_distance`` on the card (the
    kernels) against the same Function on the CPU (the plain versions), in
    float32: indices equal, distances to float32 rounding, gradients to
    1e-5 of their largest."""
    g = torch.Generator().manual_seed(13)
    x, y = torch.randn(2, 3000, 3, generator=g), torch.randn(2, 5000, 3, generator=g)
    w = ((torch.rand(2, 3000, generator=g) > 0.3).float(), (torch.rand(2, 5000, generator=g) > 0.3).float())
    g1, g2 = torch.randn(2, 3000, generator=g), torch.randn(2, 5000, generator=g)
    outs = {}
    for device in (dev, torch.device("cpu")):
        tx, ty = x.to(device).requires_grad_(), y.to(device).requires_grad_()
        tw = tuple(m.to(device) for m in w) if masked else (None, None)
        d1, d2, i1, i2 = ops.nn_distance(tx, ty, *tw)
        torch.autograd.backward([d1, d2], [g1.to(device), g2.to(device)])
        outs[device.type] = [t.detach().cpu() for t in (d1, d2, i1, i2, tx.grad, ty.grad)]
    for a, b in zip(outs["cuda"][2:4], outs["cpu"][2:4]):
        assert torch.equal(a, b)
    for a, b in zip(outs["cuda"][:2], outs["cpu"][:2]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    for a, b in zip(outs["cuda"][4:], outs["cpu"][4:]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("B,S,K,M,C", [(8, 512, 63, 512, 64), (2, 100, 7, 50, 3), (3, 77, 40, 130, 12),
                                       (1, 64, 70, 64, 1000), (2, 33, 5, 20, 1100), (2, 5, 0, 9, 8)])
def test_weighted_gather_sum_kernel_agrees_with_plain(dev, B, S, K, M, C):
    """GDANet's shape (K 63, C 64), narrow and odd widths, K over one
    staged chunk, widths past one block's threads, K = 0; a third of the
    indices out of range, which contribute nothing."""
    g = torch.Generator().manual_seed(S + K + C)
    w = _cloud(g, B, S, K, device=dev)
    idx = torch.randint(-M // 2, M + M // 2, (B, S, K), generator=g).to(dev)
    feats = _cloud(g, B, M, C, device=dev)
    got = _launched("weighted_gather_sum", lambda: ops.weighted_gather_sum(w, idx, feats))
    want = ops.weighted_gather_sum_plain(w, idx, feats)
    room = 1e-5 * ops.weighted_gather_sum_plain(w.abs(), idx, feats.abs())
    assert bool(((got - want).abs() <= room).all())
    dropped = ops.weighted_gather_sum(w.masked_fill((idx >= 0) & (idx < M), 0.0), idx, feats)
    assert int(dropped.count_nonzero()) == 0


def test_weighted_gather_sum_kernel_refuses_what_it_cannot_take(dev):
    """The backward on the card: the two backward kernels launch once each
    and agree with the same Function on the CPU; then what the wrappers
    refuse."""
    g = torch.Generator().manual_seed(3)
    w, feats = torch.rand(2, 64, 63, generator=g), torch.randn(2, 64, 64, generator=g)
    idx = torch.randint(-8, 72, (2, 64, 63), generator=g)
    cot = torch.randn(2, 64, 64, generator=g)
    grads = {}
    for device in (dev, torch.device("cpu")):
        tw, tf = w.to(device).requires_grad_(), feats.to(device).requires_grad_()
        out = ops.weighted_gather_sum(tw, idx.to(device), tf)
        before = _build.launches()
        # a non-contiguous cotangent, as autograd may hand one to the backward
        out.backward(cot.to(device).transpose(1, 2).contiguous().transpose(1, 2))
        if device.type == "cuda":
            torch.cuda.synchronize()
            for name in ("weighted_gather_sum_dfeats", "weighted_gather_sum_dweights"):
                assert _build.launches()[name] == before[name] + 1
        grads[device.type] = (tw.grad.cpu(), tf.grad.cpu())
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    w = torch.ones(1, 4, 3, device=dev)
    idx = torch.zeros(1, 4, 3, dtype=torch.int64, device=dev)
    feats = torch.ones(1, 5, 8, device=dev)
    with pytest.raises(TypeError):
        ops.weighted_gather_sum(w.double(), idx, feats.double())
    with pytest.raises(ValueError):
        ops.weighted_gather_sum(w, idx.cpu(), feats)
    with pytest.raises(ValueError):
        ops.weighted_gather_sum(w, idx, feats.transpose(1, 2).contiguous().transpose(1, 2))


@pytest.mark.parametrize("B,S,K,M,C", [(16, 512, 63, 512, 64), (2, 100, 7, 50, 3), (3, 77, 40, 130, 12),
                                       (1, 64, 70, 64, 1000), (2, 33, 5, 20, 1100), (2, 9, 1, 9, 130)])
def test_weighted_gather_sum_backward_kernels_agree_with_plain(dev, B, S, K, M, C):
    """dfeats (float32 atomics: 1e-5 of each element's absolute sum) and
    dweights (a fixed shuffle order: 1e-5 of each element's absolute sum,
    and the same bits in two runs) at the superset's GDANet shape and odd
    widths; a third of the indices out of range."""
    g = torch.Generator().manual_seed(S + K + C + 1)
    w = _cloud(g, B, S, K, device=dev)
    idx = torch.randint(-M // 2, M + M // 2, (B, S, K), generator=g).to(dev)
    feats, cot = _cloud(g, B, M, C, device=dev), _cloud(g, B, S, C, device=dev)
    df = _launched("weighted_gather_sum_dfeats", lambda: ops.weighted_gather_sum_dfeats(w, idx, cot, M))
    room = 1e-5 * ops.weighted_gather_sum_dfeats_plain(w.abs(), idx, cot.abs(), M)
    assert bool(((df - ops.weighted_gather_sum_dfeats_plain(w, idx, cot, M)).abs() <= room).all())
    dw = _launched("weighted_gather_sum_dweights", lambda: ops.weighted_gather_sum_dweights(idx, cot, feats))
    room = 1e-5 * ops.weighted_gather_sum_dweights_plain(idx, cot.abs(), feats.abs())
    assert bool(((dw - ops.weighted_gather_sum_dweights_plain(idx, cot, feats)).abs() <= room).all())
    assert torch.equal(dw, ops.weighted_gather_sum_dweights(idx, cot, feats))
    invalid = (idx < 0) | (idx >= M)
    assert int(dw[invalid].count_nonzero()) == 0


@pytest.mark.parametrize("B,N,M", [(1, 16384, 16384), (2, 300, 400), (1, 128, 1500), (2, 1000, 1000)])
def test_auction_top2_kernel_equals_plain(dev, B, N, M):
    """Values bit-equal and indices equal on the live rows, with every row
    live and with a count per cloud."""
    g = torch.Generator().manual_seed(N + M)
    x, y = _cloud(g, B, N, 3, device=dev), _cloud(g, B, M, 3, device=dev)
    price = (torch.rand(B, M, generator=g) * 0.1).to(dev)
    want = ops.auction_top2_plain(x, y, price)
    got = _launched("auction_top2", lambda: ops.auction_top2(x, y, price))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    cnt = torch.tensor([N // 3, N][:B], device=dev)
    got = ops.auction_top2(x, y, price, cnt)
    for b in range(B):
        c = int(cnt[b])
        for a, w_ in zip(got, want):
            assert torch.equal(a[b, :c], w_[b, :c])

"""The port's twelve CUDA kernels against their plain PyTorch versions.

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


@pytest.mark.parametrize("B,N,M", [(1, 4097, 16383), (16, 512, 16384), (16, 16384, 512), (16, 2048, 2048),
                                   (3, 1, 700), (2, 33, 1)])
def test_nn_bidir_kernel_one_pass_shapes(dev, B, N, M):
    """N != M, sizes no tile divides, one point on either side, B = 1 and
    16: both directions equal to the plain version and to the
    one-direction kernel."""
    g = torch.Generator().manual_seed(B * N + M)
    x, y = _sphere(g, B, N, dev), _sphere(g, B, M, dev)
    i1, i2 = _launched("nn_bidir_argmin", lambda: ops.nn_bidir_argmin(x, y))
    assert i1.shape == (B, N) and i2.shape == (B, M) and i1.dtype == i2.dtype == torch.int64
    p1, p2 = ops.nn_bidir_argmin_plain(x, y)
    assert torch.equal(i1, p1) and torch.equal(i2, p2)
    assert torch.equal(i1, ops.nn_one_direction(x, y)) and torch.equal(i2, ops.nn_one_direction(y, x))


def test_nn_bidir_kernel_first_index_wins_ties(dev):
    """Clouds of duplicated points: every distance ties with another, and
    the first index must win in both directions."""
    g = torch.Generator().manual_seed(17)
    base = torch.randn(2, 1500, 3, generator=g)
    x = base.repeat(1, 3, 1)[:, torch.randperm(4500, generator=g)].contiguous().to(dev)
    y = torch.cat([base[:, :1000], base[:, 500:], base[:, :700]], dim=1).contiguous().to(dev)
    i1, i2 = ops.nn_bidir_argmin(x, y)
    p1, p2 = ops.nn_bidir_argmin_plain(x, y)
    assert torch.equal(i1, p1) and torch.equal(i2, p2)
    # an exact match at distance 0: the first copy in the other cloud
    yi = y.cpu()
    first = {tuple(v): j for j in reversed(range(yi.shape[1])) for v in [yi[0, j].tolist()]}
    assert [first[tuple(v)] for v in x[0].cpu().tolist()] == i1[0].cpu().tolist()
    xi = x.cpu()
    first = {tuple(v): j for j in reversed(range(xi.shape[1])) for v in [xi[0, j].tolist()]}
    assert [first[tuple(v)] for v in y[0].cpu().tolist()] == i2[0].cpu().tolist()


@pytest.mark.parametrize("C", [3, 5, 8, 32, 64, 384])
def test_gather_kernel_widths_aligned_and_not(dev, C):
    """Every row width, from a 16-byte aligned table and from a contiguous
    view that starts one float in (the kernel then moves single floats),
    with out-of-range indices clamped."""
    g = torch.Generator().manual_seed(C)
    B, M, S = 3, 1000, 5000
    flat = _cloud(g, B * M * C + 1, device=dev)
    idx = torch.randint(-5, M + 5, (B, S), generator=g).to(dev)
    idx[:, :3] = torch.tensor([-1, M, M + 10**6])
    for table in (flat[: B * M * C].view(B, M, C), flat[1:].view(B, M, C)):
        assert table.is_contiguous()
        got = _launched("gather_rows", lambda: ops.gather_rows(table, idx))
        assert torch.equal(got, ops.gather_rows_plain(table, idx))
        assert torch.equal(got[:, 0], table[:, 0]) and torch.equal(got[:, 1], table[:, M - 1])
        assert torch.equal(got[:, 2], table[:, M - 1])


def test_gather_kernel_no_grad_route_equals_autograd_route(dev):
    """The direct forward (no gradient can flow) and the autograd Function
    launch the same kernel once each and give the same bits."""
    g = torch.Generator().manual_seed(5)
    table = _cloud(g, 4, 2048, 32, device=dev)
    idx = torch.randint(0, 2048, (4, 8192), generator=g).to(dev)
    with torch.no_grad():
        direct = _launched("gather_rows", lambda: ops.gather_rows(table.requires_grad_(), idx))
    with torch.inference_mode():
        inference = _launched("gather_rows", lambda: ops.gather_rows(table, idx))
    graph = _launched("gather_rows", lambda: ops.gather_rows(table, idx))
    assert graph.requires_grad and not direct.requires_grad
    assert torch.equal(direct, graph) and torch.equal(inference, graph)


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
    else:  # the bidirectional kernel's distance bits and tie rule: the same index
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


@pytest.mark.parametrize("B,S,K,M,C", [
    (16, 512, 63, 512, 64), (2, 100, 7, 50, 3), (3, 77, 40, 130, 12), (1, 64, 70, 64, 1000),
    (2, 33, 5, 20, 1100), (2, 9, 1, 9, 130), (4, 200, 1, 512, 64),
    # wide tables, at a float4 width and at C = 3
    (2, 130, 63, 769, 64), (1, 70, 5, 16385, 3)])
def test_weighted_gather_sum_backward_kernels_agree_with_plain(dev, B, S, K, M, C):
    """dfeats (float32 atomics: 1e-5 of each element's absolute sum) and
    dweights (a fixed shuffle order: 1e-5 of each element's absolute sum,
    and the same bits in two runs) at the superset's GDANet shape, odd
    widths, K = 1, S off the kernel's 64-row tile and wide tables; a third
    of the indices out of range."""
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


@pytest.mark.parametrize("B,N,M,counts", [
    (1, 16384, 16384, None), (2, 300, 400, None), (1, 128, 1500, None), (2, 1000, 1000, None),
    # live counts that straddle the kernel's 512-row tiles, over the full
    # width and as the compacted width the auction hands in
    (1, 16384, 16384, (1060,)), (1, 1060, 16384, (1060,)), (2, 1500, 3000, (511, 1025)),
    (3, 1060, 4096, (0, 1, 1060)),
    # items below one chunk, and not a multiple of the chunk
    (1, 1060, 20, None), (1, 1060, 16379, None),
    # no bidders at all: nothing to launch on the card
    (2, 0, 100, None)])
@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "duplicated"])
def test_auction_top2_kernel_equals_plain(dev, B, N, M, counts, dup):
    """Values bit-equal and indices equal on the live rows, and the same
    bits in two runs, with every row live and with a count per cloud.
    ``duplicated``: the items repeat half a cloud apart at equal prices and
    some bidders sit on items, so equal values (exact ties) fall in
    different item chunks and meet in the kernel's merge."""
    g = torch.Generator().manual_seed(N + M)
    x, y = _cloud(g, B, N, 3, device=dev), _cloud(g, B, M, 3, device=dev)
    price = (torch.rand(B, M, generator=g) * 0.1).to(dev)
    if dup:
        h = (M + 1) // 2
        y = torch.cat([y[:, :h], y[:, :h]], dim=1)[:, :M].contiguous()
        price = torch.cat([price[:, :h], price[:, :h]], dim=1)[:, :M].contiguous()
        x[:, :min(N, h) // 2] = y[:, :min(N, h) // 2]
    want = ops.auction_top2_plain(x, y, price)
    for cnt in ([N] * B if counts is None else counts, [N // 3, N, N][:B]):
        c_t = torch.tensor(cnt, device=dev)
        got = _launched("auction_top2", lambda: ops.auction_top2(x, y, price, c_t))
        again = ops.auction_top2(x, y, price, c_t)
        for b, c in enumerate(cnt):
            for a, a2, w_ in zip(got, again, want):
                assert torch.equal(a[b, :c], w_[b, :c])
                assert torch.equal(a[b, :c], a2[b, :c])
    got = ops.auction_top2(x, y, price)  # no count: every row
    for a, w_ in zip(got, want):
        assert torch.equal(a, w_)


@pytest.mark.parametrize("B,N,M,C", [(16, 2048, 256, 192), (32, 4608, 576, 192), (16, 4096, 512, 384),
                                     (2, 100, 3, 5), (3, 77, 1500, 7)])
def test_three_nn_interpolate_kernel_equals_plain(dev, B, N, M, C):
    """Indices equal, weights and outputs bit-equal (the kernel repeats the
    plain version's roundings in its order), at the deformable blocks'
    shapes and at ragged ones (M = 3; C not a multiple of 4; M past one
    shared-memory tile)."""
    g = torch.Generator().manual_seed(N + M + C)
    u, k, f = _cloud(g, B, N, 3, device=dev), _cloud(g, B, M, 3, device=dev), _cloud(g, B, M, C, device=dev)
    out, idx, w = _launched("three_nn_interpolate", lambda: ops.pointops._three_nn_interpolate_forward(
        u, k, f, 1e-8))
    pout, pidx, pw = ops.three_nn_interpolate_plain(u, k, f)
    assert torch.equal(idx, pidx)
    assert torch.equal(w, pw) and torch.equal(out, pout)


def test_three_nn_interpolate_kernel_edges_and_backward(dev):
    g = torch.Generator().manual_seed(5)
    known = _cloud(g, 2, 576, 3, device=dev)
    feats = _cloud(g, 2, 576, 192, device=dev)
    # queries on known points (d = 0, weight about 1) and duplicated known points
    dup = torch.cat([known, known], dim=1)
    for kn, fe in ((known, feats), (dup, torch.cat([feats, feats], dim=1))):
        got = ops.pointops._three_nn_interpolate_forward(known[:, :100].contiguous(), kn, fe, 1e-8)
        want = ops.three_nn_interpolate_plain(known[:, :100], kn, fe)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert bool((got[2][..., 0] > 0.49).all())  # two copies at distance 0 share the weight
    # the public entry takes non-contiguous inputs; its backward is the dfeats kernel
    f = feats.transpose(1, 2).contiguous().transpose(1, 2).requires_grad_()
    before = _build.launches()["weighted_gather_sum_dfeats"]
    out = ops.three_nn_interpolate(known[:, ::2], known, f)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(6)).to(dev)
    out.backward(cot)
    torch.cuda.synchronize()
    assert _build.launches()["weighted_gather_sum_dfeats"] == before + 1
    _, idx, w = ops.three_nn_interpolate_plain(known[:, ::2], known, feats)
    want = ops.weighted_gather_sum_dfeats_plain(w, idx, cot, 576)
    room = 1e-5 * ops.weighted_gather_sum_dfeats_plain(w, idx, cot.abs(), 576)
    assert bool(((f.grad - want).abs() <= room).all())
    with pytest.raises(ValueError, match="at least 3"):
        ops.three_nn_interpolate(known, known[:, :2], feats[:, :2])
    with pytest.raises(TypeError):
        ops.pointops._three_nn_interpolate_forward(known.double(), known.double(), feats.double(), 1e-8)


@pytest.mark.parametrize("kind,B,N,M", [("sphere", 2, 16384, 16384), ("random", 2, 300, 4000),
                                        ("random", 1, 5, 3), ("sphere", 3, 1000, 999)])
def test_nn_bidir_mxu_kernel_equals_plain(dev, kind, B, N, M):
    g = torch.Generator().manual_seed(N + M)
    if kind == "sphere":
        x, y = _sphere(g, B, N, dev), _sphere(g, B, M, dev)
    else:
        x, y = _cloud(g, B, N, 3, device=dev), _cloud(g, B, M, 3, device=dev)
    i1, i2 = _launched("nn_bidir_mxu", lambda: ops.nn_argmin_bidir_mxu(x, y))
    p1, p2 = ops.nn_argmin_bidir_mxu_plain(x, y)
    assert torch.equal(i1, p1) and torch.equal(i2, p2)


def test_eval_entry_takes_the_mxu_kernel_under_the_flag(dev, monkeypatch):
    g = torch.Generator().manual_seed(3)
    x, y = _sphere(g, 2, 4096, dev), _sphere(g, 2, 4096, dev)
    monkeypatch.setenv("IMGADAPOINTR_ENABLE_MXU_EVAL_CHAMFER", "1")
    d1, d2, i1, i2 = _launched("nn_bidir_mxu", lambda: ops.nn_distance_eval(x, y))
    assert torch.equal(i1, ops.nn_argmin_bidir_mxu_plain(x, y)[0])
    e1, e2, _, _ = ops.nn_distance(x, y)
    assert float((d1 - e1).abs().max()) < 1e-5 and float((d2 - e2).abs().max()) < 1e-5
    monkeypatch.delenv("IMGADAPOINTR_ENABLE_MXU_EVAL_CHAMFER")
    _launched("nn_bidir_argmin", lambda: ops.nn_distance_eval(x, y))

"""The port's four CUDA kernels against their plain PyTorch versions.

These need an NVIDIA GPU and ``nvcc`` (the kernels are built from
``imgadapointr_tpu_torch/csrc`` at first use); elsewhere each test skips
with its reason. The file imports neither JAX nor the JAX package, so on a
machine with a card it runs on its own:

    python -m pytest tests/test_torch_kernels.py -q --noconftest

Tolerance: none. Every kernel repeats its plain version's arithmetic
(diff-form distances without FMA contraction, first index on ties), so
indices are equal and values bit-equal.
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.gather_rows(table.requires_grad_(), idx)


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

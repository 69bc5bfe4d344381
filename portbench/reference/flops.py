"""Model FLOPs of one cloud, counted from a configuration's widths: the
matrix products (every Linear, each attention's two products, GDANet's
distance products, the normals' covariances) and the ResNet18
convolutions, two FLOPs a multiply-add, in the form :mod:`.models` computes
them (an edge convolution over its (N, k, 2C) edge tensor). Elementwise
work, norms, pools, sorts and searches are not counted.

A training step counts the forward at its train-mode sizes (the 64 denoise
queries join the decoder) and the backward the reference's autograd runs:
the product that gives each input's gradient where the input needs one,
and each weight's gradient where the weight trains. So frozen GDANet adds
only its input gradient, the query ranking (only its sort's indices are
used) and GDANet's distance products (only their selections are used) add
nothing, and a layer on the raw points or the image computes no input
gradient. Nothing recomputed is counted.
"""

from __future__ import annotations

DENOISE = 64


class Count:
    """FLOPs of a forward and of its backward, term by term."""

    def __init__(self):
        self.fwd = 0.0
        self.bwd = 0.0

    def mm(self, rows: float, cin: float, cout: float, w_grad: bool = True, x_grad: bool = True) -> None:
        """A product (rows, cin) x (cin, cout): the forward, then the input's
        and the weight's gradient where each is needed."""
        f = 2.0 * rows * cin * cout
        self.fwd += f
        self.bwd += f * (int(w_grad) + int(x_grad))

    def linear(self, rows, cin, cout, frozen=False, x_grad=True):
        self.mm(rows, cin, cout, w_grad=not frozen, x_grad=x_grad)


def _mha(c: Count, n_q: int, n_kv: int, dim: int, proj_kv: bool = True, frozen: bool = False) -> None:
    """Projections of q (n_q rows), k and v (n_kv rows), the two attention
    products and the output projection."""
    c.linear(n_q, dim, dim, frozen)
    c.linear(n_kv, dim, dim, frozen)
    c.linear(n_kv, dim, dim, frozen)
    c.mm(n_q, dim, n_kv)  # q kᵀ, both operands need gradients
    c.mm(n_q, n_kv, dim)  # attention v
    c.linear(n_q, dim, dim, frozen)


def _block(c: Count, n: int, dim: int, mlp: int, graph: bool, k: int) -> None:
    """A self-attention block over n tokens, with the 'graph' branch."""
    _mha(c, n, n, dim)
    if graph:
        c.linear(n * k, 2 * dim, dim)
        c.linear(n, 2 * dim, dim)
    c.linear(n, dim, mlp)
    c.linear(n, mlp, dim)


def _fusion(c: Count, n: int, n_feat: int, feat_dim: int, dim: int) -> None:
    """The five-layer fusion stack of n tokens over n_feat features."""
    c.linear(n_feat, feat_dim, dim)
    for n_kv in (n_feat, n, n_feat, n, n):
        _mha(c, n, n_kv, dim)


def _resnet18(c: Count, size: int) -> None:
    def conv(h_out, cin, cout, kk, x_grad=True):
        c.mm(h_out * h_out, cin * kk * kk, cout, x_grad=x_grad)

    h = (size - 1) // 2 + 1
    conv(h, 3, 64, 7, x_grad=False)
    h = (h - 1) // 2 + 1  # max pool
    for _ in range(4):
        conv(h, 64, 64, 3)
    for cin, cout in ((64, 128), (128, 256)):
        h = (h - 1) // 2 + 1
        conv(h, cin, cout, 3)
        conv(h, cout, cout, 3)
        conv(h, cin, cout, 1)
        conv(h, cout, cout, 3)
        conv(h, cout, cout, 3)


def _gdanet(c: Count, n: int, k: int = 30) -> None:
    """Frozen GDANet's feature tap over n points, with the normals."""
    c.mm(n * 3, k, 3)  # the normals' covariances: (3, k) x (k, 3) a point
    f = dict(frozen=True)

    def dist(width):  # distance products: selections only, no gradient
        c.fwd += 2.0 * n * n * width

    dist(3)
    c.linear(n * k, 9, 64, **f)
    c.linear(n * k, 64, 64, **f)
    for block in (1, 2):
        if block == 2:
            dist(67)
            c.linear(n * k, 134, 64, **f)
            c.linear(n * k, 64, 64, **f)
        dist(64)  # the GDM's neighbours
        for _ in range(2):  # SGCAM over the n points and the n // 1 picked ones
            m = min(512, n)
            c.linear(m, 64, 32, **f)
            c.linear(n, 64, 32, **f)
            c.linear(m, 64, 32, **f)
            c.mm(n, 32, m)
            c.mm(n, m, 32)
            c.linear(n, 32, 64, **f)
        c.linear(n, 128, 64, **f)
    dist(131)
    c.linear(n * k, 262, 128, **f)
    c.linear(n * k, 128, 128, **f)
    c.linear(n, 128, 128, **f)
    c.linear(n, 256, 512, **f)
    c.linear(1, 16, 64, frozen=True, x_grad=False)
    c.linear(n, 832, 256, **f)
    c.linear(n, 256, 256, **f)
    c.linear(n, 256, 128, **f)


def count(cfg: dict, n_points: int, train: bool, superset: bool = False) -> Count:
    """FLOPs of one cloud of ``n_points`` through AdaPoinTr under its ``model``
    config ``cfg``; with ``superset``, ImgEncSegDecAPTr's branches too."""
    enc, dec = cfg["encoder_config"], cfg["decoder_config"]
    C = int(enc["embed_dim"])
    gfd = int(cfg["global_feature_dim"])
    n0, n1 = (int(v) for v in cfg["center_num"])
    Q = int(cfg["num_query"])
    factor = int(cfg["num_points"]) // Q
    ke, kd = int(enc.get("k", 10)), int(dec.get("k", 10))
    mlp_e, mlp_d = int(C * float(enc.get("mlp_ratio", 4.0))), int(C * float(dec.get("mlp_ratio", 4.0)))
    c = Count()
    kg = 16  # the DGCNN grouper's k
    # grouper
    c.linear(n_points, 3, 8, x_grad=False)
    c.linear(n_points * kg, 16, 32)
    c.linear(n0 * kg, 64, 64)
    c.linear(n0 * kg, 128, 64)
    c.linear(n1 * kg, 128, 128)
    T = n1
    c.linear(T, 3, 128, x_grad=False)
    c.linear(T, 128, C)
    c.linear(T, 128, 512)
    c.linear(T, 512, C)
    for style in enc["block_style_list"]:
        _block(c, T, C, mlp_e, "graph" in style, ke)
    if superset:
        _resnet18(c, int(cfg.get("img_size", 224)))
        h = int(cfg.get("img_size", 224))
        for _ in range(4):
            h = (h - 1) // 2 + 1
        _fusion(c, T, 256, h * h, C)
    c.linear(T, C, 1024)
    c.linear(T, 1024, gfd)
    c.linear(1, gfd, 1024)
    c.linear(1, 1024, 3 * Q)
    n_cand = Q + Q // 2
    for cin, cout in ((3, 256), (256, 256), (256, 1)):  # the ranking: indices only
        c.fwd += 2.0 * n_cand * cin * cout
    nq = Q + (DENOISE if train else 0)
    c.linear(nq, gfd + 3, 1024)
    c.linear(nq, 1024, 1024)
    c.linear(nq, 1024, C)
    for s, x in zip(dec["self_attn_block_style_list"], dec["cross_attn_block_style_list"]):
        _mha(c, nq, nq, C)
        if "graph" in s:
            c.linear(nq * kd, 2 * C, C)
            c.linear(nq, 2 * C, C)
        _mha(c, nq, T, C)
        if "graph" in x:
            c.linear(nq * kd, 2 * C, C)
            c.linear(nq, 2 * C, C)
        c.linear(nq, C, mlp_d)
        c.linear(nq, mlp_d, C)
    if superset:
        _gdanet(c, Q)
        _fusion(c, Q, Q, 128, C)
    c.linear(nq, C, 1024)
    c.linear(nq, 1024, 1024)
    c.linear(nq, 1024 + C + 3, C)
    c.linear(nq, 2 * C, 512)
    c.linear(nq, 512, 3 * factor)
    return c


def step_flops(cfg: dict, n_points: int, train: bool, superset: bool = False) -> float:
    """FLOPs of one cloud: the forward, plus the backward in training."""
    c = count(cfg, n_points, train, superset)
    return c.fwd + (c.bwd if train else 0.0)

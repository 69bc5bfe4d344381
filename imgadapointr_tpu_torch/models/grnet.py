"""GRNet, the gridding residual network.

Counterpart of ``imgadapointr_tpu/models/grnet.py:31-144`` (reference
``models/external/GRNet.py:45-185``): gridding of the partial cloud (64³),
a 3-D U-Net, gridding reverse, random point sampling, cubic feature
sampling at three scales, an MLP of 8 point offsets a sparse point. The
loss is CD-L2 on (sparse, dense); the reference's gridding loss has weight
0 (``GRNet.py:51``), so it is not taken.

The volumes are channels last, (B, D, H, W, C), as in the JAX module; each
convolution runs on a permuted view (PyTorch's channels-last-3d layout) in
cuDNN with TF32 off (``utils/device.py``): ``Conv3d(k=4, padding=2)``
grows D to D + 1 before the 2x max pool (65 -> 32, floor), and
``ConvTranspose3d(k=4, stride=2, padding=1)`` doubles D, the flax
``ConvTranspose(k4, s2, 'SAME')`` with its kernel flipped
(``tools/convert.py``). Parameters are named after the flax tree.

The point sampling's uniform scores are an argument (``noise``), else a
draw from ``generator`` in train mode. In eval mode they are fixed: drawn
on the host from a CPU generator seeded 0 and moved to the device, so the
card and the CPU pick the same subset (the JAX module's fixed key gives
another). With ``eval_sampling: random`` the eval scores are drawn from the
generator the forward is handed, as the dropout masks are, and a forward
without one raises (the JAX module draws them from its ``noise`` key, which
the port does not reproduce: the CPU tests hand both the same scores).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import BatchNorm, Linear, leaky_relu
from ..parallel.dist import global_draw
from ..ops import gather_rows
from ..ops.gridding import cubic_feature_sampling, gridding, gridding_reverse
from .baselines import Baseline, register_baseline, set_bn_momentum

GRID = 64  # the gridding's scale
EVAL_SCORES_SEED = 0


def random_point_sampling(pred_cloud: torch.Tensor, partial_cloud: torch.Tensor, n_points: int,
                          scores: torch.Tensor) -> torch.Tensor:
    """``n_points`` rows of cat(partial, pred): the rows with the largest
    ``scores`` (B, N_partial + N_pred), a zero row scoring -1e9, in score
    order, the lower index first among equal scores (``lax.top_k``'s order;
    reference GRNet.py:21-42 takes a random subset of the nonzero rows)."""
    cloud = torch.cat([partial_cloud, pred_cloud], dim=1)
    nonzero = cloud.abs().sum(dim=-1) > 0
    scores = torch.where(nonzero, scores.to(cloud.dtype), -1e9)
    idx = torch.sort(scores, dim=1, descending=True, stable=True)[1][:, :n_points].contiguous()
    return gather_rows(cloud, idx)


@functools.lru_cache(maxsize=4)
def fixed_eval_scores(B: int, n: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The eval mode's scores: float64 uniforms from a CPU generator seeded
    ``EVAL_SCORES_SEED``, in ``dtype`` on ``device``."""
    g = torch.Generator().manual_seed(EVAL_SCORES_SEED)
    return torch.rand(B, n, generator=g, dtype=torch.float64).to(device=device, dtype=dtype)


class ConvBlock3D(nn.Module):
    """Conv3d(k=4, padding=2), BN, LeakyReLU(0.2), 2x max pool."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv = nn.Conv3d(cin, features, 4, padding=2)
        self.bn = BatchNorm(features)

    def forward(self, x):  # (B, D, H, W, C) -> (B, (D + 1) // 2, ..., features)
        y = self.conv(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        y = leaky_relu(self.bn(y))
        return F.max_pool3d(y.permute(0, 4, 1, 2, 3), 2).permute(0, 2, 3, 4, 1)


class DeconvBlock3D(nn.Module):
    """ConvTranspose3d(k=4, stride=2, padding=1, no bias), BN, ReLU."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.dconv = nn.ConvTranspose3d(cin, features, 4, stride=2, padding=1, bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x):  # (B, D, H, W, C) -> (B, 2 D, 2 H, 2 W, features)
        return F.relu(self.bn(self.dconv(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)))


@register_baseline
class GRNet(Baseline):
    def __init__(self, config):
        super().__init__()
        self.eval_sampling = str(config.get("eval_sampling", "fixed"))
        if self.eval_sampling not in ("fixed", "random"):
            raise ValueError(f"GRNet: eval_sampling must be fixed|random, got {self.eval_sampling!r}")
        self.num_pred = int(config.num_pred)
        self.n_sparse = self.num_pred // 8
        self.conv1 = ConvBlock3D(1, 32)
        self.conv2 = ConvBlock3D(32, 64)
        self.conv3 = ConvBlock3D(64, 128)
        self.conv4 = ConvBlock3D(128, 256)
        self.fc5 = Linear(16384, 2048)
        self.fc6 = Linear(2048, 16384)
        self.dconv7 = DeconvBlock3D(256, 128)
        self.dconv8 = DeconvBlock3D(128, 64)
        self.dconv9 = DeconvBlock3D(64, 32)
        self.dconv10 = DeconvBlock3D(32, 1)
        self.fc11 = Linear(1792, 1792)
        self.fc12 = Linear(1792, 448)
        self.fc13 = Linear(448, 112)
        self.fc14 = Linear(112, 24)

    def scores(self, B: int, n: int, like: torch.Tensor, generator: torch.Generator | None,
               noise: torch.Tensor | None) -> torch.Tensor:
        if noise is not None:
            return noise.to(like)
        if self.training or self.eval_sampling == "random":
            if generator is None:
                raise ValueError("GRNet: random point sampling needs a generator: pass one to the forward")
            return global_draw(torch.rand, (B, n), generator=generator, device=like.device, dtype=like.dtype)
        return fixed_eval_scores(B, n, like.device, like.dtype)

    def forward(self, xyz: torch.Tensor, bn_momentum: float = 0.1,
                generator: torch.Generator | None = None, noise: torch.Tensor | None = None):
        """(sparse x 2, dense x 2): (B, num_pred / 8, 3) and (B, num_pred, 3).
        ``noise`` (B, N + 64³) are the point sampling's uniform scores."""
        set_bn_momentum(self, bn_momentum)
        B = xyz.shape[0]
        partial = xyz * 0.5  # keeps the gridding inside its grid (reference GRNet.py:140)
        g64 = gridding(partial, GRID)[..., None]  # (B, 64, 64, 64, 1)
        f32 = self.conv1(g64)
        f16 = self.conv2(f32)
        f8 = self.conv3(f16)
        f4 = self.conv4(f8)
        h = F.relu(self.fc6(F.relu(self.fc5(f4.reshape(B, -1)))))
        r4 = h.reshape(B, 4, 4, 4, 256) + f4
        r8 = self.dconv7(r4) + f8
        r16 = self.dconv8(r8) + f16
        r32 = self.dconv9(r16) + f32
        r64 = self.dconv10(r32) + g64
        sparse = gridding_reverse(r64[..., 0], GRID)  # (B, 64³, 3)
        scores = self.scores(B, partial.shape[1] + sparse.shape[1], sparse, generator, noise)
        sparse = random_point_sampling(sparse, partial, self.n_sparse, scores)
        pf = torch.cat([cubic_feature_sampling(sparse, r).reshape(B, self.n_sparse, -1)
                        for r in (r32, r16, r8)], dim=-1)  # (B, n, 8 * (32 + 64 + 128))
        pf = F.relu(self.fc13(F.relu(self.fc12(F.relu(self.fc11(pf))))))
        offsets = self.fc14(pf).reshape(B, self.num_pred, 3)
        dense = sparse.repeat_interleave(8, dim=1) + offsets
        return sparse * 2.0, dense * 2.0

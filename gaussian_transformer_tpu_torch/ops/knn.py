"""Mean squared distance to the 3 nearest neighbours (port of
``gaussian_transformer_tpu/ops/knn.py``), used once at scene initialization
to seed the log-scales of a point cloud's Gaussians.

A blockwise exact top-3 over the pairwise distance matrix, as the reference:
each [block, N] panel is one matmul through |a - b|^2 = |a|^2 + |b|^2 - 2 a.b
(``torch.matmul`` in full float32), then ``torch.topk``. O(N^2) operations,
a one-off set-up cost; not a TPU kernel in the reference either.
"""

from __future__ import annotations

import torch

BLOCK = 1024


def _squared_norms(pts: torch.Tensor) -> torch.Tensor:
    """x^2 + y^2 + z^2 rounded as the reference's compiled sum rounds it: a
    chain of fused multiply-adds, fma(z, z, fma(y, y, x * x)), emulated in
    float64 (a product of two float32 values is exact there). The expansion
    cancels |a|^2 + |b|^2 against 2 a.b, so one ulp of |a|^2 is a 1e-5
    relative change of a near neighbour's distance."""
    d = pts.to(torch.float64)
    acc = (d[:, 0] * d[:, 0]).to(torch.float32).to(torch.float64)
    acc = (d[:, 1] * d[:, 1] + acc).to(torch.float32).to(torch.float64)
    return (d[:, 2] * d[:, 2] + acc).to(torch.float32)


@torch.no_grad()
def mean_sq_dist_to_3nn(points: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """points [N, 3] -> [N]: the mean of the squared distances to the 3
    nearest other points (self excluded)."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    sq = _squared_norms(pts)
    out = torch.empty(n, dtype=torch.float32, device=pts.device)
    for lo in range(0, n, block):
        rows = pts[lo:lo + block]
        d2 = sq[lo:lo + block, None] + sq[None, :] - 2.0 * (rows @ pts.T)
        d2 = torch.clamp(d2, min=0.0)
        i = torch.arange(rows.shape[0], device=pts.device)
        d2[i, lo + i] = float("inf")  # self
        if n < 3:  # fewer than 3 others: the missing ones are infinitely far
            d2 = torch.nn.functional.pad(d2, (0, 3 - n), value=float("inf"))
        out[lo:lo + block] = torch.topk(d2, 3, dim=1, largest=False).values.mean(dim=1)
    return out


# Reference-spelling alias (the reference's call sites name it distCUDA2).
def dist_to_3nn_sq(points):
    return mean_sq_dist_to_3nn(points)

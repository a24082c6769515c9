"""The floors' counts against counts made by hand: the reference's
contributing pairs on a tiny scene, and each floor's arithmetic."""

import math

import pytest
import torch

from perfbench import floors
from perfbench.reference import splat as ref


def _projected(means, conics, opac, radii):
    n = len(means)
    return ref.Projected(torch.tensor(means, dtype=torch.float32), torch.arange(1, n + 1, dtype=torch.float32),
                         torch.tensor(conics, dtype=torch.float32), torch.tensor(radii, dtype=torch.int32),
                         torch.full((n, 3), 0.5), torch.tensor(opac, dtype=torch.float32))


def _hand_pairs(means, conics, opac, radii, W, H):
    """Pixel by pixel, front to back, the upstream rules: a pair counts when
    the Gaussian's tile rect holds the pixel, power <= 0, alpha >= 1/255,
    and the pixel has not stopped."""
    pairs = 0
    for y in range(H):
        for x in range(W):
            T = 1.0
            for (mx, my), (a, b, c), o, r in zip(means, conics, opac, radii):
                x0, x1 = max(0, math.floor((mx - r) / 16)), min(-(-W // 16), math.floor((mx + r + 15) / 16))
                y0, y1 = max(0, math.floor((my - r) / 16)), min(-(-H // 16), math.floor((my + r + 15) / 16))
                if not (x0 <= x // 16 < x1 and y0 <= y // 16 < y1):
                    continue
                dx, dy = mx - x, my - y
                power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                alpha = min(0.99, o * math.exp(power))
                if power > 0 or alpha < 1 / 255:
                    continue
                if T * (1 - alpha) < 1e-4:
                    break
                T *= 1 - alpha
                pairs += 1
    return pairs


@pytest.mark.parametrize("case", ["one", "overlap", "opaque_stack"])
def test_contributing_pairs_by_hand(case):
    W, H = 40, 24
    if case == "one":
        g = ([[13.3, 9.6]], [[0.08, 0.01, 0.05]], [0.9], [12])
    elif case == "overlap":
        g = ([[10.0, 10.0], [22.5, 12.0]], [[0.05, 0.0, 0.05], [0.02, -0.005, 0.03]], [0.7, 0.5], [14, 20])
    else:
        # Three opaque Gaussians on one spot: pixels near it stop after two.
        g = ([[20.0, 12.0]] * 3, [[0.02, 0.0, 0.02]] * 3, [0.98] * 3, [22] * 3)
    p = _projected(*g)
    img, _, pairs = ref.composite(p, W, H, torch.zeros(3))
    assert pairs == _hand_pairs(*g, W, H)
    assert pairs > 0


def test_floor_arithmetic():
    assert floors.k1(1000, 10, 64) == max(1000 * 23 / 67e12, (10 * 36 + 64 * 16) / 3.35e12)
    assert floors.k2(1000, 10, 64) == max(1000 * 64 / 67e12, (2 * 10 * 36 + 64 * 16) / 3.35e12)
    assert floors.k3(100) == max(3 * 100 * 243 / 67e12, 24 * 100 / 3.35e12)
    assert floors.k4(100) == max(3 * 100 * 430 / 67e12, 36 * 100 / 3.35e12)
    assert floors.learnables_per_gaussian(3) == 59 and floors.learnables_per_gaussian(1) == 23
    # A whole step at 1M Gaussians is bound by the bytes of the learnables
    # and both Adam moments, read and written: 59 x 4 x 6 bytes each.
    assert floors.splat_step(10**8, 10**6, 1920 * 1080, 3) == pytest.approx(
        (59 * 4 * 6 * 10**6 + 12 * 1920 * 1080) / 3.35e12)


def test_transformer_floor_by_hand():
    d = 4
    # One encoder layer over 2 source tokens: embeddings 2 x 2 x 3d^2, the
    # layer 2 x 2 x 7d^2 + 4 x 2 x 2 x d; one decoder position over those
    # keys: embedding 2 x 3d^2, the layer 2 x 7d^2 + 4 x 1 x d + 2 x 4d^2 +
    # 4 x 2 x d, the head 2 d^2.
    enc = 2 * 2 * 3 * d * d + 2 * 2 * 7 * d * d + 4 * 2 * 2 * d
    dec = 2 * 3 * d * d + 2 * 7 * d * d + 4 * 1 * d + 2 * 4 * d * d + 4 * 2 * d + 2 * d * d
    assert floors.stacked_forward_ops(d, 1, 2, 1) == enc + dec

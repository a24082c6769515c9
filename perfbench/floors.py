"""The least time each measured piece of work could take on one H100, from
what its inputs need and whatever implements it: the larger of its
operations over the float32 peak and its bytes over the memory bandwidth.

Counts follow the inputs, never an implementation: compositing counts only
the contributing (pixel, Gaussian) pairs the reference finds under the
upstream rules; per-Gaussian passes count live Gaussians; bytes count each
input read once and each output written once, and a whole step's bytes hold
no intermediate buffer (no sort passes, stream rows or gradient rows), only
the learnables, the optimizer's state and the images.

Peaks: NVIDIA's H100 SXM data sheet, dense: 67 TFLOP/s in float32 outside
the tensor cores, 3.35 TB/s of HBM3 (at the 700 W power limit).
"""

from __future__ import annotations

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# Operations a contributing pair needs in the forward: the offset (2), the
# quadratic form (9), exp (1), alpha = min(0.99, o e) (2), the transmittance
# update (2), alpha T and three colour multiply-adds (7).
FWD_PAIR_OPS = 23
# In the backward: alpha again (14), the transmittance (2), three colour
# gradients (6), the running colour and the alpha gradient (21), the
# Gaussian's value (1), its offsets (6), the mean's (6), conic's (6) and
# opacity's (2) gradients.
BWD_PAIR_OPS = 64
# SSIM per pixel and channel: five 11-tap separable blurs (5 x 2 x 11 x 2),
# the three products and the map (20).
SSIM_FWD_OPS = 243
# Its gradient: the blurs again (223), the map's partials (25), four
# transposed blurs (176) and the sum (6).
SSIM_BWD_OPS = 430
# Projecting a Gaussian: the mean (24), the 3D covariance (45), the 2D
# covariance and conic (60), the radius (10), SH degree 3 colour (111).
PROJECT_OPS = 250
# One Adam update of a float32 parameter.
ADAM_OPS = 12

PROPS_2D_BYTES = 36  # mean 2, conic 3, colour 3, opacity 1, float32


def seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)


def learnables_per_gaussian(sh_degree: int) -> int:
    """Floats a Gaussian learns: mean 3, SH 3 (deg + 1)^2, scale 3, rotation
    4, opacity 1."""
    return 3 + 3 * (sh_degree + 1) ** 2 + 3 + 4 + 1


def k1(pairs: int, included: int, pixels: int) -> float:
    """Forward compositing of one view: pairs x ops; the included
    Gaussians' 2D properties read, the image and final transmittance
    written."""
    return seconds(pairs * FWD_PAIR_OPS, included * PROPS_2D_BYTES + pixels * 16)


def k2(pairs: int, included: int, pixels: int) -> float:
    """Backward compositing: properties and their gradients, the image's
    gradient and the final transmittance."""
    return seconds(pairs * BWD_PAIR_OPS, 2 * included * PROPS_2D_BYTES + pixels * 16)


def k3(pixels: int) -> float:
    return seconds(3 * pixels * SSIM_FWD_OPS, 2 * 12 * pixels)


def k4(pixels: int) -> float:
    return seconds(3 * pixels * SSIM_BWD_OPS, 3 * 12 * pixels)


def splat_step(pairs: int, gaussians: int, pixels: int, sh_degree: int) -> float:
    """A whole 3DGS train step: projection forward and backward of every
    live Gaussian, compositing both ways, SSIM both ways, Adam; bytes: the
    learnables and both Adam moments read and written, the ground truth
    read."""
    p = learnables_per_gaussian(sh_degree)
    ops = (pairs * (FWD_PAIR_OPS + BWD_PAIR_OPS) + 3 * pixels * (SSIM_FWD_OPS + SSIM_BWD_OPS)
           + gaussians * (3 * PROJECT_OPS + p * ADAM_OPS))
    return seconds(ops, gaussians * p * 4 * 6 + pixels * 12)


def splat_view(pairs: int, gaussians: int, pixels: int, sh_degree: int) -> float:
    """A served view: projection and compositing forward; the learnables
    read, the frame's bytes (HWC uint8) written."""
    p = learnables_per_gaussian(sh_degree)
    return seconds(gaussians * PROJECT_OPS + pairs * FWD_PAIR_OPS, gaussians * p * 4 + pixels * 3)


# ------------------------------------------------------------ transformer

def layer_ops(d: int, tokens: int, keys: int, cross_keys: int = 0) -> float:
    """Forward multiply-adds x 2 of one pre-norm layer over ``tokens`` rows:
    q, k, v, out (4 d^2), SwiGLU FFN (d x 2d, then d x d), attention over
    ``keys`` (and a cross-attention block over ``cross_keys``)."""
    ops = 2 * tokens * (4 * d * d + 3 * d * d) + 4 * tokens * keys * d
    if cross_keys:
        ops += 2 * tokens * 4 * d * d + 4 * tokens * cross_keys * d
    return ops


def stacked_forward_ops(d: int, layers: int, src_len: int, tgt_len: int) -> float:
    """The encoder once over the real source tokens, then the decoder once
    per real target position (the cached decode's cost: position i attends
    to i + 1 keys), the embeddings and the regression head."""
    enc = 2 * src_len * 3 * d * d + layers * layer_ops(d, src_len, src_len)
    dec = 0.0
    for i in range(tgt_len):
        dec += 2 * 3 * d * d + layers * layer_ops(d, 1, i + 1, src_len) + 2 * d * d
    return enc + dec


def stacked_step(d: int, layers: int, params: int, src_len: int, tgt_len: int) -> float:
    """A train step: the forward above, the backward at twice it, Adam;
    bytes: the parameters and both Adam moments read and written."""
    ops = 3 * stacked_forward_ops(d, layers, src_len, tgt_len) + params * ADAM_OPS
    return seconds(ops, params * 4 * 6)

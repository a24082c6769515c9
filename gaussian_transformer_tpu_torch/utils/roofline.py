"""The least time one H100 could take for each stage of the 3DGS train step
(port of ``gaussian_transformer_tpu/utils/roofline.py``, re-based on the
card the port runs on).

A stage's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the card's memory rate,
and the float32 operations it must do over the card's float32 rate outside
the tensor cores (the 3DGS step runs no matrix unit). It is "bytes" or
"operations" bound by whichever is larger:

    roofline_ms = max(bytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS)

and ``roofline_frac`` = roofline_ms / measured ms says how near the stage
runs to that floor. The counts follow the port's code: the compositor
stages count the (row, pixel) pairs the kernels K1/K2 walk and the pairs
that contribute (``render.stream.composite_stream_tiles_plain(
count_work=True)`` counts both on the same rows); the property rows count
at their width (64 B in float32, 32 B in bf16). Every constant is the
published peak or an operation count read off the code, and ``chip_smoke.py``
takes the card's bounds from here.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

# Published H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # the tensor cores' dense bf16 rate (the transformers' GEMMs)

# Operation counts of the kernels (float32, outside the tensor cores). The
# compositors' walk costs every walked (row, pixel) pair WALK_OPS_PER_PAIR;
# a pair that contributes (not skipped, not the terminating row) costs the
# kernel's *_OPS_PER_LIVE more.
WALK_OPS_PER_PAIR = 14  # power (10), exp, opacity product, alpha cap, skip test
K1_OPS_PER_LIVE = 6  # T update (2), w, 3 FMAs
# K1's (6), then w, <rgb, gC> and the prefix (8), w gC (3), g_alpha (7),
# g_power and its 5 weighted copies (8), and the 9 sums over the tile's
# pixels (9 adds per pair).
K2_OPS_PER_LIVE = K1_OPS_PER_LIVE + 8 + 3 + 7 + 8 + 9
K3_OPS_PER_PIXEL = 3 + 2 * (5 * 11 * 2) + 17  # products, two 11-tap passes x 5 fields, map
# Products (3), fields by two 11-tap passes (220), partials (30), scale (4),
# four maps filtered back (176), combine (8).
K4_OPS_PER_PIXEL = 3 + 2 * (5 * 11 * 2) + 30 + 4 + 2 * (4 * 11 * 2) + 8
# K6: K5's (6), then w, <rgb, gC> and the prefix (8), w gC (3), g_alpha (7),
# g_power (1), dx and dy (2), the five geometric terms (16), and the 9 sums
# over the tile's pixels (9 adds per pair).
K6_OPS_PER_LIVE = K1_OPS_PER_LIVE + 8 + 3 + 7 + 1 + 2 + 16 + 9

P = 256  # pixels per tile (16x16)
# A property row as the compositor kernels read it, by precision.
ROW_BYTES = {"fp32": 16 * 4, "bf16": 16 * 2}
GRAD_ROW_BYTES = 16 * 4  # a float32 gradient row (K2's output)
# torch.sort of the binning's int64 keys with their int64 indices: a radix
# sort of 8 passes of 8 bits, each reading and writing key and index.
SORT_BYTES_PER_KEY = 8 * 2 * (8 + 8)


class StageRoofline(NamedTuple):
    nbytes: float
    ops: float

    @property
    def t_bytes_ms(self) -> float:
        return self.nbytes / PEAK_BYTES_PER_S * 1e3

    @property
    def t_ops_ms(self) -> float:
        return self.ops / PEAK_FP32_FLOPS * 1e3

    @property
    def roofline_ms(self) -> float:
        return max(self.t_bytes_ms, self.t_ops_ms)

    @property
    def bound(self) -> str:
        return "bytes" if self.t_bytes_ms >= self.t_ops_ms else "operations"


def _param_floats(sh_degree: int) -> int:
    """Learnable floats per Gaussian: xyz, scaling, rotation, opacity and
    the SH coefficients up to ``sh_degree``."""
    return 3 + 3 + 4 + 1 + (sh_degree + 1) ** 2 * 3


def project(c: int, sh_degree: int = 1) -> StageRoofline:
    """Projection of ``c`` Gaussian slots (render/project.py, forward):
    reads the learnables, writes means2d, depth, conic, radius, rgb,
    opacity, the binning radius and rect (56 B). ~270 operations for the
    covariance chain (quaternion to R, M = R S, Sigma, J W, cov2D, its
    inverse, eigenvalue, radius, the 1/255 level set) and the mean's two
    transforms, ~40 for the SH basis and 6 a coefficient for the colour."""
    read = c * _param_floats(sh_degree) * 4
    write = c * 56
    return StageRoofline(read + write, c * (310 + 6 * (sh_degree + 1) ** 2))


# K10 (csrc/project_fwd.cu) a Gaussian: the stored leaves it reads besides
# features_rest (xyz 12, scaling 12, rotation 16, opacity 4, alive 1,
# features_dc 12) and what it writes (means2d 8, depth 4, conic 12, radius
# 4, rgb 12, opacity 4, binning radius 4, rect 8, include 1).
K10_READ_BYTES = 12 + 12 + 16 + 4 + 1 + 12
K10_WRITE_BYTES = 8 + 4 + 12 + 4 + 12 + 4 + 4 + 8 + 1


def project_kernel(c: int, rest_rows: int, sh_degree: int) -> StageRoofline:
    """K10 over ``c`` slots: the leaves read once (features_rest's
    ``rest_rows`` rows of 12 B whole: the kernel stages them so), the
    outputs written once, ``project``'s operations."""
    return StageRoofline(c * (K10_READ_BYTES + 12 * rest_rows + K10_WRITE_BYTES), project(c, sh_degree).ops)


def binning(i: int, i_pad: int, c: int) -> StageRoofline:
    """``render/tiles.py bin_stream`` over an instance budget of ``i`` rows
    and a stream of ``i_pad`` rows: the expansion reads each Gaussian's
    screen rect, conic and opacity (36 B) and writes (tile, Gaussian,
    depth) per instance (20 B); one ``torch.sort`` of the int64 (tile,
    depth) keys with their indices (SORT_BYTES_PER_KEY); the sorted tiles
    and Gaussians gathered (32 B); the run starts, tail padding and stream
    positions (~40 B an instance); the scatters into the stream (8 B a
    stream row) and the unsorted positions (8 B)."""
    expand = c * 36 + i * 20
    sort = i * SORT_BYTES_PER_KEY
    scan = i * (32 + 40 + 8)
    scatter = i_pad * 8
    return StageRoofline(expand + sort + scan + scatter, i * 40)


def gather(i: int, i_pad: int, c: int) -> StageRoofline:
    """``render/stream.py stream_gather`` and its pullback: the packed
    per-Gaussian rows written (64 B), each stream row's index read and its
    row gathered and written (4 + 64 + 64 B); backward, each instance's
    position and 9 gradient columns read (4 + 36 B), the float64 prefix
    sum over them written and read (2 x 72 B), and each Gaussian's
    gradient row written (64 B); ~2 operations a column."""
    fwd = c * 64 + i_pad * (4 + 64 + 64)
    bwd = i * (4 + 36 + 2 * 72) + c * 64
    return StageRoofline(fwd + bwd, i * 9 * 2)


def fwd_kernel(walked: int, contributing: int, real_rows: int, n_tiles: int,
               precision: str = "fp32") -> StageRoofline:
    """K1 (``csrc/stream_fwd.cu``, or ``stream_fwd_bf16``): reads each real
    stream row once at its width and each tile's row range (8 B), writes
    the colour and transmittance planes [T, 4, 256] float32; every walked
    pair WALK_OPS_PER_PAIR, every contributing pair K1_OPS_PER_LIVE more."""
    nbytes = real_rows * ROW_BYTES[precision] + n_tiles * (8 + 4 * P * 4)
    return StageRoofline(nbytes, walked * WALK_OPS_PER_PAIR + contributing * K1_OPS_PER_LIVE)


def bwd_kernel(walked: int, contributing: int, real_rows: int, stream_rows: int, n_tiles: int,
               precision: str = "fp32") -> StageRoofline:
    """K2 (``csrc/stream_bwd.cu``, or ``stream_bwd_bf16``): reads each real
    row at its width and the per-tile table [T, 8, 256] float32 (colour, T,
    their cotangents), writes one float32 gradient row per stream row;
    every walked pair WALK_OPS_PER_PAIR, every contributing pair
    K2_OPS_PER_LIVE more."""
    nbytes = real_rows * ROW_BYTES[precision] + n_tiles * 8 * P * 4 + stream_rows * GRAD_ROW_BYTES
    return StageRoofline(nbytes, walked * WALK_OPS_PER_PAIR + contributing * K2_OPS_PER_LIVE)


def loss_adam(c: int, h: int, w: int, sh_degree: int = 1) -> StageRoofline:
    """The loss and the optimizer: L1 forward and backward (reads both
    images, writes the image gradient: 3 planes), SSIM forward (K3: both
    images) and backward (K4: both images in, two gradients out), and Adam
    over every learnable of ``c`` slots (reads parameter, gradient, m, v;
    writes parameter, m, v; ~12 operations an element)."""
    n_px = 3 * h * w
    image = n_px * 4 * (3 + 2 + 4)
    n_param = c * _param_floats(sh_degree)
    ops = n_px * (K3_OPS_PER_PIXEL + K4_OPS_PER_PIXEL + 4) + n_param * 12
    return StageRoofline(image + n_param * 4 * 7, ops)


def step_report(counts: Dict[str, int], measured_ms: Optional[Dict[str, float]] = None):
    """{stage: {roofline_ms, bound, t_bytes_ms, t_ops_ms[, measured_ms,
    roofline_frac]}} for one train step, plus "_total".

    counts: n_gaussians (the slots the per-Gaussian passes run over),
    n_instances (the binning's instance budget), i_pad (stream rows),
    real_rows, n_tiles, height, width, walked and contributing (K1's and
    K2's (row, pixel) pairs), and optionally precision ("fp32") and
    sh_degree (1). measured_ms: optional measured ms by stage, and "total"
    for the whole step."""
    c, i, i_pad = counts["n_gaussians"], counts["n_instances"], counts["i_pad"]
    t, real = counts["n_tiles"], counts["real_rows"]
    walked, live = counts["walked"], counts["contributing"]
    precision = counts.get("precision", "fp32")
    sh = counts.get("sh_degree", 1)
    stages = {
        "project": project(c, sh),
        "bin": binning(i, i_pad, c),
        "gather": gather(i, i_pad, c),
        "fwd_kernel": fwd_kernel(walked, live, real, t, precision),
        "bwd_kernel": bwd_kernel(walked, live, real, i_pad, t, precision),
        "loss_adam": loss_adam(c, counts["height"], counts["width"], sh),
    }
    measured_ms = measured_ms or {}
    out = {}
    total = 0.0
    for name, r in stages.items():
        row = {"roofline_ms": r.roofline_ms, "bound": r.bound, "t_bytes_ms": r.t_bytes_ms, "t_ops_ms": r.t_ops_ms}
        total += r.roofline_ms
        if measured_ms.get(name, 0) > 0:
            row["measured_ms"] = measured_ms[name]
            row["roofline_frac"] = r.roofline_ms / measured_ms[name]
        out[name] = row
    out["_total"] = {"roofline_ms": total}
    if measured_ms.get("total", 0) > 0:
        out["_total"]["measured_ms"] = measured_ms["total"]
        out["_total"]["roofline_frac"] = total / measured_ms["total"]
    return out

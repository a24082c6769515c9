"""Per-Gaussian projection: world -> screen, EWA splatting math (port of
``gaussian_transformer_tpu/render/project.py``; same formulas, same operation
order, so integer outputs match the reference exactly).

  * mean projection through the (transposed) full projection matrix,
  * near-plane cull at z <= 0.2,
  * 3D covariance from activated scale + quaternion,
  * perspective Jacobian J and view rotation W: cov2D = J W Sigma W^T J^T,
    plus the 0.3 low-pass dilation,
  * conic = cov2D^{-1}, radius = ceil(3 * sqrt(max eigenvalue)),
  * the exact binning extents ``radii_bin`` / ``rect_bin`` (1/255 level set),
  * SH -> RGB with the clamp at 0 (not at 1).

Everything is structure-of-arrays: rank-1 [C] columns, no batched 3x3
matmuls. Invalid / culled Gaussians get radius 0 and opacity 0.

``project_scene`` projects a scene from its stored leaves: on CUDA tensors
through kernel K10 (csrc/project_fwd.cu), one pass that applies the scene's
activations, runs the chain below and writes every field of ``Projected``
and the binning's include mask, bit for bit as the chain computes them; on
CPU tensors through ``project_scene_plain``, the activations and the chain
as PyTorch ops. K10's gradient recomputes the plain chain on the saved
leaves and differentiates it.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from gaussian_transformer_tpu_torch.kernels import CudaKernel
from gaussian_transformer_tpu_torch.scene.gaussians import TensorScene
from gaussian_transformer_tpu_torch.utils.profiling import count
from gaussian_transformer_tpu_torch.utils.sh import C0, C1, eval_sh

# K10: one launch per projected view; its counter is ``render.project.fused``.
PROJECT_FWD = CudaKernel(
    "project_fwd.cu",
    "project_fwd",
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 10,
)
# The scene's stored leaves K10 reads, in its argument order.
LEAVES = ("xyz", "scaling", "rotation", "opacity", "alive", "features_dc", "features_rest")
# The camera's tensors projection reads.
CAMERA = ("world_view_transform", "full_proj_transform", "camera_center")
# features_rest rows K10 takes (SH degree 3).
MAX_REST = 15


class Projected(NamedTuple):
    """Screen-space per-Gaussian quantities (capacity-length tensors)."""

    means2d: torch.Tensor  # [C, 2] pixel coords
    depths: torch.Tensor  # [C]
    conics: torch.Tensor  # [C, 3] upper-tri of inverse 2D covariance (a, b, c)
    radii: torch.Tensor  # [C] int32 screen-space radius, 0 = culled
    rgbs: torch.Tensor  # [C, 3] view-dependent color
    opacities: torch.Tensor  # [C] activated opacity
    radii_bin: torch.Tensor  # [C] int32 effective binning radius (<= radii)
    rect_bin: torch.Tensor  # [C, 2] int32 per-axis binning extents


def ndc_to_pixel(ndc, size):
    """((ndc + 1) * size - 1) / 2 — integer pixel centers, no +0.5."""
    return ((ndc + 1.0) * size - 1.0) * 0.5


def _cov3d_cols(scales, rotations, scaling_modifier):
    """Six unique world-covariance entries as [C] columns (Sigma = M M^T,
    M = R(q) diag(s))."""
    r, x, y, z = rotations[:, 0], rotations[:, 1], rotations[:, 2], rotations[:, 3]
    s0 = scaling_modifier * scales[:, 0]
    s1 = scaling_modifier * scales[:, 1]
    s2 = scaling_modifier * scales[:, 2]

    R00 = 1 - 2 * (y * y + z * z)
    R01 = 2 * (x * y - r * z)
    R02 = 2 * (x * z + r * y)
    R10 = 2 * (x * y + r * z)
    R11 = 1 - 2 * (x * x + z * z)
    R12 = 2 * (y * z - r * x)
    R20 = 2 * (x * z - r * y)
    R21 = 2 * (y * z + r * x)
    R22 = 1 - 2 * (x * x + y * y)

    M00, M01, M02 = R00 * s0, R01 * s1, R02 * s2
    M10, M11, M12 = R10 * s0, R11 * s1, R12 * s2
    M20, M21, M22 = R20 * s0, R21 * s1, R22 * s2

    Sxx = M00 * M00 + M01 * M01 + M02 * M02
    Sxy = M00 * M10 + M01 * M11 + M02 * M12
    Sxz = M00 * M20 + M01 * M21 + M02 * M22
    Syy = M10 * M10 + M11 * M11 + M12 * M12
    Syz = M10 * M20 + M11 * M21 + M12 * M22
    Szz = M20 * M20 + M21 * M21 + M22 * M22
    return Sxx, Sxy, Sxz, Syy, Syz, Szz


def compute_cov2d_cols(tx_raw, ty_raw, tz, Sigma, focal_x, focal_y, tan_fovx, tan_fovy, view_rot):
    """EWA projection of the 3D covariance to 2D: (cov_xx, cov_xy, cov_yy)
    [C] columns WITH the +0.3 dilation. ``view_rot`` is the [3, 3]
    world->camera rotation; its entries multiply [C] columns as 0-dim tensors."""
    Sxx, Sxy, Sxz, Syy, Syz, Szz = Sigma
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    txtz = torch.clamp(tx_raw / tz, -limx, limx)
    tytz = torch.clamp(ty_raw / tz, -limy, limy)
    tx = txtz * tz
    ty = tytz * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z2

    W = view_rot
    T00 = j00 * W[0, 0] + j02 * W[2, 0]
    T01 = j00 * W[0, 1] + j02 * W[2, 1]
    T02 = j00 * W[0, 2] + j02 * W[2, 2]
    T10 = j11 * W[1, 0] + j12 * W[2, 0]
    T11 = j11 * W[1, 1] + j12 * W[2, 1]
    T12 = j11 * W[1, 2] + j12 * W[2, 2]

    U00 = T00 * Sxx + T01 * Sxy + T02 * Sxz
    U01 = T00 * Sxy + T01 * Syy + T02 * Syz
    U02 = T00 * Sxz + T01 * Syz + T02 * Szz
    U10 = T10 * Sxx + T11 * Sxy + T12 * Sxz
    U11 = T10 * Sxy + T11 * Syy + T12 * Syz
    U12 = T10 * Sxz + T11 * Syz + T12 * Szz

    cov_xx = U00 * T00 + U01 * T01 + U02 * T02 + 0.3
    cov_xy = U00 * T10 + U01 * T11 + U02 * T12
    cov_yy = U10 * T10 + U11 * T11 + U12 * T12 + 0.3
    return cov_xx, cov_xy, cov_yy


def compute_cov2d(mean_view, cov3d, focal_x, focal_y, tan_fovx, tan_fovy, view_rot):
    """Matrix-form wrapper of ``compute_cov2d_cols``: [C, 3] packed (xx, xy,
    yy) from [C, 3] camera-space means and [C, 3, 3] covariances."""
    Sigma = (cov3d[:, 0, 0], cov3d[:, 0, 1], cov3d[:, 0, 2],
             cov3d[:, 1, 1], cov3d[:, 1, 2], cov3d[:, 2, 2])
    cov_xx, cov_xy, cov_yy = compute_cov2d_cols(
        mean_view[:, 0], mean_view[:, 1], mean_view[:, 2], Sigma,
        focal_x, focal_y, tan_fovx, tan_fovy, view_rot,
    )
    return torch.stack([cov_xx, cov_xy, cov_yy], dim=-1)


def project_gaussians(
    xyz: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    shs: Optional[torch.Tensor],
    colors_precomp: Optional[torch.Tensor],
    *,
    world_view_transform: torch.Tensor,
    full_proj_transform: torch.Tensor,
    camera_center: torch.Tensor,
    image_width: int,
    image_height: int,
    tan_fovx: float,
    tan_fovy: float,
    active_sh_degree: int,
    scaling_modifier: float = 1.0,
) -> Projected:
    """Vectorized projection of all (capacity) Gaussians for one camera.

    ``scales``/``rotations``/``opacities`` are the ACTIVATED values; ``shs``
    is [C, K, 3]. Matrices use the transposed row-vector convention."""
    focal_x = image_width / (2.0 * tan_fovx)
    focal_y = image_height / (2.0 * tan_fovy)

    px, py, pz = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    Wv = world_view_transform
    Fp = full_proj_transform

    def affine(M, j):
        return px * M[0, j] + py * M[1, j] + pz * M[2, j] + M[3, j]

    view_x = affine(Wv, 0)
    view_y = affine(Wv, 1)
    depths = affine(Wv, 2)

    hom_x = affine(Fp, 0)
    hom_y = affine(Fp, 1)
    hom_w = affine(Fp, 3)
    p_w = 1.0 / (hom_w + 1e-7)

    in_front = depths > 0.2  # near cull

    mean_x = ndc_to_pixel(hom_x * p_w, image_width)
    mean_y = ndc_to_pixel(hom_y * p_w, image_height)

    Sigma = _cov3d_cols(scales, rotations, scaling_modifier)
    view_rot = world_view_transform[:3, :3].T  # rows of W2C = world->cam rotation
    safe_depth = torch.where(in_front, depths, torch.ones_like(depths))
    cov_xx, cov_xy, cov_yy = compute_cov2d_cols(
        view_x, view_y, safe_depth, Sigma, focal_x, focal_y, tan_fovx, tan_fovy, view_rot
    )

    det = cov_xx * cov_yy - cov_xy * cov_xy
    valid_det = det != 0.0
    det_inv = 1.0 / torch.where(valid_det, det, torch.ones_like(det))
    conic_a = cov_yy * det_inv
    conic_b = -cov_xy * det_inv
    conic_c = cov_xx * det_inv

    # Screen-space radius from the larger eigenvalue (3 sigma).
    mid = 0.5 * (cov_xx + cov_yy)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    sqrt_l1 = torch.sqrt(torch.clamp(lambda1, min=0.0))
    radius_f = torch.ceil(3.0 * sqrt_l1)

    visible = in_front & valid_det
    zero = torch.zeros_like(radius_f)
    radii = torch.where(visible, radius_f, zero).to(torch.int32)

    # Effective radius where alpha can still reach 1/255 (+1 px guard).
    ln_term = torch.log(torch.clamp(255.0 * opacities, min=1.0))
    r_eff = torch.ceil(torch.sqrt(2.0 * ln_term) * sqrt_l1) + 1.0
    radii_bin = torch.minimum(radii, torch.where(visible, r_eff, zero).to(torch.int32))

    # Per-axis ellipse-bbox extents at the 1/255 level set (conditional
    # variance bound), each <= radii_bin.
    rb = radii_bin.to(torch.float32)
    rx_eff = torch.minimum(rb, torch.ceil(torch.sqrt(2.0 * ln_term * torch.clamp(cov_xx, min=0.0))) + 1.0)
    ry_eff = torch.minimum(rb, torch.ceil(torch.sqrt(2.0 * ln_term * torch.clamp(cov_yy, min=0.0))) + 1.0)
    rect = torch.stack([rx_eff, ry_eff], dim=-1)
    rect_bin = torch.where(visible[:, None], rect, torch.zeros_like(rect)).to(torch.int32)

    if colors_precomp is not None:
        rgbs = colors_precomp
    else:
        if shs is None:
            raise ValueError("project_gaussians needs shs or colors_precomp")
        dx = px - camera_center[0]
        dy = py - camera_center[1]
        dz = pz - camera_center[2]
        inv_n = 1.0 / torch.clamp(torch.sqrt(dx * dx + dy * dy + dz * dz), min=1e-12)
        dx, dy, dz = dx * inv_n, dy * inv_n, dz * inv_n
        if active_sh_degree == 0:
            raw = C0 * shs[:, 0, :] + 0.5
        elif active_sh_degree == 1:
            raw = (
                C0 * shs[:, 0, :]
                - (C1 * dy)[:, None] * shs[:, 1, :]
                + (C1 * dz)[:, None] * shs[:, 2, :]
                - (C1 * dx)[:, None] * shs[:, 3, :]
                + 0.5
            )
        else:
            dirs = torch.stack([dx, dy, dz], dim=-1)
            raw = eval_sh(active_sh_degree, shs.transpose(-1, -2), dirs) + 0.5
        rgbs = torch.clamp(raw, min=0.0)  # clamp at 0 only, as the CUDA path

    opac = torch.where(visible, opacities, torch.zeros_like(opacities))
    return Projected(
        means2d=torch.stack([mean_x, mean_y], dim=-1),
        depths=depths,
        conics=torch.stack([conic_a, conic_b, conic_c], dim=-1),
        radii=radii,
        rgbs=rgbs,
        opacities=opac,
        radii_bin=radii_bin,
        rect_bin=rect_bin,
    )


def view_args(camera) -> dict:
    """What projection reads of a camera: its matrices and centre, its size
    and the tangents of its half fields of view."""
    return dict(
        world_view_transform=camera.world_view_transform,
        full_proj_transform=camera.full_proj_transform,
        camera_center=camera.camera_center,
        image_width=camera.image_width,
        image_height=camera.image_height,
        tan_fovx=math.tan(camera.fovx * 0.5),
        tan_fovy=math.tan(camera.fovy * 0.5),
    )


def include_mask(proj: Projected) -> torch.Tensor:
    """The Gaussians binning keeps: a radius, and an opacity that can pass
    the compositor's 1/255 alpha skip."""
    return (proj.radii > 0) & (proj.opacities >= 1.0 / 255.0)


def project_scene_plain(pc, view: dict, scaling_modifier: float = 1.0,
                        override_color: Optional[torch.Tensor] = None) -> Tuple[Projected, torch.Tensor]:
    """K10's plain version: (Projected, include) of the scene's activated
    Gaussians (its ``get_*`` properties) for the view ``view_args`` gives."""
    shs = None if override_color is not None else pc.get_features
    proj = project_gaussians(
        pc.get_xyz,
        pc.get_scaling,
        pc.get_rotation,
        pc.get_opacity[:, 0],
        shs,
        override_color,
        **view,
        active_sh_degree=pc.active_sh_degree,
        scaling_modifier=scaling_modifier,
    )
    return proj, include_mask(proj)


def project_scene(pc, view: dict, scaling_modifier: float = 1.0,
                  override_color: Optional[torch.Tensor] = None) -> Tuple[Projected, torch.Tensor]:
    """(Projected, include) of a scene for one view: K10 where the scene
    lies on the card, the plain chain where it lies on the CPU."""
    if pc.get_xyz.is_cuda:
        return project_fused(pc, view, scaling_modifier, override_color)
    return project_scene_plain(pc, view, scaling_modifier, override_color)


def project_fused(pc, view: dict, scaling_modifier: float = 1.0,
                  override_color: Optional[torch.Tensor] = None) -> Tuple[Projected, torch.Tensor]:
    """(Projected, include) through K10, differentiable in the scene's
    leaves, the override colour and the camera's tensors."""
    leaves = [getattr(pc, k).contiguous() for k in LEAVES]
    dev = leaves[0].device
    cam = [view[k].to(dev, torch.float32).contiguous() for k in CAMERA]
    static = (view["image_width"], view["image_height"], view["tan_fovx"], view["tan_fovy"],
              pc.active_sh_degree, float(scaling_modifier))
    oc = None if override_color is None else override_color.contiguous()
    out = _ProjectFused.apply(static, *leaves, oc, *cam)
    return Projected(*out[:8]), out[8]


def _plain_on_inputs(static, inputs) -> Tuple[Projected, torch.Tensor]:
    """``project_scene_plain`` on ``_ProjectFused``'s inputs."""
    width, height, tan_fovx, tan_fovy, degree, smod = static
    fields = dict(zip(LEAVES, inputs))
    oc = inputs[len(LEAVES)]
    cam = dict(zip(CAMERA, inputs[len(LEAVES) + 1:]))
    scene = TensorScene(**fields, active_sh_degree=degree)
    view = dict(cam, image_width=width, image_height=height, tan_fovx=tan_fovx, tan_fovy=tan_fovy)
    return project_scene_plain(scene, view, smod, oc)


class _ProjectFused(torch.autograd.Function):
    """K10 forward. The backward recomputes the plain chain on the saved
    leaves and hands the float outputs' cotangents to autograd: the JAX
    package's projection has no kernel of its own (XLA differentiates its
    ops), so the gradients are the plain chain's, bit for bit. The integer
    outputs and the include mask are not differentiable."""

    @staticmethod
    def forward(ctx, static, *inputs):
        out = _launch_project(static, *inputs)
        ctx.mark_non_differentiable(out[3], out[6], out[7], out[8])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        ctx.static = static
        return out

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [None if x is None else x.detach().requires_grad_(n)
                      for x, n in zip(ctx.saved_tensors, need)]
            proj, _ = _plain_on_inputs(ctx.static, inputs)
        pairs = [(o, g) for o, g in zip(proj, grads) if g is not None and o.requires_grad]
        wrt = [x for x, n in zip(inputs, need) if n]
        got = [None] * len(wrt)
        if pairs and wrt:
            outs, cots = zip(*pairs)
            got = list(torch.autograd.grad(outs, wrt, cots, allow_unused=True))
        got = iter(got)
        return (None, *[next(got) if n else None for n in need])


def _launch_project(static, xyz, scaling, rotation, opacity, alive, features_dc, features_rest, override_color,
                    world_view_transform, full_proj_transform, camera_center):
    """K10: the outputs of ``_ProjectFused.forward`` (``Projected``'s fields,
    then the include mask). Raises on what the kernel does not take before
    anything is launched."""
    width, height, tan_fovx, tan_fovy, degree, smod = static
    if not 0 <= degree <= 3:
        raise ValueError(f"K10 evaluates SH degrees 0-3, got {degree}")
    n = xyz.shape[0]
    rest = features_rest.shape[1] if features_rest.dim() == 3 else -1
    if not (degree + 1) ** 2 - 1 <= rest <= MAX_REST:
        raise ValueError(f"features_rest must be [C, R, 3] with {(degree + 1) ** 2 - 1} <= R <= {MAX_REST} "
                         f"at SH degree {degree}, got {list(features_rest.shape)}")
    f32 = torch.float32
    expected = [
        ("xyz", xyz, f32, (n, 3)), ("scaling", scaling, f32, (n, 3)), ("rotation", rotation, f32, (n, 4)),
        ("opacity", opacity, f32, (n, 1)), ("alive", alive, torch.bool, (n,)),
        ("features_dc", features_dc, f32, (n, 1, 3)), ("features_rest", features_rest, f32, (n, rest, 3)),
        ("world_view_transform", world_view_transform, f32, (4, 4)),
        ("full_proj_transform", full_proj_transform, f32, (4, 4)), ("camera_center", camera_center, f32, (3,)),
    ] + ([("override_color", override_color, f32, (n, 3))] if override_color is not None else [])
    for name, t, dtype, shape in expected:
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} {list(shape)}, got {t.dtype} "
                             f"{list(t.shape)}{'' if t.is_contiguous() else ' (strided)'}")
    dev = xyz.device
    devices = {t.device for _, t, _, _ in expected}
    if dev.type != "cuda" or len(devices) > 1:
        raise ValueError(f"K10 takes CUDA tensors on one device, got {sorted(map(str, devices))}")
    kw = dict(device=dev)
    means2d = torch.empty(n, 2, dtype=f32, **kw)
    depths = torch.empty(n, dtype=f32, **kw)
    conics = torch.empty(n, 3, dtype=f32, **kw)
    radii = torch.empty(n, dtype=torch.int32, **kw)
    rgbs = torch.empty(n, 3, dtype=f32, **kw)
    opac = torch.empty(n, dtype=f32, **kw)
    radii_bin = torch.empty(n, dtype=torch.int32, **kw)
    rect_bin = torch.empty(n, 2, dtype=torch.int32, **kw)
    include = torch.empty(n, dtype=torch.bool, **kw)
    out = (means2d, depths, conics, radii, rgbs, opac, radii_bin, rect_bin, include)
    # The plain chain's Python floats, each rounded to float32 once where
    # PyTorch rounds the scalar.
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)
    PROJECT_FWD.launch(
        xyz.data_ptr(), scaling.data_ptr(), rotation.data_ptr(), opacity.data_ptr(), alive.data_ptr(),
        features_dc.data_ptr(), features_rest.data_ptr(),
        None if override_color is None else override_color.data_ptr(),
        world_view_transform.data_ptr(), full_proj_transform.data_ptr(), camera_center.data_ptr(),
        n, rest, degree, width, height, smod, focal_x, focal_y, 1.3 * tan_fovx, 1.3 * tan_fovy,
        *(t.data_ptr() for t in out), torch.cuda.current_stream(dev).cuda_stream,
    )
    count("render.project.fused", 1)
    return out

"""Plain PyTorch 3D Gaussian splatting, as Kerbl et al. 2023 define it
(the upstream CUDA rasterizer's rules), for judging the port.

  * projection: EWA splatting with the 0.3 low-pass dilation, near cull at
    z <= 0.2, radius = ceil(3 sqrt(largest eigenvalue)), SH to degree 3 with
    the clamp at 0;
  * binning: every tile of the 3-sigma square (``getRect``), front to back
    by view depth;
  * compositing: alpha = min(0.99, o exp(power)), skipped when power > 0 or
    alpha < 1/255, a pixel stops before the Gaussian that would take its
    transmittance under 1e-4; pixel centres at integer coordinates;
  * loss: (1 - lambda) L1 + lambda (1 - SSIM), SSIM over an 11x11 Gaussian
    window of sigma 1.5 with zero padding;
  * Adam with eps 1e-15 and the exponential position learning rate.

Tiles are composited in blocks of similar list length so that the pixel x
Gaussian tensors fit beside the port on the card; the backward recomputes
each block under autograd from the image's gradient. ``dtype`` runs all of
it in another precision (the benchmark's control). Imports nothing of the
port.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

TILE = 16
LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
      -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


class View(NamedTuple):
    """A camera as the rasterizer reads it: transposed (row-vector) world to
    view and world to clip matrices, the centre, the fields of view."""

    world_view: torch.Tensor  # [4, 4]
    full_proj: torch.Tensor  # [4, 4]
    center: torch.Tensor  # [3]
    fovx: float
    fovy: float
    width: int
    height: int


class Projected(NamedTuple):
    means2d: torch.Tensor
    depths: torch.Tensor
    conics: torch.Tensor
    radii: torch.Tensor
    rgbs: torch.Tensor
    opacities: torch.Tensor


def sh_to_rgb(deg: int, sh: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """sh [N, K, 3], unit directions d [N, 3] -> [N, 3] (+0.5, clamped at 0)."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    out = C0 * sh[:, 0]
    if deg > 0:
        out = out - C1 * y * sh[:, 1] + C1 * z * sh[:, 2] - C1 * x * sh[:, 3]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out = (out + C2[0] * xy * sh[:, 4] + C2[1] * yz * sh[:, 5] + C2[2] * (2 * zz - xx - yy) * sh[:, 6]
               + C2[3] * xz * sh[:, 7] + C2[4] * (xx - yy) * sh[:, 8])
    if deg > 2:
        out = (out + C3[0] * y * (3 * xx - yy) * sh[:, 9] + C3[1] * xy * z * sh[:, 10]
               + C3[2] * y * (4 * zz - xx - yy) * sh[:, 11] + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
               + C3[4] * x * (4 * zz - xx - yy) * sh[:, 13] + C3[5] * z * (xx - yy) * sh[:, 14]
               + C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return torch.clamp(out + 0.5, min=0.0)


def project(fields: Dict[str, torch.Tensor], view: View, sh_degree: int) -> Projected:
    """All Gaussians of raw ``fields`` (log scales, logit opacities,
    unnormalised quaternions) through ``view``; culled ones get radius 0."""
    xyz = fields["xyz"]
    scales = torch.exp(fields["scaling"])
    q = fields["rotation"]
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    opac = torch.sigmoid(fields["opacity"][:, 0])
    sh = torch.cat([fields["features_dc"], fields["features_rest"]], dim=1)
    W, H = view.width, view.height
    tanx, tany = math.tan(view.fovx * 0.5), math.tan(view.fovy * 0.5)
    fx, fy = W / (2 * tanx), H / (2 * tany)
    hom = torch.cat([xyz, torch.ones_like(xyz[:, :1])], 1)
    pv = hom @ view.world_view.to(xyz.dtype)
    pc = hom @ view.full_proj.to(xyz.dtype)
    pw = 1.0 / (pc[:, 3] + 1e-7)
    mx = ((pc[:, 0] * pw + 1.0) * W - 1.0) * 0.5
    my = ((pc[:, 1] * pw + 1.0) * H - 1.0) * 0.5
    depth = pv[:, 2]
    front = depth > 0.2
    # Sigma = M M^T, M = R(q) diag(s).
    r, x, y, z = q.unbind(-1)
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1)], -2)
    M = R * scales[:, None, :]
    Sigma = M @ M.transpose(1, 2)
    tz = torch.where(front, depth, torch.ones_like(depth))
    tx = torch.clamp(pv[:, 0] / tz, -1.3 * tanx, 1.3 * tanx) * tz
    ty = torch.clamp(pv[:, 1] / tz, -1.3 * tany, 1.3 * tany) * tz
    zero = torch.zeros_like(tz)
    J = torch.stack([torch.stack([fx / tz, zero, -fx * tx / (tz * tz)], -1),
                     torch.stack([zero, fy / tz, -fy * ty / (tz * tz)], -1)], -2)  # [N, 2, 3]
    T = J @ view.world_view[:3, :3].T.to(xyz.dtype)
    cov = T @ Sigma @ T.transpose(1, 2)
    a, b, c = cov[:, 0, 0] + 0.3, cov[:, 0, 1], cov[:, 1, 1] + 0.3
    det = a * c - b * b
    ok = det != 0.0
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    conics = torch.stack([c * inv, -b * inv, a * inv], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    vis = front & ok
    radii = torch.where(vis, torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0))), zero).to(torch.int32)
    d = xyz - view.center.to(xyz.dtype)
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)
    rgb = sh_to_rgb(sh_degree, sh, d)
    return Projected(torch.stack([mx, my], -1), depth, conics, radii, rgb,
                     torch.where(vis, opac, torch.zeros_like(opac)))


def bin_tiles(p: Projected, width: int, height: int):
    """(gaussian of each instance in (tile, depth) order, per-tile counts,
    per-tile starts, tiles across, tiles down)."""
    gw, gh = -(-width // TILE), -(-height // TILE)
    include = (p.radii > 0) & (p.opacities.detach() >= 1.0 / 255.0)
    r = p.radii.to(torch.float32)
    m = p.means2d.detach().to(torch.float32)
    clip = lambda v, hi: torch.clamp(torch.floor(v), 0, hi).to(torch.int64)
    x0, y0 = clip((m[:, 0] - r) / TILE, gw), clip((m[:, 1] - r) / TILE, gh)
    x1, y1 = clip((m[:, 0] + r + TILE - 1) / TILE, gw), clip((m[:, 1] + r + TILE - 1) / TILE, gh)
    w = x1 - x0
    n = torch.where(include, w * (y1 - y0), torch.zeros_like(w))
    g = torch.repeat_interleave(torch.arange(len(n), device=n.device), n)
    off = torch.arange(len(g), device=n.device) - torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    tile = (y0[g] + off // w[g]) * gw + x0[g] + off % w[g]
    o = torch.argsort(p.depths.detach()[g], stable=True)
    o = o[torch.argsort(tile[o], stable=True)]
    g, tile = g[o], tile[o]
    counts = torch.bincount(tile, minlength=gw * gh)
    return g, counts, torch.cumsum(counts, 0) - counts, gw, gh


def _blocks(counts: torch.Tensor, budget: int):
    """Tiles with Gaussians, heaviest first, in blocks of at most ``budget``
    pixel x Gaussian pairs (padded to each block's longest list)."""
    order = torch.argsort(counts, descending=True, stable=True)
    c = counts[order].tolist()
    busy = sum(1 for x in c if x > 0)
    i = 0
    while i < busy:
        L = c[i]
        j = min(busy, i + max(1, budget // (TILE * TILE * L)))
        yield order[i:j], L
        i = j


def _composite(tiles, L, g, counts, starts, gw, means2d, conics, rgbs, opac, width, height):
    """One block: (colour [n, 256, 3], final T [n, 256], contributing pairs
    inside the image). Differentiable in the four property arrays."""
    dev = means2d.device
    j = torch.arange(L, device=dev)
    valid = j[None, :] < counts[tiles][:, None]
    idx = g[torch.clamp(starts[tiles][:, None] + j[None, :], max=max(len(g) - 1, 0))]
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    pix = torch.arange(TILE * TILE, device=dev)
    px = ((tiles % gw) * TILE)[:, None] + pix % TILE  # [n, 256]
    py = ((tiles // gw) * TILE)[:, None] + pix // TILE
    dt = means2d.dtype
    dx = means2d[idx, 0][:, None, :] - px[:, :, None].to(dt)  # [n, 256, L]
    dy = means2d[idx, 1][:, None, :] - py[:, :, None].to(dt)
    con = conics[idx]
    power = -0.5 * (con[..., 0][:, None] * dx * dx + con[..., 2][:, None] * dy * dy) - con[..., 1][:, None] * dx * dy
    alpha = torch.clamp(opac[idx][:, None, :] * torch.exp(power), max=0.99)
    skip = (power > 0) | (alpha < 1.0 / 255.0) | ~valid[:, None, :]
    alpha = torch.where(skip, torch.zeros_like(alpha), alpha)
    with torch.no_grad():
        om = 1.0 - alpha
        Tn = torch.cat([torch.ones_like(om[..., :1]), torch.cumprod(om, -1)[..., :-1]], -1)
        live = torch.cumsum(((~skip) & (Tn * om < 1e-4)).to(torch.int32), -1) == 0
        inside = ((px < width) & (py < height))[:, :, None]
        pairs = int((live & ~skip & inside).sum())
    a = alpha * live
    T = torch.cat([torch.ones_like(a[..., :1]), torch.cumprod(1.0 - a, -1)[..., :-1]], -1)
    color = torch.einsum("npl,nlc->npc", a * T, rgbs[idx])
    final_t = T[..., -1] * (1.0 - a[..., -1])
    return color, final_t, pairs


def _pixels(tiles, gw):
    """Flat indices [n, 256] of each tile's pixels in a (gh*16, gw*16) image."""
    pix = torch.arange(TILE * TILE, device=tiles.device)
    y = (tiles // gw * TILE)[:, None] + pix // TILE
    x = (tiles % gw * TILE)[:, None] + pix % TILE
    return y * (gw * TILE) + x


def _scatter(tiles, gw, vals, out):
    """Write per-tile pixel values [n, 256, k] into out [k, gh*16, gw*16]."""
    out.view(out.shape[0], -1)[:, _pixels(tiles, gw)] = vals.permute(2, 0, 1)


def _gather(tiles, gw, img):
    return img.reshape(img.shape[0], -1)[:, _pixels(tiles, gw)].permute(1, 2, 0)  # [n, 256, k]


def composite(p: Projected, width: int, height: int, bg: torch.Tensor, budget: int = 1 << 26,
              bins=None):
    """(image [3, H, W], final T [H, W], contributing pairs), no gradient."""
    g, counts, starts, gw, gh = bins if bins is not None else bin_tiles(p, width, height)
    dt = p.means2d.dtype
    color = torch.zeros(3, gh * TILE, gw * TILE, device=g.device, dtype=dt)
    tfin = torch.ones(1, gh * TILE, gw * TILE, device=g.device, dtype=dt)
    pairs = 0
    with torch.no_grad():
        for tiles, L in _blocks(counts, budget):
            c, t, n = _composite(tiles, L, g, counts, starts, gw, p.means2d, p.conics, p.rgbs, p.opacities,
                                 width, height)
            _scatter(tiles, gw, c, color)
            _scatter(tiles, gw, t[..., None], tfin)
            pairs += n
    img = color + tfin * bg.to(dt)[:, None, None]
    return img[:, :height, :width], tfin[0, :height, :width], pairs


def composite_backward(p: Projected, width: int, height: int, bg: torch.Tensor, d_img: torch.Tensor,
                       budget: int = 1 << 24, bins=None):
    """Backpropagate d loss / d image [3, H, W] into the projection's graph
    (the image is colour + T bg), one block of tiles at a time."""
    g, counts, starts, gw, gh = bins if bins is not None else bin_tiles(p, width, height)
    dt = p.means2d.dtype
    pad = torch.zeros(3, gh * TILE, gw * TILE, device=d_img.device, dtype=dt)
    pad[:, :height, :width] = d_img
    leaves = [t.detach().requires_grad_() for t in (p.means2d, p.conics, p.rgbs, p.opacities)]
    for tiles, L in _blocks(counts, budget):
        c, t, _ = _composite(tiles, L, g, counts, starts, gw, *leaves, width, height)
        dc = _gather(tiles, gw, pad)
        out = (c * dc).sum() + (t * (dc * bg.to(dt)).sum(-1)).sum()
        out.backward()
    torch.autograd.backward([p.means2d, p.conics, p.rgbs, p.opacities],
                            [x.grad if x.grad is not None else torch.zeros_like(x) for x in leaves])


def _window(dtype, device) -> torch.Tensor:
    g = torch.tensor([math.exp(-((x - 5) ** 2) / (2 * 1.5 ** 2)) for x in range(11)], dtype=torch.float64)
    g = (g / g.sum()).to(dtype)
    return (g[:, None] * g[None, :]).to(device)


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two [3, H, W] images."""
    w = _window(img1.dtype, img1.device)[None, None].expand(3, 1, 11, 11)
    conv = lambda x: F.conv2d(x[None], w, padding=5, groups=3)[0]
    mu1, mu2 = conv(img1), conv(img2)
    s11 = conv(img1 * img1) - mu1 * mu1
    s22 = conv(img2 * img2) - mu2 * mu2
    s12 = conv(img1 * img2) - mu1 * mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + C1) * (2 * s12 + C2)) / ((mu1 * mu1 + mu2 * mu2 + C1) * (s11 + s22 + C2))).mean()


def loss_and_grads(fields: Dict[str, torch.Tensor], view: View, gt: torch.Tensor, bg: torch.Tensor,
                   sh_degree: int, lambda_dssim: float, dtype=torch.float32):
    """One train step's forward and backward: (loss, {leaf: gradient}),
    computed in ``dtype`` (gradients returned in float32)."""
    leaves = {k: fields[k].detach().to(dtype).requires_grad_() for k in LEAVES}
    p = project(leaves, view, sh_degree)
    bins = bin_tiles(p, view.width, view.height)
    img, _, _ = composite(p, view.width, view.height, bg, bins=bins)
    img = img.detach().requires_grad_()
    gt = gt.to(dtype)
    loss = (1.0 - lambda_dssim) * torch.abs(img - gt).mean() + lambda_dssim * (1.0 - ssim(img, gt))
    (d_img,) = torch.autograd.grad(loss, img)
    composite_backward(p, view.width, view.height, bg, d_img, bins=bins)
    return float(loss.detach()), {k: leaves[k].grad.to(torch.float32) for k in LEAVES}


def expon_lr(step: int, lr_init: float, lr_final: float, max_steps: int) -> float:
    """The position learning rate: log-linear from init to final (no delay)."""
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def adam(params: Dict[str, torch.Tensor], grads, mu, nu, count: float, lrs: Dict[str, float],
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15) -> None:
    """One Adam step in place on params, mu, nu (float32)."""
    t = count + 1.0
    for k in LEAVES:
        mu[k].mul_(b1).add_((1 - b1) * grads[k])
        nu[k].mul_(b2).add_((1 - b2) * grads[k] * grads[k])
        params[k].sub_(lrs[k] * (mu[k] / (1 - b1 ** t)) / (torch.sqrt(nu[k] / (1 - b2 ** t)) + eps))

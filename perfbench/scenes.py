"""The benchmark's own inputs for the splatting cells, made on the device
from the seed: a trained-looking scene (the shapes of the port's
``tools/synthetic.py synthetic_scene``: a sphere, a ground disk, a torus and
a cylinder, drawn here with a ``torch.Generator`` on the card), orbit
cameras, and the camera matrices the rasterizer reads (the upstream
``getWorld2View2`` and ``getProjectionMatrix``).

Every seed gets the same set of camera poses in its own order, so that a
seed changes the content and the order of the work but not its amount.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference.splat import C0, View


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of ``seed`` (any whole number)."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, int(seed < 0), *tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def synthetic_scene(n: int, seed: int, device, sh_degree: int = 3) -> dict:
    """Raw fields (log scales, logit opacities, unnormalised quaternions) of
    ``n`` Gaussians: 35% sphere, 35% ground, 15% torus, 15% cylinder; scales
    from each surface's point spacing, Beta(2, 2) opacities, base colours in
    the DC band, small higher SH bands."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    f32 = dict(device=device, dtype=torch.float32)
    rand = lambda *s: torch.rand(*s, generator=g, **f32)
    randn = lambda *s: torch.randn(*s, generator=g, **f32)
    counts = {"sphere": 0, "ground": int(n * 0.35), "torus": int(n * 0.15), "cylinder": int(n * 0.15)}
    counts["sphere"] = n - sum(counts.values())
    xyz, spacing, base = [], [], []

    def part(points, area, color):
        m = points.shape[0]
        xyz.append(points)
        spacing.append(torch.full((m,), math.sqrt(area / max(m, 1)), **f32))
        base.append(color if color.ndim == 2 else color.expand(m, 3))

    m = counts["sphere"]
    u = randn(m, 3)
    part(u / torch.linalg.vector_norm(u, dim=1, keepdim=True) + torch.tensor([0.0, 0.2, 0.0], **f32),
         4 * math.pi, torch.tensor([0.8, 0.3, 0.2], **f32))
    m = counts["ground"]
    r, a = 3.0 * torch.sqrt(rand(m)), 2 * math.pi * rand(m)
    part(torch.stack([r * torch.cos(a), torch.full_like(r, -1.0), r * torch.sin(a)], 1), 9 * math.pi,
         torch.tensor([0.4, 0.5, 0.3], **f32) + 0.1 * torch.sin(3 * r)[:, None])
    m = counts["torus"]
    u, v = 2 * math.pi * rand(m), 2 * math.pi * rand(m)
    ring = 1.6 + 0.25 * torch.cos(v)
    part(torch.stack([ring * torch.cos(u), 0.2 + 0.25 * torch.sin(v), ring * torch.sin(u)], 1),
         4 * math.pi ** 2 * 1.6 * 0.25, torch.tensor([0.2, 0.3, 0.8], **f32))
    m = counts["cylinder"]
    a, h = 2 * math.pi * rand(m), 1.2 * rand(m)
    part(torch.stack([1.9 + 0.4 * torch.cos(a), -1.0 + h, -1.2 + 0.4 * torch.sin(a)], 1),
         2 * math.pi * 0.4 * 1.2, torch.tensor([0.9, 0.8, 0.3], **f32))

    color = torch.clamp(torch.cat(base) + 0.08 * randn(n, 3), 0.0, 1.0)
    scale = torch.cat(spacing)[:, None] * (0.5 + 0.6 * rand(n, 3))
    opac = torch.sort(rand(n, 3), dim=1).values[:, 1]  # the middle of three uniforms is Beta(2, 2)
    rest = (sh_degree + 1) ** 2 - 1
    return {
        "xyz": torch.cat(xyz),
        "features_dc": ((color - 0.5) / C0)[:, None, :],
        "features_rest": 0.02 * randn(n, rest, 3),
        "scaling": torch.log(scale),
        "rotation": randn(n, 4),
        "opacity": torch.log(opac / (1.0 - opac))[:, None],
    }


def _look_at(eye, target=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Blender/OpenGL camera-to-world of a camera at ``eye``."""
    eye = np.asarray(eye, np.float64)
    f = np.asarray(target, np.float64) - eye
    f /= np.linalg.norm(f)
    r = np.cross(f, [0.0, 1.0, 0.0])
    r /= np.linalg.norm(r)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = r, np.cross(r, f), -f, eye
    return c2w


def view_from_c2w(c2w: np.ndarray, fovx: float, width: int, height: int, device) -> View:
    """The rasterizer's matrices of a Blender camera-to-world, built as the
    upstream COLMAP/Blender readers and ``Camera`` build them (znear 0.01,
    zfar 100)."""
    c2w = np.array(c2w, np.float64)
    c2w[:3, 1:3] *= -1
    w2c = np.linalg.inv(c2w)
    Rt = np.eye(4)
    Rt[:3, :3], Rt[:3, 3] = w2c[:3, :3], w2c[:3, 3]
    world_view = np.float32(Rt).T
    fovy = 2 * math.atan(height / (2 * (width / (2 * math.tan(fovx / 2)))))
    zn, zf = 0.01, 100.0
    top, right = math.tan(fovy / 2) * zn, math.tan(fovx / 2) * zn
    P = np.zeros((4, 4), np.float32)
    P[0, 0], P[1, 1] = 2 * zn / (2 * right), 2 * zn / (2 * top)
    P[3, 2], P[2, 2], P[2, 3] = 1.0, zf / (zf - zn), -(zf * zn) / (zf - zn)
    full = world_view @ P.T
    center = np.linalg.inv(world_view)[3, :3]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)
    return View(t(world_view), t(full), t(center), float(fovx), float(fovy), int(width), int(height))


def orbit_views(spec: dict, seed: int, device, tag: int = 2):
    """``spec['count']`` views on orbits: azimuths evenly spaced from
    ``spec['phase']`` (in steps), heights and radii from fixed
    low-discrepancy sequences over ``spec['height']`` and
    ``spec['radius']``; the same poses for every seed, the list in a seeded
    order."""
    rng = np.random.RandomState(sub_seed(seed, tag) % 2**32)
    n = spec["count"]
    phase = spec["phase"]
    views = []
    for i in range(n):
        az = 2 * math.pi * (i + phase) / n
        h = spec["height"][0] + (spec["height"][1] - spec["height"][0]) * ((i * 0.6180339887) % 1.0)
        rad = spec["radius"][0] + (spec["radius"][1] - spec["radius"][0]) * ((i * 0.4142135624 + 0.5) % 1.0)
        eye = [rad * math.sin(az), h, rad * math.cos(az)]
        views.append(view_from_c2w(_look_at(eye), spec["fovx"], spec["width"], spec["height_px"], device))
    return [views[i] for i in rng.permutation(n)]


def cameras_extent(views) -> float:
    """The upstream ``getNerfppNorm`` radius: 1.1 x the largest distance of a
    camera centre from their mean."""
    c = torch.stack([v.center for v in views]).double()
    return float(1.1 * torch.linalg.vector_norm(c - c.mean(0), dim=1).max())

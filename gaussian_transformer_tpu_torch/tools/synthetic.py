"""A seeded synthetic scene and orbit cameras, shared by ``tools.full_gate``
and the root ``chip_smoke.py``: a trained-looking scene's fields in the JAX
package's layouts (``synthetic_scene``) and Blender/OpenGL camera-to-world
frames around it, with the camera the port's Blender reader builds from
each."""

from __future__ import annotations

import math

import numpy as np


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def synthetic_scene(n: int, seed: int):
    """Fields of a trained-looking scene in the JAX package's layouts: points
    on a sphere, a ground disk, a torus and a cylinder; per-axis log-scales
    from each surface's point spacing; Beta(2, 2) opacities; per-surface
    base colors in the SH DC band and small SH rest coefficients (degree 3)."""
    rng = np.random.RandomState(seed)
    shares = {"sphere": 0.35, "ground": 0.35, "torus": 0.15, "cylinder": 0.15}
    counts = {k: int(n * v) for k, v in shares.items()}
    counts["sphere"] += n - sum(counts.values())
    xyz, spacing, base = [], [], []
    m = counts["sphere"]  # radius 1 at (0, 0.2, 0)
    xyz.append(_unit(rng.randn(m, 3)) + [0.0, 0.2, 0.0])
    spacing.append(np.full(m, math.sqrt(4 * math.pi / m)))
    base.append(np.tile([0.8, 0.3, 0.2], (m, 1)))
    m = counts["ground"]  # disk of radius 3 at y = -1
    r, a = 3.0 * np.sqrt(rng.rand(m)), 2 * np.pi * rng.rand(m)
    xyz.append(np.stack([r * np.cos(a), np.full(m, -1.0), r * np.sin(a)], 1))
    spacing.append(np.full(m, math.sqrt(math.pi * 9.0 / m)))
    base.append(np.tile([0.4, 0.5, 0.3], (m, 1)) + 0.1 * np.sin(3 * r)[:, None])
    m = counts["torus"]  # R 1.6, r 0.25 around the sphere
    u, v = 2 * np.pi * rng.rand(m), 2 * np.pi * rng.rand(m)
    ring = 1.6 + 0.25 * np.cos(v)
    xyz.append(np.stack([ring * np.cos(u), 0.2 + 0.25 * np.sin(v), ring * np.sin(u)], 1))
    spacing.append(np.full(m, math.sqrt(4 * math.pi**2 * 1.6 * 0.25 / m)))
    base.append(np.tile([0.2, 0.3, 0.8], (m, 1)))
    m = counts["cylinder"]  # radius 0.4, height 1.2, standing on the ground
    a, h = 2 * np.pi * rng.rand(m), 1.2 * rng.rand(m)
    xyz.append(np.stack([1.9 + 0.4 * np.cos(a), -1.0 + h, -1.2 + 0.4 * np.sin(a)], 1))
    spacing.append(np.full(m, math.sqrt(2 * math.pi * 0.4 * 1.2 / m)))
    base.append(np.tile([0.9, 0.8, 0.3], (m, 1)))

    xyz = np.concatenate(xyz).astype(np.float32)
    spacing = np.concatenate(spacing)
    color = np.clip(np.concatenate(base) + 0.08 * rng.randn(n, 3), 0.0, 1.0)
    scale = spacing[:, None] * rng.uniform(0.5, 1.1, (n, 3))
    opac = rng.beta(2.0, 2.0, n)
    c0 = 0.28209479177387814
    return {
        "xyz": xyz,
        "features_dc": ((color - 0.5) / c0).astype(np.float32)[:, None, :],
        "features_rest": (0.02 * rng.randn(n, 15, 3)).astype(np.float32),
        "scaling": np.log(scale).astype(np.float32),
        "rotation": rng.randn(n, 4).astype(np.float32),
        "opacity": np.log(opac / (1.0 - opac)).astype(np.float32)[:, None],
        "alive": np.ones(n, bool),
    }


def look_at_c2w(eye, target) -> list:
    """Blender/OpenGL camera-to-world of a camera at ``eye`` looking at ``target``."""
    eye = np.asarray(eye, np.float64)
    f = _unit(np.asarray(target, np.float64) - eye)
    r = _unit(np.cross(f, [0.0, 1.0, 0.0]))
    u = np.cross(r, f)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = r, u, -f, eye
    return c2w.tolist()


def orbit_c2w(angle: float, radius: float = 4.2, height: float = 1.3) -> list:
    """Blender/OpenGL camera-to-world of a camera on a circle, looking at the origin."""
    return look_at_c2w([radius * math.sin(angle), height, radius * math.cos(angle)], [0.0, 0.0, 0.0])


def camera_from_c2w(c2w, fovx, width, height, device):
    """The camera the port's Blender reader builds from this frame."""
    from gaussian_transformer_tpu_torch.scene.cameras import Camera
    from gaussian_transformer_tpu_torch.utils.graphics import focal2fov, fov2focal

    R, t = colmap_w2c(c2w)
    return Camera.create(0, np.transpose(R), t, fovx,
                         focal2fov(fov2focal(fovx, width), height), None, None, "view", 0,
                         width=width, height=height, device=device)


def colmap_w2c(c2w):
    """COLMAP's (world-to-camera rotation, translation) of a Blender/OpenGL
    camera-to-world: the camera ``camera_from_c2w`` builds from it."""
    c2w = np.array(c2w, np.float64)
    c2w[:3, 1:3] *= -1
    w2c = np.linalg.inv(c2w)
    return w2c[:3, :3], w2c[:3, 3]


def write_colmap_binary(root, views, width: int, height: int, fovx: float, xyz, rgb, images: str = "images",
                        seed: int = 0) -> list:
    """A COLMAP binary model under ``root``: ``sparse/0/cameras.bin`` (one
    PINHOLE camera of ``fovx``), ``images.bin`` (one record per view, with a
    few seeded 2D observations each, which the readers skip),
    ``points3D.bin`` (``xyz`` [N, 3] float64, ``rgb`` [N, 3] uint8, seeded
    errors and tracks), and the views' images in ``root/images``.
    ``views``: [(camera-to-world, image)], where an image is a uint8
    [H, W, 3] array (written as ``<i:03d>.png``) or the path of an image
    file that already exists (a JPEG, say: named by its file name, and
    copied into ``root/images`` unless it is there). Returns the image
    names."""
    import shutil
    import struct
    from pathlib import Path

    from gaussian_transformer_tpu_torch.scene.colmap import rotmat2qvec
    from gaussian_transformer_tpu_torch.utils.png import write_png

    root = Path(root)
    (root / "sparse/0").mkdir(parents=True, exist_ok=True)
    (root / images).mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    focal = width / (2 * math.tan(fovx / 2))
    with open(root / "sparse/0/cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, width, height))
        f.write(struct.pack("<dddd", focal, focal, width / 2, height / 2))
    names = []
    with open(root / "sparse/0/images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(views)))
        for i, (c2w, image) in enumerate(views):
            R, t = colmap_w2c(c2w)
            if isinstance(image, (str, Path)):
                name = Path(image).name
                if not (root / images / name).exists():
                    shutil.copyfile(image, root / images / name)
            else:
                name = f"{i:03d}.png"
                write_png(str(root / images / name), image)
            f.write(struct.pack("<I", i + 1))
            f.write(struct.pack("<dddd", *rotmat2qvec(R)))
            f.write(struct.pack("<ddd", *t))
            f.write(struct.pack("<I", 1))
            f.write(name.encode() + b"\x00")
            n_obs = int(rng.randint(0, 4))
            f.write(struct.pack("<Q", n_obs))
            for _ in range(n_obs):
                f.write(struct.pack("<ddq", *rng.uniform(0, width, 2), int(rng.randint(-1, len(xyz)))))
            names.append(name)
    xyz = np.asarray(xyz, np.float64)
    rgb = np.asarray(rgb, np.uint8)
    err = rng.rand(len(xyz))
    track = rng.randint(0, 3, len(xyz))
    # Each point: a 51-byte record, then its track of 8-byte (image, point2D) pairs.
    rec = np.zeros(len(xyz), np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("err", "<f8"),
                                       ("n", "<u8")]))
    rec["id"], rec["xyz"], rec["rgb"], rec["err"], rec["n"] = np.arange(1, len(xyz) + 1), xyz, rgb, err, track
    size = rec.dtype.itemsize + 8 * track
    start = np.concatenate([[0], np.cumsum(size)[:-1]])
    buf = rng.randint(0, 256, int(size.sum())).astype(np.uint8)  # the tracks' bytes: never read
    buf[start[:, None] + np.arange(rec.dtype.itemsize)] = rec.view(np.uint8).reshape(len(xyz), -1)
    with open(root / "sparse/0/points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        f.write(buf.tobytes())
    return names

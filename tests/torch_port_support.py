"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
carry JAX scenes and cameras into the port."""

import numpy as np
import torch
from gaussian_transformer_tpu_torch.convert import camera_from_numpy, scene_from_numpy

# The suite runs in several worker processes on a few cores, and every
# worker imports this module. One torch intra-op thread each keeps their
# OpenMP pools from oversubscribing the cores (the test shapes are small).
torch.set_num_threads(1)

SCENE_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "alive")


def bf16_ulp(x):
    """One bf16 ulp of each value of a float32 array (of the smallest
    subnormal at 0)."""
    x = np.abs(np.asarray(x, np.float32))
    return np.where(x > 0, 2.0 ** (np.floor(np.log2(np.maximum(x, 1e-38))) - 7), 2.0 ** -133)


def torch_scene(jax_scene, device="cpu"):
    fields = {k: np.asarray(getattr(jax_scene, k)) for k in SCENE_FIELDS}
    return scene_from_numpy(fields, jax_scene.active_sh_degree, device)


def torch_camera(cam, device="cpu"):
    return camera_from_numpy(
        np.asarray(cam.world_view_transform), np.asarray(cam.full_proj_transform),
        np.asarray(cam.camera_center), cam.fovx, cam.fovy, cam.image_width,
        cam.image_height, device,
    )


def sequential_work(rows, px, py):
    """(walked, contributing) (row, pixel) pairs of one tile walked row by
    row as the compositor kernels walk it: rows [n, 16] front to back (means
    in the frame of the pixel centers px, py [256]). A real row (opacity > 0)
    counts as walked for every pixel still live; a pixel stops at the row
    that would take T below 1e-4, which it walks but does not contribute."""
    f32 = np.float32
    T = np.ones(px.shape, f32)
    live = np.ones(px.shape, bool)
    walked = contributing = 0
    for r in rows.astype(f32):
        if r[8] > 0:
            walked += int(live.sum())
        dx, dy = r[0] - px, r[1] - py
        power = f32(-0.5) * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy
        alpha = np.minimum(f32(0.99), r[8] * np.exp(np.minimum(power, f32(0))))
        hit = live & ~((power > 0) | (alpha < f32(1.0 / 255.0)))
        next_t = T * (f32(1) - alpha)
        stop = hit & (next_t < f32(1e-4))
        go = hit & ~stop
        contributing += int(go.sum())
        T = np.where(go, next_t, T)
        live &= ~stop
    return walked, contributing



def sequential_warp_steps(rows, px, py, lanes):
    """(steps, uniform-skip steps) of a forward kernel's warps over one tile
    walked row by row: rows [n, 16] front to back (means in the frame of the
    pixel centers px, py [256]), ``lanes`` [8, 32] the pixel of each (warp,
    lane). A warp steps through a row where any lane is still live (a pixel
    walks its terminating row); the step is a uniform skip where every live
    lane skips the row (power > 0 or alpha < 1/255)."""
    f32 = np.float32
    T = np.ones(px.shape, f32)
    live = np.ones(px.shape, bool)
    steps = uniform = 0
    for r in rows.astype(f32):
        dx, dy = r[0] - px, r[1] - py
        power = f32(-0.5) * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy
        alpha = np.minimum(f32(0.99), r[8] * np.exp(np.minimum(power, f32(0))))
        skip = (power > 0) | (alpha < f32(1.0 / 255.0))
        step = live[lanes].any(axis=1)
        steps += int(step.sum())
        uniform += int((step & ~(live & ~skip)[lanes].any(axis=1)).sum())
        hit = live & ~skip
        next_t = T * (f32(1) - alpha)
        stop = hit & (next_t < f32(1e-4))
        T = np.where(hit & ~stop, next_t, T)
        live &= ~stop
    return steps, uniform

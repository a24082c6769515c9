"""Port parity: projection (render/project.py), SH evaluation and camera math
against the JAX reference on the same seeded inputs. Integer fields exact,
floats to 1e-5 relative."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussian_transformer_tpu.render.project import project_gaussians as jax_project
from gaussian_transformer_tpu.scene.cameras import MiniCam as JaxMiniCam
from gaussian_transformer_tpu.utils import graphics as jgraphics
from gaussian_transformer_tpu.utils.sh import eval_sh as jax_eval_sh
from gaussian_transformer_tpu_torch.render.project import project_gaussians
from gaussian_transformer_tpu_torch.scene.cameras import Camera, MiniCam
from gaussian_transformer_tpu_torch.utils import graphics
from gaussian_transformer_tpu_torch.utils.sh import eval_sh

from tests.test_render import make_camera, make_scene
from tests.torch_port_support import torch_camera, torch_scene

INT_FIELDS = ("radii", "radii_bin", "rect_bin")


def _project_both(jscene, cam):
    kw = dict(
        image_width=cam.image_width,
        image_height=cam.image_height,
        tan_fovx=math.tan(cam.fovx * 0.5),
        tan_fovy=math.tan(cam.fovy * 0.5),
        active_sh_degree=jscene.active_sh_degree,
    )
    ref = jax_project(
        jscene.get_xyz, jscene.get_scaling, jscene.get_rotation, jscene.get_opacity[:, 0],
        jscene.get_features, None,
        world_view_transform=cam.world_view_transform,
        full_proj_transform=cam.full_proj_transform,
        camera_center=cam.camera_center, **kw,
    )
    ts, tc = torch_scene(jscene), torch_camera(cam)
    with torch.no_grad():
        out = project_gaussians(
            ts.get_xyz, ts.get_scaling, ts.get_rotation, ts.get_opacity[:, 0], ts.get_features, None,
            world_view_transform=tc.world_view_transform,
            full_proj_transform=tc.full_proj_transform,
            camera_center=tc.camera_center, **kw,
        )
    return ref, out


def _assert_projected_equal(ref, out):
    for name in ref._fields:
        r, o = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        assert r.shape == o.shape, name
        if name in INT_FIELDS:
            assert o.dtype == np.int32, name
            np.testing.assert_array_equal(o, r, err_msg=name)
        else:
            np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("degree", [0, 1, 3])
def test_projection_matches_reference(degree):
    cam = make_camera(width=80, height=48)
    scene = make_scene(200, seed=degree, capacity=210, max_sh_degree=max(degree, 1))
    scene = scene.replace(active_sh_degree=degree)
    ref, out = _project_both(scene, cam)
    assert int((np.asarray(ref.radii) > 0).sum()) > 50  # most of the scene is visible
    _assert_projected_equal(ref, out)


def test_projection_culls_like_reference():
    """Gaussians behind the near plane, dead slots and huge splats: the
    culled set (radius 0, opacity 0) and the clamps match exactly."""
    cam = make_camera(width=48, height=40, z=2.0)
    scene = make_scene(120, seed=7, capacity=128, spread=3.0)
    scene = scene.replace(
        alive=scene.alive.at[::5].set(False),
        scaling=scene.scaling.at[:10].set(1.0),  # splats far larger than the image
    )
    ref, out = _project_both(scene, cam)
    radii = np.asarray(ref.radii)
    assert (radii == 0).sum() > 10 and (radii > 0).sum() > 10
    _assert_projected_equal(ref, out)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches_reference(degree):
    rng = np.random.RandomState(degree)
    sh = rng.randn(64, 3, (degree + 1) ** 2).astype(np.float32)
    dirs = rng.randn(64, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ref = np.asarray(jax_eval_sh(degree, jnp.asarray(sh), jnp.asarray(dirs)))
    out = eval_sh(degree, torch.from_numpy(sh), torch.from_numpy(dirs)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_rgb_sh_conversions_match_reference():
    from gaussian_transformer_tpu.utils.sh import rgb_to_sh as jax_rgb_to_sh, sh_to_rgb as jax_sh_to_rgb
    from gaussian_transformer_tpu_torch.utils.sh import rgb_to_sh, sh_to_rgb

    rgb = np.random.RandomState(5).rand(32, 3).astype(np.float32)
    sh = rgb_to_sh(torch.from_numpy(rgb))
    np.testing.assert_array_equal(sh.numpy(), np.asarray(jax_rgb_to_sh(jnp.asarray(rgb))))
    np.testing.assert_array_equal(sh_to_rgb(sh).numpy(), np.asarray(jax_sh_to_rgb(jnp.asarray(sh.numpy()))))
    np.testing.assert_allclose(sh_to_rgb(sh).numpy(), rgb, atol=1e-6)


def test_camera_matrices_are_bit_identical():
    R = np.linalg.qr(np.random.RandomState(0).randn(3, 3))[0]
    T = np.array([0.3, -0.2, 4.0])
    np.testing.assert_array_equal(graphics.get_world2view(R, T), jgraphics.get_world2view(R, T))
    np.testing.assert_array_equal(
        graphics.get_projection_matrix(0.01, 100.0, 0.9, 0.6),
        jgraphics.get_projection_matrix(0.01, 100.0, 0.9, 0.6),
    )
    assert graphics.fov2focal(0.9, 800) == jgraphics.fov2focal(0.9, 800)
    assert graphics.focal2fov(700.0, 800) == jgraphics.focal2fov(700.0, 800)
    cam = make_camera(width=72, height=40)
    tc = torch_camera(cam)
    mini_args = (72, 40, cam.fovy, cam.fovx, 0.01, 100.0, np.asarray(cam.world_view_transform),
                 np.asarray(cam.full_proj_transform))
    jax_mini, mini = JaxMiniCam.create(*mini_args), MiniCam.create(*mini_args, device="cpu")
    rebuilt = Camera.create(0, np.eye(3), np.array([0.0, 0.0, 5.0]), cam.fovx, cam.fovy, None,
                            None, "test", 0, width=72, height=40, device="cpu")
    for name in ("world_view_transform", "full_proj_transform", "camera_center"):
        np.testing.assert_array_equal(getattr(rebuilt, name).numpy(), np.asarray(getattr(cam, name)))
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(cam, name)))
        np.testing.assert_array_equal(getattr(mini, name).numpy(), np.asarray(getattr(jax_mini, name)))

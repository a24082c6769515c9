"""The port's public helpers against their JAX counterparts on seeded numpy
inputs: ``utils/system.py mkdir_p``, ``utils/general.py get_expon_lr_func``,
``utils/graphics.py build_scaling_rotation / build_covariance_3d /
strip_symmetric``, ``utils/sh.py sh_basis``, ``scene/colmap.py
rotmat2qvec``, the cameras' reference-named properties,
``GaussianScene.get_covariance``, ``ops/knn.py dist_to_3nn_sq`` and
``render/project.py compute_cov2d``.

Tolerances (of each output's largest magnitude): 1e-6 for the float32
products and polynomials, 1e-5 for the 3-NN distances (as
``tests/test_torch_train.py``); ``rotmat2qvec`` (float64 numpy in both) and
the camera properties bit for bit."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_transformer_tpu.ops import knn as jax_knn
from gaussian_transformer_tpu.render import project as jax_project
from gaussian_transformer_tpu.scene import cameras as jax_cameras
from gaussian_transformer_tpu.scene import colmap as jax_colmap
from gaussian_transformer_tpu.utils import general as jax_general
from gaussian_transformer_tpu.utils import graphics as jax_graphics
from gaussian_transformer_tpu.utils import sh as jax_sh
from gaussian_transformer_tpu.utils import system as jax_system
from gaussian_transformer_tpu_torch.ops import knn
from gaussian_transformer_tpu_torch.render import project
from gaussian_transformer_tpu_torch.scene import cameras, colmap
from gaussian_transformer_tpu_torch.utils import general, graphics, sh, system

from tests.test_render import make_scene
from tests.torch_port_support import torch_scene


def _rng(seed=0):
    return np.random.RandomState(seed)


def _quats(n, seed=0):
    return _rng(seed).randn(n, 4).astype(np.float32)


def _scales(n, seed=1):
    return np.exp(_rng(seed).uniform(-3, 0, (n, 3))).astype(np.float32)


def _dirs(n, seed=2):
    d = _rng(seed).randn(n, 3)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _cov2d_inputs(seed=3):
    rng = _rng(seed)
    n = 64
    mean_view = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(0.5, 6, (n, 1))], 1).astype(np.float32)
    L = rng.randn(n, 3, 3).astype(np.float32) * 0.1
    cov3d = (L @ L.transpose(0, 2, 1) + 1e-3 * np.eye(3, dtype=np.float32)).astype(np.float32)
    R = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    return mean_view, cov3d, 300.0, 280.0, 0.6, 0.45, R


def _case(name):
    """(port output, JAX output, tolerance of the largest magnitude)."""
    t = torch.from_numpy
    if name.startswith("get_expon_lr_func"):
        kw = {"plain": {}, "delay": dict(lr_delay_steps=100, lr_delay_mult=0.01),
              "zero": dict(lr_init_zero=True)}[name.split("-")[1]]
        init, final = (0.0, 0.0) if kw.pop("lr_init_zero", False) else (1.6e-4 * 2.5, 1.6e-6 * 2.5)
        got_f = general.get_expon_lr_func(init, final, max_steps=30_000, **kw)
        ref_f = jax_general.get_expon_lr_func(init, final, max_steps=30_000, **kw)
        steps = [0, 1, 7, 50, 99, 100, 101, 1000, 15_000, 29_999, 30_000, 40_000]
        return (np.array([float(got_f(s)) for s in steps], np.float32),
                np.array([float(ref_f(s)) for s in steps], np.float32), 1e-6)
    if name == "build_scaling_rotation":
        s, q = _scales(50), _quats(50)
        return graphics.build_scaling_rotation(t(s), t(q)), jax_graphics.build_scaling_rotation(s, q), 1e-6
    if name == "build_covariance_3d":
        s, q = _scales(50), _quats(50)
        return (graphics.build_covariance_3d(t(s), t(q), 0.7),
                jax_graphics.build_covariance_3d(s, q, 0.7), 1e-6)
    if name == "strip_symmetric":
        c = _rng(4).randn(20, 3, 3).astype(np.float32)
        return graphics.strip_symmetric(t(c)), jax_graphics.strip_symmetric(c), 0.0
    if name.startswith("sh_basis"):
        deg, d = int(name[-1]), _dirs(100)
        return sh.sh_basis(deg, t(d)), jax_sh.sh_basis(deg, d), 1e-6
    if name == "get_covariance":
        jscene = make_scene(40, seed=5)
        return torch_scene(jscene).get_covariance(1.3).detach(), jscene.get_covariance(1.3), 1e-6
    if name == "dist_to_3nn_sq":
        pts = _rng(6).uniform(-1, 1, (300, 3)).astype(np.float32)
        return knn.dist_to_3nn_sq(t(pts)), jax_knn.dist_to_3nn_sq(jnp.asarray(pts)), 1e-5
    if name == "compute_cov2d":
        mv, c3, fx, fy, tx, ty, R = _cov2d_inputs()
        return (project.compute_cov2d(t(mv), t(c3), fx, fy, tx, ty, t(R)),
                jax_project.compute_cov2d(jnp.asarray(mv), jnp.asarray(c3), fx, fy, tx, ty, jnp.asarray(R)), 1e-6)
    if name == "rotmat2qvec":
        qs = _rng(7).randn(20, 4)
        Rs = [jax_colmap.qvec2rotmat(q / np.linalg.norm(q)) for q in qs]
        return np.stack([colmap.rotmat2qvec(R) for R in Rs]), np.stack([jax_colmap.rotmat2qvec(R) for R in Rs]), 0.0
    raise KeyError(name)


CASES = ["get_expon_lr_func-plain", "get_expon_lr_func-delay", "get_expon_lr_func-zero",
         "build_scaling_rotation", "build_covariance_3d", "strip_symmetric",
         *(f"sh_basis{d}" for d in range(5)), "get_covariance", "dist_to_3nn_sq", "compute_cov2d", "rotmat2qvec"]


@pytest.mark.parametrize("name", CASES)
def test_helper_matches_jax(name):
    got, ref, tol = _case(name)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.shape, ref.shape, got.dtype, ref.dtype)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * (np.abs(ref).max() + 1e-30))


def test_rotmat2qvec_round_trips_through_qvec2rotmat():
    for q in _rng(8).randn(50, 4):
        q = q / np.linalg.norm(q)
        q = q if q[0] >= 0 else -q
        R = colmap.qvec2rotmat(q)
        got = colmap.rotmat2qvec(R)
        np.testing.assert_allclose(got, q, atol=1e-12)
        np.testing.assert_allclose(colmap.qvec2rotmat(got), R, atol=1e-12)


def test_camera_reference_properties_match_jax():
    rng = _rng(9)
    R = np.linalg.qr(rng.randn(3, 3))[0]
    T = rng.randn(3)
    args = (3, R, T, math.radians(55.0), math.radians(40.0), None, None, "v", 3)
    got = cameras.Camera.create(*args, width=64, height=48, device="cpu")
    ref = jax_cameras.Camera.create(*args, width=64, height=48)
    assert (got.FoVx, got.FoVy) == (ref.FoVx, ref.FoVy)
    np.testing.assert_array_equal(got.R, ref.R)
    np.testing.assert_array_equal(got.T, ref.T)
    np.testing.assert_allclose(got.R, R, atol=1e-6)  # the R the camera was made from
    mini = dict(width=64, height=48, fovy=0.7, fovx=0.9, znear=0.01, zfar=100.0,
                world_view_transform=np.eye(4), full_proj_transform=np.eye(4))
    got_m = cameras.MiniCam.create(**mini, device="cpu")
    ref_m = jax_cameras.MiniCam.create(**mini)
    assert (got_m.FoVx, got_m.FoVy) == (ref_m.FoVx, ref_m.FoVy) == (0.9, 0.7)


def test_mkdir_p_matches_jax(tmp_path):
    for mod, root in ((system, tmp_path / "port"), (jax_system, tmp_path / "jax")):
        mod.mkdir_p(str(root / "a" / "b"))
        mod.mkdir_p(str(root / "a" / "b"))  # exists: no error
        assert (root / "a" / "b").is_dir()

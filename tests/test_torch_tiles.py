"""Port parity: padded-CSR binning (render/tiles.py bin_stream) must be
integer-exact against the JAX reference, field by field, on the same
projected inputs — with tile culling on and off, at two chunk sizes, and
under starved budgets where instances overflow."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussian_transformer_tpu.render.project import project_gaussians as jax_project
from gaussian_transformer_tpu.render.tiles import (
    _tile_cull_dist2 as jax_cull_dist2,
    bin_stream as jax_bin_stream,
    compute_rects as jax_compute_rects,
    num_tiles,
)
from gaussian_transformer_tpu_torch.render.tiles import _tile_cull_dist2, bin_stream, compute_rects

from tests.test_render import make_camera, make_scene

W, H = 80, 56  # 5 x 4 tiles, height not a multiple of 16


@pytest.fixture(scope="module")
def projected():
    """Projected inputs of a 300-Gaussian scene (numpy), as render() bins them."""
    cam = make_camera(width=W, height=H)
    scene = make_scene(300, seed=11, capacity=310, spread=1.2)
    p = jax_project(
        scene.get_xyz, scene.get_scaling, scene.get_rotation, scene.get_opacity[:, 0],
        scene.get_features, None,
        world_view_transform=cam.world_view_transform,
        full_proj_transform=cam.full_proj_transform, camera_center=cam.camera_center,
        image_width=W, image_height=H, tan_fovx=math.tan(cam.fovx * 0.5),
        tan_fovy=math.tan(cam.fovy * 0.5), active_sh_degree=1,
    )
    include = (np.asarray(p.radii) > 0) & (np.asarray(p.opacities) >= 1.0 / 255.0)
    return {
        "means2d": np.array(p.means2d), "depths": np.array(p.depths),
        "rect_bin": np.array(p.rect_bin), "include": include,
        "conics": np.array(p.conics), "opacities": np.array(p.opacities),
    }


def _bin_both(inp, cull, **kw):
    kw = dict(grid_w=num_tiles(W), grid_h=num_tiles(H), max_tiles_per_gaussian=1024, **kw)
    names = ("means2d", "depths", "rect_bin", "include") + (("conics", "opacities") if cull else ())
    ref = jax_bin_stream(*(jnp.asarray(inp[k]) for k in names), **kw)
    out = bin_stream(*(torch.from_numpy(inp[k]) for k in names), **kw)
    return ref, out


def _assert_binned_equal(ref, out):
    # The reference's extra field ``order`` is an identity placeholder.
    assert set(ref._fields) - set(out._fields) == {"order"}
    np.testing.assert_array_equal(np.asarray(ref.order), np.arange(len(ref.order)))
    for name in out._fields:
        r, o = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        assert o.shape == r.shape, name
        assert o.dtype == r.dtype, name
        np.testing.assert_array_equal(o, r, err_msg=name)


@pytest.mark.parametrize("cull", [True, False], ids=["cull", "nocull"])
@pytest.mark.parametrize("chunk", [32, 64])
def test_bin_stream_is_integer_exact(projected, cull, chunk):
    ref, out = _bin_both(projected, cull, chunk=chunk)
    assert int(ref.overflow) == 0 and int(ref.n_instances) > 200
    _assert_binned_equal(ref, out)


@pytest.mark.parametrize(
    "budget", [dict(max_instances=128), dict(max_stream=256), dict(max_tiles_per_gaussian=2)],
    ids=["instances", "stream", "per_gaussian"],
)
def test_bin_stream_starved_budget_overflows_identically(projected, budget):
    kw = dict(budget)
    cap = kw.pop("max_tiles_per_gaussian", None)
    names = ("means2d", "depths", "rect_bin", "include", "conics", "opacities")
    common = dict(grid_w=num_tiles(W), grid_h=num_tiles(H), chunk=32, **kw)
    common["max_tiles_per_gaussian"] = cap or 1024
    ref = jax_bin_stream(*(jnp.asarray(projected[k]) for k in names), **common)
    out = bin_stream(*(torch.from_numpy(projected[k]) for k in names), **common)
    assert int(ref.overflow) > 0
    _assert_binned_equal(ref, out)


def test_rects_and_cull_distance_match(projected):
    m, r = projected["means2d"], projected["rect_bin"]
    for radii in (r, r[:, 0]):
        ref = jax_compute_rects(jnp.asarray(m), jnp.asarray(radii), 5, 4)
        out = compute_rects(torch.from_numpy(m), torch.from_numpy(np.ascontiguousarray(radii)), 5, 4)
        for a, b in zip(ref, out):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    c, o = projected["conics"], projected["opacities"]
    ref = np.asarray(jax_cull_dist2(jnp.asarray(c), jnp.asarray(o)))
    out = _tile_cull_dist2(torch.from_numpy(c), torch.from_numpy(o)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))

"""Port parity: the table path (``RenderConfig(use_stream=False)``) forward.
``render/tiles.py bin_gaussians`` is integer-exact against the JAX binning;
the plain version of kernel K5 (what CPU tensors take) matches the JAX
``composite_tiles_pallas`` (Pallas K5 in interpret mode) on the same table,
and the port's table render matches the JAX table render, image and
transmittance to atol 2e-5 with ``overflow`` exact. K5 itself is checked on
the card by tests/test_torch_kernels.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_transformer_tpu.render import RenderConfig as JaxRenderConfig
from gaussian_transformer_tpu.render import render as jax_render
from gaussian_transformer_tpu.render.pallas_composite import (
    _build_props_table as jax_build_props_table,
    composite_tiles_pallas,
    pack_props as jax_pack_props,
)
from gaussian_transformer_tpu.render.project import project_gaussians as jax_project
from gaussian_transformer_tpu.render.tiles import bin_gaussians as jax_bin_gaussians, num_tiles
from gaussian_transformer_tpu.utils.general import inverse_sigmoid
from gaussian_transformer_tpu_torch.render import RenderConfig, prepare_table, render, render_naive
from gaussian_transformer_tpu_torch.render import stream, table_composite
from gaussian_transformer_tpu_torch.render.tiles import Binned, bin_gaussians

from tests.test_render import make_camera, make_scene
from tests.torch_port_support import sequential_warp_steps, sequential_work, torch_camera, torch_scene

ATOL = 2e-5
W, H = 80, 48  # 5 x 3 tiles
# Jitted, so that cases of one shape share a compile of the interpreted kernel.
jax_composite_tiles = jax.jit(composite_tiles_pallas, static_argnums=2)
jax_render_jit = jax.jit(jax_render)


def _projected(scene, cam):
    """The JAX projection of a scene, as render() bins it (numpy fields)."""
    p = jax_project(
        scene.get_xyz, scene.get_scaling, scene.get_rotation, scene.get_opacity[:, 0],
        scene.get_features, None,
        world_view_transform=cam.world_view_transform,
        full_proj_transform=cam.full_proj_transform, camera_center=cam.camera_center,
        image_width=cam.image_width, image_height=cam.image_height,
        tan_fovx=math.tan(cam.fovx * 0.5), tan_fovy=math.tan(cam.fovy * 0.5),
        active_sh_degree=scene.active_sh_degree,
    )
    include = (np.asarray(p.radii) > 0) & (np.asarray(p.opacities) >= 1.0 / 255.0)
    return p, include


@pytest.fixture(scope="module")
def projected():
    return _projected(make_scene(256, seed=11, capacity=263, spread=1.2), make_camera(width=W, height=H))


@pytest.mark.parametrize("kw", [
    dict(max_per_tile=160), dict(max_per_tile=8), dict(max_per_tile=4),
    dict(max_per_tile=64, max_instances=128), dict(max_per_tile=64, max_tiles_per_gaussian=2),
], ids=["fits", "cap8", "cap4", "instances", "per_gaussian"])
def test_bin_gaussians_is_integer_exact(projected, kw):
    p, include = projected
    kw = dict(grid_w=num_tiles(W), grid_h=num_tiles(H), **kw)
    ref = jax_bin_gaussians(p.means2d, p.depths, p.radii, jnp.asarray(include), **kw)
    out = bin_gaussians(*(torch.from_numpy(np.array(a)) for a in (p.means2d, p.depths, p.radii, include)), **kw)
    # The port's extra fields are its pullback layout.
    assert set(out._fields) - set(ref._fields) == {"inst_pos", "gauss_offsets", "gauss_cov"}
    T = kw["grid_w"] * kw["grid_h"]
    valid = np.asarray(ref.inst_tile) < T
    for name in ref._fields:
        r, o = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        assert o.shape == r.shape and o.dtype == r.dtype, name
        if name.startswith("inst_"):
            r, o = r[valid], o[valid]
        np.testing.assert_array_equal(o, r, err_msg=name)
    assert int(ref.n_instances) > 300
    if kw["max_per_tile"] < 160:
        assert int(ref.overflow) > 0
    # The pullback layout: inst_pos inverts the tile sort, and each
    # Gaussian's instances are its unsorted range.
    pos = out.inst_pos.long()
    assert torch.equal(torch.sort(pos).values, torch.arange(len(pos)))
    g_unsorted = out.inst_gauss.long()[pos]
    for g in np.flatnonzero(out.gauss_cov.numpy())[:40]:
        lo = int(out.gauss_offsets[g])
        hi = min(lo + int(out.gauss_cov[g]), len(pos))
        assert torch.all(g_unsorted[lo:hi] == g)


def _jax_table(seed, n, K, opacity=None, spread=1.5, width=W, height=H):
    """The JAX table-path inputs of a random scene: props [T, K_pad, 16] and
    counts [T] (numpy), and the grid width."""
    scene = make_scene(n, seed=seed, capacity=261, spread=spread)  # one shape: one compile
    if opacity is not None:
        scene = scene.replace(opacity=jnp.full_like(scene.opacity, inverse_sigmoid(jnp.asarray(opacity))))
    p, include = _projected(scene, make_camera(width=width, height=height))
    gw, gh = num_tiles(width), num_tiles(height)
    b = jax_bin_gaussians(p.means2d, p.depths, p.radii, jnp.asarray(include), grid_w=gw, grid_h=gh,
                          max_per_tile=K)
    o = b.order
    full = jax_pack_props(p.means2d[o], p.conics[o], p.rgbs[o], p.opacities[o])
    lists = b.tile_lists
    if K % 32:
        lists = jnp.pad(lists, ((0, 0), (0, 32 - K % 32)), constant_values=full.shape[0] - 1)
    props = jax_build_props_table(full, lists, b.inst_tile, b.inst_rank, b.inst_gauss)
    return np.asarray(props), np.asarray(b.tile_counts), gw


@pytest.mark.parametrize("seed,n,opacity", [(0, 64, None), (1, 256, None), (3, 96, 0.97)],
                         ids=["small", "dense", "saturated"])
def test_plain_forward_matches_pallas_interpret(seed, n, opacity):
    props, counts, gw = _jax_table(seed, n, 64, opacity, spread=0.2 if opacity else 1.5)
    ref_c, ref_t = jax_composite_tiles(jnp.asarray(props), jnp.asarray(counts, jnp.float32), gw)
    color, final_t = table_composite.composite_table_tiles_plain(
        torch.from_numpy(props.copy()), torch.from_numpy(counts.copy()), gw)
    assert color.shape == ref_c.shape and final_t.shape == ref_t.shape
    np.testing.assert_allclose(color.numpy(), np.asarray(ref_c), atol=ATOL)
    np.testing.assert_allclose(final_t.numpy(), np.asarray(ref_t), atol=ATOL)
    if opacity:
        assert float(final_t.min()) < 1e-3


@pytest.mark.parametrize("seed,n,opacity", [(1, 256, None), (3, 96, 0.97)], ids=["dense", "saturated"])
def test_plain_work_counts_match_a_sequential_walk(seed, n, opacity):
    """The pairs the kernels' bounds are computed from: walked and
    contributing (row, pixel) pairs, against a row-by-row walk of each tile."""
    props, counts, gw = _jax_table(seed, n, 64, opacity, spread=0.2 if opacity else 1.5)
    _, _, work = table_composite.composite_table_tiles_plain(
        torch.from_numpy(props.copy()), torch.from_numpy(counts.copy()), gw, count_work=True)
    p = np.arange(256)
    want = np.zeros(2, np.int64)
    for t in range(props.shape[0]):
        px = ((t % gw) * 16 + p % 16).astype(np.float32)
        py = ((t // gw) * 16 + p // 16).astype(np.float32)
        want += sequential_work(props[t], px, py)
    assert work == tuple(int(v) for v in want)
    assert 0 < work[1] < work[0]


@pytest.mark.parametrize("seed,n,K", [(0, 64, 64), (1, 256, 64), (2, 200, 8)], ids=["small", "dense", "overflow"])
def test_render_matches_reference(seed, n, K):
    cam = make_camera(width=W, height=H)
    scene = make_scene(n, seed=seed, capacity=261)
    bg = np.array([0.15, 0.25, 0.35], np.float32)
    ref = jax_render_jit(cam, scene, JaxRenderConfig(max_per_tile=K, use_stream=False), jnp.asarray(bg))
    with torch.no_grad():
        out = render(torch_camera(cam), torch_scene(scene), RenderConfig(max_per_tile=K, use_stream=False),
                     bg_color=torch.from_numpy(bg))
    assert set(out) == set(ref)
    np.testing.assert_allclose(out["render"].numpy(), np.asarray(ref["render"]), atol=ATOL)
    np.testing.assert_allclose(out["final_T"].numpy(), np.asarray(ref["final_T"]), atol=ATOL)
    assert int(out["overflow"]) == int(ref["overflow"]) and int(out["n_instances"]) == int(ref["n_instances"])
    assert int(out["overflow"]) > 0 or K > 8
    np.testing.assert_array_equal(out["radii"].numpy(), np.asarray(ref["radii"]))


def test_render_saturation_matches_reference_and_golden():
    cam = make_camera(width=32, height=32)
    scene = make_scene(96, seed=3, spread=0.2)
    scene = scene.replace(opacity=jnp.full_like(scene.opacity, inverse_sigmoid(jnp.asarray(0.97))))
    cfg = dict(max_per_tile=96, use_stream=False)
    ref = jax_render(cam, scene, JaxRenderConfig(**cfg), bg_color=jnp.ones(3))
    tc, ts = torch_camera(cam), torch_scene(scene)
    with torch.no_grad():
        out = render(tc, ts, RenderConfig(**cfg), bg_color=torch.ones(3))
        golden = render_naive(tc, ts, bg_color=torch.ones(3))
    np.testing.assert_allclose(out["render"].numpy(), np.asarray(ref["render"]), atol=ATOL)
    np.testing.assert_allclose(out["final_T"].numpy(), np.asarray(ref["final_T"]), atol=ATOL)
    np.testing.assert_allclose(out["render"].numpy(), golden["render"].numpy(), atol=ATOL)
    assert int(out["overflow"]) == 0 and float(out["final_T"].min()) < 1e-3


def test_table_and_stream_renders_agree():
    """Both paths walk the same front-to-back lists when nothing overflows."""
    cam = torch_camera(make_camera(width=64, height=48))
    scene = torch_scene(make_scene(128, seed=2))
    with torch.no_grad():
        a = render(cam, scene, RenderConfig(max_per_tile=160, use_stream=False))
        b = render(cam, scene, RenderConfig())
        s = prepare_table(cam, scene, RenderConfig(max_per_tile=160, use_stream=False))
    assert isinstance(s.binned, Binned) and s.props().shape == (12, 160, 16)
    assert int(a["overflow"]) == 0
    np.testing.assert_allclose(a["render"].numpy(), b["render"].numpy(), atol=ATOL)
    np.testing.assert_allclose(a["final_T"].numpy(), b["final_T"].numpy(), atol=ATOL)


def test_empty_scene_and_device_policy():
    from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene

    cam = torch_camera(make_camera(width=64, height=48))
    bg = torch.tensor([0.2, 0.4, 0.6])
    with torch.no_grad():
        out = render(cam, GaussianScene.empty(8, 1, device="cpu"), RenderConfig(use_stream=False), bg_color=bg)
    img = out["render"].numpy()
    assert img.shape == (3, 48, 64) and int(out["overflow"]) == 0
    np.testing.assert_allclose(img, np.broadcast_to(bg.numpy()[:, None, None], img.shape), atol=1e-6)
    np.testing.assert_allclose(out["final_T"].numpy(), 1.0)
    props = torch.zeros(2, 32, 16, device="meta")
    with pytest.raises(ValueError):
        table_composite.composite_table_tiles(props, torch.zeros(2, dtype=torch.int32, device="meta"), 1)
    # Shapes the kernels do not take are refused before any launch, and the
    # CPU path refuses them too (a K off the chunk grid would lose rows).
    counts = torch.zeros(2, dtype=torch.int32)
    for bad in (torch.zeros(2, 40, 16), torch.zeros(2, 32, 9), torch.zeros(2, 32, 16, dtype=torch.float64)):
        for fn in (table_composite._checked_table, lambda p, c: table_composite.composite_table_tiles(p, c, 1)):
            with pytest.raises(ValueError):
                fn(bad, counts)
    for bad_counts in (torch.zeros(2), torch.zeros(3, dtype=torch.int32)):
        with pytest.raises(ValueError):
            table_composite._checked_table(torch.zeros(2, 32, 16), bad_counts)
        with pytest.raises(ValueError):
            table_composite.composite_table_tiles(torch.zeros(2, 32, 16), bad_counts, 1)


@pytest.mark.parametrize("K,overflow", [(256, False), (16, True)])
def test_real_rows_of_the_table_are_the_counts(K, overflow):
    """Rows [0, min(counts, K)) of each tile's slab are the real instances
    of the tile's list and every later row of the slab (padded to a multiple
    of 32) is the zero sentinel, also where the list cap drops instances
    (overflow); so K5's walk to ``walked_rows`` (counts rounded up to 32)
    reads at most 31 sentinel rows a tile, which change nothing."""
    scene = torch_scene(make_scene(200, seed=4, spread=1.2))
    with torch.no_grad():
        s = prepare_table(torch_camera(make_camera(width=W, height=H)), scene,
                          RenderConfig(use_stream=False, max_per_tile=K))
        props = s.props()
    b = s.binned
    assert (int(b.overflow) > 0) == overflow
    C = scene.get_xyz.shape[0]
    n_real = torch.clamp(b.tile_counts.long(), 0, props.shape[1])
    k = torch.arange(props.shape[1])[None, :]
    inside = k < n_real[:, None]
    assert props.shape[1] % 32 == 0 and int(n_real.max()) > 0
    assert bool(torch.all((b.tile_lists < C) == inside[:, :b.tile_lists.shape[1]]))
    assert bool(torch.all(props[inside][:, 8] > 0)) and bool(torch.all(props[~inside] == 0))
    walked = table_composite.walked_rows(b.tile_counts, props.shape[1])
    assert bool(torch.all(n_real <= walked)) and bool(torch.any(n_real < walked))


@pytest.mark.parametrize("seed,n,opacity", [(1, 256, None), (3, 96, 0.97)], ids=["dense", "saturated"])
def test_warp_step_counts_match_a_sequential_walk(seed, n, opacity):
    """K5's warp steps and uniform-skip steps as ``table_warp_steps`` counts
    them from the plain rounds, against a row-by-row walk of each tile's
    slab to its ``walked_rows`` with K5's 8x4 warps."""
    props, counts, gw = _jax_table(seed, n, 64, opacity, spread=0.2 if opacity else 1.5)
    p = np.arange(256)
    lanes = stream.warp_lanes().numpy()
    end = table_composite.walked_rows(torch.from_numpy(counts.copy()), 64).numpy()
    assert np.any(end > counts)  # some walks read sentinel rows
    want = np.zeros(2, np.int64)
    for t in range(props.shape[0]):
        px = ((t % gw) * 16 + p % 16).astype(np.float32)
        py = ((t // gw) * 16 + p // 16).astype(np.float32)
        want += sequential_warp_steps(props[t, :end[t]], px, py, lanes)
    got = table_composite.table_warp_steps(torch.from_numpy(props.copy()), torch.from_numpy(counts.copy()), gw)
    assert got == tuple(int(v) for v in want)
    assert 0 < got[1] < got[0]

"""Port parity: the stream compositor (render/stream.py). The port's plain
version (what CPU tensors take) against the JAX ``stream_image``, which runs
the Pallas kernel K1 in interpret mode, on the same binned stream: image and
transmittance to atol 2e-5. Also the brute-force golden, saturation, the
empty scene and the options not ported yet. Kernel K1 itself is checked on
the card by tests/test_torch_kernels.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussian_transformer_tpu.render import RenderConfig as JaxRenderConfig
from gaussian_transformer_tpu.render import render as jax_render
from gaussian_transformer_tpu.render import render_naive as jax_render_naive
from gaussian_transformer_tpu.render.stream import stream_image as jax_stream_image
from gaussian_transformer_tpu.render.tiles import bin_stream as jax_bin_stream, num_tiles
from gaussian_transformer_tpu.utils.general import inverse_sigmoid
from gaussian_transformer_tpu_torch.render import RenderConfig, prepare_stream, render, render_naive
from gaussian_transformer_tpu_torch.render import stream
from gaussian_transformer_tpu_torch.render.tiles import StreamBinned

from tests.test_render import make_camera, make_scene
from tests.torch_port_support import sequential_warp_steps, sequential_work, torch_camera, torch_scene

ATOL = 2e-5


def _jax_stream_inputs(seed, n, width, height, chunk):
    """A JAX-projected, JAX-binned stream (numpy fields) of a random scene."""
    import math

    from gaussian_transformer_tpu.render.project import project_gaussians

    cam = make_camera(width=width, height=height)
    scene = make_scene(n, seed=seed, capacity=n + 5)
    p = project_gaussians(
        scene.get_xyz, scene.get_scaling, scene.get_rotation, scene.get_opacity[:, 0],
        scene.get_features, None,
        world_view_transform=cam.world_view_transform,
        full_proj_transform=cam.full_proj_transform, camera_center=cam.camera_center,
        image_width=width, image_height=height, tan_fovx=math.tan(cam.fovx * 0.5),
        tan_fovy=math.tan(cam.fovy * 0.5), active_sh_degree=1,
    )
    gw, gh = num_tiles(width), num_tiles(height)
    include = (p.radii > 0) & (p.opacities >= 1.0 / 255.0)
    binned = jax_bin_stream(p.means2d, p.depths, p.rect_bin, include, p.conics, p.opacities,
                            grid_w=gw, grid_h=gh, max_tiles_per_gaussian=1024, chunk=chunk)
    return p, binned, gw, gh


@pytest.mark.parametrize("seed,n,chunk", [(0, 64, 32), (1, 256, 64)])
def test_plain_compositor_matches_pallas_interpret(seed, n, chunk):
    p, binned, gw, gh = _jax_stream_inputs(seed, n, 80, 48, chunk)
    bg = np.array([0.15, 0.25, 0.35], np.float32)
    ref_img, ref_t = jax_stream_image(binned, p.means2d, p.conics, p.rgbs, p.opacities,
                                      jnp.asarray(bg), grid_w=gw, grid_h=gh)
    tb = StreamBinned(**{k: torch.from_numpy(np.array(getattr(binned, k))) for k in StreamBinned._fields})
    t = lambda a: torch.from_numpy(np.array(a))
    img, t_map = stream.stream_image(tb, t(p.means2d), t(p.conics), t(p.rgbs), t(p.opacities),
                                     torch.from_numpy(bg), grid_w=gw, grid_h=gh)
    assert img.shape == (3, gh * 16, gw * 16)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), atol=ATOL)
    np.testing.assert_allclose(t_map.numpy(), np.asarray(ref_t), atol=ATOL)


def test_render_matches_naive_goldens():
    """The port's tiled render against its own brute-force golden and the
    reference's golden."""
    cam = make_camera(width=64, height=32)
    scene = make_scene(128, seed=2)
    tc, ts = torch_camera(cam), torch_scene(scene)
    with torch.no_grad():
        out = render(tc, ts, bg_color=torch.zeros(3))
        golden = render_naive(tc, ts, bg_color=torch.zeros(3))
    ref = jax_render_naive(cam, scene, bg_color=jnp.zeros(3))
    np.testing.assert_allclose(out["render"].numpy(), golden["render"].numpy(), atol=ATOL)
    np.testing.assert_allclose(golden["render"].numpy(), np.asarray(ref["render"]), atol=ATOL)
    np.testing.assert_allclose(golden["final_T"].numpy(), np.asarray(ref["final_T"]), atol=ATOL)


def test_saturation_matches_reference():
    """Opaque, overlapping splats: most pixels terminate (T < 1e-3)."""
    cam = make_camera(width=32, height=32)
    scene = make_scene(96, seed=3, spread=0.2)
    scene = scene.replace(opacity=jnp.full_like(scene.opacity, inverse_sigmoid(jnp.asarray(0.97))))
    ref = jax_render(cam, scene, JaxRenderConfig(), bg_color=jnp.ones(3))
    with torch.no_grad():
        out = render(torch_camera(cam), torch_scene(scene), bg_color=torch.ones(3))
    np.testing.assert_allclose(out["render"].numpy(), np.asarray(ref["render"]), atol=ATOL)
    np.testing.assert_allclose(out["final_T"].numpy(), np.asarray(ref["final_T"]), atol=ATOL)
    assert float(out["final_T"].min()) < 1e-3


def test_empty_scene_is_background():
    from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene

    cam = torch_camera(make_camera(width=64, height=48))
    bg = torch.tensor([0.2, 0.4, 0.6])
    with torch.no_grad():
        out = render(cam, GaussianScene.empty(8, 1, device="cpu"), bg_color=bg)
    img = out["render"].numpy()
    assert img.shape == (3, 48, 64) and int(out["overflow"]) == 0
    np.testing.assert_allclose(img, np.broadcast_to(bg.numpy()[:, None, None], img.shape), atol=1e-6)
    np.testing.assert_allclose(out["final_T"].numpy(), 1.0)


def test_unported_options_raise():
    """What still raises in both packages: ``layout="transposed"`` on the
    stream path (the JAX package retired that kernel to attic/stream_t.py;
    the port serves it through attic/stream_t.py stream_image_t). The
    table paths do not read ``layout``, so there both packages render; so
    does every other option (tests/test_torch_bf16_stream.py,
    tests/test_torch_composite.py compare the images)."""
    cam = make_camera(width=32, height=32)
    scene = make_scene(16, seed=0)
    tc, ts = torch_camera(cam), torch_scene(scene)
    with pytest.raises(NotImplementedError):
        jax_render(cam, scene, JaxRenderConfig(layout="transposed", precision="bf16"))
    with pytest.raises(NotImplementedError):
        render(tc, ts, RenderConfig(layout="transposed", precision="bf16"))
    for kw in ({"use_stream": False}, {"use_pallas": False}, {"use_pallas": False, "use_stream": False}):
        ref = jax_render(cam, scene, JaxRenderConfig(layout="transposed", **kw))
        with torch.no_grad():
            out = render(tc, ts, RenderConfig(layout="transposed", **kw))
        np.testing.assert_allclose(out["render"].numpy(), np.asarray(ref["render"]), atol=ATOL)


@pytest.mark.parametrize("seed,n,opacity", [(1, 256, None), (3, 96, 0.97)], ids=["dense", "saturated"])
def test_plain_work_counts_match_a_sequential_walk(seed, n, opacity):
    """The pairs the kernels' bounds are computed from: walked and
    contributing (row, pixel) pairs, against a row-by-row walk of each
    tile's run."""
    scene = make_scene(n, seed=seed, spread=0.2 if opacity else 1.5)
    if opacity:
        scene = scene.replace(opacity=jnp.full_like(scene.opacity, inverse_sigmoid(jnp.asarray(opacity))))
    cam = torch_camera(make_camera(width=64, height=48))
    with torch.no_grad():
        s = prepare_stream(cam, torch_scene(scene), RenderConfig(chunk=32))
        props, ct = s.props(), s.chunk_tile
        work = stream.composite_stream_tiles_plain(props, ct, s.grid_w, s.grid_h, count_work=True)[2]
    chunks = props.numpy().reshape(ct.shape[0], -1, 16)
    p = np.arange(256)
    want = np.zeros(2, np.int64)
    for t in range(s.grid_w * s.grid_h):
        rows = chunks[ct.numpy() == t].reshape(-1, 16).copy()
        rows[:, 0] -= (t % s.grid_w) * 16  # tile-local means, as the stream kernels read them
        rows[:, 1] -= (t // s.grid_w) * 16
        want += sequential_work(rows, (p % 16).astype(np.float32), (p // 16).astype(np.float32))
    assert work == tuple(int(v) for v in want)
    assert 0 < work[1] < work[0]



@pytest.mark.parametrize("chunk,overflow", [(32, False), (32, True), (512, False), (512, True)])
def test_real_row_ranges_are_the_real_rows(chunk, overflow):
    """K1's walk, [row_start, row_end) of each tile as the wrapper computes
    it: the run's first chunk start plus its tile count. Those rows are the
    real ones (Gaussian < C) and the rest of the run is sentinel, also when
    the stream budget cuts runs (overflow)."""
    scene = torch_scene(make_scene(200, seed=4, spread=1.2))
    cam = torch_camera(make_camera(width=80, height=48))
    with torch.no_grad():
        b = prepare_stream(cam, scene, RenderConfig(chunk=chunk)).binned
        if overflow:
            b = prepare_stream(cam, scene, RenderConfig(chunk=chunk, max_stream=int(b.n_padded) // 2)).binned
    assert (int(b.overflow) > 0) == overflow
    C, T = scene.get_xyz.shape[0], b.tile_counts.shape[0]
    stream_gauss, ct = stream.used_stream(b)
    real = (stream_gauss < C).numpy()
    row_start, row_end = (v.numpy() for v in stream.real_row_ranges(ct, b.tile_counts, T, chunk))
    start, end = (v.numpy() for v in stream.tile_chunk_ranges(ct, T))
    assert np.array_equal(row_start, start * chunk)
    for t in range(T):
        assert real[row_start[t]:row_end[t]].all()
        assert not real[row_end[t]:end[t] * chunk].any()
    assert int((row_end - row_start).sum()) == int(real.sum()) > 0
    assert (row_end < end * chunk).any()  # some runs do pad past their real rows
    # A count larger than its run ends at the run's padded end, never in the next tile's run.
    over = stream.real_row_ranges(ct, b.tile_counts + 10 * chunk, T, chunk)[1].numpy()
    assert np.array_equal(over, end * chunk)


def skip_floor(opac: np.ndarray) -> np.ndarray:
    """The kernels' per-row skip floor P_row (``csrc/stream_common.cuh
    skip_floor``), in float32 as they form it: log(fl(1/255 / opacity)) -
    1e-3 for 0 < opacity <= 1e30, +inf for opacity 0 (every pair skips) and
    -inf otherwise (no early skip)."""
    f32 = np.float32
    opac = np.asarray(opac, f32)
    ok = (opac > 0) & (opac <= f32(1e30))
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        floor = np.log(f32(1.0 / 255.0) / np.where(ok, opac, f32(1))) - f32(1e-3)
    return np.where(ok, floor, np.where(opac == 0, f32(np.inf), f32(-np.inf))).astype(f32)


def test_skip_floor_implies_the_exact_skip():
    """The kernels' exp-free skip: power < P_row (the row's floor, formed in
    float32 as the kernels form it) must imply the exact test's skip,
    fl(opacity * exp(min(power, 0))) < 1/255. A float32 sweep of opacity over
    [1/255, 1] and of power from 64 ulps to 0.05 below each floor; the floor
    sits within 2e-3 of the true threshold (not vacuous); and the edge
    opacities (0: skip all; NaN, negative, above 1e30: no early skip)."""
    f32 = np.float32
    rng = np.random.RandomState(0)
    lo = f32(1.0 / 255.0)
    opac = np.concatenate([np.geomspace(lo, 1.0, 3000), rng.uniform(lo, 1.0, 3000),
                           [lo, np.nextafter(lo, f32(1)), 0.99, 1.0]]).astype(f32)
    floor = skip_floor(opac)
    assert floor.dtype == np.float32 and np.all(floor < 0)
    # floor < 0: a float further from zero has a larger bit pattern.
    ulps = (floor.view(np.int32)[:, None] + np.arange(1, 65, dtype=np.int32)).view(f32)
    steps = floor[:, None] - np.linspace(0.0, 0.05, 257, dtype=f32)[None, 1:]
    power = np.concatenate([ulps, steps], axis=1)
    assert np.all(power < floor[:, None])
    alpha = np.minimum(f32(0.99), opac[:, None] * np.exp(np.minimum(power, f32(0))))
    assert alpha.dtype == np.float32 and np.all(alpha < lo)
    above = opac.astype(np.float64) * np.exp(floor.astype(np.float64) + 2e-3)
    assert np.all(above >= 1.0 / 255.0)
    got = skip_floor(np.array([0.0, -0.0, np.nan, -0.5, 2e30, 1e-44], np.float32)).tolist()
    assert got[:2] == [float("inf")] * 2 and got[2:5] == [float("-inf")] * 3
    assert got[5] == float("inf")  # 1/255 / 1e-44 overflows: no alpha reaches 1/255


@pytest.mark.parametrize("seed,n,opacity", [(1, 256, None), (3, 96, 0.97)], ids=["dense", "saturated"])
def test_warp_step_counts_match_a_sequential_walk(seed, n, opacity):
    """K1's warp steps and uniform-skip steps as ``stream_warp_steps``
    counts them from the plain rounds, against a row-by-row walk of each
    tile's real rows with K1's 8x4 warps."""
    scene = make_scene(n, seed=seed, spread=0.2 if opacity else 1.5)
    if opacity:
        scene = scene.replace(opacity=jnp.full_like(scene.opacity, inverse_sigmoid(jnp.asarray(opacity))))
    with torch.no_grad():
        s = prepare_stream(torch_camera(make_camera(width=64, height=48)), torch_scene(scene), RenderConfig(chunk=64))
        props, ct, counts = s.props(), s.chunk_tile, s.binned.tile_counts
    T = s.grid_w * s.grid_h
    chunks = props.numpy().reshape(ct.shape[0], -1, 16)
    p = np.arange(256)
    px, py = (p % 16).astype(np.float32), (p // 16).astype(np.float32)
    lanes = stream.warp_lanes().numpy()
    assert sorted(lanes.ravel()) == list(range(256))
    assert all(len(set(lanes[w] // 16)) == 4 and len(set(lanes[w] % 16)) == 8 for w in range(8))  # 8x4 blocks
    want = np.zeros(2, np.int64)
    for t in range(T):
        rows = chunks[ct.numpy() == t].reshape(-1, 16)[:int(counts[t])].copy()
        rows[:, 0] -= (t % s.grid_w) * 16
        rows[:, 1] -= (t // s.grid_w) * 16
        want += sequential_warp_steps(rows, px, py, lanes)
    got = stream.stream_warp_steps(props, ct, counts, s.grid_w, s.grid_h)
    assert got == tuple(int(v) for v in want)
    assert 0 < got[1] < got[0]

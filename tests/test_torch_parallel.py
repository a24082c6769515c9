"""Port parity for the 3DGS half of the multi-device tier
(gaussian_transformer_tpu_torch/parallel/) against the JAX package's
``parallel/`` on the same seeded inputs: the JAX functions run on the
virtual 8-device CPU mesh of tests/conftest.py in this process, the port on
2, 3 and 4 gloo ranks spawned by ``tests/torch_dist_workers.py`` (torch and
the port only).

Inputs and bounds are the JAX package's own tests'
(tests/test_parallel.py): ``_synthetic_scene_and_cams(n=120, n_cams=4,
48x32, seed=31)``; the manual Gaussian-sharded step on a (data, gauss) mesh
of (2, 1), (1, 3) and (2, 2) against the JAX package's unsharded batched
step: loss 1e-5 relative, the parameters and Adam's moments 1e-6, the
densify statistics 1e-5; the tile-sharded render at D = 3 and 4 against the
JAX package's ``render_tile_sharded`` at the same D: image and final T
2e-5, gradients 2e-4 x max|grad|; against the port's own ``render()``: 3e-4
(forward) and 1e-3 x max|grad| (the JAX test's bounds for its tile-sharded
render against its render); the tile-sharded step against the port's
batched step: loss 1e-3 relative, xyz 1e-5, the gradient accumulator 1e-4.
The collectives' transposes are checked exactly; the butterfly fold issues
a collective-permute and no all-gather of frame_bytes x (D - 1).

Cost: three spawns (2, 3 and 4 ranks, ~10-20 s each) and ~50 s of JAX
compiles (the unsharded step, the tile-sharded render and gradient at two
mesh sizes).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussian_transformer_tpu.parallel import make_mesh as jax_make_mesh
from gaussian_transformer_tpu.parallel import make_sharded_train_step as jax_step_fn
from gaussian_transformer_tpu.parallel import stack_cameras as jax_stack
from gaussian_transformer_tpu.parallel.fsdp import leaf_spec as jax_leaf_spec
from gaussian_transformer_tpu.parallel.tile_shard import render_tile_sharded as jax_render_tile_sharded
from gaussian_transformer_tpu.render import RenderConfig as JaxRenderConfig
from gaussian_transformer_tpu.scene.densify import DensifyStats as JaxStats
from gaussian_transformer_tpu.train.optim import AdamState as JaxAdam
from gaussian_transformer_tpu.train.splat import OptConfig as JaxOptConfig
from gaussian_transformer_tpu_torch.config import OptConfig
from gaussian_transformer_tpu_torch.parallel import audit, fsdp
from gaussian_transformer_tpu_torch.parallel.collectives import Collective
from gaussian_transformer_tpu_torch.parallel.health import CrashSaver
from gaussian_transformer_tpu_torch.parallel.step import camera_at, make_sharded_train_step, stack_cameras
from gaussian_transformer_tpu_torch.parallel.tile_shard import shard_chunk_range, shard_tile_counts
from gaussian_transformer_tpu_torch.render import RenderConfig, prepare_stream, render
from gaussian_transformer_tpu_torch.render.tiles import TILE, num_tiles
from gaussian_transformer_tpu_torch.scene.densify import DensifyStats
from gaussian_transformer_tpu_torch.scene.gaussians import TensorScene
from gaussian_transformer_tpu_torch.train.optim import PARAM_LEAVES, AdamState

from tests.test_parallel import _setup
from tests.torch_dist_workers import Spawned, cameras
from tests.torch_port_support import SCENE_FIELDS

MESHES = {2: (2, 1), 3: (1, 3), 4: (2, 2)}
TILE_BG = np.array([0.2, 0.3, 0.1], np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def case():
    """The JAX scene and cameras, and the same as the workers' inputs."""
    scene, cams = _setup()
    inputs = {f"scene.{k}": np.asarray(getattr(scene, k)) for k in SCENE_FIELDS}
    inputs["scene.active_sh_degree"] = np.asarray(scene.active_sh_degree)
    inputs["cam.n"] = np.asarray(len(cams))
    for i, c in enumerate(cams):
        for k, v in (("wvt", c.world_view_transform), ("fpt", c.full_proj_transform), ("center", c.camera_center),
                     ("fovx", c.fovx), ("fovy", c.fovy), ("width", c.image_width), ("height", c.image_height),
                     ("image", c.original_image)):
            inputs[f"cam.{i}.{k}"] = np.asarray(v)
    inputs["tile_bg"] = TILE_BG
    return scene, cams, inputs


@pytest.fixture(scope="module")
def runs(case, tmp_path_factory):
    """Each world's worker results; every world starts at the first use and
    runs while this process compiles the JAX references."""
    _, _, inputs = case
    started = {w: Spawned("tier_3dgs", w, dict(inputs, mesh=np.asarray(m)), tmp_path_factory.mktemp(f"w{w}"))
               for w, m in MESHES.items()}
    return lambda world: started[world].result()


@pytest.fixture(scope="module")
def jax_batched(case):
    """The JAX package's unsharded batched step (its ``mesh=None`` form)."""
    scene, cams, _ = case
    step = jax_step_fn(JaxOptConfig(), JaxRenderConfig(max_per_tile=64))
    s, a, st, m = step(scene, JaxAdam.init(scene), JaxStats.init(scene.capacity), jax_stack(cams), jnp.zeros(3),
                       jnp.asarray(1.0), jnp.asarray(1.0))
    return jax.tree.map(np.asarray, (s, a, st, m))


@pytest.fixture(scope="module")
def jax_tile(case):
    """The JAX package's tile-sharded render of camera 0 and its gradients
    (xyz, opacity, screen offset) at D = 3 and 4."""
    scene, cams, _ = case
    cfg = JaxRenderConfig(use_pallas=True, use_stream=True)
    cache = {}

    def get(D):
        if D not in cache:
            mesh = jax_make_mesh(jax.devices()[:D], data=1)

            def loss(xyz, opacity, off):
                out = jax_render_tile_sharded(cams[0], scene.replace(xyz=xyz, opacity=opacity), cfg, mesh,
                                              bg_color=jnp.asarray(TILE_BG), screenspace_offset=off)
                return jnp.sum(out["render"] ** 2) + 0.1 * jnp.sum(out["final_T"]), (out["render"], out["final_T"])

            (_, (img, t)), g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
                scene.xyz, scene.opacity, jnp.zeros((scene.capacity, 2)))
            cache[D] = {"render": np.asarray(img), "final_T": np.asarray(t),
                        **{f"g_{k}": np.asarray(v) for k, v in zip(("xyz", "opacity", "offset"), g)}}
        return cache[D]

    return get


def _port_inputs(inputs):
    from tests.torch_dist_workers import _scene

    return _scene(inputs), stack_cameras(cameras(inputs))


def _assemble(results, key, gauss):
    """A whole array from the ranks' row shards (gauss coordinate order)."""
    by_g = {}
    for r in results:
        g = int(r["manual.coord"][1])
        if g in by_g:  # the data axis holds replicas of the same rows
            np.testing.assert_array_equal(r[key], by_g[g], err_msg=f"{key}: data replicas differ")
        by_g[g] = r[key]
    assert sorted(by_g) == list(range(gauss))
    return np.concatenate([by_g[g] for g in range(gauss)])


# --------------------------------------------------------- the manual step ---


@pytest.mark.parametrize("world", [2, 3, 4])
def test_manual_step_matches_the_unsharded_jax_step(runs, jax_batched, world):
    results = runs(world)
    s, a, st, m = jax_batched
    gauss = MESHES[world][1]
    for r in results:
        assert float(r["manual.loss"]) == pytest.approx(float(m["loss"]), rel=1e-5)
        assert int(r["manual.n_visible"]) == int(m["n_visible"])
    for k in PARAM_LEAVES:
        np.testing.assert_allclose(_assemble(results, f"manual.{k}", gauss), getattr(s, k), rtol=0, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(_assemble(results, f"manual.mu.{k}", gauss), a.mu[k], rtol=0, atol=1e-6,
                                   err_msg=f"mu.{k}")
        np.testing.assert_allclose(_assemble(results, f"manual.nu.{k}", gauss), a.nu[k], rtol=0, atol=1e-6,
                                   err_msg=f"nu.{k}")
    for key, ref in (("accum", st.xyz_gradient_accum), ("denom", st.denom), ("max_radii2d", st.max_radii2d)):
        np.testing.assert_allclose(_assemble(results, f"manual.{key}", gauss), ref, rtol=0, atol=1e-5, err_msg=key)


def _report(r, prefix):
    dims = lambda s: tuple(int(d) for d in s[s.index("[") + 1:-1].split(",") if d)
    return [Collective(op, tuple(dims(x) for x in shapes.split(";")), shapes.split(";")[0].split("[")[0], int(b))
            for op, shapes, b in zip(r[f"{prefix}.rec.ops"], r[f"{prefix}.rec.shapes"], r[f"{prefix}.rec.bytes"])]


@pytest.mark.parametrize("world", [2, 3, 4])
def test_manual_step_gathers_only_the_projected_arrays(case, runs, world):
    scene, _, _ = case
    data, gauss = MESHES[world]
    n_cams = 4 // data
    for r in runs(world):
        report = audit.collective_report(_report(r, "manual"))
        gathers = [c for c in report if c.op == "all-gather"]
        # The 7 projected arrays of each local camera, each [C, <= 3] rows.
        assert len(gathers) == 7 * n_cams
        assert all(c.shapes[0][0] == scene.capacity for c in gathers)
        audit.assert_no_param_gathers(report, [(15, 3), (4,), (1, 3)], min_rows=8)
        audit.assert_no_large_gathers(report, scene.capacity * 3 * 4)
        # Their transposes: a reduce-scatter of each differentiable one.
        assert sum(c.op == "reduce-scatter" for c in report) == 4 * n_cams
        print(audit.summarize(report))


# -------------------------------------------------------- tile sharding ---


def _port_render_and_grads(case):
    scene, cams, inputs = case
    full, batch = _port_inputs(inputs)
    xyz = full.xyz.detach().clone().requires_grad_()
    opacity = full.opacity.detach().clone().requires_grad_()
    off = torch.zeros(full.capacity, 2, requires_grad=True)
    s = TensorScene.of(full).replace(xyz=xyz, opacity=opacity)
    out = render(camera_at(batch, 0), s, RenderConfig(), bg_color=torch.from_numpy(TILE_BG), screenspace_offset=off)
    loss = (out["render"] ** 2).sum() + 0.1 * out["final_T"].sum()
    g = torch.autograd.grad(loss, [xyz, opacity, off])
    return {"render": _np(out["render"]), "final_T": _np(out["final_T"]),
            **{f"g_{k}": _np(v) for k, v in zip(("xyz", "opacity", "offset"), g)}}


@pytest.mark.parametrize("world", [3, 4])
def test_tile_sharded_render_matches_jax(runs, jax_tile, world):
    ref = jax_tile(world)
    for r in runs(world):
        for k in ("render", "final_T"):
            np.testing.assert_allclose(r[f"tile.{k}"], ref[k], rtol=0, atol=2e-5, err_msg=k)
        for k in ("g_xyz", "g_opacity", "g_offset"):
            scale = np.abs(ref[k]).max() + 1e-8
            np.testing.assert_allclose(r[f"tile.{k}"], ref[k], rtol=0, atol=2e-4 * scale, err_msg=k)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_tile_sharded_render_matches_the_port_render(case, runs, world):
    ref = _port_render_and_grads(case)
    for r in runs(world):
        for k in ("render", "final_T"):
            np.testing.assert_allclose(r[f"tile.{k}"], ref[k], rtol=0, atol=3e-4, err_msg=k)
        for k in ("g_xyz", "g_opacity", "g_offset"):
            assert np.all(np.isfinite(r[f"tile.{k}"])), k
            scale = np.abs(ref[k]).max() + 1e-8
            np.testing.assert_allclose(r[f"tile.{k}"], ref[k], rtol=0, atol=1e-3 * scale, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_tile_sharded_step_matches_the_batched_step(case, runs, world):
    _, _, inputs = case
    full, batch = _port_inputs(inputs)
    step = make_sharded_train_step(OptConfig(), RenderConfig())
    full, _, stats, m = step(full, AdamState.init(full), DensifyStats.init(full.capacity), batch, torch.zeros(3), 1, 1.0)
    for r in runs(world):
        assert float(r["tstep.loss"]) == pytest.approx(float(m["loss"]), rel=1e-3)
        np.testing.assert_allclose(r["tstep.xyz"], _np(full.xyz), rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["tstep.accum"], _np(stats.xyz_gradient_accum), rtol=0, atol=1e-4)


def test_butterfly_fold_has_no_full_frame_gather(case, runs):
    """At D = 4 the fold is log2(D) permute pairs: a collective-permute, and
    no all-gather reaches frame_bytes x (D - 1) (tests/test_parallel.py's
    rule for the same fold)."""
    _, cams, _ = case
    D = 4
    T = num_tiles(cams[0].image_width) * num_tiles(cams[0].image_height)
    frame_bytes = T * 4 * TILE * TILE * 4
    for r in runs(D):
        report = audit.collective_report(_report(r, "tile"))
        assert any(c.op == "collective-permute" for c in report), [c.op for c in report]
        for g in (c for c in report if c.op == "all-gather"):
            assert g.bytes < frame_bytes * (D - 1), g


@pytest.mark.parametrize("world", [2, 3, 4])
def test_collectives_and_their_transposes(runs, world):
    n = world
    for r, res in enumerate(runs(world)):
        g = lambda k: (res[f"cc.{k}.y"], res[f"cc.{k}.g"])
        A = np.arange(6.0).reshape(3, 2)
        y, gx = g("all_gather")
        np.testing.assert_array_equal(y, np.concatenate([(s + 1) * A for s in range(n)]))
        np.testing.assert_array_equal(gx, n * np.arange(6.0 * n).reshape(3 * n, 2)[3 * r:3 * r + 3])
        B = np.arange(4.0 * n).reshape(2 * n, 2)
        y, gx = g("reduce_scatter")
        np.testing.assert_array_equal(y, n * (n + 1) / 2 * B[2 * r:2 * r + 2])
        np.testing.assert_array_equal(gx, np.repeat(np.arange(1.0, n + 1), 2)[:, None] * np.ones((1, 2)))
        y, gx = g("all_reduce")
        np.testing.assert_array_equal(y, np.full(2, n * (n + 1) / 2))
        np.testing.assert_array_equal(gx, np.full(2, n * (n + 1) / 2))  # psum's transpose
        y, gx = g("all_reduce_mean")
        np.testing.assert_allclose(y, np.full(2, (n + 1) / 2))
        np.testing.assert_allclose(gx, np.full(2, (n + 1) / 2))
        y, gx = g("all_to_all")  # x_s [2, n]: rank r receives column r of every rank, stacked on dim 0
        np.testing.assert_array_equal(y, np.concatenate([(10.0 * s + np.arange(2.0 * n).reshape(2, n))[:, r:r + 1]
                                                         for s in range(n)]))
        cot = [100.0 * s + np.arange(2.0 * n).reshape(2 * n, 1) for s in range(n)]
        np.testing.assert_array_equal(gx, np.concatenate([cot[s][2 * r:2 * r + 2] for s in range(n)], axis=1))
        y, gx = g("ring_shift")  # receives from r + 1; the gradient goes back to it
        np.testing.assert_array_equal(y, np.full(2, float((r + 1) % n)))
        np.testing.assert_array_equal(gx, np.full(2, 10.0 * ((r - 1) % n)))
        y, gx = g("replicated_slice")
        np.testing.assert_array_equal(y, np.arange(2.0 * n)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(gx, np.repeat(np.arange(1.0, n + 1), 2))
        y, gx = g("replicated_output")
        np.testing.assert_allclose(gx, np.full(2, (r + 1.0) / n))


@pytest.mark.parametrize("world", [2, 3, 4])
def test_heartbeat_completes_on_every_rank(runs, world):
    assert all(bool(r["heartbeat"]) for r in runs(world))


# ------------------------------------------------------ single-process parts ---


def test_batched_step_matches_the_jax_step(case, jax_batched):
    """The port's mesh=None step (the reference the sharded forms agree
    with) against the JAX package's, at the manual step's bounds."""
    _, _, inputs = case
    full, batch = _port_inputs(inputs)
    step = make_sharded_train_step(OptConfig(), RenderConfig(max_per_tile=64))
    full, adam, stats, m = step(full, AdamState.init(full), DensifyStats.init(full.capacity), batch, torch.zeros(3),
                                1, 1.0)
    s, a, st, jm = jax_batched
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(m["l1"]) == pytest.approx(float(jm["l1"]), rel=1e-5)
    assert int(m["n_visible"]) == int(jm["n_visible"])
    for k in PARAM_LEAVES:
        np.testing.assert_allclose(_np(getattr(full, k)), getattr(s, k), rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(_np(adam.mu[k]), a.mu[k], rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(_np(stats.xyz_gradient_accum), st.xyz_gradient_accum, rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(stats.max_radii2d), st.max_radii2d, rtol=0, atol=1e-5)


def test_stack_cameras(case):
    _, cams, inputs = case
    batch = stack_cameras(cameras(inputs))
    assert tuple(batch.world_view_transform.shape) == (4, 4, 4)
    assert batch.original_image.shape[0] == 4
    np.testing.assert_array_equal(_np(camera_at(batch, 2).camera_center), np.asarray(cams[2].camera_center))


@pytest.mark.parametrize("D", [2, 3, 4, 5])
def test_shard_tile_counts_are_the_real_rows_in_the_shard(case, D):
    """A shard that starts or ends inside a tile's run walks only the real
    rows inside its own rows (the sentinel C marks a padding row)."""
    _, _, inputs = case
    full, batch = _port_inputs(inputs)
    s = prepare_stream(camera_at(batch, 0), full, RenderConfig(chunk=32))
    b = s.binned
    T, C = s.grid_w * s.grid_h, full.capacity
    G = b.chunk_tile.shape[0]
    chunk = b.stream_gauss.shape[0] // G
    tile_of_row = b.chunk_tile.long().repeat_interleave(chunk)
    real = b.stream_gauss.long() < C
    for idx in range(D):
        c0, c1 = shard_chunk_range(G, D, idx)
        c1 = min(c1, G)
        r0, r1 = c0 * chunk, max(c1, c0) * chunk
        got = shard_tile_counts(b.chunk_tile, b.tile_counts, T, chunk, r0, r1)
        rows = torch.arange(b.stream_gauss.shape[0])
        inside = real & (rows >= r0) & (rows < r1) & (tile_of_row < T)
        want = torch.bincount(tile_of_row[inside], minlength=T)[:T]
        np.testing.assert_array_equal(_np(got), _np(want))
    assert int(b.tile_counts.sum()) > 0


def test_crash_saver_saves_and_swallows():
    saved = []
    saver = CrashSaver(lambda: saved.append(1))
    assert saver(lambda x: x + 1, 1) == 2 and saved == []

    def boom():
        raise RuntimeError("nan")

    assert saver(boom) is None and saved == [1] and saver.crash_count == 1
    with pytest.raises(RuntimeError):
        CrashSaver(lambda: saved.append(2), swallow=False)(boom)
    assert saved == [1, 2]


@pytest.mark.parametrize("shape,n,min_size", [((128, 512), 8, 1024), ((1024, 100), 8, 1024), ((4, 4), 8, 1024),
                                              ((999, 1001), 8, 1024), ((416, 208), 4, 1 << 16),
                                              ((104,), 4, 1), ((6656, 13312), 8, 1 << 16)])
def test_leaf_spec_matches_jax(shape, n, min_size):
    x = np.zeros(shape, np.float32)
    assert fsdp.leaf_spec(x, n, "fsdp", min_size) == tuple(jax_leaf_spec(x, n, "fsdp", min_size))

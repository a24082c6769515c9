"""Port parity for the training slice: the optimizer (train/optim.py), the
densification (scene/densify.py), the 3-NN seeding and ``from_pcd``, and the
train step (train/splat.py) against the JAX package on the same inputs.

Tolerances: Adam, the lr schedule, the stats and the opacity reset to 1e-6
relative; densify masks and counts exact and its floats to 1e-6 (the split's
normal samples are drawn with JAX and handed to the port); the 3-NN distances
and ``from_pcd`` to 1e-5 relative; one and three train steps (loss, leaves,
Adam moments, stats) to 2e-4 of each array's largest magnitude, the render
gradients' own tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_transformer_tpu.ops.knn import mean_sq_dist_to_3nn as jax_knn
from gaussian_transformer_tpu.render import RenderConfig as JaxRenderConfig
from gaussian_transformer_tpu.scene.densify import DensifyStats as JaxStats
from gaussian_transformer_tpu.scene.densify import add_densification_stats as jax_add_stats
from gaussian_transformer_tpu.scene.densify import densify_and_prune as jax_densify
from gaussian_transformer_tpu.scene.densify import reset_opacity as jax_reset_opacity
from gaussian_transformer_tpu.scene.gaussians import GaussianScene as JaxGaussianScene
from gaussian_transformer_tpu.train import optim as jax_optim
from gaussian_transformer_tpu.train.splat import OptConfig as JaxOptConfig
from gaussian_transformer_tpu.train.splat import capture as jax_capture
from gaussian_transformer_tpu.train.splat import train_step as jax_train_step
from gaussian_transformer_tpu.utils.general import inverse_sigmoid as jax_inverse_sigmoid
from gaussian_transformer_tpu.utils.graphics import BasicPointCloud
from gaussian_transformer_tpu_torch.convert import adam_from_numpy, stats_from_numpy
from gaussian_transformer_tpu_torch.ops.knn import mean_sq_dist_to_3nn
from gaussian_transformer_tpu_torch.render import RenderConfig
from gaussian_transformer_tpu_torch.scene.densify import (
    DensifyStats,
    add_densification_stats,
    densify_and_prune,
    reset_opacity,
)
from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene
from gaussian_transformer_tpu_torch.train import optim
from gaussian_transformer_tpu_torch.train.splat import OptConfig, capture, restore, train_step

from tests.test_render import make_scene
from tests.test_train import _synthetic_scene_and_cams
from tests.torch_port_support import SCENE_FIELDS, torch_camera, torch_scene

LEAVES = optim.PARAM_LEAVES
STATS = ("xyz_gradient_accum", "denom", "max_radii2d")


def _close(got, ref, rel, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * (np.abs(ref).max() + 1e-30), err_msg=what)


def _torch_adam(jadam):
    return adam_from_numpy(*({k: np.asarray(v) for k, v in d.items()} for d in (jadam.mu, jadam.nu, jadam.counts)),
                           device="cpu")


def _torch_stats(jstats):
    return stats_from_numpy(*(np.asarray(getattr(jstats, k)) for k in STATS), device="cpu")


def _check_state(tscene, tadam, tstats, jscene, jadam, jstats, rel):
    for k in LEAVES:
        _close(getattr(tscene, k), getattr(jscene, k), rel, k)
        _close(tadam.mu[k], jadam.mu[k], rel, f"mu.{k}")
        _close(tadam.nu[k], jadam.nu[k], rel, f"nu.{k}")
        _close(tadam.counts[k], jadam.counts[k], 0.0, f"count.{k}")
    np.testing.assert_array_equal(tscene.alive.numpy(), np.asarray(jscene.alive))
    for k in STATS:
        _close(getattr(tstats, k), getattr(jstats, k), rel, k)


# ---------------------------------------------------------------- optimizer ---


def test_adam_steps_match_reference():
    scene = make_scene(12, seed=0, capacity=16)
    rng = np.random.RandomState(0)
    jadam = jax_optim.AdamState.init(scene)
    tscene = torch_scene(scene)
    tadam = optim.AdamState.init(tscene)
    lrs = {"xyz": 1e-3, "features_dc": 0.0025, "features_rest": 0.0025 / 20, "scaling": 0.005,
           "rotation": 0.001, "opacity": 0.05}
    for _ in range(3):
        grads = {k: rng.randn(*getattr(scene, k).shape).astype(np.float32) for k in LEAVES}
        scene, jadam = jax_optim.adam_step(scene, {k: jnp.asarray(v) for k, v in grads.items()}, jadam, lrs)
        tscene, tadam = optim.adam_step(tscene, {k: torch.from_numpy(v) for k, v in grads.items()}, tadam, lrs)
    for k in LEAVES:
        _close(getattr(tscene, k), getattr(scene, k), 1e-6, k)
        _close(tadam.mu[k], jadam.mu[k], 1e-6, k)
        _close(tadam.nu[k], jadam.nu[k], 1e-6, k)
        assert float(tadam.counts[k]) == float(jadam.counts[k]) == 3.0


@pytest.mark.parametrize("delay_steps", [0, 50])
def test_expon_lr_matches_reference(delay_steps):
    for step in [0, 1, 10, 500, 999, 1000, 2000, -1]:
        ref = float(jax_optim.expon_lr(step, 1.6e-4 * 2.5, 1.6e-6 * 2.5, lr_delay_steps=delay_steps,
                                       lr_delay_mult=0.01, max_steps=1000))
        got = float(optim.expon_lr(step, 1.6e-4 * 2.5, 1.6e-6 * 2.5, lr_delay_steps=delay_steps,
                                   lr_delay_mult=0.01, max_steps=1000))
        assert abs(got - ref) <= 1e-6 * abs(ref), step


def test_compact_state_and_scene_match_reference():
    scene = make_scene(10, seed=1, capacity=14)
    alive = np.array([1, 0, 1, 1, 0, 1, 1, 1, 0, 1, 1, 0, 0, 1], bool)
    scene = scene.replace(alive=jnp.asarray(alive))
    rng = np.random.RandomState(1)
    jadam = jax_optim.AdamState(
        mu={k: jnp.asarray(rng.randn(*getattr(scene, k).shape).astype(np.float32)) for k in LEAVES},
        nu={k: jnp.asarray(rng.rand(*getattr(scene, k).shape).astype(np.float32)) for k in LEAVES},
        counts={k: jnp.asarray(4.0, jnp.float32) for k in LEAVES},
    )
    ref = jax_optim.compact_state(jadam, scene.alive, 20)
    got = optim.compact_state(_torch_adam(jadam), torch.from_numpy(alive), 20)
    for k in LEAVES:
        _close(got.mu[k], ref.mu[k], 0.0, k)
        _close(got.nu[k], ref.nu[k], 0.0, k)
    ref_scene = scene.compact(20)
    got_scene = torch_scene(scene).compact(20)
    for k in SCENE_FIELDS:
        np.testing.assert_array_equal(getattr(got_scene, k).detach().numpy(), np.asarray(getattr(ref_scene, k)), k)
    assert got_scene.active_sh_degree == ref_scene.active_sh_degree


def test_reset_opacity_matches_reference():
    scene = make_scene(8, seed=2, capacity=11)
    jadam = jax_optim.AdamState.init(scene)
    jadam = jax_optim.AdamState(mu={k: v + 1.0 for k, v in jadam.mu.items()}, nu=jadam.nu,
                                counts=jadam.counts)
    ref_scene, ref_adam = jax_reset_opacity(scene, jadam)
    got_scene, got_adam = reset_opacity(torch_scene(scene), _torch_adam(jadam))
    _close(got_scene.opacity, ref_scene.opacity, 1e-6, "opacity")
    for k in LEAVES:
        _close(got_adam.mu[k], ref_adam.mu[k], 0.0, k)


def test_densification_stats_match_reference():
    rng = np.random.RandomState(3)
    C = 9
    stats = JaxStats(*(jnp.asarray(rng.rand(C).astype(np.float32) * s) for s in (1.0, 3.0, 7.0)))
    g = rng.randn(C, 2).astype(np.float32) * 1e-3
    vis = rng.rand(C) > 0.3
    radii = rng.randint(0, 12, C).astype(np.int32)
    for size in (None, (640, 480)):
        ref = jax_add_stats(stats, jnp.asarray(g), jnp.asarray(vis), jnp.asarray(radii), image_size=size)
        got = add_densification_stats(_torch_stats(stats), torch.from_numpy(g), torch.from_numpy(vis),
                                      torch.from_numpy(radii), image_size=size)
        for k in STATS:
            _close(getattr(got, k), getattr(ref, k), 1e-6, k)


# ------------------------------------------------------------- densify ---


def _densify_case(case):
    """(scene, stats, kwargs) of the reference suite's densify cases."""
    kw = dict(max_grad=0.5, min_opacity=0.0, extent=1.0, max_screen_size=0.0, percent_dense=0.01)
    cap = 9 if case == "exhaustion" else 32
    scene = make_scene(8, seed=2, capacity=cap)
    stats = JaxStats.init(cap)
    hot = {"clone": [0], "split": [1], "mixed": [0, 1, 5], "exhaustion": list(range(8)), "prune": []}[case]
    if case in ("clone", "exhaustion", "mixed"):
        scene = scene.replace(scaling=jnp.full_like(scene.scaling, -5.0))
    if case in ("split", "mixed"):
        scene = scene.replace(scaling=scene.scaling.at[1].set(jnp.log(0.5)).at[5].set(jnp.log(0.3)))
    if case == "prune":
        scene = scene.replace(opacity=scene.opacity.at[3].set(jax_inverse_sigmoid(jnp.asarray([1e-4]))))
        radii = np.zeros(cap, np.float32)
        radii[6] = 50.0
        stats = stats.replace(max_radii2d=jnp.asarray(radii))
        kw.update(max_grad=9.9, min_opacity=0.005, max_screen_size=20.0)
    if hot:
        stats = stats.replace(
            xyz_gradient_accum=stats.xyz_gradient_accum.at[jnp.asarray(hot)].set(1.0),
            denom=stats.denom.at[jnp.asarray(hot)].set(1.0),
        )
    return scene, stats, kw


@pytest.mark.parametrize("case", ["clone", "split", "mixed", "prune", "exhaustion"])
def test_densify_and_prune_matches_reference(case):
    scene, stats, kw = _densify_case(case)
    jadam = jax_optim.AdamState.init(scene)
    jadam = jax_optim.AdamState(mu={k: v + 0.5 for k, v in jadam.mu.items()}, nu=jadam.nu,
                                counts=jadam.counts)
    key = jax.random.PRNGKey(7)
    ref_scene, ref_adam, _, ref_rep = jax_densify(scene, jadam, stats, key, **kw)
    samples = np.array(jax.random.normal(key, (2, scene.capacity, 3), dtype=jnp.float32))
    tscene = torch_scene(scene)
    got_scene, got_adam, got_stats, got_rep = densify_and_prune(
        tscene, _torch_adam(jadam), _torch_stats(stats), torch.from_numpy(samples), **kw
    )
    for name in ("n_cloned", "n_split", "n_pruned", "n_dropped"):
        assert int(getattr(got_rep, name)) == int(getattr(ref_rep, name)), name
    np.testing.assert_array_equal(got_scene.alive.numpy(), np.asarray(ref_scene.alive))
    for k in LEAVES:
        _close(getattr(got_scene, k), getattr(ref_scene, k), 1e-6, k)
        _close(got_adam.mu[k], ref_adam.mu[k], 0.0, k)
    assert all(float(getattr(got_stats, k).abs().sum()) == 0.0 for k in STATS)
    if case == "exhaustion":
        assert int(got_rep.n_dropped) == 7 and got_scene.num_alive == 9
    if case == "prune":
        assert int(got_rep.n_pruned) >= 2 and not bool(got_scene.alive[3]) and not bool(got_scene.alive[6])


def test_densify_draws_split_samples_from_a_generator():
    scene, stats, kw = _densify_case("split")
    jadam = jax_optim.AdamState.init(scene)
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        s, _, _, rep = densify_and_prune(torch_scene(scene), _torch_adam(jadam), _torch_stats(stats),
                                         generator=gen, **kw)
        runs.append(s.xyz.detach().numpy())
        assert int(rep.n_split) == 1 and s.num_alive == 9
    np.testing.assert_array_equal(runs[0], runs[1])


# -------------------------------------------------------- init from pcd ---


def test_knn_and_from_pcd_match_reference():
    rng = np.random.RandomState(5)
    n = 700  # crosses a block boundary at block 256
    points = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    colors = rng.rand(n, 3).astype(np.float32)
    ref = np.asarray(jax_knn(points, block=256))
    got = mean_sq_dist_to_3nn(torch.from_numpy(points), block=256).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    pcd = BasicPointCloud(points=points, colors=colors, normals=np.zeros_like(points))
    ref_scene = JaxGaussianScene.from_pcd(pcd, max_sh_degree=1, capacity=n + 20)
    got_scene = GaussianScene.from_pcd(pcd, max_sh_degree=1, capacity=n + 20, device="cpu")
    for k in SCENE_FIELDS:
        np.testing.assert_allclose(getattr(got_scene, k).detach().numpy(), np.asarray(getattr(ref_scene, k)),
                                   rtol=1e-5, err_msg=k)
    assert got_scene.active_sh_degree == ref_scene.active_sh_degree == 0
    for _ in range(2):  # the bump stops at the max degree, as the reference's
        got_scene.oneup_sh_degree()
        ref_scene = ref_scene.oneup_sh_degree()
        assert got_scene.active_sh_degree == ref_scene.active_sh_degree == 1


# ---------------------------------------------------------- train step ---


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_matches_reference(steps):
    start, cams = _synthetic_scene_and_cams(n=48, n_cams=3, width=40, height=32)
    jscene, jadam, jstats = start, jax_optim.AdamState.init(start), JaxStats.init(start.capacity)
    tscene = torch_scene(start)
    tadam, tstats = optim.AdamState.init(tscene), DensifyStats.init(tscene.capacity, "cpu")
    opt = dict(position_lr_init=0.0016, position_lr_max_steps=200)
    for it in range(1, steps + 1):
        cam = cams[it % len(cams)]
        jscene, jadam, jstats, jm = jax_train_step(
            jscene, jadam, jstats, cam.anonymize(), jnp.zeros(3), jnp.asarray(it, jnp.float32),
            jnp.asarray(2.0, jnp.float32), JaxOptConfig(**opt), JaxRenderConfig(),
        )
        tcam = torch_camera(cam)
        tcam.original_image = torch.from_numpy(np.asarray(cam.original_image))
        tscene, tadam, tstats, tm = train_step(tscene, tadam, tstats, tcam, torch.zeros(3), it, 2.0,
                                               OptConfig(**opt), RenderConfig())
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 2e-4 * abs(float(jm["loss"]))
        assert int(tm["n_visible"]) == int(jm["n_visible"])
    _check_state(tscene, tadam, tstats, jscene, jadam, jstats, 2e-4)


def test_port_restores_a_reference_checkpoint(tmp_path):
    start = make_scene(16, seed=6, capacity=20)
    rng = np.random.RandomState(6)
    jadam = jax_optim.AdamState(
        mu={k: jnp.asarray(rng.randn(*getattr(start, k).shape).astype(np.float32)) for k in LEAVES},
        nu={k: jnp.asarray(rng.rand(*getattr(start, k).shape).astype(np.float32)) for k in LEAVES},
        counts={k: jnp.asarray(float(i + 1), jnp.float32) for i, k in enumerate(LEAVES)},
    )
    jstats = JaxStats(*(jnp.asarray(rng.rand(start.capacity).astype(np.float32)) for _ in STATS))
    np.savez(tmp_path / "chkpnt42.npz", **jax_capture(start, jadam, jstats, 42, 3.5))
    payload = dict(np.load(tmp_path / "chkpnt42.npz", allow_pickle=False))
    scene, adam, stats, it, slrs = restore(payload, device="cpu")
    assert (it, slrs) == (42, 3.5) and scene.active_sh_degree == start.active_sh_degree
    _check_state(scene, adam, stats, start, jadam, jstats, 0.0)
    # ... and the port's own capture writes the same keys and arrays back.
    again = capture(scene, adam, stats, it, slrs)
    assert set(again) == set(payload)
    for k, v in payload.items():
        np.testing.assert_array_equal(again[k], v, k)

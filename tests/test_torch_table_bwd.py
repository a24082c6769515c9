"""Port parity: the table path (``RenderConfig(use_stream=False)``) backward.
The plain version of kernel K6 (what CPU tensors take) matches the JAX
``_bwd_rule`` (Pallas K6 in interpret mode) on the same table and
cotangents; the port's render gradients w.r.t. xyz, opacity, scaling,
features_dc and the screen-space offset match ``jax.grad`` through the JAX
table render at the reference's tolerance for it
(``tests/test_pallas_composite.py``: 2e-4 of the largest gradient, 5e-4
under saturation); one train step with the table config matches the JAX
step; and the trainer tunes its budgets from a table-path probe render. K6
itself is checked on the card by tests/test_torch_kernels.py."""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_transformer_tpu.render import RenderConfig as JaxRenderConfig
from gaussian_transformer_tpu.render import render as jax_render
from gaussian_transformer_tpu.render.pallas_composite import _bwd_rule, _fwd
from gaussian_transformer_tpu.scene.densify import DensifyStats as JaxStats
from gaussian_transformer_tpu.train import optim as jax_optim
from gaussian_transformer_tpu.train.splat import OptConfig as JaxOptConfig
from gaussian_transformer_tpu.train.splat import train_step as jax_train_step
from gaussian_transformer_tpu.utils.general import inverse_sigmoid
from gaussian_transformer_tpu_torch.render import RenderConfig, render
from gaussian_transformer_tpu_torch.render import table_composite
from gaussian_transformer_tpu_torch.scene.densify import DensifyStats
from gaussian_transformer_tpu_torch.train import optim
from gaussian_transformer_tpu_torch.train.splat import OptConfig, train_step, training

from tests.test_render import make_camera, make_scene
from tests.test_torch_table import _jax_table
from tests.test_torch_train import _check_state
from tests.test_train import _synthetic_scene_and_cams
from tests.torch_port_support import torch_camera, torch_scene

NAMES = ("xyz", "opacity", "scaling", "features_dc", "offset")


def _close_rel(got, ref, rel, what=""):
    scale = np.abs(ref).max() + 1e-8
    assert np.all(np.isfinite(got)), what
    np.testing.assert_allclose(got, ref, atol=rel * scale, rtol=0, err_msg=what)


@functools.partial(jax.jit, static_argnums=2)
def _jax_fwd_bwd(props, counts, gw, g_color, g_t):
    """The interpreted K5 and K6 (jitted: cases of one shape share a compile)."""
    color, final_t = _fwd(props, counts, gw)
    return color, final_t, _bwd_rule(gw, (props, counts, color, final_t), (g_color, g_t))[0]


@pytest.mark.parametrize("seed,n,opacity", [(0, 128, None), (3, 96, 0.97)], ids=["plain", "saturated"])
def test_plain_backward_matches_pallas_interpret(seed, n, opacity):
    props, counts, gw = _jax_table(seed, n, 64, opacity, spread=0.3 if opacity else 1.5)
    rng = np.random.RandomState(seed)
    g_color = rng.randn(props.shape[0], 3, 256).astype(np.float32)
    g_t = rng.randn(props.shape[0], 1, 256).astype(np.float32)
    color, final_t, ref = _jax_fwd_bwd(jnp.asarray(props), jnp.asarray(counts, jnp.float32), gw,
                                       jnp.asarray(g_color), jnp.asarray(g_t))
    t = lambda a: torch.from_numpy(np.array(a))
    got = table_composite.composite_table_tiles_bwd_plain(t(props), t(counts), gw, t(color), t(final_t),
                                                          t(g_color), t(g_t))
    assert got.shape == ref.shape and torch.all(got[..., table_composite.GRAD_F:] == 0)
    _close_rel(got.numpy(), np.asarray(ref), 2e-4)
    # Rows past each tile's walk are zero.
    walked = table_composite.walked_rows(t(counts), props.shape[1])
    past = torch.arange(props.shape[1])[None, :] >= walked[:, None]
    assert torch.all(got[past] == 0)


def test_plain_backward_matches_autograd_of_plain_forward():
    """A second check of the plain K6 (and of the forward it replays), and the
    autograd node's backward is it."""
    props0, counts, gw = (torch.from_numpy(np.array(a)) if not isinstance(a, int) else a
                          for a in _jax_table(2, 160, 96, spread=0.6))
    rng = np.random.RandomState(2)
    g_color = torch.from_numpy(rng.randn(props0.shape[0], 3, 256).astype(np.float32))
    g_t = torch.from_numpy(rng.randn(props0.shape[0], 1, 256).astype(np.float32))
    props = props0.clone().requires_grad_()
    color, final_t = table_composite.composite_table_tiles_plain(props, counts, gw)
    (ref,) = torch.autograd.grad((color * g_color).sum() + (final_t * g_t).sum(), props)
    with torch.no_grad():
        got = table_composite.composite_table_tiles_bwd_plain(props0, counts, gw, color, final_t, g_color, g_t)
    _close_rel(got[..., :table_composite.GRAD_F].numpy(), ref[..., :table_composite.GRAD_F].numpy(), 2e-4)
    props = props0.clone().requires_grad_()
    color2, t2 = table_composite.composite_table_tiles(props, counts, gw)
    (via_node,) = torch.autograd.grad((color2 * g_color).sum() + (t2 * g_t).sum(), props)
    np.testing.assert_array_equal(via_node.numpy(), got.numpy())


@jax.jit
def _jax_grads(scene, cam, bg, cfg):
    """jax.grad through the JAX table render (jitted: cases of one shape
    share a compile)."""
    def loss_fn(xyz, opacity, scaling, fdc, offset):
        s = scene.replace(xyz=xyz, opacity=opacity, scaling=scaling, features_dc=fdc)
        out = jax_render(cam, s, cfg, bg_color=bg, screenspace_offset=offset)
        return jnp.sum(out["render"] ** 2) + 0.1 * jnp.sum(out["final_T"])

    args = (scene.xyz, scene.opacity, scene.scaling, scene.features_dc, jnp.zeros((scene.capacity, 2)))
    return jax.grad(loss_fn, argnums=(0, 1, 2, 3, 4))(*args)


def _grads(scene, cam, bg, K):
    ref = [np.asarray(g) for g in _jax_grads(scene, cam.anonymize(), bg,
                                             JaxRenderConfig(max_per_tile=K, use_stream=False))]

    ts = torch_scene(scene)
    offset = torch.zeros(ts.capacity, 2, requires_grad=True)
    out = render(torch_camera(cam), ts, RenderConfig(max_per_tile=K, use_stream=False),
                 bg_color=torch.from_numpy(np.array(bg)), screenspace_offset=offset)
    loss = torch.sum(out["render"] ** 2) + 0.1 * torch.sum(out["final_T"])
    leaves = [ts.xyz, ts.opacity, ts.scaling, ts.features_dc, offset]
    return ref, [g.numpy() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("seed,K", [(0, 96), (1, 40)])
def test_render_grads_match_reference(seed, K):
    ref, got = _grads(make_scene(96, seed=seed), make_camera(width=48, height=32),
                      jnp.array([0.2, 0.1, 0.4], jnp.float32), K)
    for name, a, b in zip(NAMES, ref, got):
        _close_rel(b, a, 2e-4, name)


def test_render_grads_under_saturation():
    scene = make_scene(96, seed=4, spread=0.2)
    scene = scene.replace(opacity=jnp.full_like(scene.opacity, inverse_sigmoid(jnp.asarray(0.95))))
    ref, got = _grads(scene, make_camera(width=48, height=32), jnp.zeros(3, jnp.float32), 96)
    for name, a, b in zip(NAMES, ref, got):
        _close_rel(b, a, 5e-4, name)


def test_train_step_matches_reference():
    start, cams = _synthetic_scene_and_cams(n=48, n_cams=3, width=40, height=32)
    cam = cams[1]
    opt = dict(position_lr_init=0.0016, position_lr_max_steps=200)
    tscene = torch_scene(start)  # before the JAX step, which donates its inputs
    jscene, jadam, jstats, jm = jax_train_step(
        start, jax_optim.AdamState.init(start), JaxStats.init(start.capacity), cam.anonymize(), jnp.zeros(3),
        jnp.asarray(1, jnp.float32), jnp.asarray(2.0, jnp.float32), JaxOptConfig(**opt),
        JaxRenderConfig(max_per_tile=64, use_stream=False),
    )
    tcam = torch_camera(cam)
    tcam.original_image = torch.from_numpy(np.array(cam.original_image))
    tscene, tadam, tstats, tm = train_step(
        tscene, optim.AdamState.init(tscene), DensifyStats.init(tscene.capacity, "cpu"), tcam, torch.zeros(3),
        1, 2.0, OptConfig(**opt), RenderConfig(max_per_tile=64, use_stream=False))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 2e-4 * abs(float(jm["loss"]))
    assert int(tm["n_visible"]) == int(jm["n_visible"]) and int(tm["overflow"]) == 0
    _check_state(tscene, tadam, tstats, jscene, jadam, jstats, 2e-4)


def test_training_tunes_table_budgets_at_scale(tmp_path):
    """At 50k slots and more the trainer sizes its budgets from a probe
    render; a table-path probe has no stream length to read."""
    start, cams = _synthetic_scene_and_cams(n=48, n_cams=3, width=40, height=32)
    tcams = []
    for cam in cams:
        tc = torch_camera(cam)
        tc.original_image = torch.from_numpy(np.array(cam.original_image))
        tcams.append(tc)
    scene_obj = SimpleNamespace(gaussians=torch_scene(start), cameras_extent=2.0, model_path=str(tmp_path),
                                get_train_cameras=lambda: tcams)
    seen = []
    cfg = RenderConfig(max_per_tile=64, use_stream=False)
    g = training(scene_obj, OptConfig(iterations=3), cfg, capacity_headroom=1100.0,
                 log_fn=lambda **kw: seen.append((kw["loss"], kw["overflow"], kw["render_cfg"])))
    assert g.capacity >= 50_000 and len(seen) == 3
    assert all(np.isfinite(loss) and overflow == 0 for loss, overflow, _ in seen)
    tuned = seen[0][2]
    assert tuned == cfg.replace(max_instances=32768) and tuned.max_stream == 0

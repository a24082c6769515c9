"""Port parity: the bf16 property stream (``RenderConfig(precision="bf16")``,
render/stream.py ``kernel_props``), on the CPU against the JAX package
(its Pallas K1/K2 in interpret mode in the ``local_coords`` mode).

Both packages round the same tile-local float32 rows to bf16, so the port's
bf16 render equals the reference's bf16 render at the float32 parity
tolerances (image and final_T 2e-5, gradients 2e-4 of the largest); against
its own float32 render the port meets the reference's bf16 rules
(tests/test_stream.py TestBF16Stream). The bf16 entry points of K1/K2 are
checked on the card by tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_transformer_tpu.render import RenderConfig as JaxRenderConfig
from gaussian_transformer_tpu.render import render as jax_render
from gaussian_transformer_tpu.render.stream import _localize_props
from gaussian_transformer_tpu.scene.densify import DensifyStats as JaxStats
from gaussian_transformer_tpu.train import optim as jax_optim
from gaussian_transformer_tpu.train.splat import OptConfig as JaxOptConfig
from gaussian_transformer_tpu.train.splat import train_step as jax_train_step
from gaussian_transformer_tpu_torch.config import OptConfig
from gaussian_transformer_tpu_torch.render import RenderConfig, prepare_stream, render
from gaussian_transformer_tpu_torch.render import stream
from gaussian_transformer_tpu_torch.scene.densify import DensifyStats
from gaussian_transformer_tpu_torch.train import optim
from gaussian_transformer_tpu_torch.train.splat import train_step

from tests.test_render import make_camera, make_scene
from tests.test_torch_train import _check_state, _synthetic_scene_and_cams
from tests.torch_port_support import torch_camera, torch_scene

ATOL = 2e-5
NAMES = ("xyz", "opacity", "scaling", "features_dc", "offset")


def _stream_rows(seed, grid_w, chunk, n_chunks):
    """Float32 rows of a 1080p-wide screen (means up to 1920 x 1080, the
    range bf16 cannot hold whole) on a non-decreasing chunk -> tile map
    that ends in trash chunks (tile id T)."""
    rng = np.random.RandomState(seed)
    n_tiles = grid_w * 68
    props = rng.randn(n_chunks * chunk, 16).astype(np.float32)
    props[:, 0] = rng.uniform(-8.0, 1928.0, len(props))
    props[:, 1] = rng.uniform(-8.0, 1088.0, len(props))
    props[rng.rand(len(props)) < 0.2] = 0.0  # sentinel rows
    ct = np.sort(rng.randint(0, n_tiles, n_chunks)).astype(np.int32)
    ct[-3:] = n_tiles
    return props, ct


@pytest.mark.parametrize("chunk", [32, 128])
def test_kernel_props_round_as_the_reference(chunk):
    """The shift in float32, then bf16 rounding: the same bits as
    ``_localize_props(...).astype(bfloat16)``, every row (trash included)."""
    props, ct = _stream_rows(chunk, 120, chunk, 40)
    ref = np.asarray(_localize_props(jnp.asarray(props), jnp.asarray(ct), 120, chunk).astype(jnp.bfloat16))
    got = stream.kernel_props(torch.from_numpy(props), torch.from_numpy(ct), 120, "bf16")
    assert got.dtype == torch.bfloat16 and got.shape == props.shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), ref.view(np.uint16))
    local = stream.localize_props(torch.from_numpy(props), torch.from_numpy(ct), 120, chunk)
    np.testing.assert_array_equal(local.numpy(), np.asarray(_localize_props(jnp.asarray(props), jnp.asarray(ct),
                                                                            120, chunk)))
    assert stream.kernel_props(torch.from_numpy(props), torch.from_numpy(ct), 120, "fp32").dtype == torch.float32


@pytest.mark.parametrize("seed,n,chunk", [(9, 192, 0), (1, 256, 64)])
def test_bf16_render_matches_reference(seed, n, chunk):
    cam = make_camera(width=80, height=48)
    scene = make_scene(n, seed=seed, capacity=n + 8)
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    ref = jax_render(cam, scene, JaxRenderConfig(precision="bf16", chunk=chunk), bg_color=jnp.asarray(bg))
    with torch.no_grad():
        out = render(torch_camera(cam), torch_scene(scene), RenderConfig(precision="bf16", chunk=chunk),
                     bg_color=torch.from_numpy(bg))
    np.testing.assert_allclose(out["render"].numpy(), np.asarray(ref["render"]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(out["final_T"].numpy(), np.asarray(ref["final_T"]), atol=ATOL, rtol=0)


def _jax_grads(scene, cam, bg, precision):
    def loss_fn(xyz, opacity, scaling, fdc, offset):
        s = scene.replace(xyz=xyz, opacity=opacity, scaling=scaling, features_dc=fdc)
        out = jax_render(cam, s, JaxRenderConfig(precision=precision), bg_color=bg, screenspace_offset=offset)
        return jnp.sum(out["render"] ** 2) + 0.1 * jnp.sum(out["final_T"])

    args = (scene.xyz, scene.opacity, scene.scaling, scene.features_dc, jnp.zeros((scene.capacity, 2)))
    return [np.asarray(g) for g in jax.grad(loss_fn, argnums=(0, 1, 2, 3, 4))(*args)]


def _port_grads(scene, cam, bg, precision):
    ts = torch_scene(scene)
    offset = torch.zeros(ts.capacity, 2, requires_grad=True)
    out = render(torch_camera(cam), ts, RenderConfig(precision=precision), bg_color=torch.from_numpy(bg),
                 screenspace_offset=offset)
    loss = torch.sum(out["render"] ** 2) + 0.1 * torch.sum(out["final_T"])
    leaves = [ts.xyz, ts.opacity, ts.scaling, ts.features_dc, offset]
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("seed", [0, 10])
def test_bf16_grads_match_reference(seed):
    cam = make_camera(width=48, height=32)
    scene = make_scene(96, seed=seed)
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    ref = _jax_grads(scene, cam, jnp.asarray(bg), "bf16")
    got = _port_grads(scene, cam, bg, "bf16")
    for name, a, b in zip(NAMES, ref, got):
        assert np.all(np.isfinite(b)), name
        np.testing.assert_allclose(b, a, atol=2e-4 * (np.abs(a).max() + 1e-8), rtol=0, err_msg=name)


def _psnr(a, b):
    mse = np.mean((a - b) ** 2, axis=(1, 2))
    return float(np.mean(20.0 * np.log10(1.0 / np.sqrt(mse))))


def test_bf16_image_close_to_fp32():
    """The reference's rule for its bf16 image (tests/test_stream.py
    TestBF16Stream.test_image_close_to_fp32), on the port alone."""
    cam = torch_camera(make_camera(width=80, height=48))
    scene = torch_scene(make_scene(192, seed=9, capacity=200))
    bg = torch.tensor([0.2, 0.1, 0.3])
    with torch.no_grad():
        a = torch.clamp(render(cam, scene, RenderConfig(), bg_color=bg)["render"], 0, 1).numpy()
        b = torch.clamp(render(cam, scene, RenderConfig(precision="bf16"), bg_color=bg)["render"], 0, 1).numpy()
    assert _psnr(b, a) > 40.0
    np.testing.assert_allclose(b, a, atol=0.03, rtol=0)
    assert np.abs(b - a).max() > 0  # the rows really were rounded


def test_bf16_grads_close_to_fp32():
    """The reference's rule for its bf16 gradients (TestBF16Stream.
    test_grads_close_to_fp32): 0.12 of the largest, > 97% within 5%."""
    cam = make_camera(width=48, height=32)
    scene = make_scene(96, seed=10)
    bg = np.zeros(3, np.float32)
    ga = _port_grads(scene, cam, bg, "fp32")
    gb = _port_grads(scene, cam, bg, "bf16")
    for name, a, b in zip(NAMES, ga, gb):
        assert np.all(np.isfinite(b)), name
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b, a, atol=0.12 * scale, rtol=0, err_msg=name)
        assert np.mean(np.abs(b - a) <= 0.05 * scale) > 0.97, name


def test_bf16_residual_is_the_bf16_rows():
    """The autograd node saves the bf16 rows the forward composited (half
    the bytes), and its backward returns the float32 rows' gradient."""
    with torch.no_grad():
        s = prepare_stream(torch_camera(make_camera(width=48, height=32)), torch_scene(make_scene(64, seed=3)))
        props0 = s.props()
    props = props0.clone().requires_grad_()
    color, final_t = stream.composite_stream_tiles(props, s.chunk_tile, s.binned.tile_counts, s.grid_w, s.grid_h,
                                                   "bf16")
    saved = color.grad_fn.saved_tensors[0]
    assert saved.dtype == torch.bfloat16 and saved.shape == props.shape
    assert torch.equal(saved, stream.kernel_props(props0, s.chunk_tile, s.grid_w, "bf16"))
    (color.sum() + final_t.sum()).backward()
    assert props.grad.dtype == torch.float32 and torch.all(torch.isfinite(props.grad))
    fp32 = stream.composite_stream_tiles(props0, s.chunk_tile, s.binned.tile_counts, s.grid_w, s.grid_h)
    assert fp32[0].grad_fn is None  # no grad through props0: nothing saved in float32
    with pytest.raises(ValueError):
        stream.composite_stream_tiles(props0.to(torch.bfloat16), s.chunk_tile, s.binned.tile_counts,
                                      s.grid_w, s.grid_h, "bf16")
    with pytest.raises(ValueError):
        stream.composite_stream_tiles(props0, s.chunk_tile, s.binned.tile_counts, s.grid_w, s.grid_h, "fp16")


def test_bf16_train_step_matches_reference():
    """Two train steps with RenderConfig(precision="bf16") at the tolerances
    of tests/test_torch_train.py test_train_step_matches_reference."""
    start, cams = _synthetic_scene_and_cams(n=48, n_cams=3, width=40, height=32)
    jscene, jadam, jstats = start, jax_optim.AdamState.init(start), JaxStats.init(start.capacity)
    tscene = torch_scene(start)
    tadam, tstats = optim.AdamState.init(tscene), DensifyStats.init(tscene.capacity, "cpu")
    opt = dict(position_lr_init=0.0016, position_lr_max_steps=200)
    for it in range(1, 3):
        cam = cams[it % len(cams)]
        jscene, jadam, jstats, jm = jax_train_step(
            jscene, jadam, jstats, cam.anonymize(), jnp.zeros(3), jnp.asarray(it, jnp.float32),
            jnp.asarray(2.0, jnp.float32), JaxOptConfig(**opt), JaxRenderConfig(precision="bf16"),
        )
        tcam = torch_camera(cam)
        tcam.original_image = torch.from_numpy(np.asarray(cam.original_image))
        tscene, tadam, tstats, tm = train_step(tscene, tadam, tstats, tcam, torch.zeros(3), it, 2.0,
                                               OptConfig(**opt), RenderConfig(precision="bf16"))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 2e-4 * abs(float(jm["loss"]))
        assert int(tm["n_visible"]) == int(jm["n_visible"])
    _check_state(tscene, tadam, tstats, jscene, jadam, jstats, 2e-4)

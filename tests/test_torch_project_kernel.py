"""Kernel K10 (csrc/project_fwd.cu, driven by render/project.py
``project_scene``): the projection of a scene's stored leaves in one pass.

On the card (marker ``gpu``; each test skips without a CUDA device) K10 is
held to the plain chain (``project_scene_plain``, the scene's activations
and ``project_gaussians`` as PyTorch ops on the same tensors) bit for bit on
every output, its gradient to the plain chain's autograd gradient, and a
served view to one K10 launch and no host synchronisation in projection. On
the CPU: ``project_view`` runs the plain chain and launches nothing, the
recompute-backward (with the plain chain in K10's place) gives plain
autograd's gradients, and the wrapper refuses what the kernel does not take
before any launch.

This file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_project_kernel.py
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gaussian_transformer_tpu_torch.convert import scene_from_numpy
from gaussian_transformer_tpu_torch.render import RenderConfig, project_view, render
from gaussian_transformer_tpu_torch.render import project
from gaussian_transformer_tpu_torch.scene.cameras import Camera
from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene, TensorScene
from gaussian_transformer_tpu_torch.utils import profiling
from gaussian_transformer_tpu_torch.viewer.network_gui import image_to_bytes

FIELDS = project.Projected._fields + ("include",)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: these tests run only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K10 runs only on the card)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def clean_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _fields(n, seed, rest=15, edge=False):
    """Seeded leaves. ``edge``: an eighth behind the camera, an eighth
    needles (one huge axis, two vanishing: some covariances' determinants
    round to exactly 0), an eighth with opacities below 1/255, every
    seventh slot dead."""
    rng = np.random.RandomState(seed)
    op = rng.uniform(0.05, 0.95, (n, 1))
    xyz = rng.uniform(-1.5 if edge else -1.0, 1.5 if edge else 1.0, (n, 3)).astype(np.float32)
    scaling = rng.uniform(-4.0, -2.0, (n, 3)).astype(np.float32)
    alive = np.ones(n, bool)
    if edge:
        k = n // 8
        xyz[:k, 2] = rng.uniform(-6.0, -3.75, k)
        scaling[k:2 * k, 0] = rng.uniform(6.0, 9.0, k)
        scaling[k:2 * k, 1:] = -30.0
        op[2 * k:3 * k] = rng.uniform(1e-4, 1.0 / 255.0, (k, 1))
        alive[::7] = False
    return {
        "xyz": xyz,
        "features_dc": (0.3 * rng.randn(n, 1, 3)).astype(np.float32),
        "features_rest": (0.05 * rng.randn(n, rest, 3)).astype(np.float32),
        "scaling": scaling,
        "rotation": rng.randn(n, 4).astype(np.float32),
        "opacity": np.log(op / (1 - op)).astype(np.float32),
        "alive": alive,
    }


def _scene(n, seed, device, degree=3, rest=15, edge=False):
    scene = scene_from_numpy(_fields(n, seed, rest, edge), degree, device)
    scene.active_sh_degree = degree
    return scene


def _camera(width, height, device, fov=60.0):
    return Camera.create(0, np.eye(3), np.array([0.0, 0.0, 4.0]), math.radians(fov),
                         math.radians(fov * height / width), None, None, "k", 0,
                         width=width, height=height, device=device)


def _bench_scene_and_view(device, seed=1234567):
    """The benchmark's 1M-Gaussian SH-3 scene and one of its 1080p poses."""
    from perfbench import scenes
    from perfbench.drivers.splat_train import port_camera
    from perfbench.reference import splat as ref

    fields = scenes.synthetic_scene(1_000_000, seed, device, 3)
    spec = {"phase": 0.5, "count": 64, "radius": [3.9, 4.7], "height": [0.7, 1.9], "fovx": 0.9,
            "width": 1920, "height_px": 1080}
    v = scenes.orbit_views(spec, seed, device, tag=4)[0]
    scene = GaussianScene(1_000_000, 3, device)
    with torch.no_grad():
        for k in ref.LEAVES:
            getattr(scene, k).copy_(fields[k])
        scene.alive.fill_(True)
    scene.active_sh_degree = 3
    return scene, port_camera(0, v, None)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same_bits(got, want):
    for name, a, b in zip(FIELDS, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype, a.shape, b.shape)
        same = _bits(a) == _bits(b)
        if not bool(same.all()):
            bad = ~same
            raise AssertionError(f"{name}: {int(bad.sum())} of {a.numel()} values differ, e.g. "
                                 f"{a[bad][:4].tolist()} vs {b[bad][:4].tolist()}")


def _both(scene, cam, scaling_modifier=1.0, override_color=None):
    view = project.view_args(cam)
    with torch.no_grad():
        before = project.PROJECT_FWD.launches
        proj, inc = project.project_scene(scene, view, scaling_modifier, override_color)
        torch.cuda.synchronize()
        assert project.PROJECT_FWD.launches == before + 1
        p_proj, p_inc = project.project_scene_plain(scene, view, scaling_modifier, override_color)
    return tuple(proj) + (inc,), tuple(p_proj) + (p_inc,)


def _unaligned(scene):
    """The scene with its features_rest moved to a contiguous view whose
    start is not 16-byte aligned (K10 then stages its rows word by word)."""
    rest = scene.features_rest.detach()
    base = torch.empty((rest.shape[0] + 1,) + rest.shape[1:], dtype=rest.dtype, device=rest.device)
    base[1:] = rest
    moved = TensorScene.of(scene).replace(features_rest=base[1:])
    assert moved.features_rest.is_contiguous() and moved.features_rest.data_ptr() % 16
    return moved


GPU_CASES = {
    # name: (n, degree, features_rest rows, scaling_modifier, override_color, edge, width, height)
    "sh0": (4000, 0, 15, 1.0, False, False, 160, 112),
    "sh1": (4001, 1, 15, 1.0, False, False, 160, 112),
    "sh2": (4000, 2, 15, 1.0, False, False, 160, 112),
    "sh3": (4099, 3, 15, 1.0, False, False, 200, 90),
    "sh1_of_1": (3000, 1, 3, 1.0, False, False, 160, 112),
    "sh2_of_2": (3000, 2, 8, 1.0, False, False, 160, 112),
    "override_color": (4000, 3, 15, 1.0, True, False, 160, 112),
    "scaling_modifier": (4000, 3, 15, 0.37, False, False, 160, 112),
    "edge": (4000, 3, 15, 1.0, False, True, 128, 128),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_CASES))
def test_k10_matches_plain_chain_bit_for_bit(cuda, case):
    n, degree, rest, smod, with_color, edge, w, h = GPU_CASES[case]
    scene = _scene(n, 3, cuda, degree, rest, edge)
    color = (torch.rand(n, 3, generator=torch.Generator().manual_seed(5)).to(cuda) if with_color else None)
    got, want = _both(scene, _camera(w, h, cuda), smod, color)
    _assert_same_bits(got, want)
    radii, depths, conics = want[3], want[1], want[2]
    assert int((radii > 0).sum()) > n // 4
    if edge:
        assert int((depths <= 0.2).sum()) > 0
        assert int(((depths > 0.2) & (radii == 0) & torch.isfinite(conics).all(1)).sum()) > 0  # det == 0
        assert int(((radii > 0) & (want[5] < 1.0 / 255.0) & (want[5] > 0)).sum()) > 0
        assert int((~scene.alive & (radii > 0)).sum()) > 0


@pytest.mark.gpu
def test_k10_reads_unaligned_rest_rows(cuda):
    scene = _unaligned(_scene(4001, 3, cuda))
    _assert_same_bits(*_both(scene, _camera(160, 112, cuda)))


@pytest.mark.gpu
def test_k10_matches_plain_chain_on_the_benchmark_scene(cuda):
    scene, cam = _bench_scene_and_view(cuda)
    got, want = _both(scene, cam)
    _assert_same_bits(got, want)
    assert int(want[-1].sum()) > 100_000


@pytest.mark.gpu
@pytest.mark.parametrize("with_color", [False, True])
def test_k10_gradient_matches_plain_autograd(cuda, with_color):
    scene = _scene(3000, 3, cuda, edge=True)
    cam = _camera(128, 128, cuda)
    color = torch.rand(3000, 3, device=cuda, requires_grad=True) if with_color else None
    grads = []
    for fn in (project.project_scene, project.project_scene_plain):
        proj, _ = fn(scene, project.view_args(cam), 0.8, color)
        g = torch.Generator(device=cuda).manual_seed(0)
        loss = sum((torch.randn(x.shape, generator=g, device=cuda) * x).sum() for x in proj
                   if x.is_floating_point())
        params = list(scene.parameters()) + ([color] if with_color else [])
        grads.append(torch.autograd.grad(loss, params, allow_unused=True))
    assert project.PROJECT_FWD.launches > 0
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(_bits(a), _bits(b))


@pytest.mark.gpu
def test_render_counts_one_fused_projection_per_view(cuda):
    scene, cam = _scene(4000, 0, cuda), _camera(320, 240, cuda)
    with torch.no_grad():
        render(cam, scene)
        before = project.PROJECT_FWD.launches
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(3):
                render(cam, scene)
        torch.cuda.synchronize()
    assert project.PROJECT_FWD.launches == before + 3
    assert profiling.summary()["counters"]["render.project.fused"] == 3


@pytest.mark.gpu
def test_served_view_projects_without_a_host_sync(cuda):
    """A served view keeps its 7 host synchronisations (binning 5, gather 1,
    frame bytes 1), none of them in projection."""
    scene, cam = _scene(4000, 3, cuda), _camera(320, 240, cuda)

    def serve():
        with torch.no_grad():
            out = render(cam, scene, RenderConfig(), bg_color=torch.zeros(3, device=cuda))
            return image_to_bytes(out["render"])

    serve()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        profiling.reset()
        serve()
        s = profiling.summary()
    assert s["counters"][profiling.SYNCS] == 7
    assert s["spans"]["render.project"]["syncs"] == 0
    assert s["counters"]["render.project.fused"] == 1


# ---------------------------------------------------------------- the CPU ----


@pytest.mark.parametrize("degree,with_color", [(0, False), (1, False), (2, False), (3, False), (3, True)])
def test_project_view_on_cpu_runs_the_plain_chain(degree, with_color):
    scene, cam = _scene(500, 1, "cpu", degree), _camera(96, 64, "cpu")
    color = torch.rand(500, 3) if with_color else None
    before = project.PROJECT_FWD.launches
    with torch.no_grad():
        got = project_view(cam, scene, 0.9, color)
        want = project.project_gaussians(
            scene.get_xyz, scene.get_scaling, scene.get_rotation, scene.get_opacity[:, 0],
            None if with_color else scene.get_features, color, **project.view_args(cam),
            active_sh_degree=degree, scaling_modifier=0.9)
        out = render(cam, scene)
    assert project.PROJECT_FWD.launches == before
    for name, a, b in zip(project.Projected._fields, got, want):
        assert torch.equal(_bits(a), _bits(b)), name
    assert torch.equal(out["radii"], project_view(cam, scene).radii)


def _plain_launch(static, *inputs):
    """K10's outputs from the plain chain, in K10's place."""
    proj, include = project._plain_on_inputs(static, inputs)
    return tuple(t.clone() for t in proj) + (include.clone(),)


@pytest.mark.parametrize("degree,with_color,used", [
    (0, False, "all"), (1, False, "all"), (2, False, "all"), (3, False, "all"), (3, True, "all"),
    (3, False, "rgbs"), (2, True, "means2d"),
])
def test_recompute_backward_matches_plain_autograd(monkeypatch, degree, with_color, used):
    monkeypatch.setattr(project, "_launch_project", _plain_launch)
    scene, cam = _scene(400, 2, "cpu", degree, edge=True), _camera(64, 64, "cpu")
    color = torch.rand(400, 3, requires_grad=True) if with_color else None
    view = project.view_args(cam)
    params = list(scene.parameters()) + ([color] if with_color else [])
    grads = []
    for fn in (project.project_fused, project.project_scene_plain):
        proj, include = fn(scene, view, 0.8, color)
        g = torch.Generator().manual_seed(0)
        loss = sum((torch.randn(getattr(proj, k).shape, generator=g) * getattr(proj, k)).sum()
                   for k in ("means2d", "depths", "conics", "rgbs", "opacities") if used in ("all", k))
        grads.append((torch.autograd.grad(loss, params, allow_unused=True), proj, include))
    (g_fused, p_fused, i_fused), (g_plain, p_plain, i_plain) = grads
    for a, b in zip(tuple(p_fused) + (i_fused,), tuple(p_plain) + (i_plain,)):
        assert torch.equal(_bits(a.detach()), _bits(b.detach()))
    for name, a, b in zip([n for n, _ in scene.named_parameters()] + ["override_color"], g_fused, g_plain):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(_bits(a), _bits(b)), name
    assert not any(t.requires_grad for t in (p_fused.radii, p_fused.radii_bin, p_fused.rect_bin, i_fused))


def _launch_args(**change):
    """``_launch_project``'s arguments for a valid 64-Gaussian SH-3 scene on
    the CPU, with ``change`` applied."""
    n = 64
    f = {k: torch.as_tensor(v) for k, v in _fields(n, 0).items()}
    cam = _camera(64, 48, "cpu")
    args = dict(static=(64, 48, 0.5, 0.4, 3, 1.0), xyz=f["xyz"], scaling=f["scaling"], rotation=f["rotation"],
                opacity=f["opacity"], alive=f["alive"], features_dc=f["features_dc"],
                features_rest=f["features_rest"], override_color=None,
                world_view_transform=cam.world_view_transform, full_proj_transform=cam.full_proj_transform,
                camera_center=cam.camera_center)
    for k, v in change.items():
        args[k] = v(args) if callable(v) else v
    return args


BAD_LAUNCHES = {
    "degree_4": dict(static=(64, 48, 0.5, 0.4, 4, 1.0)),
    "degree_negative": dict(static=(64, 48, 0.5, 0.4, -1, 1.0)),
    "rest_too_short": dict(static=(64, 48, 0.5, 0.4, 3, 1.0), features_rest=lambda a: a["features_rest"][:, :8]),
    "rest_too_long": dict(features_rest=torch.zeros(64, 24, 3)),
    "xyz_float64": dict(xyz=lambda a: a["xyz"].double()),
    "rotation_shape": dict(rotation=lambda a: a["rotation"][:, :3].contiguous()),
    "scaling_strided": dict(scaling=lambda a: a["scaling"].t().contiguous().t()),
    "opacity_flat": dict(opacity=lambda a: a["opacity"][:, 0]),
    "alive_float": dict(alive=lambda a: a["alive"].float()),
    "features_dc_shape": dict(features_dc=lambda a: a["features_dc"][:, 0]),
    "override_shape": dict(override_color=torch.zeros(64, 4)),
    "override_strided": dict(override_color=torch.zeros(3, 64).t()),
    "camera_shape": dict(camera_center=torch.zeros(4)),
    "matrix_float64": dict(full_proj_transform=lambda a: a["full_proj_transform"].double()),
    "on_the_cpu": dict(),
}


@pytest.mark.parametrize("case", sorted(BAD_LAUNCHES))
def test_launch_checks_raise_before_any_launch(case):
    args = _launch_args(**BAD_LAUNCHES[case])
    before = project.PROJECT_FWD.launches
    with pytest.raises(ValueError):
        project._launch_project(**args)
    assert project.PROJECT_FWD.launches == before
    assert project.PROJECT_FWD._fn is None  # nothing built or loaded

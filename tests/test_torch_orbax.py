"""The port's snapshot layer (``train/orbax_ckpt.py``) and its wiring into the
splat trainer and the two CLIs, against the JAX package's Orbax layer.

The JAX package writes with Orbax; its snapshots are read back here with
Orbax as numpy. Tolerances: the snapshot trees after 20 iterations of both
trainers from the same scene (no densification) agree in keys, shapes and
``meta`` exactly and in values to 2e-4 of each array's largest magnitude
(``tests/test_torch_train.py``'s train-step tolerance); a JAX snapshot
restored by the port is bit for bit; the SH bump and the opacity reset from
a shared JAX checkpoint agree exactly in the SH degree, the opacity leaf
and its zeroed Adam moments, and to 2e-4 after the next step."""

import math
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gaussian_transformer_tpu.render import RenderConfig as JaxRenderConfig
from gaussian_transformer_tpu.train import optim as jax_optim
from gaussian_transformer_tpu.train import orbax_ckpt as jax_orbax
from gaussian_transformer_tpu.train.splat import OptConfig as JaxOptConfig
from gaussian_transformer_tpu.train.splat import capture as jax_capture
from gaussian_transformer_tpu.train.splat import training as jax_training
from gaussian_transformer_tpu.scene.densify import DensifyStats as JaxStats
from gaussian_transformer_tpu_torch.cli import train as cli_train
from gaussian_transformer_tpu_torch.cli import train_stacked as cli_stacked
from gaussian_transformer_tpu_torch.convert import scene_from_numpy
from gaussian_transformer_tpu_torch.render import RenderConfig
from gaussian_transformer_tpu_torch.train import orbax_ckpt
from gaussian_transformer_tpu_torch.train.optim import PARAM_LEAVES
from gaussian_transformer_tpu_torch.train.splat import OptConfig, orbax_payload, orbax_restore_state, training

from tests.test_render import make_scene
from tests.test_train import _synthetic_scene_and_cams
from tests.torch_port_support import torch_camera, torch_scene

REL = 2e-4  # tests/test_torch_train.py's train-step tolerance, of each array's largest magnitude


def _close(got, ref, rel, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * (np.abs(ref).max() + 1e-30), err_msg=what)


def _flat(tree, prefix=""):
    """{"a/b/c": numpy array} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


@pytest.fixture(scope="module")
def scene_and_cams():
    return _synthetic_scene_and_cams(n=16, n_cams=3)


def _torch_cams(cams):
    out = []
    for cam in cams:
        t = torch_camera(cam)
        t.original_image = torch.from_numpy(np.asarray(cam.original_image))
        out.append(t)
    return out


def _scene_obj(gaussians, cams, model_path):
    return types.SimpleNamespace(gaussians=gaussians, cameras_extent=2.0, model_path=str(model_path),
                                 get_train_cameras=lambda scale=1.0: cams,
                                 get_test_cameras=lambda scale=1.0: [], save=lambda it: None)


NO_DENSIFY = dict(densify_from_iter=10**9, position_lr_max_steps=60)


@pytest.fixture(scope="module")
def jax_run(scene_and_cams, tmp_path_factory):
    """The JAX trainer's Orbax snapshots: 20 iterations, one every 10."""
    start, cams = scene_and_cams
    root = tmp_path_factory.mktemp("jax_orbax")
    jax_training(_scene_obj(start, cams, root), JaxOptConfig(iterations=20, **NO_DENSIFY), JaxRenderConfig(),
                 progress=False, orbax_dir=str(root / "run"), orbax_every=10)
    return root / "run"


# ------------------------------------------------------------ the layer ---


def test_training_resumes_from_a_snapshot(scene_and_cams, tmp_path):
    """``tests/test_train.py TestOrbaxResume`` on the port: a first run
    snapshots every 10 iterations; a second run with a longer horizon
    resumes from the newest snapshot instead of starting over."""
    start, cams = scene_and_cams
    tcams = _torch_cams(cams)
    run = str(tmp_path / "run")
    training(_scene_obj(torch_scene(start), tcams, tmp_path), OptConfig(iterations=20, **NO_DENSIFY),
             RenderConfig(), orbax_dir=run, orbax_every=10)
    assert orbax_ckpt.make_manager(run).latest_step() == 20
    seen = []
    training(_scene_obj(torch_scene(start), tcams, tmp_path), OptConfig(iterations=40, **NO_DENSIFY),
             RenderConfig(), orbax_dir=run, orbax_every=10, log_fn=lambda iteration, **kw: seen.append(iteration))
    assert seen == list(range(21, 41))
    mgr = orbax_ckpt.make_manager(run)
    assert mgr.latest_step() == 40 and mgr.all_steps() == [20, 30, 40]


def test_resume_across_a_capacity_doubling(tmp_path):
    """A snapshot taken after the capacity doubled restores at the doubled
    capacity, though the fresh run starts at the smaller one."""
    start, cams = _synthetic_scene_and_cams(n=300, n_cams=3, width=32, height=24, seed=3)
    tcams = _torch_cams(cams)
    opt = dict(densify_from_iter=5, densification_interval=10, densify_until_iter=15, position_lr_max_steps=60)
    run = str(tmp_path / "run")
    caps = []
    training(_scene_obj(torch_scene(start), tcams, tmp_path), OptConfig(iterations=20, **opt), RenderConfig(),
             capacity_headroom=1.0, orbax_dir=run, orbax_every=20,
             log_fn=lambda iteration, gaussians, **kw: caps.append(gaussians.capacity))
    assert caps[0] == 300 and caps[-1] == 600, (caps[0], caps[-1])
    snap = orbax_ckpt.restore_raw(orbax_ckpt.make_manager(run))
    assert snap["param"]["xyz"].shape == (600, 3) and snap["adam"]["mu"]["xyz"].shape == (600, 3)
    seen = []
    training(_scene_obj(torch_scene(start), tcams, tmp_path), OptConfig(iterations=22, **opt), RenderConfig(),
             capacity_headroom=1.0, orbax_dir=run, orbax_every=20,
             log_fn=lambda iteration, gaussians, **kw: seen.append((iteration, gaussians.capacity)))
    assert seen == [(21, 600), (22, 600)]


def test_torn_temporary_snapshot_is_ignored_and_removed(tmp_path):
    mgr = orbax_ckpt.make_manager(str(tmp_path))
    orbax_ckpt.save(mgr, 10, {"w": torch.arange(4.0)})
    mgr.wait_until_finished()
    torn = tmp_path / "orbax" / ".tmp-20-dead"
    torn.mkdir()
    (torn / "state.pt").write_bytes(b"\x80\x02half a pickle")
    mgr = orbax_ckpt.make_manager(str(tmp_path))
    assert mgr.latest_step() == 10 and not torn.exists()
    assert torch.equal(orbax_ckpt.restore_raw(mgr)["w"], torch.arange(4.0))


@pytest.mark.parametrize("async_save", [True, False])
def test_max_to_keep_is_honoured(tmp_path, async_save):
    """Saves from the loop race the writer thread over the step set (a
    short switch interval makes them interleave); none is lost."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        mgr = orbax_ckpt.make_manager(str(tmp_path), max_to_keep=2, async_save=async_save)
        for step in range(1, 41):
            orbax_ckpt.save(mgr, step, {"w": torch.full((3,), float(step))})
            assert mgr.latest_step() == step  # in flight or written
        mgr.wait_until_finished()
    finally:
        sys.setswitchinterval(interval)
    assert mgr.all_steps() == [39, 40]
    assert sorted(p.name for p in (tmp_path / "orbax").iterdir()) == ["39", "40"]
    assert torch.equal(orbax_ckpt.restore_raw(mgr, 39)["w"], torch.full((3,), 39.0))


def test_save_copies_the_state_before_returning(tmp_path):
    """The loop goes on editing its tensors in place while the writer runs."""
    mgr = orbax_ckpt.make_manager(str(tmp_path))
    w = torch.zeros(1000)
    orbax_ckpt.save(mgr, 1, {"w": w})
    w += 1.0
    assert float(orbax_ckpt.restore_raw(mgr)["w"].abs().max()) == 0.0


def test_a_jax_orbax_dir_raises(jax_run):
    with pytest.raises(ValueError, match="Orbax"):
        orbax_ckpt.make_manager(str(jax_run))


# ------------------------------------------------- against the JAX layer ---


def test_snapshot_tree_matches_the_jax_package(scene_and_cams, jax_run, tmp_path):
    start, cams = scene_and_cams
    training(_scene_obj(torch_scene(start), _torch_cams(cams), tmp_path), OptConfig(iterations=20, **NO_DENSIFY),
             RenderConfig(), orbax_dir=str(tmp_path / "run"), orbax_every=10)
    jmgr = jax_orbax.make_manager(str(jax_run))
    assert jmgr.latest_step() == 20 and orbax_ckpt.make_manager(str(tmp_path / "run")).all_steps() == [10, 20]
    ref = _flat(jax_orbax.restore_raw(jmgr))
    got = _flat(orbax_ckpt.restore_raw(orbax_ckpt.make_manager(str(tmp_path / "run"))))
    assert sorted(got) == sorted(ref)
    np.testing.assert_array_equal(got["meta"], ref["meta"])
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    for k in ref:
        _close(got[k], ref[k], REL, k)

    # The JAX snapshot restores through the port bit for bit.
    scene, adam, stats, it, slrs = orbax_restore_state(jax_orbax.restore_raw(jmgr), device="cpu")
    again = _flat(orbax_payload(scene, adam, stats, it, slrs))
    assert (it, slrs) == (20, 2.0) and sorted(again) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(again[k], ref[k], k)


def test_sh_bump_and_opacity_reset_match_the_jax_package(scene_and_cams, tmp_path):
    """Both trainers resume from one JAX-written ``chkpnt999.npz`` (an SH-2
    scene at degree 0 with nonzero Adam moments) and run iterations 1000
    (the SH bump before the step, the opacity reset after it) and 1001."""
    _, cams = scene_and_cams
    start = make_scene(24, seed=9, max_sh_degree=2).replace(active_sh_degree=0)
    rng = np.random.RandomState(9)
    jadam = jax_optim.AdamState(
        mu={k: jnp.asarray(0.01 * rng.randn(*getattr(start, k).shape).astype(np.float32)) for k in PARAM_LEAVES},
        nu={k: jnp.asarray(1e-4 * rng.rand(*getattr(start, k).shape).astype(np.float32)) for k in PARAM_LEAVES},
        counts={k: jnp.asarray(999.0, jnp.float32) for k in PARAM_LEAVES},
    )
    ckpt = tmp_path / "chkpnt999.npz"
    np.savez(ckpt, **jax_capture(start, jadam, JaxStats.init(start.capacity), 999, 2.0))
    opt = dict(iterations=1001, densify_from_iter=10**9, densify_until_iter=2000, opacity_reset_interval=1000,
               position_lr_max_steps=2000)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jax_training(_scene_obj(start, cams, jdir), JaxOptConfig(**opt), JaxRenderConfig(), progress=False,
                 start_checkpoint=str(ckpt), checkpoint_iterations={1000, 1001})
    seen = []
    training(_scene_obj(torch_scene(start), _torch_cams(cams), tdir), OptConfig(**opt), RenderConfig(),
             start_checkpoint=str(ckpt), checkpoint_iterations={1000, 1001},
             log_fn=lambda iteration, gaussians, **kw: seen.append((iteration, gaussians.active_sh_degree)))
    assert seen == [(1000, 1), (1001, 1)]
    ref, got = dict(np.load(jdir / "chkpnt1000.npz")), dict(np.load(tdir / "chkpnt1000.npz"))
    assert int(got["active_sh_degree"]) == int(ref["active_sh_degree"]) == 1
    alive = ref["alive"]
    assert np.all(1 / (1 + np.exp(-got["param.opacity"][alive])) <= 0.01 * (1 + 1e-6))
    np.testing.assert_array_equal(got["param.opacity"], ref["param.opacity"])
    for m in ("mu", "nu"):
        assert not got[f"adam.{m}.opacity"].any() and not ref[f"adam.{m}.opacity"].any()
        assert got[f"adam.{m}.xyz"].any()
    ref, got = dict(np.load(jdir / "chkpnt1001.npz")), dict(np.load(tdir / "chkpnt1001.npz"))
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(got[k], ref[k], REL, k)


# ------------------------------------------------------------------ CLIs ---


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("orbax_data")
    scene = scene_from_numpy(chip_smoke.synthetic_scene(2000, 0), 3, "cpu")
    chip_smoke.write_train_dataset(root, scene, chip_smoke.surface_points(800, 3), 3, 1, 64, 48,
                                   math.radians(50.0), torch.device("cpu"))
    return root


def test_cli_train_orbax_every_snapshots_and_resumes(dataset, tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # TensorBoard is optional
    argv = ["-s", str(dataset), "-m", str(tmp_path / "model"), "--eval", "--densify_from_iter", "5",
            "--densification_interval", "5", "--densify_until_iter", "20", "--orbax_every", "10",
            "--test_iterations", "30", "--device", "cpu"]
    first = cli_train.main(argv + ["--iterations", "20", "--quiet"])
    assert [h["iteration"] for h in first["history"]] == list(range(1, 21))
    mgr = orbax_ckpt.make_manager(str(tmp_path / "model"))
    assert mgr.all_steps() == [10, 20]
    assert int(orbax_ckpt.restore_raw(mgr)["meta"][0]) == 20

    resumed = cli_train.main(argv + ["--iterations", "30"])
    out = capsys.readouterr().out
    assert f"resumed from orbax step 20 ({tmp_path / 'model'})" in out
    assert "Tensorboard not available" in out
    assert [h["iteration"] for h in resumed["history"]] == list(range(21, 31))
    assert all(math.isfinite(h["loss"]) for h in resumed["history"])
    assert orbax_ckpt.make_manager(str(tmp_path / "model")).all_steps() == [10, 20, 30]
    assert (tmp_path / "model" / "point_cloud" / "iteration_30" / "point_cloud.ply").exists()


@pytest.fixture(scope="module")
def stacked_dir(tmp_path_factory):
    """A trained-looking SH-1 scene of 320 Gaussians as a model dir with a
    Blender dataset of four 64x48 views (as ``tests/test_torch_stacked.py``)."""
    root = tmp_path_factory.mktemp("stacked_orbax")
    fields = chip_smoke.synthetic_scene(320, 2)
    fields["features_rest"] = fields["features_rest"][:, :3]
    scene = scene_from_numpy(fields, 1, "cpu")
    chip_smoke.write_train_dataset(root / "data", scene, chip_smoke.surface_points(300, 2), 4, 1, 64, 48,
                                   math.radians(50.0), torch.device("cpu"))
    scene.save_ply(str(root / "model" / "point_cloud" / "iteration_7" / "point_cloud.ply"))
    return root


def test_cli_train_stacked_orbax_snapshots_and_resumes(stacked_dir, tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.chdir(tmp_path)
    run = tmp_path / "run"
    argv = ["-s", str(stacked_dir / "data"), "-m", str(stacked_dir / "model"), "--eval", "--stack", "2",
            "--layers", "1", "--batch_size", "2", "--run_name", str(run), "--checkpoint_every", "1",
            "--orbax", "--quiet", "--device", "cpu"]
    res = cli_stacked.main(argv + ["--epochs", "2"])
    assert res["first_epoch"] == 0 and [e["epoch"] for e in res["epochs"]] == [0, 1]
    assert orbax_ckpt.make_manager(str(run)).all_steps() == [1]
    assert not list(run.glob("checkpoint_*"))  # snapshots in place of the npz checkpoints
    saved = {n: p.detach().clone() for n, p in res["model"].named_parameters()}
    capsys.readouterr()

    resumed = cli_stacked.main(argv + ["--epochs", "4"])
    assert "resumed from orbax epoch 1" in capsys.readouterr().out
    assert resumed["first_epoch"] == 2 and [e["epoch"] for e in resumed["epochs"]] == [2, 3]
    assert orbax_ckpt.make_manager(str(run)).all_steps() == [1, 3]
    changed = [not torch.equal(saved[n], p) for n, p in resumed["model"].named_parameters()]
    assert all(changed)
    state = resumed["optimizer"].state[next(resumed["model"].parameters())]
    assert int(state["step"]) == 8  # 4 cameras / batch 2, four epochs

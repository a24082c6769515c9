"""The port's training slice end to end on the CPU: ``cli.train --device
cpu`` on a tiny Blender-layout dataset built by ``chip_smoke.py``'s own
helpers (the GT views are the port's renders of a seeded synthetic scene,
the point cloud is sampled from its surfaces), with one densify pass in the
window; the loss falls, the output tree is the reference's, and a checkpoint
resumes. The fresh ``Scene`` (point-cloud init, input.ply, cameras.json) is
held against the JAX ``Scene`` on the same dataset."""

import dataclasses
import json
import math
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from gaussian_transformer_tpu.scene import Scene as JaxScene
from gaussian_transformer_tpu_torch.cli import train as cli_train
from gaussian_transformer_tpu_torch.convert import scene_from_numpy
from gaussian_transformer_tpu_torch.scene import Scene
from gaussian_transformer_tpu_torch.train.splat import restore

from tests.torch_port_support import SCENE_FIELDS

W, H = 96, 64


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    scene = scene_from_numpy(chip_smoke.synthetic_scene(4000, 0), 3, "cpu")
    points = chip_smoke.surface_points(1500, 3)
    chip_smoke.write_train_dataset(root, scene, points, 3, 2, W, H, math.radians(50.0), torch.device("cpu"))
    return root


def _argv(data, model, iterations, *extra):
    return ["-s", str(data), "-m", str(model), "-r", "1", "--eval", "--iterations", str(iterations),
            "--densify_from_iter", "10", "--densification_interval", "10", "--densify_until_iter", "30",
            "--test_iterations", str(iterations), "--save_iterations", str(iterations),
            "--quiet", "--device", "cpu", *extra]


def test_cli_train_loss_falls_writes_the_tree_and_resumes(dataset, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # TensorBoard is optional
    model = tmp_path / "model"
    res = cli_train.main(_argv(dataset, model, 30, "--checkpoint_iterations", "20"))
    hist = res["history"]
    assert [h["iteration"] for h in hist] == list(range(1, 31))
    losses = [h["loss"] for h in hist]
    assert all(math.isfinite(v) for v in losses)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    dens = [h for h in hist if "densify" in h]
    assert [h["iteration"] for h in dens] == [20]
    assert dens[0]["densify"]["n_alive"] != 1500
    assert all(h["overflow"] == 0 for h in hist)
    for name in ("cfg_args", "input.ply", "cameras.json", "chkpnt20.npz",
                 "point_cloud/iteration_30/point_cloud.ply"):
        assert (model / name).exists(), name
    assert math.isfinite(res["evals"][30]["test"][0])
    with open(model / "cameras.json") as f:
        assert len(json.load(f)) == 5  # test views first, then train

    payload = dict(np.load(model / "chkpnt20.npz", allow_pickle=False))
    scene, _, _, it, _ = restore(payload, device="cpu")
    assert it == 20 and scene.num_alive == dens[0]["densify"]["n_alive"]
    resumed = cli_train.main(_argv(dataset, model, 24, "--start_checkpoint", str(model / "chkpnt20.npz")))
    assert [h["iteration"] for h in resumed["history"]] == [21, 22, 23, 24]
    assert all(math.isfinite(h["loss"]) for h in resumed["history"])
    assert (model / "point_cloud/iteration_24/point_cloud.ply").exists()


@pytest.mark.parametrize("group", ["OptimizationParams", "PipelineParams"])
def test_flag_groups_match_reference(group):
    """The port's optimization and pipeline flags: the reference's names,
    defaults and types, and ``OptConfig`` built from them."""
    from argparse import ArgumentParser

    from gaussian_transformer_tpu import config as jax_config
    from gaussian_transformer_tpu.train.splat import OptConfig as JaxOptConfig
    from gaussian_transformer_tpu_torch import config

    argv = ["--iterations", "7", "--lambda_dssim", "0.5", "--debug"]
    got_parser, ref_parser = ArgumentParser(), ArgumentParser()
    got_group = getattr(config, group)(got_parser)
    ref_group = getattr(jax_config, group)(ref_parser)
    got, ref = got_parser.parse_args([]), ref_parser.parse_args([])
    assert vars(got) == vars(ref)
    assert {k: type(v) for k, v in vars(got).items()} == {k: type(v) for k, v in vars(ref).items()}
    if group == "OptimizationParams":
        got_opt = config.OptConfig.from_args(got_group.extract(got_parser.parse_args(argv[:4])))
        ref_opt = JaxOptConfig(**vars(ref_group.extract(ref_parser.parse_args(argv[:4]))))
        assert dataclasses.asdict(got_opt) == dataclasses.asdict(ref_opt)
        assert got_opt.iterations == 7 and got_opt.lambda_dssim == 0.5
    else:
        assert got_group.extract(got_parser.parse_args(argv[4:])).debug is True


def test_fresh_scene_matches_reference(dataset, tmp_path):
    """Point-cloud init, the model dir's input.ply and cameras.json, and the
    cameras, against the JAX Scene on the same dataset."""
    from argparse import Namespace

    kw = dict(source_path=str(dataset), images="images", eval=True, white_background=False,
              resolution=1, sh_degree=1)
    ref = JaxScene(Namespace(model_path=str(tmp_path / "jax"), **kw), shuffle=False)
    got = Scene(Namespace(model_path=str(tmp_path / "port"), **kw), shuffle=False, device="cpu")
    assert got.cameras_extent == pytest.approx(ref.cameras_extent, rel=1e-12)
    for k in SCENE_FIELDS:
        np.testing.assert_allclose(getattr(got.gaussians, k).detach().numpy(),
                                   np.asarray(getattr(ref.gaussians, k)), rtol=1e-5, err_msg=k)
    assert (tmp_path / "port" / "input.ply").read_bytes() == (tmp_path / "jax" / "input.ply").read_bytes()
    with open(tmp_path / "jax" / "cameras.json") as f, open(tmp_path / "port" / "cameras.json") as g:
        assert json.load(g) == json.load(f)
    for split in ("get_train_cameras", "get_test_cameras"):
        for a, b in zip(getattr(got, split)(), getattr(ref, split)()):
            np.testing.assert_array_equal(a.full_proj_transform.numpy(), np.asarray(b.full_proj_transform))
            np.testing.assert_array_equal(a.original_image.numpy(), np.asarray(b.original_image))

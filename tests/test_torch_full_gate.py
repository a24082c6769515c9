"""The port's quality gate (``gaussian_transformer_tpu_torch/tools/full_gate.py``)
at a tiny size on the CPU: 4 ring cameras at 64x48, a 2,000-Gaussian ground
truth, a 300-point seed and 150 iterations with an early densify window
given through ``cli.train``'s own flags. The chain completes and writes its
record, the COLMAP text reads back through the port's reader to the
rotations and translations that were written (1e-9), and the verdict
follows the floors."""

import json
import sys

import numpy as np
import pytest
import torch

import tests.torch_port_support  # noqa: F401  (one torch thread a worker)
from gaussian_transformer_tpu_torch.scene.dataset_readers import read_colmap_scene_info
from gaussian_transformer_tpu_torch.tools import full_gate

ARGV = ["--iters", "150", "--cams", "4", "--width", "64", "--height", "48", "--gt-size", "2000",
        "--seed-points", "300", "--psnr-floor", "5", "--min-final", "100", "--device", "cpu",
        "--densify_from_iter", "20", "--densification_interval", "50", "--densify_until_iter", "150"]


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    out = tmp_path_factory.mktemp("gate")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)  # TensorBoard is optional
        rc = full_gate.main(ARGV + ["--out", str(out)])
    return rc, out


def test_the_chain_completes_and_writes_its_record(gate):
    rc, out = gate
    with open(out / "full_gate_results.json") as f:
        r = json.load(f)
    assert rc == 0 and r["verdict"] == "PASS"
    assert np.isfinite(r["psnr"]) and 0.0 < r["ssim"] <= 1.0
    assert r["n_final"] >= 100 and r["densify_passes"] == 2
    assert [d["iteration"] for d in r["densify"]] == [50, 100]
    assert r["extra_train_args"] == ARGV[-6:]
    assert set(r["stage_s"]) == {"dataset", "train", "render", "metrics"}
    assert r["device"] == "cpu" and r["launches_per_step"] == {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0}
    assert [w["iterations"] for w in r["windows"]] == ["1-150"]
    assert (out / "full_gate.md").read_text().startswith("# Full-pipeline quality gate")
    model = out / "work" / "model"
    assert (model / "point_cloud" / "iteration_150" / "point_cloud.ply").exists()
    assert full_gate.ply_vertex_count(model / "point_cloud" / "iteration_150" / "point_cloud.ply") == r["n_final"]


def test_colmap_text_reads_back_to_the_written_cameras(tmp_path):
    written = full_gate.build_scene_dir(tmp_path, 3, 32, 24, 500, 50, 1, torch.device("cpu"))
    info = read_colmap_scene_info(str(tmp_path), "images", eval=False)
    cams = info.train_cameras
    assert [c.image_name + ".png" for c in cams] == written["names"]
    for c, R, T in zip(cams, written["R"], written["T"]):
        np.testing.assert_allclose(c.R, R.T, atol=1e-9)  # the reader stores the transposed rotation
        np.testing.assert_allclose(c.T, T, atol=1e-9)
        assert (c.width, c.height) == (32, 24) and c.image.shape == (24, 32, 3)
    assert info.point_cloud.points.shape == (50, 3)


@pytest.mark.parametrize("psnr, n_final, verdict", [
    (30.0, 200, "PASS"), (25.0, 150, "PASS"), (24.99, 200, "FAIL"), (30.0, 149, "FAIL"), (float("nan"), 200, "FAIL"),
])
def test_the_verdict_follows_the_floors(psnr, n_final, verdict):
    assert full_gate.gate_verdict(psnr, n_final, 25.0, 150) == verdict

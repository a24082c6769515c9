"""``cli.full_eval`` (the port's counterpart of the root ``full_eval.py``):
the same subprocess commands as the root script, with the port's modules in
place of the scripts and ``--device`` passed on; and one real chain
(``--skip_training``: renders at 7000 and 30000, then the metrics) on tiny
synthetic COLMAP scenes with ``--device cpu``, the scene lists cut to one
scene each for the two MipNeRF360 lists."""

import json
import math
import sys

import pytest
import torch

import chip_smoke
import full_eval as root_full_eval
from gaussian_transformer_tpu_torch.cli import full_eval

ROOTS = ["-m360", "/data/m360", "-tat", "/data/tat", "-db", "/data/db", "--output_path", "/out/eval"]
CASES = {
    "all": ROOTS,
    "skip_training": ["--skip_training"] + ROOTS,
    "skip_rendering": ["--skip_rendering"] + ROOTS,
    "skip_metrics": ["--skip_metrics"] + ROOTS,
    "metrics_only": ["--skip_training", "--skip_rendering", "--output_path", "/out/eval"],
    "nothing": ["--skip_training", "--skip_rendering", "--skip_metrics"],
}
SCRIPTS = {"train.py": "train", "render.py": "render", "metrics.py": "metrics"}


def _root_commands(argv, monkeypatch):
    cmds = []
    monkeypatch.setattr(root_full_eval, "run", cmds.append)
    monkeypatch.setattr(sys, "argv", ["full_eval.py"] + argv)
    root_full_eval.main()
    return cmds


def _port_commands(argv, monkeypatch):
    cmds = []
    monkeypatch.setattr(full_eval, "run", lambda cmd: cmds.append(cmd) or 0)
    ran = full_eval.main(argv)
    assert [c for c, _ in ran] == cmds and all(rc == 0 for _, rc in ran)
    return cmds


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_commands_are_the_root_scripts_with_the_port_modules(case, device, monkeypatch):
    argv = CASES[case]
    ref = _root_commands(argv, monkeypatch)
    got = _port_commands(argv + ([] if device is None else ["--device", device]), monkeypatch)
    tail = [] if device is None else ["--device", device]
    mapped = [[c[0], "-m", f"gaussian_transformer_tpu_torch.cli.{SCRIPTS[c[1]]}"] + c[2:] + tail for c in ref]
    assert got == mapped
    n = {"all": 40, "skip_training": 27, "skip_rendering": 14, "skip_metrics": 39, "metrics_only": 1, "nothing": 0}
    assert len(got) == n[case]
    if case == "all":
        # The split of the root script: images_4 outdoors, images_2 indoors, 7000 and 30000.
        trains = [c for c in got if c[2].endswith(".train")]
        assert [c[c.index("-i") + 1] for c in trains if "-i" in c] == ["images_4"] * 5 + ["images_2"] * 4
        renders = [c for c in got if c[2].endswith(".render")]
        assert [c[c.index("--iteration") + 1] for c in renders] == ["7000", "30000"] * 13


def test_rendering_without_the_roots_is_refused():
    with pytest.raises(SystemExit):
        full_eval.main(["--skip_training", "--output_path", "/out"])


SCENES = {"mipnerf360_outdoor_scenes": ["bicycle"], "mipnerf360_indoor_scenes": ["room"],
          "tanks_and_temples_scenes": [], "deep_blending_scenes": []}


def test_real_chain_on_the_cpu(tmp_path, monkeypatch):
    """``--skip_training`` over synthetic roots: each model dir is rendered
    at 7000 and 30000 from its images_4 / images_2 folder and scored; the
    children run from another working directory (the repository reaches
    them through PYTHONPATH)."""
    fe = chip_smoke.write_full_eval_roots(tmp_path / "roots", torch.device("cpu"), SCENES, gaussians=1500,
                                          views=2, width=64, height=48)
    for name, scenes in SCENES.items():
        monkeypatch.setattr(full_eval, name, scenes)
    monkeypatch.chdir(tmp_path)
    ran = full_eval.main(["--skip_training"] + fe["flags"] + ["--device", "cpu"])
    assert [rc for _, rc in ran] == [0] * 5, ran
    for name, model in fe["models"].items():
        with open(model / "results.json") as f:
            res = json.load(f)
        assert sorted(res) == ["ours_30000", "ours_7000"]
        images = "images_4" if name == "bicycle" else "images_2"
        with open(model / "cfg_args") as f:
            assert f"images='{images}'" in f.read()
        for method, scores in res.items():
            assert len(list((model / "test" / method / "renders").iterdir())) == 1
            assert math.isfinite(scores["SSIM"])
            assert abs(scores["PSNR"] - chip_smoke.numpy_psnr(model, method)) <= 1e-3

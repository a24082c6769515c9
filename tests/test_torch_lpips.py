"""Port parity for LPIPS (eval/lpips.py) against the JAX package's
``gaussian_transformer_tpu/eval/lpips.py`` on seeded random weights written in
the converter's npz layout (``chip_smoke.write_lpips_weights``): alex and vgg
outputs within 1e-5 relative, their input gradients against ``jax.grad``
within 2e-4 x max|grad| (the suites' gradient tolerance); the weights file search order; and ``cli.metrics``
reporting LPIPS(vgg) with a weights file and null without one."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gaussian_transformer_tpu.eval import lpips as jax_lpips
from gaussian_transformer_tpu_torch.cli import metrics as cli_metrics
from gaussian_transformer_tpu_torch.eval import lpips
from gaussian_transformer_tpu_torch.utils.png import write_png

REL = 1e-5
GRAD_REL = 2e-4


@pytest.fixture
def weights(tmp_path, monkeypatch):
    """Point both packages at a seeded random npz of ``net``."""

    def use(net, seed=0):
        path = tmp_path / f"lpips_{net}.npz"
        chip_smoke.write_lpips_weights(path, net, seed)
        monkeypatch.setenv("GT_LPIPS_WEIGHTS", str(path))
        jax_lpips._load.cache_clear()
        lpips._load.cache_clear()
        return path

    yield use
    jax_lpips._load.cache_clear()
    lpips._load.cache_clear()


@pytest.mark.parametrize("net,shape", [("alex", (3, 64, 96)), ("alex", (2, 3, 70, 81)), ("vgg", (3, 48, 64))])
def test_lpips_and_its_gradient_match_jax(weights, net, shape):
    weights(net, seed=len(shape))
    r = np.random.RandomState(sum(shape))
    x = r.rand(*shape).astype(np.float32)
    y = np.clip(x + r.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    jl, jg = jax.value_and_grad(lambda a: jax_lpips.lpips(a, jnp.asarray(y), net))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = lpips.lpips(tx, torch.from_numpy(y), net)
    got.backward()
    assert float(jl) > 0
    np.testing.assert_allclose(float(got.detach()), float(jl), rtol=REL, atol=0)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tx.grad.numpy(), jg, rtol=0, atol=GRAD_REL * float(np.abs(jg).max()))
    same = lpips.lpips(torch.from_numpy(x), torch.from_numpy(x.copy()), net)
    assert float(same) < 1e-8


def test_weights_search_order(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("GT_LPIPS_WEIGHTS", raising=False)
    for net in ("alex", "vgg"):
        assert lpips.weights_path(net) is None and not lpips.available(net)
    cache = tmp_path / "home" / ".cache" / "gaussian_transformer_tpu" / "lpips_alex.npz"
    chip_smoke.write_lpips_weights(cache, "alex", 0)
    assert lpips.weights_path("alex") == str(cache) and not lpips.available("vgg")
    local = tmp_path / "weights" / "lpips_alex.npz"
    chip_smoke.write_lpips_weights(local, "alex", 1)
    assert lpips.weights_path("alex") == "weights/lpips_alex.npz"
    env = tmp_path / "any.npz"
    chip_smoke.write_lpips_weights(env, "alex", 2)
    monkeypatch.setenv("GT_LPIPS_WEIGHTS", str(env))
    for net in ("alex", "vgg"):
        assert lpips.weights_path(net) == str(env) == jax_lpips.weights_path(net)
    monkeypatch.setenv("GT_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))
    assert lpips.weights_path("alex") == "weights/lpips_alex.npz" == jax_lpips.weights_path("alex")
    lpips._load.cache_clear()
    with pytest.raises(FileNotFoundError):
        lpips._load("vgg")


def _model_dir(root, seed=0):
    """``<root>/test/ours_1/{renders,gt}`` with two 40x48 PNG pairs."""
    r = np.random.RandomState(seed)
    for name in ("00000.png", "00001.png"):
        gt = (r.rand(40, 48, 3) * 255).astype(np.uint8)
        noisy = np.clip(gt.astype(np.int16) + r.randint(-30, 30, gt.shape), 0, 255).astype(np.uint8)
        for sub, img in (("gt", gt), ("renders", noisy)):
            (root / "test" / "ours_1" / sub).mkdir(parents=True, exist_ok=True)
            write_png(str(root / "test" / "ours_1" / sub / name), img)
    return root


def test_metrics_cli_reports_lpips_vgg(weights, tmp_path, monkeypatch):
    model = _model_dir(tmp_path / "model")
    monkeypatch.setenv("GT_LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    monkeypatch.chdir(tmp_path)
    res = cli_metrics.main(["-m", str(model), "--device", "cpu"])
    assert res[str(model)]["ours_1"]["LPIPS"] is None

    weights("vgg", seed=4)
    res = cli_metrics.main(["-m", str(model), "--device", "cpu"])
    got = res[str(model)]["ours_1"]["LPIPS"]
    renders, gts, _ = cli_metrics.read_images(model / "test" / "ours_1" / "renders", model / "test" / "ours_1" / "gt")
    ref = np.mean([float(jax_lpips.lpips(jnp.asarray(a), jnp.asarray(b), "vgg")) for a, b in zip(renders, gts)])
    assert got > 0 and math.isclose(got, ref, rel_tol=REL)
    import json

    per_view = json.loads((model / "per_view.json").read_text())["ours_1"]["LPIPS"]
    assert sorted(per_view) == ["00000.png", "00001.png"] and all(v > 0 for v in per_view.values())

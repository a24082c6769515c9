"""Port parity for the Gaussian autoencoders (models/autoencoder.py) against
the JAX package's flax modules on the same seeded numpy inputs, weights
carried over with ``models/transformer.py params_from_jax``: the scalar
stub, the unshuffle (exact) and the conv pair at factor 1, 2 and 3
(outputs and parameter gradients within 1e-5 x max(1, max|ref|))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_transformer_tpu.models import autoencoder as jax_ae
from gaussian_transformer_tpu_torch.models import autoencoder as ae
from gaussian_transformer_tpu_torch.models import transformer as tf

REL = 1e-5


def _close(got, ref, what=""):
    got, ref = got.detach().numpy(), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL * max(1.0, float(np.abs(ref).max())), err_msg=what)


def _pair(jmod, tmod, x, seed):
    """Init the flax module, carry its weights into the torch module, and
    return the flax variables."""
    variables = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    tmod.load_state_dict(tf.params_from_jax(jax.tree.map(np.asarray, variables)))
    return variables


def _grads_close(tmod, jgrads, what):
    ref = dict(zip(tf.jax_order(tmod), jax.tree.leaves(jgrads)))
    assert len(ref) == len(list(tmod.parameters()))
    for name, p in tmod.named_parameters():
        got = torch.from_numpy(tf.tensor_to_jax(name, p.grad))
        _close(got, ref[name], f"{what} {name}")


def test_scalar_stub_and_its_gradient():
    x = np.random.RandomState(0).randn(1, 26, 9).astype(np.float32)
    jm, tm = jax_ae.GAutoEncoder(), ae.GAutoEncoder(device="cpu")
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    np.testing.assert_array_equal(tm.w.detach().numpy(), np.asarray(variables["params"]["w"]))
    w = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    jl, jg = jax.value_and_grad(lambda v: jnp.sum(jm.apply(v, jnp.asarray(x)) * w))(variables)
    out = tm(torch.from_numpy(x))
    _close(out, jm.apply(variables, jnp.asarray(x)), "stub output")
    (out * torch.from_numpy(w)).sum().backward()
    _close(tm.w.grad, jg["params"]["w"], "stub gradient")


@pytest.mark.parametrize("shape", [(2, 8, 3), (1, 26, 5), (3, 64, 4)])
def test_unshuffle_exact(shape):
    x = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(ae.gaussian_unshuffle_1d(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_ae.gaussian_unshuffle_1d(jnp.asarray(x))))


@pytest.mark.parametrize("factor", [1, 2, 3])
def test_conv_autoencoder_matches_jax_with_gradients(factor):
    r = np.random.RandomState(factor)
    x = (r.randn(2, 26, 16) * 0.5).astype(np.float32)
    jm, tm = jax_ae.GConvAutoEncoder(factor=factor), ae.GConvAutoEncoder(factor=factor, device="cpu")
    variables = _pair(jm, tm, x, seed=factor)
    assert tf.jax_order(tm) == [".".join(k.key for k in path[1:]).replace("kernel", "weight")
                                for path, _ in jax.tree_util.tree_flatten_with_path(variables)[0]]
    ref = jm.apply(variables, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert got.shape == (2, 26, 16)
    _close(got, ref, f"factor {factor} output")
    # The encoder alone (its output width follows from factor).
    jenc = jax_ae.GEncoder(factor=factor)
    enc_ref = jenc.apply({"params": variables["params"]["encoder"]}, jnp.asarray(x))
    assert enc_ref.shape[1] == ae.encoder_channels(factor)
    _close(tm.encoder(torch.from_numpy(x)), enc_ref, f"factor {factor} encoder")

    w = r.randn(*x.shape).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(jm.apply(v, jnp.asarray(x)) ** 2 * w))(variables)
    (got ** 2 * torch.from_numpy(w)).sum().backward()
    _grads_close(tm, jg, f"factor {factor} gradient")


@pytest.mark.parametrize("dims", [1, 2], ids=["conv1d_stride2", "conv2d_stride4"])
def test_convs_run_in_float32_forward_and_backward(monkeypatch, dims):
    """ops/conv.py holds cuDNN's TF32 off inside each convolution, its
    backward included, leaves the flag as it found it, and computes what
    F.conv1d/F.conv2d compute (the autoencoder's Conv1d, LPIPS's strided
    2-D conv)."""
    import torch.nn.functional as F
    from torch.utils._python_dispatch import TorchDispatchMode

    from gaussian_transformer_tpu_torch.ops import conv as conv_mod

    seen = []

    class Spy(TorchDispatchMode):
        """Records cuDNN's TF32 flag at each convolution op, backward included."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.__name__.startswith("convolution"):
                seen.append((func.__name__.split(".")[0], torch.backends.cudnn.allow_tf32))
            return func(*args, **(kwargs or {}))

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    r = np.random.RandomState(dims)
    if dims == 1:
        layer = ae.Conv1d(26, 32, 5, stride=2, padding=2, device="cpu")
        x = torch.from_numpy(r.randn(2, 26, 17).astype(np.float32)).requires_grad_()
        ref_fn = lambda x, w, b: F.conv1d(x, w, b, stride=2, padding=2)
        run = layer
        w, b = layer.weight, layer.bias
    else:
        w = torch.from_numpy(r.randn(8, 3, 11, 11).astype(np.float32) * 0.1).requires_grad_()
        b = torch.from_numpy(r.randn(8).astype(np.float32)).requires_grad_()
        x = torch.from_numpy(r.rand(1, 3, 40, 36).astype(np.float32)).requires_grad_()
        ref_fn = lambda x, w, b: F.conv2d(x, w, b, stride=4, padding=2)
        run = lambda x: conv_mod.conv(x, w, b, 4, 2)
    g = torch.from_numpy(r.randn(*ref_fn(x, w, b).shape).astype(np.float32))
    with Spy():
        got = run(x)
        grads = torch.autograd.grad((got * g).sum(), (x, w, b))
    assert {n for n, _ in seen} == {"convolution", "convolution_backward"}
    assert not any(flag for _, flag in seen)
    assert torch.backends.cudnn.allow_tf32
    ref = ref_fn(x, w, b)
    ref_grads = torch.autograd.grad((ref * g).sum(), (x, w, b))
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
    for a, e in zip(grads, ref_grads):
        torch.testing.assert_close(a, e, rtol=0, atol=1e-5 * float(e.abs().max()))


def test_init_autoencoder_is_lecun_normal_and_seeded():
    tm = ae.init_autoencoder(ae.GConvAutoEncoder(factor=2, device="cpu"), seed=3)
    again = ae.init_autoencoder(ae.GConvAutoEncoder(factor=2, device="cpu"), seed=3)
    for (name, p), q in zip(tm.named_parameters(), again.parameters()):
        p = p.detach()
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert float(p.abs().max()) == 0.0, name
        else:
            bound = 2.0 / 0.87962566103423978 / np.sqrt(p[0].numel())
            assert float(p.abs().max()) <= bound * (1 + 1e-6), name
    big = ae.init_autoencoder(ae.GConvAutoEncoder(factor=3, device="cpu"), seed=0).decoder.up2_conv1.weight.detach()
    assert abs(float(big.var()) * big[0].numel() - 1.0) < 0.05
    stub = ae.init_autoencoder(ae.GAutoEncoder(device="cpu"))
    assert float(stub.w) == pytest.approx(0.1)


# ------------------------------------------------- the CLI and its losses ---


@pytest.mark.parametrize("use_lpips", [False, True], ids=["no_lpips", "lpips_alex"])
def test_token_and_image_loss_match_the_jax_pieces(tmp_path, monkeypatch, use_lpips):
    """``cli/train_autoencoder.py`` token_loss and image_loss against the JAX
    package's model, render, l1_loss, ssim and LPIPS composed as the root
    train_autoencoder.py composes them: losses within 1e-5 relative, the
    parameter gradients within 2e-4 x max|grad|."""
    import dataclasses

    import chip_smoke
    from gaussian_transformer_tpu.eval import lpips as jax_lpips
    from gaussian_transformer_tpu.models.codec import flatten_gaussians, unflatten_gaussians
    from gaussian_transformer_tpu.ops.losses import l1_loss, ssim
    from gaussian_transformer_tpu.render import RenderConfig as JaxRenderConfig
    from gaussian_transformer_tpu.render import render
    from gaussian_transformer_tpu_torch.cli import train_autoencoder as cli
    from gaussian_transformer_tpu_torch.eval import lpips
    from gaussian_transformer_tpu_torch.render import RenderConfig

    from tests.test_train import _synthetic_scene_and_cams
    from tests.torch_port_support import torch_camera

    path = tmp_path / "lpips_alex.npz"
    chip_smoke.write_lpips_weights(path, "alex", 5)
    monkeypatch.setenv("GT_LPIPS_WEIGHTS", str(path))
    jax_lpips._load.cache_clear()
    lpips._load.cache_clear()
    scene, cams = _synthetic_scene_and_cams(n=150, n_cams=1, width=48, height=32, seed=3)
    tokens = np.asarray(flatten_gaussians(scene))
    vis = np.asarray(render(cams[0], scene, JaxRenderConfig())["visibility_filter"])
    data = tokens[vis][None]
    jm, tm = jax_ae.GConvAutoEncoder(), ae.GConvAutoEncoder(device="cpu")
    variables = _pair(jm, tm, data.transpose(0, 2, 1), seed=6)

    def jax_pred(v):
        return jm.apply(v, jnp.asarray(data).transpose(0, 2, 1)).transpose(0, 2, 1)

    def jax_image_loss(v):
        pred = jax_pred(v)
        in_im = render(cams[0], unflatten_gaussians(jnp.asarray(data[0])), JaxRenderConfig())["render"]
        out_im = render(cams[0], unflatten_gaussians(pred[0]), JaxRenderConfig())["render"]
        img = l1_loss(out_im, in_im) * 0.6 + (1.0 - ssim(in_im, out_im)) * 0.2
        if use_lpips:
            img = img + 0.2 * jax_lpips.lpips(jnp.clip(in_im, 0, 1), jnp.clip(out_im, 0, 1), "alex")
        return img

    j_img, j_img_g = jax.jit(jax.value_and_grad(jax_image_loss))(variables)
    j_tok, j_tok_g = jax.value_and_grad(lambda v: l1_loss(jax_pred(v), jnp.asarray(data)))(variables)
    cam = dataclasses.replace(torch_camera(cams[0]), original_image=None)
    td = torch.from_numpy(data)
    for (loss, _), ref, ref_g, what in (
        (cli.image_loss(tm, td, cam, RenderConfig(), use_lpips), j_img, j_img_g, "image"),
        (cli.token_loss(tm, td), j_tok, j_tok_g, "token"),
    ):
        tm.zero_grad()
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=REL, atol=0, err_msg=what)
        refs = dict(zip(tf.jax_order(tm), jax.tree.leaves(ref_g)))
        scale = max(float(np.abs(np.asarray(g)).max()) for g in refs.values())
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(tf.tensor_to_jax(name, p.grad), np.asarray(refs[name]), rtol=0,
                                       atol=2e-4 * scale, err_msg=f"{what} {name}")
    jax_lpips._load.cache_clear()
    lpips._load.cache_clear()


@pytest.mark.parametrize("conv", [False, True], ids=["stub", "conv"])
def test_cli_reaches_the_image_loss(tmp_path, monkeypatch, conv):
    """``cli.train_autoencoder`` end to end on a tiny dataset: token steps
    for epochs 0-500, image steps at epoch 501, every loss finite, and the
    stub's scalar or the conv pair's weights moved."""
    import math
    import sys

    import chip_smoke
    from gaussian_transformer_tpu_torch.cli import train_autoencoder as cli
    from gaussian_transformer_tpu_torch.convert import scene_from_numpy

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # TensorBoard is optional
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("GT_LPIPS_WEIGHTS", raising=False)
    fields = chip_smoke.synthetic_scene(200, 1)
    fields["features_rest"] = fields["features_rest"][:, :3]
    scene = scene_from_numpy(fields, 1, "cpu")
    chip_smoke.write_train_dataset(tmp_path / "data", scene, chip_smoke.surface_points(100, 1), 2, 1, 32, 24,
                                   math.radians(50.0), torch.device("cpu"))
    scene.save_ply(str(tmp_path / "model" / "point_cloud" / "iteration_3" / "point_cloud.ply"))
    res = cli.main(["-s", str(tmp_path / "data"), "-m", str(tmp_path / "model"), "--eval", "--epochs", "502",
                    "--lr_sweep_start", "20", "--lr_sweep_stop", "21", "--quiet", "--device", "cpu"]
                   + (["--conv"] if conv else []))
    hist = res["history"]
    assert len(hist) == 502 * 2 and {h["lrm"] for h in hist} == {20}
    assert [h["kind"] for h in hist] == ["token"] * 1002 + ["image"] * 2
    assert all(h["finite"] and math.isfinite(h["loss"]) and h["n_visible"] > 0 for h in hist)
    assert hist[0]["lr"] == pytest.approx(2e-4)
    model = res["models"][20]
    fresh = ae.init_autoencoder(ae.GConvAutoEncoder(device="cpu") if conv else ae.GAutoEncoder(device="cpu"))
    assert all(not torch.equal(p, q) for p, q in zip(model.parameters(), fresh.parameters()))

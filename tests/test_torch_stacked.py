"""Port parity for the stacked trainer (train/stacked.py) and its CLI
(cli/train_stacked.py) against the JAX package on the same seeded inputs:
STACK 2 (token dim and d_model 104), h 8, N 1, dropout 0 unless the test is
about dropout, weights carried over with ``params_from_jax``, renders of a
few 16x16 tiles through the JAX package's CPU route.

Tolerances: schedules, masks, special tokens and the TrainingScene batches
(src, trg, trg_y, masks, ntokens, visibility) exact; the ReduceLROnPlateau
lr sequence exact; the scan decode 1e-4 x max(1, max|ref|) and its
parameter gradients 1e-4 x max|grad|; the loss and its parameter gradients
in both branches of the chamfer gate 1e-4 x max|grad| (the loss 1e-4
relative); one train step's parameter updates within 1e-2 x lr where the
gradient is at least 10 x Adam's eps = 1e-4, and 1e-1 x lr below (see
``_steps``); a
checkpointed (recomputed) decode's dropout gradients equal the plain
decode's to 1e-6 x max|grad|."""

import math
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from gaussian_transformer_tpu.models import codec as jax_codec
from gaussian_transformer_tpu.models import transformer as jax_tf
from gaussian_transformer_tpu.ops.losses import l1_loss as jax_l1
from gaussian_transformer_tpu.ops.losses import ssim as jax_ssim
from gaussian_transformer_tpu.render import RenderConfig as JaxRenderConfig
from gaussian_transformer_tpu.render import render as jax_render
from gaussian_transformer_tpu.train import stacked as js
from gaussian_transformer_tpu_torch.cli import train_stacked as cli
from gaussian_transformer_tpu_torch.convert import scene_from_numpy
from gaussian_transformer_tpu_torch.models import transformer as tf
from gaussian_transformer_tpu_torch.render import RenderConfig
from gaussian_transformer_tpu_torch.train import stacked as ps

from tests.test_train import _synthetic_scene_and_cams
from tests.torch_port_support import torch_camera, torch_scene

STACK = 2
D = ps.stacked_token_dim(STACK)
REL = 1e-4
# The image-branch case's target: the model's own decode plus N(0, NOISE).
# Chamfer then reads ~2 (the gate opens), and the pred and target renders
# differ by far more than the two packages' float noise, so no pixel's L1
# sign sits at a flip between them.
NOISE = 0.2


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, rel, what="", floor=1.0):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.all(np.isfinite(got)), what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(floor, float(np.abs(ref).max())),
                               err_msg=what)


@pytest.fixture(scope="module")
def scenes():
    """The same scene and cameras on both sides, and both TrainingScenes."""
    scene, cams = _synthetic_scene_and_cams(n=128, n_cams=4, width=48, height=32, seed=11)
    jts = js.TrainingScene(types.SimpleNamespace(gaussians=scene, get_train_cameras=lambda scale=1.0: cams),
                           JaxRenderConfig(), batch_size=2, stack=STACK, bucket=4)
    tcams = [torch_camera(c) for c in cams]
    pts = ps.TrainingScene(types.SimpleNamespace(gaussians=torch_scene(scene), get_train_cameras=lambda: tcams),
                           RenderConfig(), batch_size=2, stack=STACK, bucket=4)
    return jts, pts


def _models(seed=0, dropout=0.0):
    jm = jax_tf.make_model(STACK, D, D, N=1, d_model=D, dropout=dropout)
    variables = jax_tf.init_model(jm, jax.random.PRNGKey(seed))
    tm = tf.make_model(STACK, D, D, N=1, d_model=D, dropout=dropout, device="cpu")
    tm.load_state_dict(tf.params_from_jax(jax.tree.map(np.asarray, variables)))
    return jm, variables, tm


def _batch_pair(scenes, cams=(0, 1), epoch=1000):
    jts, pts = scenes
    jts.set_epoch(epoch)
    pts.set_epoch(epoch)
    jts.rng, pts.rng = np.random.RandomState(3), np.random.RandomState(3)
    return jts.make_batch(list(cams)), pts.make_batch(list(cams))


def _grads_close(tm, jgrads, rel, what=""):
    ref = dict(zip(tf.jax_order(tm), jax.tree.leaves(jgrads)))
    scale = max(float(np.abs(np.asarray(g)).max()) for g in ref.values())
    for name, p in tm.named_parameters():
        got = tf.tensor_to_jax(name, p.grad)
        assert np.all(np.isfinite(got)), name
        np.testing.assert_allclose(got, np.asarray(ref[name]), rtol=0, atol=rel * scale,
                                   err_msg=f"{what} {name}")


# ------------------------------------------------ schedules, masks, batches ---


def test_schedules_tokens_and_masks_exact():
    for epoch in (0, 1, 100, 2000, 5000, 10**6):
        assert ps.dropout_schedule(epoch) == js.dropout_schedule(epoch)
    np.testing.assert_array_equal(ps.start_token(STACK).numpy(), np.asarray(js.start_token(STACK)))
    np.testing.assert_array_equal(ps.pad_token(STACK).numpy(), np.asarray(js.pad_token(STACK)))
    t = np.tile(np.asarray(js.pad_token(STACK)), (2, 6, 1))
    t[:, 0] = np.asarray(js.start_token(STACK))
    t[0, 1:4] = np.random.RandomState(0).randn(3, D)
    t[1, 1] = 1.0
    np.testing.assert_array_equal(ps.make_std_mask(torch.from_numpy(t), STACK).numpy(),
                                  np.asarray(js.make_std_mask(jnp.asarray(t), STACK)))


def test_reduce_lr_on_plateau_same_lr_sequence():
    losses = list(np.random.RandomState(1).rand(40) * 0.1 + np.linspace(1.0, 0.5, 40))
    losses += [0.5] * 40
    for kw in ({}, {"patience": 2, "cooldown": 1}, {"patience": 0, "cooldown": 0, "threshold": 0.1}):
        a, b = ps.ReduceLROnPlateau(lr=5e-4, **kw), js.ReduceLROnPlateau(lr=5e-4, **kw)
        assert [a.step(x) for x in losses] == [b.step(x) for x in losses]


def test_training_scene_batches_bit_for_bit(scenes):
    jts, pts = scenes
    np.testing.assert_array_equal(pts.tokens, np.asarray(jts.tokens))
    assert pts.n_alive == jts.n_alive and pts.size == jts.size
    for k in ("world_min", "world_max", "scaling_min", "scaling_max"):
        np.testing.assert_array_equal(_np(getattr(pts.handler, k)), np.asarray(getattr(jts.handler, k)))
    jts.rng, pts.rng = np.random.RandomState(0), np.random.RandomState(0)
    n = 0
    for epoch in (0, 500, 6000):
        jts.set_epoch(epoch)
        pts.set_epoch(epoch)
        for jb, pb in zip(jts.batches(), pts.batches()):
            assert (jb is None) == (pb is None)
            if jb is None:
                continue
            n += 1
            assert pb.ntokens == jb.ntokens
            for k in ("src", "src_mask", "trg", "trg_y", "trg_mask"):
                np.testing.assert_array_equal(_np(getattr(pb, k)), np.asarray(getattr(jb, k)), err_msg=k)
    assert n >= 5
    for i in range(pts.size):
        np.testing.assert_array_equal(pts._visibility(i), jts._visibility(i))


# ---------------------------------------------------------------- decode ---


def test_greedy_decode_and_its_gradients_match_jax():
    jm, variables, tm = _models(seed=4)
    r = np.random.RandomState(4)
    src = r.randn(1, 7, D).astype(np.float32)
    src_mask = np.ones((1, 1, 7), bool)
    src_mask[0, 0, 5:] = False
    w = r.randn(1, 6, D).astype(np.float32)

    def jloss(v):
        ys = js.greedy_decode(jm, v, jnp.asarray(src), jnp.asarray(src_mask), 6, STACK)
        return jnp.sum(ys * w), ys

    (_, jys), jgrads = jax.value_and_grad(jloss, has_aux=True)(variables)
    ys = ps.greedy_decode(tm, torch.from_numpy(src), torch.from_numpy(src_mask), 6, STACK)
    _close(ys, jys, REL, "ys")
    (ys * torch.from_numpy(w)).sum().backward()
    _grads_close(tm, jgrads, REL, "decode grad")


def test_recomputed_decode_draws_the_same_dropout():
    """Train-mode dropout inside the checkpointed decode: the recomputation
    draws the masks the forward drew, so the gradients equal those of the
    decode without checkpointing; another key draws other masks."""
    _, _, tm = _models(seed=5, dropout=0.3)
    src = torch.from_numpy(np.random.RandomState(5).randn(1, 6, D).astype(np.float32))
    grads, outs = [], []
    for remat, key in ((True, (1, 7)), (False, (1, 7)), (True, (1, 8))):
        tm.zero_grad()
        ys = ps.greedy_decode(tm, src, None, 5, STACK, dropout_key=key, remat=remat)
        (ys ** 2).sum().backward()
        outs.append(ys.detach())
        grads.append({n: p.grad.clone() for n, p in tm.named_parameters()})
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    scale = max(float(g.abs().max()) for g in grads[1].values())
    for n in grads[0]:
        torch.testing.assert_close(grads[0][n], grads[1][n], rtol=0, atol=1e-6 * scale)
    assert float((outs[0] - outs[2]).abs().max()) > 1e-3
    with torch.no_grad():
        plain = ps.greedy_decode(tm, src, None, 5, STACK)
    assert float((outs[0] - plain).abs().max()) > 1e-3


# ------------------------------------------------------------------ loss ---


@pytest.fixture(scope="module")
def jax_loss(scenes):
    """The JAX loss and its parameter gradients, compiled once."""
    jts, _ = scenes
    jm = jax_tf.make_model(STACK, D, D, N=1, d_model=D, dropout=0.0)
    loss_fn = js.make_loss_fn(jm, jts.handler, jts.render_cfg, STACK)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _loss_grads(scenes, jax_loss, near_target):
    """Loss, metrics and parameter gradients of both packages' loss on one
    batch; ``near_target`` makes the target the model's own decode plus
    N(0, NOISE), so the chamfer gate opens."""
    jb, pb = _batch_pair(scenes)
    jts, pts = scenes
    jm, variables, tm = _models(seed=6)
    trg_y = np.array(jb.trg_y)  # writable: torch.from_numpy shares it
    if near_target:
        pred = np.asarray(js.greedy_decode(jm, variables, jb.src, jb.src_mask, trg_y.shape[1] + 1, STACK))
        real = ~np.asarray(jax_codec.fuzzy_token_equal(jnp.asarray(trg_y), js.pad_token(STACK)))
        noise = np.random.RandomState(6).normal(0, NOISE, trg_y.shape).astype(np.float32)
        trg_y = np.where(real[..., None], pred[:, 1:] + noise, trg_y)
    (jl, jmet), jgrads = jax_loss(variables, jb.src, jnp.asarray(trg_y), jb.cameras, jb.src_mask)
    loss_fn = ps.make_loss_fn(tm, pts.handler, pts.render_cfg, STACK)
    loss, met = loss_fn(pb.src, torch.from_numpy(trg_y), pb.cameras, pb.src_mask)
    loss.backward()
    return tm, (loss, met), (jl, jmet, jgrads)


@pytest.mark.parametrize("near_target", [False, True], ids=["chamfer_only", "image_branch"])
def test_loss_and_gradients_match_in_both_gate_branches(scenes, jax_loss, near_target):
    tm, (loss, met), (jl, jmet, jgrads) = _loss_grads(scenes, jax_loss, near_target)
    assert (float(met["chamfer"]) < 3.0) == (float(jmet["chamfer"]) < 3.0) == near_target
    _close(met["chamfer"], jmet["chamfer"], REL, "chamfer", floor=0.0)
    _close(met["img_loss"], jmet["img_loss"], REL, "img_loss", floor=0.0)
    if near_target:
        assert float(met["img_loss"]) > 0 and int(met["overflow"].sum()) == 0
    _close(loss, jl, REL, "loss", floor=0.0)
    _grads_close(tm, jgrads, REL, "loss grad")


def test_image_loss_matches_the_jax_pieces(scenes):
    """``image_loss`` against the JAX package's render, l1_loss, ssim,
    unflatten and denormalize composed as its loss composes them, and its
    gradient with respect to the predicted tokens."""
    jb, pb = _batch_pair(scenes, cams=(2, 3))
    jts, pts = scenes
    tgt = np.array(jax_codec.unstack_tokens(jb.trg_y[0], STACK))
    valid = np.repeat(~np.asarray(jax_codec.fuzzy_token_equal(jb.trg_y[0], js.pad_token(STACK))), 2**STACK)
    pred = tgt + np.random.RandomState(9).normal(0, 0.01, tgt.shape).astype(np.float32)

    def jax_image_loss(pred_list):
        g_pred = jts.handler.denormalize(jax_codec.unflatten_gaussians(pred_list)).replace(alive=valid)
        g_tgt = jts.handler.denormalize(jax_codec.unflatten_gaussians(jnp.asarray(tgt))).replace(alive=valid)
        imgs = jnp.stack([jnp.clip(jnp.nan_to_num(jax_render(c, g_pred, jts.render_cfg)["render"]), 0, 1)
                          for c in jb.cameras])
        tgts = jnp.stack([jnp.clip(jnp.nan_to_num(jax_render(c, g_tgt, jts.render_cfg)["render"]), 0, 1)
                          for c in jb.cameras])
        n = len(jb.cameras)
        return jax_l1(imgs, tgts) * (5.0 / n) * 0.1 + (1.0 - jax_ssim(imgs, tgts)) * (0.2 / n) * 0.1

    jl, jg = jax.jit(jax.value_and_grad(jax_image_loss))(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    loss, overflow = ps.image_loss(tp, torch.from_numpy(tgt), torch.from_numpy(valid), pts.handler,
                                   pb.cameras, pts.render_cfg)
    loss.backward()
    assert overflow.shape == (2, 2) and int(overflow.sum()) == 0
    _close(loss, jl, REL, "image loss", floor=0.0)
    assert float(tp.grad.abs().max()) > 0
    _close(tp.grad, jg, REL, "d loss / d pred tokens", floor=0.0)
    # PAD rows (valid False) get no gradient.
    assert float(tp.grad[~torch.from_numpy(valid)].abs().sum()) == 0.0


# A token decoded by the full-width model after a few steps: its log-scale
# token (14.6 normalized) activates to ~3e8, and the determinant of its
# projected covariance overflows float32. The scene bounds are those of the
# 17,618-Gaussian synthetic scene of chip_smoke.py's stacked sections.
HUGE_TOKEN = [13.838, 6.982, 4.944, -13.149, -6.138, -13.923, 9.068, 4.999, 7.119, -7.099, -6.038, 12.769,
              -7.46, -9.33, 5.942, -5.42, 3.075, -10.24, 6.661, -11.42, -14.553, -11.395, 14.601, -11.268,
              3.188, -2.698]
HUGE_BOUNDS = ([-2.9945, -1.0, -2.9768], [2.9828, 1.1999, 2.9957], -4.0806, -2.4647)


def test_overflowing_covariance_gradient_matches_jax():
    """The projection's gradient for a decoded Gaussian whose projected
    covariance overflows float32 is non-finite in the JAX package and in the
    port (which of its entries differs with the order of the float ops), so
    the image branch feeds Adam a non-finite gradient in both; a second,
    ordinary token's gradient agrees to 1e-4 x max|grad|."""
    from gaussian_transformer_tpu.models.box_sort import GaussianHandler as JaxHandler
    from gaussian_transformer_tpu.render.project import project_gaussians as jax_project
    from gaussian_transformer_tpu_torch.models import codec as port_codec
    from gaussian_transformer_tpu_torch.models.box_sort import GaussianHandler as PortHandler
    from gaussian_transformer_tpu_torch.render.project import project_gaussians as port_project

    rows = np.stack([HUGE_TOKEN, np.random.RandomState(3).uniform(0.2, 0.8, 26)]).astype(np.float32)
    lo, hi, s_lo, s_hi = (np.asarray(b, np.float32) for b in HUGE_BOUNDS)
    jh = JaxHandler(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(s_lo), jnp.asarray(s_hi))
    ph = PortHandler(torch.from_numpy(lo), torch.from_numpy(hi), torch.from_numpy(s_lo), torch.from_numpy(s_hi), 10)

    def projected_sum(p):
        return sum(x.sum() for x in (p.conics, p.means2d, p.rgbs, p.opacities))

    for i in (12, 16, 20, 24):  # ring cameras of 32 that see the huge Gaussian's overflow
        cam = chip_smoke.camera_from_c2w(chip_smoke.orbit_c2w(2 * math.pi * i / 32), math.radians(50.0), 320, 240,
                                         torch.device("cpu"))
        view = dict(image_width=320, image_height=240, tan_fovx=math.tan(cam.fovx / 2),
                    tan_fovy=math.tan(cam.fovy / 2), active_sh_degree=1)

        def jax_loss(tok):
            g = jh.denormalize(jax_codec.unflatten_gaussians(tok))
            return projected_sum(jax_project(
                g.get_xyz, g.get_scaling, g.get_rotation, g.get_opacity, g.get_features, None,
                world_view_transform=jnp.asarray(_np(cam.world_view_transform)),
                full_proj_transform=jnp.asarray(_np(cam.full_proj_transform)),
                camera_center=jnp.asarray(_np(cam.camera_center)), **view))

        jg = np.asarray(jax.grad(jax_loss)(jnp.asarray(rows)))
        tok = torch.from_numpy(rows.copy()).requires_grad_()
        g = ph.denormalize(port_codec.unflatten_gaussians(tok))
        projected_sum(port_project(g.get_xyz, g.get_scaling, g.get_rotation, g.get_opacity, g.get_features, None,
                                   world_view_transform=cam.world_view_transform,
                                   full_proj_transform=cam.full_proj_transform,
                                   camera_center=cam.camera_center, **view)).backward()
        pg = tok.grad.numpy()
        assert not np.isfinite(jg[0]).all(), f"camera {i}: the JAX gradient of the huge token is finite"
        assert not np.isfinite(pg[0]).all(), f"camera {i}: the port's gradient of the huge token is finite"
        _close(pg[1], jg[1], REL, f"camera {i}: the ordinary token's gradient", floor=0.0)


# ------------------------------------------------------ train step, ckpts ---

LR, EPS = 5e-4, 1e-4


@pytest.fixture(scope="module")
def jax_step(scenes):
    """The JAX train step, compiled once."""
    jts, _ = scenes
    jm = jax_tf.make_model(STACK, D, D, N=1, d_model=D, dropout=0.0)
    return js.make_train_step(jm, jts.handler, jts.render_cfg, optax.adam(1.0, eps=EPS), STACK)


def _steps(scenes, jax_step, jb, pb, variables, opt_state, tm, opt):
    """One step on each side; returns JAX's new (params, opt_state) and the
    per-element tolerance of the parameters: 1e-2 x lr where the step's
    gradient |g| >= 10 x eps, 1e-1 x lr below (there Adam's update lr * m /
    (sqrt(v) + eps) divides the gradients' float disagreement by ~eps). The
    gradients are read off Adam's first moment: g = (mu' - 0.9 mu) / 0.1."""
    v1, o1, _, _ = jax_step(variables, opt_state, jb.src, jb.trg_y, jb.cameras, jnp.asarray(LR), jb.src_mask)
    g = [(np.asarray(m1) - 0.9 * np.asarray(m0)) / 0.1
         for m1, m0 in zip(jax.tree.leaves(o1[0].mu), jax.tree.leaves(opt_state[0].mu))]
    tol = [np.where(np.abs(x) >= 10 * EPS, 1e-2 * LR, 1e-1 * LR) for x in g]
    _, pts = scenes
    ps.make_train_step(tm, pts.handler, pts.render_cfg, opt, STACK)(pb.src, pb.trg_y, pb.cameras, LR, pb.src_mask)
    return v1, o1, tol


def _params_close(tm, variables, tol, what):
    params = dict(tm.named_parameters())
    tols = tol if isinstance(tol, list) else [tol] * len(params)
    for name, leaf, t in zip(tf.jax_order(tm), jax.tree.leaves(variables), tols):
        got, ref = tf.tensor_to_jax(name, params[name]), np.asarray(leaf)
        bad = np.abs(got - ref) > t
        assert not bad.any(), f"{what} {name}: {bad.sum()} of {bad.size} beyond tolerance"


def test_train_step_matches_jax(scenes, jax_step):
    jb, pb = _batch_pair(scenes)
    jm, variables, tm = _models(seed=7)
    v1, _, tol = _steps(scenes, jax_step, jb, pb, variables, optax.adam(1.0, eps=EPS).init(variables),
                        tm, ps.make_optimizer(tm))
    _params_close(tm, v1, tol, "after one step")
    tight = sum(int((t == 1e-2 * LR).sum()) for t in tol) / sum(t.size for t in tol)
    assert tight > 0.95, tight  # the 1e-1 x lr band concerns few elements
    # Adam's first step moves every tensor by ~lr, but the attention key
    # biases: softmax is invariant to shifting a row's scores, so their
    # gradient vanishes.
    for name, a, b in zip(tf.jax_order(tm), jax.tree.leaves(v1), jax.tree.leaves(variables)):
        if not name.endswith("attn.k.bias"):
            assert float(np.abs(np.asarray(a) - np.asarray(b)).max()) > 0.5 * LR, name


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_carry_across(scenes, jax_step, tmp_path, direction):
    """A checkpoint written by one package resumes in the other: it loads
    exactly, and after one more step on each side the parameters agree as
    after the first step."""
    jb, pb = _batch_pair(scenes)
    jm, variables, tm = _models(seed=8)
    adam = optax.adam(1.0, eps=EPS)
    opt = ps.make_optimizer(tm)
    v1, o1, _ = _steps(scenes, jax_step, jb, pb, variables, adam.init(variables), tm, opt)
    if direction == "jax_to_port":
        js.save_checkpoint(str(tmp_path), 1, v1, o1)
        tm = tf.make_model(STACK, D, D, N=1, d_model=D, dropout=0.0, device="cpu")
        opt = ps.make_optimizer(tm)
        ps.load_checkpoint(str(tmp_path), 1, tm, opt)
        _params_close(tm, v1, 0.0, "loaded")
        for i, (name, p) in enumerate(zip(tf.jax_order(tm), jax.tree.leaves(o1[0].mu))):
            state = opt.state[dict(tm.named_parameters())[name]]
            np.testing.assert_array_equal(tf.tensor_to_jax(name, state["exp_avg"]), np.asarray(p))
            assert int(state["step"]) == 1
        v_start, o_start = v1, o1
    else:
        ps.save_checkpoint(str(tmp_path), 1, tm, opt)
        v_like, o_like = jax_tf.init_model(jm, jax.random.PRNGKey(0)), adam.init(variables)
        v_start, o_start = js.load_checkpoint(str(tmp_path), 1, v_like, o_like)
        _params_close(tm, v_start, 0.0, "loaded")
        assert int(o_start[0].count) == 1
        for name, a in zip(tf.jax_order(tm), jax.tree.leaves(o_start[0].mu)):
            state = opt.state[dict(tm.named_parameters())[name]]
            np.testing.assert_array_equal(np.asarray(a), tf.tensor_to_jax(name, state["exp_avg"]))
    v2, _, tol = _steps(scenes, jax_step, jb, pb, v_start, o_start, tm, opt)
    _params_close(tm, v2, tol, "after the resumed step")


# ------------------------------------------------------------------- CLI ---


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A trained-looking SH-1 scene of 320 Gaussians as a model dir with a
    Blender dataset of four 64x48 views (chip_smoke.py's helpers)."""
    root = tmp_path_factory.mktemp("stacked")
    fields = chip_smoke.synthetic_scene(320, 2)
    fields["features_rest"] = fields["features_rest"][:, :3]
    scene = scene_from_numpy(fields, 1, "cpu")
    chip_smoke.write_train_dataset(root / "data", scene, chip_smoke.surface_points(300, 2), 4, 1, 64, 48,
                                   math.radians(50.0), torch.device("cpu"))
    scene.save_ply(str(root / "model" / "point_cloud" / "iteration_7" / "point_cloud.ply"))
    return root


def test_cli_trains_checkpoints_and_resumes(model_dir, tmp_path, capsys, monkeypatch):
    # TensorBoard is optional: without it the CLI writes no event files.
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.chdir(tmp_path)
    argv = ["-s", str(model_dir / "data"), "-m", str(model_dir / "model"), "--eval", "--stack", "2",
            "--layers", "1", "--batch_size", "2", "--run_name", str(tmp_path / "run"),
            "--checkpoint_every", "1", "--quiet", "--device", "cpu"]
    res = cli.main(argv + ["--epochs", "2"])
    assert res["first_epoch"] == 0 and [e["epoch"] for e in res["epochs"]] == [0, 1]
    assert len(res["history"]) == 4  # 4 cameras / batch 2, two epochs
    assert all(math.isfinite(h["loss"]) and math.isfinite(h["chamfer"]) for h in res["history"])
    assert tf.count_params(res["model"]) == tf.count_params(
        tf.make_model(STACK, D, D, N=1, d_model=D, device="meta"))
    assert (tmp_path / "run" / "checkpoint_1" / "model.npz").exists()
    assert not (tmp_path / "run" / "checkpoint_0").exists()
    saved = {n: p.detach().clone() for n, p in res["model"].named_parameters()}
    capsys.readouterr()

    resumed = cli.main(argv + ["--epochs", "3"])
    assert "loading Model iter 1" in capsys.readouterr().out
    assert resumed["first_epoch"] == 2 and [e["epoch"] for e in resumed["epochs"]] == [2]
    changed = [not torch.equal(saved[n], p) for n, p in resumed["model"].named_parameters()]
    assert all(changed)
    state = resumed["optimizer"].state[next(resumed["model"].parameters())]
    assert int(state["step"]) == 6


@pytest.mark.parametrize("flag", [["--dp", "2"], ["--fsdp", "2"]])
def test_cli_parallel_flags_raise(model_dir, flag, monkeypatch):
    """The flags need one process per shard (torchrun): a single process
    asked for 2 raises before it trains."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        cli.main(["-s", str(model_dir / "data"), "-m", str(model_dir / "model"), "--device", "cpu", *flag])


def test_cli_flags_match_reference():
    """The stacked CLI's own flags and defaults are the reference script's."""
    import ast
    from pathlib import Path

    src = (Path(chip_smoke.ROOT) / "train_stacked_transformer.py").read_text()
    ref = {}
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw:
                ref[node.args[0].value.lstrip("-")] = ast.literal_eval(kw["default"])
    _, args = cli._parse(["-s", "x", "-m", "y"])
    for name, default in ref.items():
        assert getattr(args, name) == default, name

"""The references against the port's plain CPU paths at a tiny size: the
splatting reference's image, loss and gradients, and the transformer
reference's forward, training decode with dropout, loss and gradients."""

import pytest
import torch

from perfbench import scenes
from perfbench.drivers.splat_train import port_camera
from perfbench.reference import splat as ref
from perfbench.reference import transformer as tref

DEV = torch.device("cpu")


def _port_scene(fields, sh):
    from gaussian_transformer_tpu_torch.scene.gaussians import GaussianScene

    g = GaussianScene(fields["xyz"].shape[0], sh, DEV)
    with torch.no_grad():
        for k in ref.LEAVES:
            getattr(g, k).copy_(fields[k])
        g.alive.fill_(True)
    g.active_sh_degree = sh
    return g


@pytest.fixture(scope="module")
def splat_inputs():
    fields = scenes.synthetic_scene(2500, 77, DEV, 3)
    spec = {"phase": 0.3, "count": 3, "radius": [3.9, 4.7], "height": [0.7, 1.9], "fovx": 0.9, "width": 80,
            "height_px": 56}
    return fields, scenes.orbit_views(spec, 77, DEV)


@pytest.mark.parametrize("view", [0, 1, 2])
def test_splat_image_matches_the_port(splat_inputs, view):
    from gaussian_transformer_tpu_torch.render import RenderConfig, render

    fields, views = splat_inputs
    v = views[view]
    out = render(port_camera(0, v, None), _port_scene(fields, 3), RenderConfig(), bg_color=torch.zeros(3))
    img, final_t, pairs = ref.composite(ref.project(fields, v, 3), v.width, v.height, torch.zeros(3))
    assert torch.allclose(out["render"].detach(), img, atol=2e-6)
    assert torch.allclose(out["final_T"].detach(), final_t, atol=2e-6)
    assert torch.equal(out["radii"], ref.project(fields, v, 3).radii)
    assert pairs > 0


def test_splat_loss_and_gradients_match_the_port(splat_inputs):
    from gaussian_transformer_tpu_torch.ops.losses import l1_loss, ssim
    from gaussian_transformer_tpu_torch.render import RenderConfig, render

    fields, views = splat_inputs
    v = views[0]
    with torch.no_grad():
        gt, _, _ = ref.composite(ref.project(fields, v, 3), v.width, v.height, torch.zeros(3))
        gt = torch.clamp(gt + 0.05 * torch.randn(gt.shape, generator=torch.Generator().manual_seed(3)), 0, 1)
    scene = _port_scene(fields, 3)
    img = render(port_camera(0, v, None), scene, RenderConfig(), bg_color=torch.zeros(3))["render"]
    loss = 0.8 * l1_loss(img, gt) + 0.2 * (1.0 - ssim(img, gt))
    grads = torch.autograd.grad(loss, [getattr(scene, k) for k in ref.LEAVES])
    ref_loss, ref_grads = ref.loss_and_grads(fields, v, gt, torch.zeros(3), 3, 0.2)
    # SSIM's ratios in flat regions amplify float32 rounding of the blurs.
    assert ref_loss == pytest.approx(float(loss.detach()), rel=1e-4)
    # Element by element, a Gaussian on one of the rasterizer's thresholds
    # (power > 0, alpha >= 1/255, T < 1e-4) goes either way in float32.
    for k, g in zip(ref.LEAVES, grads):
        scale = float(ref_grads[k].abs().max())
        assert float((g - ref_grads[k]).abs().max()) <= 1e-3 * scale, k
        assert float(torch.linalg.vector_norm(g - ref_grads[k])) <= 1e-4 * float(torch.linalg.vector_norm(ref_grads[k])), k


def test_splat_adam_matches_the_port():
    from gaussian_transformer_tpu_torch.train.optim import AdamState, adam_step

    fields = scenes.synthetic_scene(300, 5, DEV, 3)
    scene = _port_scene(fields, 3)
    grads = {k: torch.randn_like(fields[k]) for k in ref.LEAVES}
    lrs = {k: 1e-3 * (i + 1) for i, k in enumerate(ref.LEAVES)}
    state = AdamState.init(scene)
    for k in ref.LEAVES:
        state.counts[k].fill_(15000.0)
    adam_step(scene, grads, state, lrs)
    params = {k: fields[k].clone() for k in ref.LEAVES}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    ref.adam(params, grads, mu, nu, 15000.0, lrs)
    for k in ref.LEAVES:
        assert torch.allclose(getattr(scene, k).detach(), params[k], rtol=0, atol=1e-6), k


STACK, D, LAYERS = 3, 208, 1


@pytest.fixture(scope="module")
def models():
    from gaussian_transformer_tpu_torch.train.stacked import make_stacked_model

    P = tref.init_weights(D, LAYERS, 11, DEV)
    port = make_stacked_model(STACK, LAYERS, 0, seed=0, device=DEV)
    named = dict(port.named_parameters())
    assert set(named) == set(P)
    with torch.no_grad():
        for k, v in P.items():
            named[k].copy_(v)
    return port, P


def _batch(n_src=5, n_tgt=4, pad_tail=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    src = torch.rand(1, n_src, D, generator=g)
    trg_y = torch.rand(1, n_tgt, D, generator=g) * 2.0
    pad = tref.special_token(tref.PAD_FLAG, STACK)
    src[0, -pad_tail:] = pad
    trg_y[0, -pad_tail:] = pad
    src_mask = ~tref.is_token(src, pad)[:, None, :]
    return src, trg_y, src_mask


def test_transformer_parameter_count_at_full_width():
    assert tref.param_count(6656, 2) == 1_905_446_400


def test_transformer_training_decode_and_loss_match_the_port(models):
    from gaussian_transformer_tpu_torch.train.stacked import greedy_decode, make_loss_fn

    port, P = models
    src, trg_y, src_mask = _batch()
    key = (123, 4)
    ys = greedy_decode(port, src, src_mask, trg_y.shape[1] + 1, STACK, key)
    ref_ys = tref.greedy_decode(tref.Model(P, LAYERS), src, src_mask, trg_y.shape[1] + 1,
                                tref.special_token(tref.START_FLAG, STACK), key)
    assert torch.allclose(ys, ref_ys, atol=1e-5)
    loss_fn = make_loss_fn(port, None, None, STACK)
    loss, metrics = loss_fn(src, trg_y, None, src_mask, key)
    assert float(metrics["chamfer"]) >= 3.0  # the gate is shut
    leaves = {k: v.clone().requires_grad_() for k, v in P.items()}
    ref_loss = tref.train_loss(tref.Model(leaves, LAYERS), src, trg_y, src_mask, STACK, key)
    assert float(ref_loss) == pytest.approx(float(loss), rel=1e-5)
    names = sorted(P)
    named = dict(port.named_parameters())
    g_port = torch.autograd.grad(loss, [named[k] for k in names])
    g_ref = torch.autograd.grad(ref_loss, [leaves[k] for k in names])
    for k, a, b in zip(names, g_port, g_ref):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-6), k

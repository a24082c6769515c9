"""Port parity for the stacked campaign's recipe: one bf16 + Adafactor train
step (train/stacked.py make_train_step with train/adafactor.py) against the
JAX package's step with ``optax.adafactor(learning_rate=1.0,
min_dim_size_to_factor=128)``, checkpoints with bf16 parameters and
Adafactor state across the two packages, and the campaign tool
(tools/stacked_campaign.py) end to end on the CPU. STACK 2 (token dim and
d_model 104), h 8, N 1, dropout 0, bf16 ``dtype`` and ``param_dtype``;
renders of a few 16x16 tiles through the JAX package's CPU route.

Tolerances. The loss within 1e-2 relative of the JAX step's in both
chamfer-gate branches (bf16 products on both sides). The port's step equals
optax's adafactor update of the port's own gradients scaled by lr (the JAX
step's ``updates * lr``) to one bf16 ulp of each element (optax's float32
sums run in another order; the bf16 optimizer test matches bit for bit). Against the JAX step's parameters, at
most 1% of all parameter elements (chamfer-only branch) and 5% (image
branch) lie more than one bf16 ulp from the JAX package's. That bound
replaces a per-tensor one (at most 1% of each tensor's elements differing,
by at most one ulp), set before the first run and missed by the bf16
gradient noise, not by the optimizer: a first Adafactor step moves each zero
bias by lr * 1e-3 with the sign of its gradient, so the elements whose bf16
gradients differ in sign between the packages move apart by two steps. The
attention key biases' gradient is zero but for rounding noise (softmax is
invariant to shifting a row's scores): about half of them. In the image
branch the renders of bf16-noisy decoded rows move the gradients further,
and 15-25% of each bias differs in sign; in the chamfer-only branch 2-4%.
Measured: 0.25% and 2.0% of all elements beyond one ulp. The gradients are
held to the JAX package's in tests/test_torch_campaign_grads.py.
Checkpoints load bit for bit."""

import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussian_transformer_tpu.models import codec as jax_codec
from gaussian_transformer_tpu.models import transformer as jax_tf
from gaussian_transformer_tpu.render import RenderConfig as JaxRenderConfig
from gaussian_transformer_tpu.train import stacked as js
from gaussian_transformer_tpu_torch.models import transformer as tf
from gaussian_transformer_tpu_torch.render import RenderConfig
from gaussian_transformer_tpu_torch.tools import stacked_campaign as campaign
from gaussian_transformer_tpu_torch.train import stacked as ps
from gaussian_transformer_tpu_torch.train.adafactor import Adafactor

from tests.test_train import _synthetic_scene_and_cams
from tests.torch_port_support import bf16_ulp, torch_camera, torch_scene

STACK = 2
D = ps.stacked_token_dim(STACK)
LR = 5e-4
LOSS_REL = 1e-2
BEYOND_ULP = {False: 0.01, True: 0.05}  # share of all parameter elements, by branch (image: True)
NOISE = 0.2  # the image-branch target: the model's own decode plus N(0, NOISE) (tests/test_torch_stacked.py)


def _adafactor():
    return optax.adafactor(learning_rate=1.0, min_dim_size_to_factor=128)


@pytest.fixture(scope="module")
def scenes():
    scene, cams = _synthetic_scene_and_cams(n=128, n_cams=4, width=48, height=32, seed=11)
    jts = js.TrainingScene(types.SimpleNamespace(gaussians=scene, get_train_cameras=lambda scale=1.0: cams),
                           JaxRenderConfig(), batch_size=2, stack=STACK, bucket=4)
    tcams = [torch_camera(c) for c in cams]
    pts = ps.TrainingScene(types.SimpleNamespace(gaussians=torch_scene(scene), get_train_cameras=lambda: tcams),
                           RenderConfig(), batch_size=2, stack=STACK, bucket=4)
    return jts, pts


def _jax_model():
    return jax_tf.make_model(STACK, D, D, N=1, d_model=D, dropout=0.0, dtype=jnp.bfloat16,
                             param_dtype=jnp.bfloat16)


def _port_model(variables=None):
    tm = tf.make_model(STACK, D, D, N=1, d_model=D, dropout=0.0, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                       device="cpu")
    if variables is not None:
        tm.load_state_dict(tf.params_from_jax(jax.tree.map(np.asarray, variables)))
    return tm


@pytest.fixture(scope="module")
def jax_step(scenes):
    jts, _ = scenes
    return js.make_train_step(_jax_model(), jts.handler, jts.render_cfg, _adafactor(), STACK)


def _batch_pair(scenes):
    jts, pts = scenes
    for ts in (jts, pts):
        ts.set_epoch(1000)
        ts.rng = np.random.RandomState(3)
    return jts.make_batch([0, 1]), pts.make_batch([0, 1])


def _beyond_one_ulp(tm, variables) -> float:
    """The share of all parameter elements more than one bf16 ulp from the
    JAX tree's."""
    params = dict(tm.named_parameters())
    beyond = total = 0
    for name, leaf in zip(tf.jax_order(tm), jax.tree.leaves(variables)):
        got = params[name].detach().float().numpy()
        ref = np.asarray(leaf).astype(np.float32)
        ref = ref.T if name.endswith("weight") else ref
        assert np.all(np.isfinite(got)), name
        beyond += int((np.abs(got - ref) > bf16_ulp(np.maximum(np.abs(got), np.abs(ref)))).sum())
        total += got.size
    return beyond / total


def _check_step_is_optax(tm, variables, opt_state=None):
    """The port's parameters after its step equal optax's adafactor update
    of the port's own gradients (left in .grad by the step) from
    ``opt_state`` (default: a fresh one), scaled by lr and applied to the
    parameters before the step, to one bf16 ulp of each element."""
    grads = {}
    for name, p in tm.named_parameters():
        leaf = tf.tensor_to_jax(name, p.grad)
        grads[name] = leaf.view(jnp.bfloat16) if p.grad.dtype == torch.bfloat16 else leaf
    g_tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(variables),
                                          [jnp.asarray(grads[n]) for n in tf.jax_order(tm)])
    opt = _adafactor()

    @jax.jit
    def update(g, o, p):
        u, _ = opt.update(g, o, p)
        return optax.apply_updates(p, jax.tree.map(lambda x: x * (jnp.asarray(LR) / 1.0), u))

    own = update(g_tree, opt.init(variables) if opt_state is None else opt_state, variables)
    params = dict(tm.named_parameters())
    for name, leaf in zip(tf.jax_order(tm), jax.tree.leaves(own)):
        got = tf.tensor_to_jax(name, params[name].detach().float())
        ref = np.asarray(leaf).astype(np.float32)
        assert np.all(np.abs(got - ref) <= bf16_ulp(np.maximum(np.abs(got), np.abs(ref)))), name


def _step_pair(scenes, jax_step, variables, opt_state, tm, opt, trg_y=None):
    jb, pb = _batch_pair(scenes)
    jt = jb.trg_y if trg_y is None else jnp.asarray(trg_y)
    pt = pb.trg_y if trg_y is None else torch.from_numpy(np.array(trg_y))
    v1, o1, jl, jmet = jax_step(variables, opt_state, jb.src, jt, jb.cameras, jnp.asarray(LR), jb.src_mask)
    _, pts = scenes
    loss, met = ps.make_train_step(tm, pts.handler, pts.render_cfg, opt, STACK)(pb.src, pt, pb.cameras, LR,
                                                                               pb.src_mask)
    return v1, o1, (float(jl), jmet), (float(loss), met)


def _case(scenes, near_target: bool, seed: int = 5):
    """The JAX model and its weights from ``seed``, the port's copy, and the
    target: the batch's own (chamfer-only) or the JAX model's own decode
    plus N(0, NOISE) on the real tokens (image branch; None for the
    batch's)."""
    jm = _jax_model()
    variables = jax_tf.init_model(jm, jax.random.PRNGKey(seed))
    trg_y = None
    if near_target:
        jb, _ = _batch_pair(scenes)
        trg_y = np.array(jb.trg_y)
        pred = np.asarray(js.greedy_decode(jm, variables, jb.src, jb.src_mask, trg_y.shape[1] + 1, STACK))
        real = ~np.asarray(jax_codec.fuzzy_token_equal(jnp.asarray(trg_y), js.pad_token(STACK)))
        noise = np.random.RandomState(6).normal(0, NOISE, trg_y.shape).astype(np.float32)
        trg_y = np.where(real[..., None], pred[:, 1:] + noise, trg_y).astype(np.float32)
    return jm, variables, _port_model(variables), trg_y


@pytest.mark.parametrize("near_target", [False, True], ids=["chamfer_only", "image_branch"])
def test_bf16_adafactor_step_matches_jax(scenes, jax_step, near_target):
    jm, variables, tm, trg_y = _case(scenes, near_target)
    opt = Adafactor(tm.parameters())
    v1, _, (jl, jmet), (loss, met) = _step_pair(scenes, jax_step, variables, _adafactor().init(variables), tm, opt,
                                                trg_y)
    assert (float(met["chamfer"]) < 3.0) == (float(jmet["chamfer"]) < 3.0) == near_target
    assert abs(loss - jl) <= LOSS_REL * abs(jl), (loss, jl)
    assert all(g["lr"] == LR for g in opt.param_groups)
    _check_step_is_optax(tm, variables)
    params = dict(tm.named_parameters())
    assert _beyond_one_ulp(tm, v1) <= BEYOND_ULP[near_target]
    biases = [n for n, p in params.items() if p.dtype == torch.bfloat16 and n.endswith(".bias")]
    assert all(float(params[n].detach().abs().max()) > 0 for n in biases)  # the zero biases move by lr * 1e-3


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_bf16_adafactor_checkpoints_carry_across(scenes, jax_step, tmp_path, direction):
    """A checkpoint with bf16 parameters and Adafactor state written by one
    package loads bit for bit in the other (optax's state flatten order:
    count, v_row..., v_col..., v...); one more step on each side: the losses
    agree, and the port's step is optax's from the loaded state."""
    jm = _jax_model()
    variables = jax_tf.init_model(jm, jax.random.PRNGKey(8))
    tm = _port_model(variables)
    opt = Adafactor(tm.parameters())
    v1, o1, _, _ = _step_pair(scenes, jax_step, variables, _adafactor().init(variables), tm, opt)
    if direction == "jax_to_port":
        js.save_checkpoint(str(tmp_path), "step1", v1, o1)
        tm = _port_model()
        opt = Adafactor(tm.parameters())
        ps.load_checkpoint(str(tmp_path), "step1", tm, opt)
        v_start, o_start = v1, o1
    else:
        ps.save_checkpoint(str(tmp_path), "step1", tm, opt)
        v_start, o_start = js.load_checkpoint(str(tmp_path), "step1", variables, _adafactor().init(variables))
    params = dict(tm.named_parameters())
    for name, leaf in zip(tf.jax_order(tm), jax.tree.leaves(v_start)):
        assert params[name].dtype == torch.bfloat16 or name.endswith(("a_2", "b_2")) or "generator" in name
        np.testing.assert_array_equal(tf.tensor_to_jax(name, params[name]), np.asarray(leaf).view(np.uint16)
                                      if tf.is_bf16(np.asarray(leaf)) else np.asarray(leaf), err_msg=name)
    fs = o_start[0]
    assert int(fs.count) == 1
    for key in ("v_row", "v_col", "v"):
        for name, leaf in zip(tf.jax_order(tm), jax.tree.leaves(getattr(fs, key))):
            state = opt.state[params[name]]
            assert state["step"] == 1
            leaf = np.asarray(leaf)
            np.testing.assert_array_equal(tf.tensor_to_numpy(state[key]),
                                          leaf.view(np.uint16) if tf.is_bf16(leaf) else leaf, err_msg=f"{key} {name}")
    v2, _, (jl, _), (loss, _) = _step_pair(scenes, jax_step, v_start, o_start, tm, opt)
    assert abs(loss - jl) <= LOSS_REL * abs(jl), (loss, jl)
    _check_step_is_optax(tm, v_start, o_start)


def test_campaign_tool_smoke_resume_report_eval(tmp_path, capsys):
    """``--smoke --device cpu`` for 3 steps, then ``--resume`` to 5, then
    ``--report-only`` and ``--eval``: the files appear, the curve continues
    and every loss is finite (a 400-Gaussian scene stands in for the
    17,618)."""
    out = str(tmp_path / "run")
    base = ["--smoke", "--out", out, "--device", "cpu"]
    res = campaign.main(base + ["--steps", "3", "--ckpt_every", "2"], gaussians=400)
    assert [h["step"] for h in res["history"]] == [1, 2, 3]
    assert all(math.isfinite(h["loss"]) for h in res["history"])
    assert res["model"].param_dtype == torch.float32 and res["model"].dtype == torch.bfloat16
    assert {"checkpoint_step2", "checkpoint_step3", "RUN.md", "meta.json", "loss_curve.csv"} <= set(
        p.name for p in (tmp_path / "run").iterdir())
    meta = json.loads((tmp_path / "run" / "meta.json").read_text())
    assert meta["stack"] == 4 and meta["d_model"] == 416 and meta["device"] == "cpu"
    capsys.readouterr()

    res = campaign.main(base + ["--steps", "5", "--resume"], gaussians=400)
    assert "resumed from checkpoint_step3" in capsys.readouterr().out
    assert res["first_step"] == 3 and [h["step"] for h in res["history"]] == [4, 5]
    rows = np.genfromtxt(tmp_path / "run" / "loss_curve.csv", delimiter=",", names=True)
    assert list(rows["step"]) == [1, 2, 3, 4, 5] and np.all(np.isfinite(rows["loss_per_token"]))

    (tmp_path / "run" / "RUN.md").unlink()
    assert campaign.main(base + ["--report-only"], gaussians=400) is None
    assert "5 steps on cpu" in (tmp_path / "run" / "RUN.md").read_text()
    ev = campaign.main(base + ["--eval"], gaussians=400)
    assert ev["step"] == 5 and math.isfinite(ev["chamfer"]) and len(ev["psnrs"]) == 8
    assert "checkpoint_step5" in (tmp_path / "run" / "EVAL.md").read_text()


def test_campaign_flags_match_the_reference():
    """The JAX tool's flags and defaults, plus ``--device`` and ``--profile``;
    ``--steps`` defaults to the reference's 1200 (30 with ``--smoke``)."""
    import ast
    from pathlib import Path

    src = (Path(campaign.REPO) / "tools" / "stacked_campaign.py").read_text()
    ref = {}
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            ref[node.args[0].value] = ast.literal_eval(kw["default"]) if "default" in kw else None
    args = campaign._parse([])
    for flag, default in ref.items():
        if flag in ("--steps", "--out"):
            continue
        assert getattr(args, flag.lstrip("-").replace("-", "_")) == (default or False), flag
    assert args.steps is None and ref["--steps"] == 1200
    assert args.device is None and args.profile is None
    assert args.out.endswith("build/torch_stacked_campaign")


def campaign_curves(steps: int, gaussians: int, seed: int = 0):
    """Both packages' campaign loops side by side on the CPU: the tool's
    ``--smoke`` shape (STACK 4, 8 ring cameras at 160x120, bucket 8, batch 4)
    on ``synthetic_scene(gaussians)`` at SH 1, with bf16 parameters (the
    full recipe's), Adafactor, the ReduceLROnPlateau lr and dropout 0 (the
    two packages draw dropout masks from different generators); the JAX
    model's initial weights carried into the port. Returns {package: [the
    chamfer of each step]}."""
    from gaussian_transformer_tpu.scene.cameras import Camera as JaxCamera
    from gaussian_transformer_tpu.scene.gaussians import GaussianScene
    from gaussian_transformer_tpu_torch.tools.synthetic import synthetic_scene

    stack = 4
    d = ps.stacked_token_dim(stack)
    stub = campaign.build_scene_stub(n_cams=8, width=160, height=120, device="cpu", gaussians=gaussians)
    fields = synthetic_scene(gaussians, campaign.SCENE_SEED)
    fields["features_rest"] = fields["features_rest"][:, :3]
    jscene = GaussianScene(**{k: jnp.asarray(v) for k, v in fields.items()}, active_sh_degree=1, max_sh_degree=1)
    jcams = [JaxCamera.create(colmap_id=c.colmap_id, R=c.R, T=c.T, fovx=c.fovx, fovy=c.fovy, image=None,
                              gt_alpha_mask=None, image_name=c.image_name, uid=c.uid, width=c.image_width,
                              height=c.image_height) for c in stub.get_train_cameras()]
    jts = js.TrainingScene(types.SimpleNamespace(gaussians=jscene, get_train_cameras=lambda scale=1.0: jcams),
                           JaxRenderConfig(), batch_size=4, stack=stack, bucket=8, seed=seed)
    pts = ps.TrainingScene(stub, RenderConfig(), batch_size=4, stack=stack, bucket=8, seed=seed)
    jm = jax_tf.make_model(stack, d, d, N=2, d_model=d, dropout=0.0, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    variables = jax_tf.init_model(jm, jax.random.PRNGKey(seed))
    tm = tf.make_model(stack, d, d, N=2, d_model=d, dropout=0.0, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                       device="cpu")
    tm.load_state_dict(tf.params_from_jax(jax.tree.map(np.asarray, variables)))
    opt = Adafactor(tm.parameters())
    p_step = ps.make_train_step(tm, pts.handler, pts.render_cfg, opt, stack)
    j_step = js.make_train_step(jm, jts.handler, jts.render_cfg, _adafactor(), stack)
    j_state = _adafactor().init(variables)
    curves = {"jax": [], "port": []}
    scheds = {"jax": js.ReduceLROnPlateau(lr=LR), "port": ps.ReduceLROnPlateau(lr=LR)}
    epoch = 0
    while len(curves["port"]) < steps:
        totals = {k: [0.0, 0] for k in curves}
        jts.set_epoch(epoch)
        pts.set_epoch(epoch)
        for jb, pb in zip(jts.batches(), pts.batches()):
            if jb is None or len(curves["port"]) >= steps:
                continue
            variables, j_state, jl, jmet = j_step(variables, j_state, jb.src, jb.trg_y, jb.cameras,
                                                  jnp.asarray(scheds["jax"].lr), jb.src_mask)
            pl, pmet = p_step(pb.src, pb.trg_y, pb.cameras, scheds["port"].lr, pb.src_mask)
            for k, loss, met in (("jax", jl, jmet), ("port", pl, pmet)):
                curves[k].append(float(met["chamfer"]))
                totals[k][0] += float(loss)
                totals[k][1] += jb.ntokens
        for k in curves:
            scheds[k].step(totals[k][0] / max(totals[k][1], 1))
        epoch += 1
    return curves


if __name__ == "__main__":
    # Both packages' campaign loops on one synthetic scene (CPU, a few
    # minutes): python tests/test_torch_campaign.py [--steps 100] [--gaussians 1000]
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--gaussians", type=int, default=1000)
    a = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    res = campaign_curves(a.steps, a.gaussians)
    k = max(a.steps // 10, 1)
    print("steps | JAX chamfer | port chamfer (window means)")
    for i in range(0, a.steps, k):
        print(f"{i + 1}-{min(i + k, a.steps)} | {np.mean(res['jax'][i:i + k]):.4f} | {np.mean(res['port'][i:i + k]):.4f}")
    print(json.dumps(res))

"""Port parity for the transformer half of the multi-device tier: ring and
Ulysses attention (parallel/ring.py, ulysses.py), FSDP (parallel/fsdp.py),
the stacked trainer's data-parallel windows alone and with FSDP
(train/stacked.py make_batch_group, make_dp_train_step), the flat
trainer's ring step (train/flat.py) and the two CLIs' ``--dp``,
``--seq_shard`` and ``--fsdp``. The JAX package's functions run on the
virtual 8-device CPU mesh of tests/conftest.py in this process; the port
on 2 and 4 gloo ranks spawned by ``tests/torch_dist_workers.py`` (torch
and the port only).

Inputs and bounds: ring and Ulysses on q/k/v [2, 4, 32, 8] (numpy seed 0)
with a causal and a source-PAD mask against the JAX package's
``ring_attention``/``ulysses_attention`` at the same D (2 and 4): forward
and gradients 1e-5 x max(1, max|ref|). The stacked cases use
tests/test_stacked.py's ``make_tscene`` scene and small model (STACK 2,
d_model 104, N 1, dropout 0) with its JAX weights: FSDP over 4 (min_size
1024) against the JAX package's unsharded step, data parallelism over 2
windows and DP x FSDP on 2 x 2 (the same two windows) against its
``make_dp_train_step`` over 2 (``make_batch_group`` bit for bit): the loss 2e-4 relative
(the JAX tests' rtol) and the parameters after one Adam step within 1e-2 x
lr where the step's gradient is at least 10 x Adam's eps, 1e-1 x lr below
(tests/test_torch_stacked.py's rule: a first Adam step is lr x sign(g)).
The flat step with a ring over 4 against the JAX package's dense flat loss
(its own test holds the ring to the dense path): loss 2e-4 relative,
gradients 5e-4 x max|grad| + 1e-6 (tests/test_parallel.py's bounds), and
the Adamax update against the port's dense step 1e-2 x lr.

Cost: three spawns (4 ranks, 2 ranks, and 2 ranks for the CLIs; ~15-40 s
each) and ~40 s of JAX compiles.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from gaussian_transformer_tpu.models.transformer import init_model as jax_init_model
from gaussian_transformer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gaussian_transformer_tpu.parallel.ring import ring_attention as jax_ring
from gaussian_transformer_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from gaussian_transformer_tpu.render import RenderConfig as JaxRenderConfig
from gaussian_transformer_tpu.train import flat as jf
from gaussian_transformer_tpu.train import stacked as js
from gaussian_transformer_tpu_torch.cli import train_stacked as stacked_cli
from gaussian_transformer_tpu_torch.cli import train_transformer as flat_cli
from gaussian_transformer_tpu_torch.models import transformer as tf
from gaussian_transformer_tpu_torch.render import RenderConfig
from gaussian_transformer_tpu_torch.train import flat as pf
from gaussian_transformer_tpu_torch.train import stacked as ps

from tests.test_stacked import STACK_S, make_tscene, small_model
from tests.test_train import _synthetic_scene_and_cams
from tests.torch_dist_workers import Spawned, write_stacked_model_dir
from tests.torch_port_support import SCENE_FIELDS, torch_camera, torch_scene

LR, EPS = 5e-4, 1e-4
FLAT_D = 64
ATTN_SHAPE = (2, 4, 32, 8)  # B, H, L, D


def _pack_scene(prefix, scene):
    out = {f"{prefix}scene.{k}": np.asarray(getattr(scene, k)) for k in SCENE_FIELDS}
    out[f"{prefix}scene.active_sh_degree"] = np.asarray(scene.active_sh_degree)
    return out


def _pack_cams(prefix, cams):
    out = {f"{prefix}cam.n": np.asarray(len(cams))}
    for i, c in enumerate(cams):
        for k, v in (("wvt", c.world_view_transform), ("fpt", c.full_proj_transform), ("center", c.camera_center),
                     ("fovx", c.fovx), ("fovy", c.fovy), ("width", c.image_width), ("height", c.image_height),
                     ("image", c.original_image)):
            out[f"{prefix}cam.{i}.{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def attn():
    rng = np.random.RandomState(0)
    B, H, L, D = ATTN_SHAPE
    q, k, v, cot = (rng.randn(*ATTN_SHAPE).astype(np.float32) for _ in range(4))
    causal = np.broadcast_to(np.tril(np.ones((L, L), bool))[None, None], (B, 1, L, L)).copy()
    pad = np.ones((B, 1, 1, L), bool)
    pad[0, ..., L - 5:] = False
    pad[1, ..., L - 11:] = False
    return {"q": q, "k": k, "v": v, "cot": cot, "mask": {"causal": causal, "pad": pad}}


@pytest.fixture(scope="module")
def stacked_case():
    """tests/test_stacked.py's scene (its make_tscene) and small model with
    JAX weights (PRNGKey(3))."""
    ts = make_tscene(batch_size=2)
    ts.set_epoch(1000)
    model = small_model()
    variables = jax_init_model(model, jax.random.PRNGKey(3))
    scene, cams = _synthetic_scene_and_cams(n=256, n_cams=4, width=48, height=32, seed=11)
    return ts, model, variables, scene, cams


@pytest.fixture(scope="module")
def flat_case():
    """tests/test_torch_flat.py's scene: 400 Gaussians, four 48x32 cameras."""
    scene, cams = _synthetic_scene_and_cams(n=400, n_cams=4, width=48, height=32, seed=21)
    jts = jf.FlatTrainingScene(types.SimpleNamespace(gaussians=scene, get_train_cameras=lambda scale=1.0: cams),
                               JaxRenderConfig(max_per_tile=64), max_len=15000, min_len=10, bucket=32)
    jm = jf.EmbeddedEncoderDecoder(N=1, d_model=FLAT_D, dropout=0.0)
    variables = jf.init_flat_model(jm, jax.random.PRNGKey(9))
    return jts, jm, variables, scene, cams


@pytest.fixture(scope="module")
def inputs(attn, stacked_case, flat_case):
    ts, model, variables, scene, cams = stacked_case
    out = {"attn.q": attn["q"], "attn.k": attn["k"], "attn.v": attn["v"], "attn.cot": attn["cot"],
           **{f"attn.mask.{k}": v for k, v in attn["mask"].items()},
           "stacked.stack": np.asarray(STACK_S), "stacked.lr": np.asarray(LR),
           **_pack_scene("stacked.", scene), **_pack_cams("stacked.", cams)}
    out.update({f"stacked.w.{k}": v.numpy() for k, v in tf.params_from_jax(jax.tree.map(np.asarray, variables)).items()})
    jts, jm, fvars, fscene, fcams = flat_case
    out.update(_pack_scene("flat.", fscene), **_pack_cams("flat.", fcams))
    out.update({f"flat.w.{k}": v.numpy() for k, v in tf.params_from_jax(jax.tree.map(np.asarray, fvars)).items()})
    out.update({"flat.cam_idx": np.asarray(2), "flat.d_model": np.asarray(FLAT_D)})
    return out


@pytest.fixture(scope="module")
def started(inputs, model_dir, tmp_path_factory):
    """Every spawn of this file, started at the first use: they run while
    this process compiles the JAX references."""
    cli_work = tmp_path_factory.mktemp("cli_run")
    return {**{w: Spawned("tier_seq", w, inputs, tmp_path_factory.mktemp(f"seq{w}")) for w in (2, 4)},
            "cli": (cli_work, Spawned("cli_pair", 2, {"root": np.asarray(str(model_dir))}, cli_work))}


@pytest.fixture(scope="module")
def runs(started):
    return lambda world: started[world].result()


def _close(got, ref, rel, what, floor=1.0):
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.all(np.isfinite(got)), what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(floor, float(np.abs(ref).max())), err_msg=what)


# ------------------------------------------------------------- attention ---


@pytest.fixture(scope="module")
def jax_attn(attn):
    """The JAX package's ring and Ulysses attention, forward and vjp, for
    both masks at D = 2 and 4 (one compile per D)."""
    cache = {}

    def get(world):
        if world not in cache:
            mesh = jax_make_mesh(jax.devices()[:world], data=1)

            @jax.jit
            def all_cases(q, k, v, cot, masks):
                out = {}
                for case, mask in masks.items():
                    for name, fn in (("ring", jax_ring), ("ulysses", jax_ulysses)):
                        y, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, mask, mesh), q, k, v)
                        out[f"{name}.{case}"] = (y, vjp(cot))
                return out

            cache[world] = jax.tree.map(np.asarray, all_cases(
                *[jnp.asarray(attn[x]) for x in ("q", "k", "v", "cot")],
                {c: jnp.asarray(m) for c, m in attn["mask"].items()}))
        return cache[world]

    return get


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["ring", "ulysses"])
@pytest.mark.parametrize("case", ["causal", "pad"])
def test_sequence_parallel_attention_matches_jax(runs, jax_attn, world, name, case):
    out, grads = jax_attn(world)[f"{name}.{case}"]
    for r, res in enumerate(runs(world)):
        rows = lambda a: np.split(np.asarray(a), world, axis=2)[r]
        _close(res[f"{name}.{case}.out"], rows(out), 1e-5, f"{name} {case} out, rank {r}")
        for x, g in zip("qkv", grads):
            _close(res[f"{name}.{case}.g{x}"], rows(g), 1e-5, f"{name} {case} d{x}, rank {r}")


# ---------------------------------------------------------------- stacked ---


def _adam_tolerance(v0, o1):
    """Per-leaf tolerances of parameters after one Adam step: 1e-2 x lr where
    |g| >= 10 x eps, 1e-1 x lr below (g read off Adam's first moment)."""
    del v0
    g = [np.asarray(m) / 0.1 for m in jax.tree.leaves(o1[0].mu)]
    return [np.where(np.abs(x) >= 10 * EPS, 1e-2 * LR, 1e-1 * LR) for x in g]


def _params_close(res, prefix, model_like, variables, tol):
    for name, leaf, t in zip(tf.jax_order(model_like), jax.tree.leaves(variables), tol):
        got, ref = res[f"{prefix}.p.{name}"], np.asarray(leaf)
        bad = np.abs(got - ref) > t
        assert not bad.any(), f"{prefix} {name}: {bad.sum()} of {bad.size} beyond tolerance"


def _port_model():
    D = ps.stacked_token_dim(STACK_S)
    return tf.make_model(STACK_S, D, D, N=1, d_model=D, dropout=0.0, device="meta")


def test_fsdp_step_matches_the_unsharded_jax_step(stacked_case, runs):
    ts, model, variables, _, _ = stacked_case
    ts.rng = np.random.RandomState(3)
    b = ts.make_batch([0, 1])
    adam = optax.adam(1.0, eps=EPS)
    o0 = adam.init(variables)
    step = js.make_train_step(model, ts.handler, ts.render_cfg, adam, STACK_S)
    v1, o1, loss, _ = step(variables, o0, b.src, b.trg_y, b.cameras, jnp.asarray(LR), b.src_mask)
    results = runs(4)
    assert all(r["fsdp.sharded"].any() for r in results)  # the test means something
    for r in results:
        assert float(r["fsdp.loss"]) == pytest.approx(float(loss), rel=2e-4)
        _params_close(r, "fsdp", _port_model(), v1, _adam_tolerance(variables, o1))


def test_fsdp_checkpoint_is_the_unsharded_trainers(stacked_case, runs):
    """Rank 0 writes the whole tensors of an FSDP run: the JAX package's
    loader reads them as the step left them, and a sharded model and
    optimizer read them back exactly."""
    _, model, variables, _, _ = stacked_case
    adam = optax.adam(1.0, eps=EPS)
    r = runs(4)[0]
    assert all(float(x["fsdp.reload_err"]) == 0.0 for x in runs(4))
    params, opt_state = js.load_checkpoint(str(r["fsdp.run"]), 1, variables, adam.init(variables))
    assert int(opt_state[0].count) == 1
    for name, leaf in zip(tf.jax_order(_port_model()), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(leaf), r[f"fsdp.p.{name}"], err_msg=name)


@pytest.fixture(scope="module")
def jax_dp(stacked_case):
    """The JAX package's make_dp_train_step over 2 windows (RandomState(5)'s
    group): the reference of both the port's DP and DP x FSDP steps, which
    train the same two windows (the JAX package holds its own 2 x 2 DP x
    FSDP step to this one, tests/test_parallel.py)."""
    ts, model, variables, _, _ = stacked_case
    ts.rng = np.random.RandomState(5)
    group = ts.make_batch_group(2)
    assert group is not None
    adam = optax.adam(1.0, eps=EPS)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    step = js.make_dp_train_step(model, ts.handler, ts.render_cfg, adam, STACK_S, mesh=mesh, batch_size=2)
    p, o1, loss, _ = step(variables, adam.init(variables), group.src, group.trg_y, group.cameras, jnp.asarray(LR),
                          group.src_mask)
    return p, o1, loss


@pytest.mark.parametrize("prefix,world", [("dp", 2), ("dpfsdp", 4)], ids=["dp_2", "dp_x_fsdp_2x2"])
def test_dp_steps_match_jax(stacked_case, runs, jax_dp, prefix, world):
    _, _, variables, _, _ = stacked_case
    p, o1, loss = jax_dp
    for r in runs(world):
        assert float(r[f"{prefix}.loss"]) == pytest.approx(float(loss), rel=2e-4)
        _params_close(r, prefix, _port_model(), p, _adam_tolerance(variables, o1))


def test_batch_group_matches_jax_bit_for_bit(stacked_case):
    ts, _, _, scene, cams = stacked_case
    tcams = [torch_camera(c) for c in cams]
    pts = ps.TrainingScene(types.SimpleNamespace(gaussians=torch_scene(scene), get_train_cameras=lambda: tcams),
                           RenderConfig(), batch_size=2, stack=STACK_S, bucket=4)
    pts.set_epoch(1000)
    for seed in (5, 9):
        ts.rng, pts.rng = np.random.RandomState(seed), np.random.RandomState(seed)
        jg, pg = ts.make_batch_group(2), pts.make_batch_group(2)
        for k in ("src", "src_mask", "trg", "trg_y"):
            np.testing.assert_array_equal(getattr(pg, k).numpy(), np.asarray(getattr(jg, k)), err_msg=k)
        assert pg.ntokens == jg.ntokens and len(pg.cameras) == 2 and all(len(c) == 2 for c in pg.cameras)
        for w in range(2):
            for b in range(2):
                np.testing.assert_array_equal(pg.cameras[w][b].world_view_transform.numpy(),
                                              np.asarray(jg.cameras.world_view_transform[w, b]))


# ------------------------------------------------------------------- flat ---


def test_flat_ring_step_matches_the_jax_dense_step(flat_case, runs):
    jts, jm, variables, fscene, fcams = flat_case
    jts.set_epoch(1000)
    jts.rng = np.random.RandomState(7)
    jb = jts.make_batch(2)
    loss_fn = jf.make_flat_loss(jm, jts.render_cfg, use_lpips=False)
    args = [jb[k] for k in ("src", "trg", "trg_y", "src_mask", "trg_mask")]
    (jl, jmet), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables, *args, jb["cam"])
    # The port's dense step on the same batch, for the update.
    tcams = [torch_camera(c) for c in fcams]
    for t, c in zip(tcams, fcams):
        t.original_image = torch.from_numpy(np.asarray(c.original_image))
    pts = pf.FlatTrainingScene(types.SimpleNamespace(gaussians=torch_scene(fscene), get_train_cameras=lambda: tcams),
                               RenderConfig(), max_len=15000, min_len=10, bucket=32)
    pts.set_epoch(1000)
    pts.rng = np.random.RandomState(7)
    pb = pts.make_batch(2)
    tm = pf.EmbeddedEncoderDecoder(N=1, d_model=FLAT_D, dropout=0.0, device="cpu")
    tm.load_state_dict(tf.params_from_jax(jax.tree.map(np.asarray, variables)))
    opt, _ = pf.make_noam_adamax(tm.parameters(), FLAT_D)
    loss, _ = pf.make_flat_loss(tm, pts.render_cfg, use_lpips=False)(
        *[pb[k] for k in ("src", "trg", "trg_y", "src_mask", "trg_mask", "cam")])
    loss.backward()
    opt.step()
    assert pb["src"].shape[1] % 4 == 0 and pb["trg"].shape[1] % 4 == 0
    ref = dict(zip(tf.jax_order(tm), jax.tree.leaves(jg)))
    scale = max(float(np.abs(np.asarray(g)).max()) for g in ref.values())
    lr = pf.noam_rate(1, FLAT_D)
    for r in runs(4):
        assert float(r["flat.loss"]) == pytest.approx(float(jl), rel=2e-4)
        for k in ("base", "gen", "l2"):
            assert float(r[f"flat.{k}"]) == pytest.approx(float(jmet[k]), rel=2e-4)
        for name in tf.jax_order(tm):
            np.testing.assert_allclose(r[f"flat.g.{name}"], np.asarray(ref[name]), rtol=0,
                                       atol=5e-4 * scale + 1e-6, err_msg=name)
            # The update within 1e-2 x lr, beside the parameter's own rounding.
            want = tf.tensor_to_jax(name, dict(tm.named_parameters())[name])
            bad = np.abs(r[f"flat.p.{name}"] - want) > 1e-2 * lr + np.spacing(np.abs(want))
            assert not bad.any(), f"{name}: {bad.sum()} of {bad.size} beyond tolerance"


# -------------------------------------------------------------------- CLIs ---


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A trained-looking SH-1 scene of 400 Gaussians as a model dir with a
    Blender dataset of four 40x30 train views and one test view."""
    return write_stacked_model_dir(tmp_path_factory.mktemp("cli"))


@pytest.fixture(scope="module")
def cli_runs(started, model_dir):
    work, run = started["cli"]
    return work, run.result(), model_dir


def test_stacked_cli_trains_data_parallel(cli_runs):
    work, results, root = cli_runs
    a, b = results
    assert len(a["stacked.loss"]) == 2 * 1  # 4 cameras // (2 windows x batch 2), two epochs
    assert np.all(np.isfinite(a["stacked.loss"]))
    np.testing.assert_array_equal(a["stacked.loss"], b["stacked.loss"])  # the windows' mean on every rank
    # Rank 0 alone wrote the checkpoint; the unsharded trainer reads it.
    model = ps.make_stacked_model(2, 1, device="cpu")
    opt = ps.make_optimizer(model)
    ps.load_checkpoint(str(root / "run"), 1, model, opt)
    assert int(opt.state[next(model.parameters())]["step"]) == 2
    log0, log1 = (open(work / f"cli_pair_2.{r}.log").read() for r in (0, 1))
    assert "Epoch: 1 Loss:" in log0 and "Epoch:" not in log1


def test_flat_cli_trains_with_a_ring(cli_runs):
    work, results, _ = cli_runs
    a, b = results
    assert len(a["flat.loss"]) >= 1 and np.all(np.isfinite(a["flat.loss"]))
    np.testing.assert_array_equal(a["flat.loss"], b["flat.loss"])
    assert np.all(a["flat.src_len"] % 2 == 0)
    data = np.load(work / "best_model.npz")
    model = pf.EmbeddedEncoderDecoder(N=1, d_model=32, device="cpu")
    assert len(data.files) == len(list(model.parameters()))
    pf.load_flat_params(str(work / "best_model.npz"), model)


def test_fsdp_clis_train_and_resume(cli_runs):
    _, results, _ = cli_runs
    a, b = results
    for key in ("flat_fsdp.loss", "stacked_fsdp.loss"):
        assert len(a[key]) >= 1 and np.all(np.isfinite(a[key])), key
        np.testing.assert_array_equal(a[key], b[key])  # every rank trains the same batch
    assert int(a["stacked_fsdp.first_epoch"]) == 2  # resumed from checkpoint_1


@pytest.mark.parametrize("argv", [["--dp", "2"], ["--fsdp", "2"], ["--dp", "2", "--fsdp", "2"]])
def test_stacked_cli_flags_must_match_the_world(model_dir, monkeypatch, argv):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        stacked_cli.main(["-s", str(model_dir / "data"), "-m", str(model_dir / "model"), "--device", "cpu", *argv])


@pytest.mark.parametrize("argv,match", [(["--seq_shard", "2"], "WORLD_SIZE"), (["--fsdp", "2"], "WORLD_SIZE"),
                                        (["--seq_shard", "2", "--fsdp", "2"], "pick one")])
def test_flat_cli_flags_must_match_the_world(model_dir, monkeypatch, argv, match):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match=match):
        flat_cli.main(["-s", str(model_dir / "data"), "-m", str(model_dir / "model"), "--device", "cpu", *argv])

"""Port parity for the flat masked-Gaussian trainer (train/flat.py) and its
CLI (cli/train_transformer.py) against the JAX package's
``gaussian_transformer_tpu/train/flat.py`` on the same seeded inputs: d_model
64, h 8, N 1, dropout 0, weights carried over with ``params_from_jax``,
renders of 48x32 cameras through the JAX package's CPU route.

Tolerances: the schedules, masks and FlatTrainingScene batches (src, trg,
trg_y, masks, counts, visibility) exact; the model's encode, decode and
generator, dense and blockwise, 1e-5 x max(1, max|ref|); the loss and its
parts 1e-5 relative, its parameter gradients 2e-4 x max|grad|, with and
without LPIPS(alex) (seeded random weights); three Noam-Adamax updates fed
the same gradients 1e-6 x max(1, max|ref|); the greedy decode 1e-5 x max(1,
max|ref|); ``best_model.npz`` round trips exact."""

import dataclasses
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
from gaussian_transformer_tpu.eval import lpips as jax_lpips
from gaussian_transformer_tpu.models.transformer import subsequent_mask as jax_subsequent_mask
from gaussian_transformer_tpu.render import RenderConfig as JaxRenderConfig
from gaussian_transformer_tpu.train import flat as jf
from gaussian_transformer_tpu_torch.cli import train_transformer as cli
from gaussian_transformer_tpu_torch.convert import scene_from_numpy
from gaussian_transformer_tpu_torch.eval import lpips
from gaussian_transformer_tpu_torch.models import transformer as tf
from gaussian_transformer_tpu_torch.render import RenderConfig
from gaussian_transformer_tpu_torch.train import flat as pf

from tests.test_train import _synthetic_scene_and_cams
from tests.torch_port_support import torch_camera, torch_scene

D_MODEL = 64
REL = 1e-5
GRAD_REL = 2e-4


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, rel, what="", floor=1.0):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.all(np.isfinite(got)), what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(floor, float(np.abs(ref).max())), err_msg=what)


def _models(seed=0, block_k=0, N=1):
    jm = jf.EmbeddedEncoderDecoder(N=N, d_model=D_MODEL, dropout=0.0, block_k=block_k)
    variables = jf.init_flat_model(jm, jax.random.PRNGKey(seed))
    tm = pf.EmbeddedEncoderDecoder(N=N, d_model=D_MODEL, dropout=0.0, block_k=block_k, device="cpu")
    tm.load_state_dict(tf.params_from_jax(jax.tree.map(np.asarray, variables)))
    return jm, variables, tm


@pytest.fixture(scope="module")
def scenes():
    """The same 400-Gaussian scene and four 48x32 cameras (with their ground
    truth) in both packages' FlatTrainingScene (window 10 < visible < 15000,
    bucket 32)."""
    scene, cams = _synthetic_scene_and_cams(n=400, n_cams=4, width=48, height=32, seed=21)
    jts = jf.FlatTrainingScene(types.SimpleNamespace(gaussians=scene, get_train_cameras=lambda scale=1.0: cams),
                               JaxRenderConfig(max_per_tile=64), max_len=15000, min_len=10, bucket=32)
    tcams = [dataclasses.replace(torch_camera(c), original_image=torch.from_numpy(np.asarray(c.original_image)))
             for c in cams]
    pts = pf.FlatTrainingScene(types.SimpleNamespace(gaussians=torch_scene(scene), get_train_cameras=lambda: tcams),
                               RenderConfig(), max_len=15000, min_len=10, bucket=32)
    return jts, pts


@pytest.fixture
def alex_weights(tmp_path, monkeypatch):
    path = tmp_path / "lpips_alex.npz"
    chip_smoke.write_lpips_weights(path, "alex", 3)
    monkeypatch.setenv("GT_LPIPS_WEIGHTS", str(path))
    jax_lpips._load.cache_clear()
    lpips._load.cache_clear()
    yield path
    jax_lpips._load.cache_clear()
    lpips._load.cache_clear()


# ------------------------------------------------ schedules, masks, batches ---


def test_noam_dropout_schedule_and_masks_exact():
    for step in (0, 1, 2, 100, 1999, 2000, 2001, 10**5):
        for size, factor, warmup in ((1024, 0.5, 2000), (64, 2.0, 10)):
            assert pf.noam_rate(step, size, factor, warmup) == jf.noam_rate(step, size, factor, warmup)
    for epoch in (0, 1, 500, 6000, 10**5):
        assert pf.dropout_schedule_flat(epoch) == jf.dropout_schedule_flat(epoch)
    t = np.tile(np.asarray(jf.PAD_GAUSSIAN), (2, 7, 1))
    t[:, 0] = np.asarray(jf.START_GAUSSIAN)
    t[0, 1:5] = np.random.RandomState(0).randn(4, 26)
    t[1, 1] = np.asarray(jf.END_GAUSSIAN)
    np.testing.assert_array_equal(pf.make_std_mask(torch.from_numpy(t)).numpy(),
                                  np.asarray(jf.make_std_mask(jnp.asarray(t))))


def test_flat_training_scene_batches_bit_for_bit(scenes):
    jts, pts = scenes
    np.testing.assert_array_equal(pts.tokens, np.asarray(jts.tokens))
    assert pts.size == jts.size == 4
    for a, b in zip(pts.visible, jts.visible):
        np.testing.assert_array_equal(a, np.asarray(b))
    jts.rng, pts.rng = np.random.RandomState(5), np.random.RandomState(5)
    for epoch in (0, 1000, 8000):
        jts.set_epoch(epoch)
        pts.set_epoch(epoch)
        assert pts.dropout == jts.dropout
        for cam_idx in (0, 3, 1):
            jb, pb = jts.make_batch(cam_idx), pts.make_batch(cam_idx)
            assert (pb["n_src"], pb["n_tgt"]) == (jb["n_src"], jb["n_tgt"])
            assert pb["src"].shape[1] % 32 == 0 and pb["trg"].shape[1] % 32 == 0
            for k in ("src", "src_mask", "trg", "trg_y", "trg_mask"):
                np.testing.assert_array_equal(_np(pb[k]), np.asarray(jb[k]), err_msg=f"epoch {epoch} {k}")


# ------------------------------------------------------------------ model ---


@pytest.mark.parametrize("block_k", [0, 8])
def test_embedded_encoder_decoder_matches_jax(block_k):
    jm, variables, tm = _models(seed=block_k + 1, block_k=block_k)
    assert tf.count_params(tm) == sum(np.asarray(x).size for x in jax.tree.leaves(variables))
    r = np.random.RandomState(block_k)
    src = r.randn(2, 24, 26).astype(np.float32)
    tgt = r.randn(2, 16, 26).astype(np.float32)
    src_mask = r.rand(2, 1, 24) > 0.2
    tgt_mask = np.asarray(jax_subsequent_mask(16)) & (r.rand(2, 1, 16) > 0.2)
    ref_mem = jm.apply(variables, src, src_mask, method=jf.EmbeddedEncoderDecoder.encode)
    ref_out = jm.apply(variables, src, tgt, src_mask, tgt_mask, True)
    ref_gen = jm.apply(variables, ref_out, method=jf.EmbeddedEncoderDecoder.generator)
    t = [torch.from_numpy(a) for a in (src, tgt, src_mask, tgt_mask)]
    with torch.no_grad():
        _close(tm.encode(t[0], t[2]), ref_mem, REL, "memory")
        out = tm(*t)
        _close(out, ref_out, REL, "decoder output")
        _close(tm.generator(out), ref_gen, REL, "generator")


def test_init_flat_model_is_seeded_xavier_core_and_lecun_wrapper():
    a = pf.init_flat_model(pf.EmbeddedEncoderDecoder(N=1, d_model=D_MODEL, device="cpu"), seed=2)
    b = pf.init_flat_model(pf.EmbeddedEncoderDecoder(N=1, d_model=D_MODEL, device="cpu"), seed=2)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    with torch.no_grad():
        for name in ("embed_in_src", "embed_in_tgt", "out_proj"):
            layer = getattr(a, name)
            assert float(layer.bias.abs().max()) == 0.0
            fan_in = layer.weight.shape[1]
            assert float(layer.weight.abs().max()) <= 2.0 / 0.87962566103423978 / math.sqrt(fan_in) * (1 + 1e-6)
        w = a.core.encoder.layer0.self_attn.q.weight
        assert float(w.abs().max()) <= math.sqrt(6.0 / (2 * D_MODEL))


# ------------------------------------------------------------------- loss ---


def _loss_pair(scenes, use_lpips, epoch=1000, cam_idx=2):
    jts, pts = scenes
    jts.set_epoch(epoch)
    pts.set_epoch(epoch)
    jts.rng, pts.rng = np.random.RandomState(7), np.random.RandomState(7)
    jb, pb = jts.make_batch(cam_idx), pts.make_batch(cam_idx)
    jm, variables, tm = _models(seed=9)
    jloss = jf.make_flat_loss(jm, jts.render_cfg, use_lpips=use_lpips)
    args = [jb[k] for k in ("src", "trg", "trg_y", "src_mask", "trg_mask")]
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables, *args, jb["cam"])
    loss_fn = pf.make_flat_loss(tm, pts.render_cfg, use_lpips=use_lpips)
    loss, met = loss_fn(*[pb[k] for k in ("src", "trg", "trg_y", "src_mask", "trg_mask", "cam")])
    loss.backward()
    return tm, (loss, met), (jl, jmet, jg)


@pytest.mark.parametrize("use_lpips", [False, True], ids=["no_lpips", "lpips_alex"])
def test_flat_loss_parts_and_gradients_match_jax(scenes, alex_weights, use_lpips):
    tm, (loss, met), (jl, jmet, jg) = _loss_pair(scenes, use_lpips)
    for k in ("base", "gen", "l2"):
        _close(met[k], jmet[k], REL, k, floor=0.0)
    _close(loss, jl, REL, "loss", floor=0.0)
    if use_lpips:  # the perceptual term is in the loss
        assert float(jl) - float(0.5 * jmet["gen"] / jmet["base"] + 0.1 * jmet["l2"]) > 1e-4
    ref = dict(zip(tf.jax_order(tm), jax.tree.leaves(jg)))
    scale = max(float(np.abs(np.asarray(g)).max()) for g in ref.values())
    assert scale > 0
    for name, p in tm.named_parameters():
        got = tf.tensor_to_jax(name, p.grad)
        assert np.all(np.isfinite(got)), name
        np.testing.assert_allclose(got, np.asarray(ref[name]), rtol=0, atol=GRAD_REL * scale, err_msg=name)


def test_flat_loss_uses_lpips_when_its_weights_exist(scenes, alex_weights, monkeypatch):
    _, pts = scenes
    _, _, tm = _models(seed=1)
    b = pts.make_batch(0)
    args = [b[k] for k in ("src", "trg", "trg_y", "src_mask", "trg_mask", "cam")]
    with torch.no_grad():
        with_lpips, met = pf.make_flat_loss(tm)(*args)
        monkeypatch.setenv("GT_LPIPS_WEIGHTS", str(alex_weights.parent / "absent.npz"))
        monkeypatch.chdir(alex_weights.parent)
        without, _ = pf.make_flat_loss(tm)(*args)
    image_terms = 0.5 * met["gen"] / met["base"] + 0.1 * met["l2"]
    torch.testing.assert_close(without, image_terms, rtol=1e-6, atol=0)
    assert float(with_lpips - without) > 0


def test_flat_loss_dropout_is_keyed_per_step(scenes):
    _, pts = scenes
    tm = pf.init_flat_model(pf.EmbeddedEncoderDecoder(N=1, d_model=D_MODEL, dropout=0.3, device="cpu"), 0)
    b = pts.make_batch(1)
    args = [b[k] for k in ("src", "trg", "trg_y", "src_mask", "trg_mask", "cam")]
    loss_fn = pf.make_flat_loss(tm, use_lpips=False)
    with torch.no_grad():
        a1, a2 = (float(loss_fn(*args, dropout_key=(42, 0))[0]) for _ in range(2))
        b1 = float(loss_fn(*args, dropout_key=(42, 1))[0])
        det = float(loss_fn(*args)[0])
    assert a1 == a2 and a1 != b1 and det not in (a1, b1)


# ---------------------------------------------------- optimizer, decode ---


def test_noam_adamax_three_updates_match_optax():
    """Both optimizers fed the same gradients: Adamax's moments, its bias
    correction and the rate's count (noam(1), noam(1), noam(2))."""
    _, variables, tm = _models(seed=3)
    size, factor, warmup = D_MODEL, 2.0, 3
    opt = pf.make_noam_adamax(tm.parameters(), size, factor, warmup)
    jopt = jf.make_noam_adamax(size, factor, warmup)
    state = jopt.init(variables)
    names = tf.jax_order(tm)
    params = dict(tm.named_parameters())
    rates = []
    r = np.random.RandomState(0)
    for step in range(3):
        grads = [r.randn(*np.shape(x)).astype(np.float32) * 10.0 ** r.randint(-6, 0)
                 for x in jax.tree.leaves(variables)]
        updates, state = jopt.update(jax.tree.unflatten(jax.tree.structure(variables), grads), state, variables)
        variables = optax.apply_updates(variables, updates)
        for n, g in zip(names, grads):
            params[n].grad = torch.from_numpy(g.T.copy() if n.endswith("weight") else g)
        rates.append(opt[0].param_groups[0]["lr"])
        opt[0].step()
        opt[1].step()
        for n, ref in zip(names, jax.tree.leaves(variables)):
            _close(tf.tensor_to_jax(n, params[n]), ref, 1e-6, f"step {step} {n}")
    assert rates == [pf.noam_rate(1, size, factor, warmup)] * 2 + [pf.noam_rate(2, size, factor, warmup)]


def test_greedy_decode_flat_matches_jax():
    jm, variables, tm = _models(seed=4)
    r = np.random.RandomState(4)
    src = r.randn(1, 12, 26).astype(np.float32)
    src_mask = np.ones((1, 1, 12), bool)
    src_mask[0, 0, 9:] = False
    ref = jf.greedy_decode_flat(jm, variables, jnp.asarray(src), jnp.asarray(src_mask), 7)
    got = pf.greedy_decode_flat(tm, torch.from_numpy(src), torch.from_numpy(src_mask), 7)
    assert not got.requires_grad
    _close(got, ref, REL, "greedy decode")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_best_model_npz_round_trip(tmp_path, direction):
    """best_model.npz as the root train_transformer.py writes and reads it:
    ``arr_i`` in jax.tree_util flatten order."""
    jm, variables, _ = _models(seed=5)
    path = tmp_path / "best_model.npz"
    flat, treedef = jax.tree_util.tree_flatten(variables)
    other = pf.init_flat_model(pf.EmbeddedEncoderDecoder(N=1, d_model=D_MODEL, dropout=0.0, device="cpu"), 11)
    if direction == "jax_to_port":
        np.savez(path, *[np.asarray(x) for x in flat])
        pf.load_flat_params(str(path), other)
        for name, leaf in zip(tf.jax_order(other), flat):
            np.testing.assert_array_equal(tf.tensor_to_jax(name, dict(other.named_parameters())[name]),
                                          np.asarray(leaf), err_msg=name)
    else:
        pf.save_flat_params(str(path), other)
        data = np.load(path)
        loaded = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(data[f"arr_{i}"]) for i in range(len(flat))])
        src = np.random.RandomState(0).randn(1, 8, 26).astype(np.float32)
        ref = jm.apply(loaded, src, np.ones((1, 1, 8), bool), method=jf.EmbeddedEncoderDecoder.encode)
        with torch.no_grad():
            _close(other.eval().encode(torch.from_numpy(src), torch.ones(1, 1, 8, dtype=torch.bool)), ref, REL)
    with pytest.raises(ValueError):
        pf.load_flat_params(str(path), pf.EmbeddedEncoderDecoder(N=2, d_model=D_MODEL, device="cpu"))


# ------------------------------------------------------------------- CLI ---


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A trained-looking SH-1 scene of 400 Gaussians as a model dir with a
    Blender dataset of four 40x30 train views and one test view
    (chip_smoke.py's helpers)."""
    root = tmp_path_factory.mktemp("flat")
    fields = chip_smoke.synthetic_scene(400, 4)
    fields["features_rest"] = fields["features_rest"][:, :3]
    scene = scene_from_numpy(fields, 1, "cpu")
    chip_smoke.write_train_dataset(root / "data", scene, chip_smoke.surface_points(300, 4), 4, 1, 40, 30,
                                   math.radians(50.0), torch.device("cpu"))
    scene.save_ply(str(root / "model" / "point_cloud" / "iteration_5" / "point_cloud.ply"))
    return root


def test_cli_trains_saves_and_reloads_best_model(model_dir, tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # TensorBoard is optional
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("GT_LPIPS_WEIGHTS", raising=False)
    steps = []
    base = ["-s", str(model_dir / "data"), "-m", str(model_dir / "model"), "--eval", "--d_model", "32",
            "--layers", "1", "--attn_block_k", "64", "--quiet", "--device", "cpu"]
    floor = cli.MIN_LEN
    assert floor == 5_000  # the reference's fixed floor
    monkeypatch.setattr(cli, "MIN_LEN", 100)  # this scene's cameras see 100-400 Gaussians
    res = cli.main(base + ["--epochs", "2"], on_step=steps.append)
    tscene = res["tscene"]
    assert tscene.size == 4 and all(100 < c < 15000 for c in tscene.counts)
    hist = res["history"]
    assert steps == hist and len(hist) == 8  # 4 cameras, two epochs
    assert [h["epoch"] for h in hist] == [0] * 4 + [1] * 4
    assert sorted(h["cam"] for h in hist[:4]) == [0, 1, 2, 3]
    assert all(math.isfinite(h["loss"]) and h["src_len"] % 256 == 0 for h in hist)
    assert [h["lr"] for h in hist[:3]] == [pf.noam_rate(1, 32)] * 2 + [pf.noam_rate(2, 32)]
    assert len(res["epochs"]) == 2
    out = capsys.readouterr().out
    assert "Epoch: 0 Loss:" in out and "Epoch: 1 Loss:" in out
    data = np.load(tmp_path / "best_model.npz")
    assert len(data.files) == len(list(res["model"].parameters()))
    best = min(res["epochs"], key=lambda e: e["loss"])["epoch"]
    assert res["best_epoch"] == best

    again = cli.main(base + ["--epochs", "0"])
    assert "Loading Model" in capsys.readouterr().out
    for name, leaf in zip(tf.jax_order(again["model"]), (data[f"arr_{i}"] for i in range(len(data.files)))):
        np.testing.assert_array_equal(tf.tensor_to_jax(name, dict(again["model"].named_parameters())[name]), leaf)
    # The reference's floor of 5,000 visible keeps no camera of this scene.
    monkeypatch.setattr(cli, "MIN_LEN", floor)
    with pytest.raises(AssertionError, match="visible-count window"):
        cli.main(base + ["--epochs", "1"])


@pytest.mark.parametrize("flag", [["--seq_shard", "2"], ["--fsdp", "2"]])
def test_cli_parallel_flags_raise(model_dir, flag, monkeypatch):
    """The flags need one process per shard (torchrun): a single process
    asked for 2 raises before it trains."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        cli.main(["-s", str(model_dir / "data"), "-m", str(model_dir / "model"), "--device", "cpu", *flag])


def test_cli_flags_match_reference():
    """The CLI's own flags and defaults are the root train_transformer.py's,
    plus --device and nothing else."""
    import ast
    from pathlib import Path

    def own_flags(path):
        """{flag: its default, or None without one}."""
        flags = {}
        for node in ast.walk(ast.parse(Path(path).read_text())):
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
                kw = {k.arg: k.value for k in node.keywords}
                flags[node.args[0].value.lstrip("-")] = ast.literal_eval(kw["default"]) if "default" in kw else None
        return flags

    flags = own_flags(Path(chip_smoke.ROOT) / "train_transformer.py")
    assert {"epochs", "d_model", "layers", "max_len", "attn_block_k", "seq_shard", "fsdp"} <= set(flags)
    assert set(own_flags(cli.__file__)) == set(flags) | {"device"}
    ref = {name: default for name, default in flags.items() if default is not None}
    _, args = cli._parse(["-s", "x", "-m", "y"])
    for name, default in ref.items():
        assert getattr(args, name) == default, name

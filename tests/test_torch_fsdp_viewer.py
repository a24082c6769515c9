"""The stacked trainer's live viewer under ``--fsdp``: every rank serves it
(viewer/network_gui.py ``pump_stacked(..., group=)``, train/stacked.py
``LiveViewerStream`` on an FSDP2 model), held to the one-process port and
to the JAX package's ``LiveViewerStream`` on the same weights.

``cli.train_stacked --fsdp 2`` runs on 2 gloo ranks
(``tests/torch_dist_workers.py viewer_fsdp``; every leaf of 1024 elements
or more sharded, so that STACK 2's weights are DTensors) for 3 epochs (6
steps) with
the listener on rank 0 and a SIBR client thread there. The client's
script: a live stream of three frames (prompt; prompt and prediction;
prediction at scaling modifier 0.7) interrupted by train=True; at the next
tick a teacher-forced frame; at the next a stream it leaves after two
frames by closing the connection. Every rank records the weights (whole)
and the batch of each stream and teacher-forced frame, and each frame's
rows, flags and image.

Tolerances: frames (float images) 2e-5, the repo's image rule; the rows of
the one-process cached decode on the same weights, and the JAX decode's,
within the cached decode's rule of tests/test_torch_models.py (1e-4 x
max(1, max|ref|): a worker's one CPU thread sums a matmul in another
order than this process's threads); frames against the JAX composite of
the same rows 2e-5 (every flag pair), and against the JAX stream's own frames where they read no
decoded row (the prompt); the teacher-forced frame against the JAX
composite's pieces run eagerly on the same rows (as
tests/test_torch_viewer.py holds the one-process one). The reply bytes
equal ``image_to_bytes`` of the rank's frames.

Cost: one spawn (~15 s) beside ~20 s of JAX compiles.
"""

import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gaussian_transformer_tpu.models import codec as jax_codec
from gaussian_transformer_tpu.models import transformer as jax_tf
from gaussian_transformer_tpu.models.box_sort import GaussianHandler as JaxHandler
from gaussian_transformer_tpu.render import RenderConfig as JaxRenderConfig
from gaussian_transformer_tpu.render import render as jax_render
from gaussian_transformer_tpu.train import stacked as js
from gaussian_transformer_tpu.viewer import network_gui as jax_gui
from gaussian_transformer_tpu_torch.models import transformer as tf
from gaussian_transformer_tpu_torch.models.box_sort import GaussianHandler
from gaussian_transformer_tpu_torch.parallel.mesh import free_port
from gaussian_transformer_tpu_torch.render import RenderConfig
from gaussian_transformer_tpu_torch.train import stacked as ps
from gaussian_transformer_tpu_torch.viewer import network_gui as gui

from tests.torch_dist_workers import Spawned, write_stacked_model_dir

IMAGE_ATOL = 2e-5
DECODE_REL = 1e-4
STACK = 2
D = ps.stacked_token_dim(STACK)
W, H = 40, 30
EPOCHS, STEPS = 3, 6  # 4 cameras at batch 2
# The client's requests: (train, show_prompt = keep_alive, show_pred =
# shs_python, smod). It closes the connection after the last reply, mid-stream.
SCRIPT = [
    (False, True, False, 1.0), (False, True, True, 1.0), (False, False, True, 0.7), (True, True, True, 1.0),
    (True, True, True, 1.0),
    (False, True, True, 1.0), (False, True, False, 1.0),
]
# The request each recorded frame answers, by (event, frame; None for the
# teacher-forced frame): a stream's frame j renders at the request read before it.
FRAME_REQUESTS = {(0, 0): 0, (0, 1): 1, (0, 2): 2, (1, None): 4, (2, 0): 5, (2, 1): 6}
# Each reply: ("stream", event, frame), or ("teacher_forced", event).
REPLIES = [("stream", 0, 0), ("stream", 0, 1), ("stream", 0, 2), ("stream", 0, 2), ("teacher_forced", 1),
           ("stream", 2, 0), ("stream", 2, 1)]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The spawn's results on both ranks, the requests and the model dir."""
    root = write_stacked_model_dir(tmp_path_factory.mktemp("viewer_fsdp"), width=W, height=H)
    with open(root / "data" / "transforms_train.json") as f:
        c2w = json.load(f)["frames"][0]["transform_matrix"]
    cam = chip_smoke.camera_from_c2w(c2w, math.radians(50.0), W, H, torch.device("cpu"))
    reqs = [chip_smoke.sibr_request(cam, train=t, keep_alive=p, smod=s, shs_python=q) for t, p, q, s in SCRIPT]
    inputs = {"root": np.asarray(str(root)), "port": np.asarray(free_port()), "fsdp": np.asarray(2),
              "epochs": np.asarray(EPOCHS), "n_req": np.asarray(len(reqs)), "image_bytes": np.asarray(W * H * 3),
              **{f"req.{i}": np.frombuffer(r, np.uint8) for i, r in enumerate(reqs)}}
    run = Spawned("viewer_fsdp", 2, inputs, tmp_path_factory.mktemp("viewer_fsdp_run"))
    messages = [json.loads(r[4:].decode()) for r in reqs]
    return types.SimpleNamespace(run=run, root=root, messages=messages)


@pytest.fixture(scope="module")
def ranks(case):
    return case.run.result()


def _events(r):
    """Each recorded event: kind, weights, batch and frames."""
    out = []
    for e in range(int(r["n_events"])):
        p = f"ev{e}."
        part = lambda key: {k[len(p) + 2:]: r[k] for k in r if k.startswith(p + key)}
        ev = types.SimpleNamespace(kind=str(r[p + "kind"]), w=part("w."), b=part("b."), frames=[])
        for j in range(int(r.get(p + "n_frames", 0))):
            f = f"{p}f{j}."
            ev.frames.append(types.SimpleNamespace(
                n_valid=int(r[f + "n_valid"]), ys=r[f + "ys"], smod=float(r[f + "smod"]),
                flags=tuple(bool(v) for v in r[f + "flags"]), image=r[f + "image"]))
        if ev.kind == "teacher_forced":
            ev.rows, ev.image, ev.training = r[p + "rows"], r[p + "image"], bool(r[p + "training"])
            ev.flags, ev.smod = tuple(bool(v) for v in r[p + "flags"]), float(r[p + "smod"])
        out.append(ev)
    return out


def _close(got, ref, atol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.all(np.isfinite(got)), what
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=what)


def _port_stream(r, ev):
    """A one-process LiveViewerStream on the event's weights and batch."""
    model = ps.make_stacked_model(STACK, 1, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in ev.w.items()})
    handler = GaussianHandler(*(torch.from_numpy(r[f"handler.{k}"]) for k in ("world_min", "world_max", "scaling_min",
                                                                              "scaling_max")))
    stream = ps.LiveViewerStream(model, handler, RenderConfig(), STACK)
    stream.set_batch(ps.StackedBatch(**{k: torch.from_numpy(v) for k, v in ev.b.items()}, cameras=[], ntokens=0))
    return stream


def test_every_rank_serves_the_client_and_trains_on(case, ranks):
    """Both ranks finish every step with the same losses; the client got
    its seven replies; each reply is rank 0's frame; every rank computed
    the same frames; the model trains on in train mode."""
    a, b = ranks
    assert int(a["sharded"]) > 0  # the decode gathers DTensors
    assert len(a["loss"]) == len(b["loss"]) == STEPS and np.all(np.isfinite(a["loss"]))
    np.testing.assert_array_equal(a["loss"], b["loss"])
    assert str(a["client.errors"][0]) == "" and int(a["n_replies"]) == len(REPLIES)
    ea, eb = _events(a), _events(b)
    assert [e.kind for e in ea] == [e.kind for e in eb] == ["stream", "teacher_forced", "stream"]
    assert [len(e.frames) for e in ea] == [3, 0, 2]
    for x, y in zip(ea, eb):
        for fx, fy in zip(x.frames, y.frames):
            assert np.array_equal(fx.image, fy.image) and np.array_equal(fx.ys, fy.ys)
    assert np.array_equal(ea[1].image, eb[1].image)
    for i, reply in enumerate(REPLIES):
        image = ea[reply[1]].frames[reply[2]].image if reply[0] == "stream" else ea[reply[1]].image
        assert bytes(a[f"reply.{i}"]) == bytes(gui.image_to_bytes(torch.from_numpy(image))), f"reply {i}"
        assert str(a[f"reply.{i}.verify"]) == str(case.root / "data")
    assert ea[1].training and bool(a["training"]) and bool(b["training"])


def test_frames_match_the_one_process_port(case, ranks):
    """Each streamed frame and the teacher-forced frame against the
    one-process port on the same weights, batch, camera and flags."""
    r = ranks[0]
    for e, ev in enumerate(_events(r)):
        stream = _port_stream(r, ev)
        if ev.kind == "teacher_forced":
            cam, _, show_pred, _, show_prompt, smod = gui.parse(case.messages[FRAME_REQUESTS[(e, None)]], "cpu")
            assert (show_prompt, show_pred, smod) == (*ev.flags, ev.smod)
            frame = ps.make_viewer_train_fn(stream)(cam, smod, show_prompt, show_pred)
            _close(ev.image, frame, IMAGE_ATOL, "teacher-forced frame")
            continue
        carry = stream.start()
        for j, f in enumerate(ev.frames):
            cam, _, show_pred, _, show_prompt, smod = gui.parse(case.messages[FRAME_REQUESTS[(e, j)]], "cpu")
            assert (show_prompt, show_pred, smod) == (*f.flags, f.smod) and f.n_valid == j + 1
            carry = stream.step(carry)
            ref = carry[0].numpy()
            _close(f.ys, ref, DECODE_REL * max(1.0, float(np.abs(ref).max())), f"rows of event {e} frame {j}")
            _close(f.image, stream.render(carry, cam, smod, show_prompt, show_pred), IMAGE_ATOL,
                   f"event {e} frame {j}")


def _jax_variables(w):
    """The port's weights as the JAX model's variables."""
    jm = jax_tf.make_model(STACK, D, D, N=1, d_model=D, dropout=0.1)
    like = jax_tf.init_model(jm, jax.random.PRNGKey(0))
    model = ps.make_stacked_model(STACK, 1, device="cpu")
    leaves = [jnp.asarray(tf.tensor_to_jax(n, torch.from_numpy(w[n]))) for n in tf.jax_order(model)]
    return jm, jax.tree.unflatten(jax.tree.structure(like), leaves)


def _jax_cam(message, monkeypatch):
    monkeypatch.setattr(jax_gui, "read", lambda: message)
    return jax_gui.receive()[0]


def test_frames_match_the_jax_stream(case, ranks, monkeypatch):
    """The JAX ``LiveViewerStream`` on each event's weights: its rows
    against the recorded rows (the decode rule), its composite of the
    recorded rows against the frames, and its own prompt frames; the
    teacher-forced rows against the JAX CLI's ``_tf_pred`` and the frame
    against the JAX composite's pieces run eagerly on them."""
    r = ranks[0]
    handler = JaxHandler(*(jnp.asarray(r[f"handler.{k}"]) for k in ("world_min", "world_max", "scaling_min",
                                                                    "scaling_max")))
    for e, ev in enumerate(_events(r)):
        jm, variables = _jax_variables(ev.w)
        b = js.StackedBatch(**{k: jnp.asarray(v) for k, v in ev.b.items()}, cameras=[], ntokens=0)
        if ev.kind == "teacher_forced":
            out = jm.apply(variables, b.src, b.trg, b.src_mask, b.trg_mask, True)
            jgen = np.asarray(jm.apply(variables, out, method=jax_tf.EncoderDecoder.generator))
            _close(ev.rows, jgen, DECODE_REL * max(1.0, float(np.abs(jgen).max())), "teacher-forced rows")
            cam = _jax_cam(case.messages[FRAME_REQUESTS[(e, None)]], monkeypatch)
            tokens = jnp.concatenate([b.src[0], jnp.asarray(ev.rows[0])], axis=0)
            g = handler.denormalize(jax_codec.unflatten_gaussians(jax_codec.unstack_tokens(tokens, STACK)))
            alive = jnp.repeat(jnp.concatenate([b.src_mask[0, 0], jnp.ones(ev.rows.shape[1], bool)]), 2**STACK)
            ref = jax_render(cam, g.replace(alive=alive), JaxRenderConfig(), scaling_modifier=ev.smod)["render"]
            _close(ev.image, ref, IMAGE_ATOL, "teacher-forced frame")
            continue
        stream = js.LiveViewerStream(jm, handler, JaxRenderConfig(), STACK)
        stream.set_batch(variables, b)
        carry = stream.start()
        for j, f in enumerate(ev.frames):
            cam = _jax_cam(case.messages[FRAME_REQUESTS[(e, j)]], monkeypatch)
            carry = stream.step(carry)
            ref = np.asarray(carry[0])
            _close(f.ys, ref, DECODE_REL * max(1.0, float(np.abs(ref).max())), f"rows of event {e} frame {j}")
            show_prompt, show_pred = f.flags
            _close(f.image, stream.compose(jnp.asarray(f.ys), f.n_valid, cam, f.smod, show_prompt, show_pred),
                   IMAGE_ATOL, f"event {e} frame {j} against the JAX composite of its rows")
            if not show_pred:
                _close(f.image, stream.render(carry, cam, f.smod, show_prompt, show_pred), IMAGE_ATOL,
                       f"event {e} frame {j} (prompt) against the JAX stream's")


def test_a_client_that_leaves_mid_stream_stops_the_stream_on_every_rank(ranks):
    """The last stream ends after the two frames the client read: no rank
    decodes further, and both train the remaining steps."""
    for r in ranks:
        ev = _events(r)[2]
        assert [f.n_valid for f in ev.frames] == [1, 2]
        assert int(ev.b["trg_y"].shape[1]) > 2  # the decode had more tokens to go
        assert len(r["loss"]) == STEPS

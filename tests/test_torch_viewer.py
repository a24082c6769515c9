"""The port's SIBR viewer bridge (viewer/network_gui.py) against the JAX
package's, and the trainers that serve it.

Every socket test binds a free port, found by binding port 0 first (never
the CLIs' default 6009: pytest workers run side by side).

Tolerances: the request's MiniCam matrices 1e-6; the reply bytes of both
``pump``s and both ``pump_stacked``s over a real localhost socket equal
byte for byte; ``training(viewer=True)`` with a client gives the parameters
of ``viewer=False`` bit for bit; ``LiveViewerStream``'s decoded rows within
the cached decode's rule of tests/test_torch_models.py (1e-4 x max(1,
max|ref|)), its frames within the repo's image rule (atol 2e-5) where the
rows are the same (the JAX rows fed to both composites, and the prompt and
target frames, which read no decoded row; the teacher-forced frame against
the JAX composite's pieces run eagerly, see its test)."""

import contextlib
import io
import json
import math
import random
import socket
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from gaussian_transformer_tpu.models import codec as jax_codec
from gaussian_transformer_tpu.models import transformer as jax_tf
from gaussian_transformer_tpu.render import RenderConfig as JaxRenderConfig
from gaussian_transformer_tpu.render import render as jax_render
from gaussian_transformer_tpu.train import stacked as js
from gaussian_transformer_tpu.viewer import network_gui as jax_gui
from gaussian_transformer_tpu_torch.cli import train as cli_train
from gaussian_transformer_tpu_torch.cli import train_autoencoder as cli_ae
from gaussian_transformer_tpu_torch.cli import train_stacked as cli_stacked
from gaussian_transformer_tpu_torch.cli import train_transformer as cli_flat
from gaussian_transformer_tpu_torch.config import OptConfig
from gaussian_transformer_tpu_torch.convert import scene_from_numpy
from gaussian_transformer_tpu_torch.models import transformer as tf
from gaussian_transformer_tpu_torch.render import RenderConfig
from gaussian_transformer_tpu_torch.scene import Scene
from gaussian_transformer_tpu_torch.train import stacked as ps
from gaussian_transformer_tpu_torch.train.optim import PARAM_LEAVES
from gaussian_transformer_tpu_torch.train.splat import training
from gaussian_transformer_tpu_torch.viewer import network_gui as gui

from tests.test_train import _synthetic_scene_and_cams
from tests.torch_port_support import torch_camera, torch_scene

IMAGE_ATOL = 2e-5
DECODE_REL = 1e-4
STACK = 2
D = ps.stacked_token_dim(STACK)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def request(width, height, view, proj, train=True, keep_alive=False, smod=1.0, shs_python=False,
            fov=(1.0, 0.8)) -> bytes:
    """One SIBR request: a 4-byte little-endian length, then the JSON."""
    msg = {
        "resolution_x": width, "resolution_y": height, "train": train, "fov_y": fov[1], "fov_x": fov[0],
        "z_near": 0.01, "z_far": 100.0, "shs_python": shs_python, "rot_scale_python": False,
        "keep_alive": keep_alive, "scaling_modifier": smod,
        "view_matrix": [float(v) for v in np.asarray(view).ravel()],
        "view_projection_matrix": [float(v) for v in np.asarray(proj).ravel()],
    }
    payload = json.dumps(msg).encode()
    return len(payload).to_bytes(4, "little") + payload


def wire_matrices(cam):
    """The view and projection matrices a client sends for ``cam``: the
    protocol's flips undone (``receive`` flips them back)."""
    view = np.array(cam.world_view_transform.detach().cpu().numpy(), np.float32)
    proj = np.array(cam.full_proj_transform.detach().cpu().numpy(), np.float32)
    view[:, 1:3] *= -1
    proj[:, 1] *= -1
    return view, proj


def recv_exact(s, n) -> bytes:
    out = b""
    while len(out) < n:
        chunk = s.recv(n - len(out))
        assert chunk, "connection closed mid-reply"
        out += chunk
    return out


def recv_reply(s, image_bytes):
    img = recv_exact(s, image_bytes)
    n = int.from_bytes(recv_exact(s, 4), "little")
    return img, recv_exact(s, n).decode("ascii")


def serve(module, tick, script, timeout=60.0):
    """Bind ``module`` on a free port; a client thread connects and runs
    ``script(sock)`` (which returns its record), while the main thread calls
    ``tick()`` until the client is done. Returns the client's record."""
    port = free_port()
    module.init("127.0.0.1", port)
    result, errors = {}, []

    def client():
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
                result["out"] = script(s)
        except Exception as e:  # reported by the main thread
            errors.append(e)

    th = threading.Thread(target=client)
    th.start()
    deadline = time.time() + timeout
    try:
        while th.is_alive() and time.time() < deadline:
            tick()
            time.sleep(0.005)
    finally:
        th.join(timeout=10)
        module.conn = None
        module.listener.close()
    assert not errors, errors
    assert "out" in result, "the client did not finish"
    return result["out"]


# ------------------------------------------------------------------- wire ---


def test_receive_builds_the_jax_minicam():
    """The same request bytes into both packages' ``receive``: the same
    flags, and MiniCam matrices and centre within 1e-6."""
    rng = np.random.RandomState(0)
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
    view[3, :3] = rng.randn(3)
    proj = rng.randn(4, 4).astype(np.float32)
    req = request(40, 24, view, proj, train=False, keep_alive=True, smod=0.5, shs_python=True)
    got = {}
    for name, module, kw in (("jax", jax_gui, {}), ("torch", gui, {"device": "cpu"})):
        a, b = socket.socketpair()
        try:
            b.sendall(req)
            module.conn = a
            got[name] = module.receive(**kw)
        finally:
            module.conn = None
            a.close()
            b.close()
    jcam, *jflags = got["jax"]
    tcam, *tflags = got["torch"]
    assert tflags == jflags == [False, True, False, True, 0.5]
    assert (tcam.image_width, tcam.image_height) == (jcam.image_width, jcam.image_height) == (40, 24)
    assert (tcam.fovx, tcam.fovy, tcam.znear, tcam.zfar) == (jcam.fovx, jcam.fovy, jcam.znear, jcam.zfar)
    for field in ("world_view_transform", "full_proj_transform", "camera_center"):
        t = getattr(tcam, field)
        assert t.device.type == "cpu" and t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(getattr(jcam, field)), rtol=0, atol=1e-6, err_msg=field)
    # The protocol's flips: the view matrix's Y and Z columns, the projection's Y.
    flipped = view.copy()
    flipped[:, 1:3] *= -1
    np.testing.assert_array_equal(tcam.world_view_transform.numpy(), flipped)


def test_zero_resolution_request_gives_no_camera():
    a, b = socket.socketpair()
    try:
        b.sendall(request(0, 0, np.eye(4), np.eye(4)))
        gui.conn = a
        assert gui.receive(device="cpu") == (None,) * 6
    finally:
        gui.conn = None
        a.close()
        b.close()


def test_image_to_bytes_is_numpy_truncation():
    """The bytes equal numpy's ``(clip(a, 0, 1) * 255).astype(uint8)`` in
    HWC order, at values just below each level too."""
    rng = np.random.RandomState(1)
    img = rng.uniform(-0.3, 1.3, (3, 17, 23)).astype(np.float32)
    img[0, 0, :10] = np.nextafter(np.arange(1, 11, dtype=np.float32) / 255, np.float32(0))
    ref = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8).transpose(1, 2, 0)
    got = gui.image_to_bytes(torch.from_numpy(img))
    assert bytes(got) == np.ascontiguousarray(ref).tobytes() == bytes(jax_gui.image_to_bytes(img))


@pytest.mark.parametrize("keep_alive", [False, True])
def test_pump_replies_equal_the_jax_pump_byte_for_byte(keep_alive):
    """One client script against both packages' ``pump`` over a real
    localhost socket: the image bytes and the verify string are equal byte
    for byte; ``keep_alive`` serves several requests in one tick, and a
    zero-resolution request gets the verify string alone."""
    H, W = 9, 14
    img = np.random.RandomState(2).uniform(-0.1, 1.1, (3, H, W)).astype(np.float32)
    view, proj = np.eye(4), np.eye(4)

    def script(s):
        out = []
        for i, smod in enumerate((1.0, 0.5, 0.25)):
            last = i == 2
            s.sendall(request(W, H, view, proj, train=last, keep_alive=keep_alive, smod=smod))
            out.append(recv_reply(s, H * W * 3))
        s.sendall(request(0, 0, view, proj, train=True))
        out.append(recv_reply(s, 0))
        return out

    replies, smods = {}, {}
    for name, module, image, kw in (("jax", jax_gui, jnp.asarray(img), {}),
                                    ("torch", gui, torch.from_numpy(img), {"device": "cpu"})):
        seen = smods.setdefault(name, [])

        def render_fn(cam, smod, image=image, seen=seen):
            seen.append((cam.image_width, cam.image_height, smod))
            return image

        replies[name] = serve(module, lambda: module.pump(render_fn, source_path="/scene/path", **kw), script)
    assert replies["torch"] == replies["jax"]
    assert smods["torch"] == smods["jax"] == [(W, H, 1.0), (W, H, 0.5), (W, H, 0.25)]
    ref = np.ascontiguousarray((np.clip(img, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)).tobytes()
    assert [r for r, _ in replies["torch"][:3]] == [ref] * 3
    assert replies["torch"][3] == (b"", "/scene/path")
    assert all(v == "/scene/path" for _, v in replies["torch"])


class StepStream:
    """A stand-in for LiveViewerStream: frame k's pixels encode k."""

    n_steps = 4

    def __init__(self, h, w):
        self.h, self.w = h, w

    def decoding(self):
        return contextlib.nullcontext()

    def start(self):
        return 0

    def step(self, carry):
        return carry + 1

    def render(self, carry, cam, smod, show_prompt, show_pred):
        base = carry / 255.0 + (0.5 if show_prompt else 0.0) + (0.25 if show_pred else 0.0)
        return np.full((3, self.h, self.w), base, np.float32)


def test_pump_stacked_streams_and_is_interrupted_like_the_jax_one():
    """``pump_stacked``: a train=False request streams one frame per decode
    step, a request read between steps; train=True mid-stream stops the
    stream and returns to training; the repurposed slots (``shs_python`` =
    show_pred, ``keep_alive`` = show_prompt) reach the renders. Both
    packages' replies are equal byte for byte."""
    H, W = 5, 7
    view, proj = np.eye(4), np.eye(4)

    def script(s):
        out = []
        s.sendall(request(W, H, view, proj, train=False, keep_alive=True, shs_python=False))
        out.append(recv_reply(s, H * W * 3))  # step 1
        s.sendall(request(W, H, view, proj, train=False, keep_alive=False, shs_python=True))
        out.append(recv_reply(s, H * W * 3))  # step 2
        s.sendall(request(W, H, view, proj, train=True))  # interrupt mid-stream
        out.append(recv_reply(s, H * W * 3))  # the last frame again; back to training
        s.sendall(request(W, H, view, proj, train=True, keep_alive=True, shs_python=True))
        out.append(recv_reply(s, H * W * 3))  # a train-mode tick: the teacher-forced image
        return out

    train_image = np.full((3, H, W), 200 / 255.0, np.float32)
    replies, ticks = {}, {}
    for name, module, kw in (("jax", jax_gui, {}), ("torch", gui, {"device": "cpu"})):
        calls = ticks.setdefault(name, [])

        def train_fn(cam, smod, show_prompt, show_pred, calls=calls):
            calls.append((show_prompt, show_pred))
            return train_image

        replies[name] = serve(module, lambda: module.pump_stacked(train_fn, StepStream(H, W), "/s", **kw), script)
    assert replies["torch"] == replies["jax"]
    level = lambda v: int((np.clip(np.float32(v), 0, 1) * 255).astype(np.uint8))
    first = [r[0][0] for r in replies["torch"]]
    # Step 1 with show_prompt, step 2 with show_pred, step 2 again as the
    # stream stops, then the teacher-forced image.
    step1, step2 = level(np.float32(1 / 255.0 + 0.5)), level(np.float32(2 / 255.0 + 0.25))
    assert first == [step1, step2, step2, level(train_image[0, 0, 0])], first
    assert ticks["torch"] == ticks["jax"] == [(True, True)]


def test_pump_stacked_raises_what_the_stream_raises():
    """A decode that raises is raised by the tick, as it is on every rank of
    a group (``pump_stacked(..., group=)``): it is not taken for a socket
    error, and the connection stays up."""
    H, W = 5, 7

    class Failing(StepStream):
        def step(self, carry):
            raise RuntimeError("decode failed")

    port = free_port()
    gui.init("127.0.0.1", port)
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(request(W, H, np.eye(4), np.eye(4), train=False, keep_alive=True))
            deadline = time.time() + 10
            while gui.conn is None and time.time() < deadline:
                gui.try_connect()
            with pytest.raises(RuntimeError, match="decode failed"):
                gui.pump_stacked(lambda *a: None, Failing(H, W), "/s", device="cpu")
            assert gui.conn is not None
    finally:
        gui.conn = None
        gui.listener.close()


def test_pump_without_a_client_is_one_accept():
    """A bound listener with no client: the pump returns at once and calls
    nothing."""
    gui.init("127.0.0.1", free_port())
    try:
        called = []
        t0 = time.perf_counter()
        for _ in range(100):
            gui.pump(lambda cam, smod: called.append(1), device="cpu")
        assert not called and gui.conn is None
        assert time.perf_counter() - t0 < 1.0
    finally:
        gui.listener.close()


# ------------------------------------------------------ 3DGS training ----

W3, H3 = 48, 32


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("viewer_data")
    scene = scene_from_numpy(chip_smoke.synthetic_scene(2000, 0), 3, "cpu")
    chip_smoke.write_train_dataset(root / "data", scene, chip_smoke.surface_points(600, 3), 3, 1, W3, H3,
                                   math.radians(50.0), torch.device("cpu"))
    return root


def _scene(root, name):
    random.seed(0)  # Scene shuffles its cameras with Python's random
    ns = types.SimpleNamespace(sh_degree=3, source_path=str(root / "data"), model_path=str(root / name),
                               images="images", resolution=1, white_background=False, eval=True)
    return Scene(ns, sh_degree=3, device="cpu")


def test_training_with_a_viewer_trains_as_without(dataset):
    """``training(viewer=True)`` with a client attached that asks for frames
    (scaling modifiers 1 and 0.5) trains to the same parameters, bit for
    bit, as ``viewer=False``; the random background draws from the
    trainer's generator, so a viewer that touched it would show here."""
    opt = OptConfig(iterations=12, random_background=True, densify_from_iter=4, densification_interval=4,
                    densify_until_iter=11)
    ref = training(_scene(dataset, "off"), opt, RenderConfig(), seed=3)

    scene = _scene(dataset, "on")
    cam = scene.get_train_cameras()[0]
    view, proj = wire_matrices(cam)
    n_frames = 8
    frames = []

    def client(s):
        # Closing the socket after the last frame ends the service: the
        # next pump reads an empty request and drops the connection.
        with s:
            for i in range(n_frames):
                s.sendall(request(W3, H3, view, proj, train=True, smod=(1.0, 0.5)[i % 2],
                                  fov=(cam.FoVx, cam.FoVy)))
                frames.append(recv_reply(s, W3 * H3 * 3))

    port = free_port()
    gui.init("127.0.0.1", port)
    try:
        th = threading.Thread(target=client, args=(socket.create_connection(("127.0.0.1", port), timeout=60),))
        th.start()
        got = training(scene, opt, RenderConfig(), seed=3, viewer=True)
        th.join(timeout=60)
    finally:
        gui.conn = None
        gui.listener.close()
    assert len(frames) == n_frames
    assert all(len(img) == W3 * H3 * 3 and verify == str(dataset / "data") for img, verify in frames)
    assert frames[0][0] != frames[1][0]  # the two scaling modifiers render differently
    assert got.capacity == ref.capacity and torch.equal(got.alive, ref.alive)
    for k in PARAM_LEAVES:
        assert torch.equal(getattr(got, k), getattr(ref, k)), k


# ---------------------------------------------------- the stacked stream ---


@pytest.fixture(scope="module")
def stacked():
    """Both TrainingScenes of one scene, a STACK 2 model in both packages
    (the weights through ``params_from_jax``), their first batches and
    cameras."""
    scene, cams = _synthetic_scene_and_cams(n=128, n_cams=4, width=48, height=32, seed=11)
    jts = js.TrainingScene(types.SimpleNamespace(gaussians=scene, get_train_cameras=lambda scale=1.0: cams),
                           JaxRenderConfig(), batch_size=2, stack=STACK, bucket=4)
    tcams = [torch_camera(c) for c in cams]
    pts = ps.TrainingScene(types.SimpleNamespace(gaussians=torch_scene(scene), get_train_cameras=lambda: tcams),
                           RenderConfig(), batch_size=2, stack=STACK, bucket=4)
    for t in (jts, pts):
        t.set_epoch(1000)
        t.rng = np.random.RandomState(3)
    jb, tb = jts.make_batch([0, 1]), pts.make_batch([0, 1])
    jm = jax_tf.make_model(STACK, D, D, N=1, d_model=D, dropout=0.1)
    variables = jax_tf.init_model(jm, jax.random.PRNGKey(0))
    tm = tf.make_model(STACK, D, D, N=1, d_model=D, dropout=0.1, device="cpu")
    tm.load_state_dict(tf.params_from_jax(jax.tree.map(np.asarray, variables)))
    jstream = js.LiveViewerStream(jm, jts.handler, JaxRenderConfig(), STACK)
    jstream.set_batch(variables, jb)
    tstream = ps.LiveViewerStream(tm, pts.handler, RenderConfig(), STACK)
    tstream.set_batch(tb)
    return types.SimpleNamespace(jts=jts, pts=pts, jstream=jstream, tstream=tstream, cams=cams, tcams=tcams, jm=jm,
                                 variables=variables, tm=tm, jb=jb, tb=tb)


def _close(got, ref, atol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.all(np.isfinite(got)), what
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=what)


def test_live_stream_matches_the_jax_stream(stacked):
    """Each step's decoded rows within the cached decode's rule; the frames
    of every flag pair at smod 1 and 0.7 within 2e-5 on the JAX rows."""
    st = stacked
    assert st.tstream.n_steps == st.jstream.n_steps == st.tb.trg_y.shape[1]
    jc, tc = st.jstream.start(), st.tstream.start()
    _close(tc[0], jc[0], 0, "START row and zero tail")
    for _ in range(st.tstream.n_steps):
        jc, tc = st.jstream.step(jc), st.tstream.step(tc)
        assert tc[2] == jc[2]
        ref = np.asarray(jc[0])
        _close(tc[0], ref, DECODE_REL * max(1.0, float(np.abs(ref).max())), f"rows after step {tc[2]}")
    ys = torch.from_numpy(np.array(jc[0]))
    for smod in (1.0, 0.7):
        for show_prompt, show_pred in ((False, False), (True, False), (False, True), (True, True)):
            for n_valid in (1, st.tstream.n_steps):
                ref = st.jstream.compose(jc[0], n_valid, st.cams[1], smod, show_prompt, show_pred)
                got = st.tstream.compose(ys, n_valid, st.tcams[1], smod, show_prompt, show_pred)
                _close(got, ref, IMAGE_ATOL, f"frame smod {smod} prompt {show_prompt} pred {show_pred} "
                                             f"rows 0..{n_valid}")
    # The stream's own frames are compose() of its own carry.
    frame = st.tstream.render(tc, st.tcams[0], 1.0, True, True)
    assert torch.equal(frame, st.tstream.compose(tc[0], tc[2], st.tcams[0], 1.0, True, True))


def test_teacher_forced_frame_matches_jax_and_restores_train_mode(stacked):
    """``make_viewer_train_fn``: the JAX CLI's deterministic teacher-forced
    rows (the decode rule), their composite (2e-5 on the JAX rows), and the
    model's train/eval mode as it was."""
    st = stacked
    fn = ps.make_viewer_train_fn(st.tstream)
    b = st.jb
    out = st.jm.apply(st.variables, b.src, b.trg, b.src_mask, b.trg_mask, True)
    jgen = st.jm.apply(st.variables, out, method=jax_tf.EncoderDecoder.generator)
    for mode in (True, False):
        st.tm.train(mode)
        frame = fn(st.tcams[2], 1.0, False, True)
        assert st.tm.training is mode
    with torch.no_grad():
        tgen = st.tm.generator(st.tm.decode(st.tm.encode(st.tb.src, st.tb.src_mask), st.tb.src_mask,
                                            st.tb.trg, st.tb.trg_mask))
    _close(tgen, jgen, DECODE_REL * max(1.0, float(np.abs(np.asarray(jgen)).max())), "teacher-forced rows")
    assert torch.equal(frame, st.tstream.compose(tgen, tgen.shape[1], st.tcams[2], 1.0, False, True))
    # The JAX composite's pieces, run eagerly: these decoded Gaussians are
    # ill-conditioned enough that the JAX stream's jitted composite moves
    # by ~4e-5 from its own eager render, so the image rule is held to the
    # eager one.
    tokens = jnp.concatenate([b.src[0], jgen[0]], axis=0)
    g = st.jts.handler.denormalize(jax_codec.unflatten_gaussians(jax_codec.unstack_tokens(tokens, STACK)))
    alive = jnp.repeat(jnp.concatenate([jnp.zeros(b.src.shape[1], bool), jnp.ones(jgen.shape[1], bool)]), 2**STACK)
    ref = jax_render(st.cams[2], g.replace(alive=alive), JaxRenderConfig(), scaling_modifier=1.0)["render"]
    got = st.tstream.compose(torch.from_numpy(np.array(jgen)), jgen.shape[1], st.tcams[2], 1.0, False, True)
    _close(got, ref, IMAGE_ATOL, "teacher-forced frame")
    assert ps.make_viewer_train_fn(ps.LiveViewerStream(st.tm, None, RenderConfig(), STACK))(
        st.tcams[0], 1.0, True, True) is None


def test_pump_stacked_serves_the_live_stream_as_the_jax_one(stacked):
    """The real streams behind both ``pump_stacked``s over localhost: one
    frame per decode step, then the last again when train=True arrives;
    the prompt frames of both packages within one level (the renders agree
    to float noise, which can move a value across a truncation edge)."""
    st = stacked
    cam = st.tcams[3]
    view, proj = wire_matrices(cam)
    W, H = cam.image_width, cam.image_height

    def script(s):
        # show_prompt only: the prompt's rows are the same in both packages.
        out = []
        for _ in range(st.tstream.n_steps):
            s.sendall(request(W, H, view, proj, train=False, keep_alive=True, shs_python=False,
                              fov=(cam.FoVx, cam.FoVy)))
            out.append(recv_reply(s, W * H * 3))
        s.sendall(request(W, H, view, proj, train=True, fov=(cam.FoVx, cam.FoVy)))
        out.append(recv_reply(s, W * H * 3))
        return out

    replies = {}
    for name, module, stream, kw in (("jax", jax_gui, st.jstream, {}),
                                     ("torch", gui, st.tstream, {"device": "cpu"})):
        replies[name] = serve(module, lambda: module.pump_stacked(lambda *a: None, stream, "/s", **kw), script)
    assert len(replies["torch"]) == st.tstream.n_steps + 1
    for (tb_, tv), (jb_, jv) in zip(replies["torch"], replies["jax"]):
        assert tv == jv == "/s"
        diff = np.abs(np.frombuffer(tb_, np.uint8).astype(int) - np.frombuffer(jb_, np.uint8).astype(int))
        assert diff.max() <= 1, diff.max()  # one level where a value sits at a truncation edge


# ------------------------------------------------------------ CLI binds ---

class _Stop(Exception):
    pass


CLIS = {"train": cli_train, "train_stacked": cli_stacked, "train_autoencoder": cli_ae,
        "train_transformer": cli_flat}


@pytest.mark.parametrize("taken", [False, True], ids=["free", "taken"])
@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_binds_the_listener_or_disables_the_viewer(name, taken, tmp_path, monkeypatch):
    """Each trainer CLI binds ``--ip``/``--port`` before it loads its scene;
    when the address is taken it prints ``viewer disabled`` and goes on."""
    cli = CLIS[name]
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)

    def stop(*a, **k):
        raise _Stop

    monkeypatch.setattr(cli, "Scene", stop)
    port = free_port()
    blocker = None
    if taken:
        blocker = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        blocker.bind(("127.0.0.1", port))
        blocker.listen()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out), pytest.raises(_Stop):
            cli.main(["-s", str(tmp_path / "data"), "-m", str(tmp_path / "model"), "--ip", "127.0.0.1",
                      "--port", str(port), "--device", "cpu"])
        if taken:
            assert "viewer disabled" in out.getvalue()
        else:
            assert "viewer disabled" not in out.getvalue()
            assert gui.listener.getsockname() == ("127.0.0.1", port)
    finally:
        gui.listener.close()
        if blocker is not None:
            blocker.close()

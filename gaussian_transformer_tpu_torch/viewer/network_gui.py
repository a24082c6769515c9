"""SIBR remote-viewer TCP bridge (port of
``gaussian_transformer_tpu/viewer/network_gui.py``).

The wire format is the reference's, byte for byte, so the external SIBR C++
viewer keeps working: a non-blocking listener; a request is a 4-byte
little-endian length and a JSON object carrying the resolution, the train
flag, the FoVs, znear/zfar, the python-path toggles, keep_alive, the
scaling modifier and the view and view-projection matrices (the view
matrix's Y and Z columns and the projection's Y column negated); the reply
is the raw HWC uint8 RGB bytes, then a 4-byte little-endian length and the
ASCII source path.

``receive`` builds the request's ``MiniCam`` on ``device`` (the device of
the caller's Gaussians). ``image_to_bytes`` converts a [3, H, W] render to
uint8 where it lies and copies only the bytes to the host (at 1080p 6.2 MB
in place of 24.9 MB of float32).

``pump_stacked(..., group=)`` serves one viewer from every rank of a
``torch.distributed`` group (the stacked trainer under FSDP2, where each
forward is a collective) through the one loop that serves a single
process: rank 0 alone owns the socket, reads each request and shares it
(``share``) before any rank computes, every rank runs the same calls in
the same order, and rank 0 alone sends. A socket error on rank 0 drops
the connection and ends the tick on every rank.
"""

from __future__ import annotations

import json
import socket
import traceback

import numpy as np
import torch

from gaussian_transformer_tpu_torch.scene.cameras import MiniCam
from gaussian_transformer_tpu_torch.utils.profiling import span

host = "127.0.0.1"
port = 6009

conn = None
addr = None

listener = None  # the bound socket, from init() on


def init(wish_host: str, wish_port: int) -> None:
    """Bind the non-blocking listener. Re-initializable: an already-bound
    listener is replaced, so trainers (and tests) can rebind. Raises
    ``OSError`` when the address is taken."""
    global host, port, listener
    host = wish_host
    port = wish_port
    if listener is not None:
        listener.close()
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        listener.bind((host, port))
    except OSError:
        listener.close()
        raise
    listener.listen()
    listener.settimeout(0)


def bind_viewer(wish_host: str, wish_port: int) -> bool:
    """``init`` for the CLIs: True once bound; when the address is taken
    (another run, a parallel test) prints ``viewer disabled: ...`` and
    returns False, and the caller trains without the viewer."""
    try:
        init(wish_host, wish_port)
        return True
    except OSError as e:
        print(f"viewer disabled: {e}")
        return False


def try_connect() -> None:
    """Accept a pending client, if any (one non-blocking ``accept``; nothing
    before ``init``)."""
    global conn, addr, listener
    try:
        conn, addr = listener.accept()
        print(f"\nConnected by {addr}")
        conn.settimeout(None)
    except Exception:
        pass


def read():
    global conn
    message_length = conn.recv(4)
    message_length = int.from_bytes(message_length, "little")
    message = conn.recv(message_length)
    return json.loads(message.decode("utf-8"))


def send(message_bytes, verify: str) -> None:
    global conn
    if message_bytes is not None:
        conn.sendall(message_bytes)
    conn.sendall(len(verify).to_bytes(4, "little"))
    conn.sendall(bytes(verify, "ascii"))


def receive(device=None):
    """Read one request and parse it into (MiniCam on ``device``, train,
    shs_python, rot_scale_python, keep_alive, scaling_modifier); all None
    for a request of zero resolution."""
    return parse(read(), device)


def parse(message: dict, device=None):
    """``receive``'s parse of one request's JSON object."""
    width = message["resolution_x"]
    height = message["resolution_y"]

    if width != 0 and height != 0:
        try:
            do_training = bool(message["train"])
            fovy = message["fov_y"]
            fovx = message["fov_x"]
            znear = message["z_near"]
            zfar = message["z_far"]
            do_shs_python = bool(message["shs_python"])
            do_rot_scale_python = bool(message["rot_scale_python"])
            keep_alive = bool(message["keep_alive"])
            scaling_modifier = message["scaling_modifier"]
            world_view_transform = np.reshape(
                np.asarray(message["view_matrix"], dtype=np.float32), (4, 4)
            )
            world_view_transform[:, 1] = -world_view_transform[:, 1]
            world_view_transform[:, 2] = -world_view_transform[:, 2]
            full_proj_transform = np.reshape(
                np.asarray(message["view_projection_matrix"], dtype=np.float32), (4, 4)
            )
            full_proj_transform[:, 1] = -full_proj_transform[:, 1]
            custom_cam = MiniCam.create(
                width, height, fovy, fovx, znear, zfar, world_view_transform, full_proj_transform,
                device=device,
            )
        except Exception as e:
            print("")
            traceback.print_exc()
            raise e
        return custom_cam, do_training, do_shs_python, do_rot_scale_python, keep_alive, scaling_modifier
    else:
        return None, None, None, None, None, None


def image_to_bytes(image) -> memoryview:
    """[3, H, W] float render -> the protocol's raw HWC uint8 buffer:
    ``(clip(image, 0, 1) * 255)`` truncated, as numpy's ``astype(uint8)``
    does. The conversion runs where the tensor lies; one copy of the uint8
    bytes reaches the host (the span ``frame.bytes``, where the host waits
    for the frame's device work)."""
    with span("frame.bytes"):
        img = torch.as_tensor(image)
        arr = (img.clamp(0.0, 1.0) * 255).to(torch.uint8).permute(1, 2, 0).contiguous()
        return memoryview(arr.cpu().numpy())


def pump_stacked(render_train_fn, stream, source_path: str = "", device=None, group=None) -> None:
    """One stacked-trainer viewer tick. The stacked protocol repurposes two
    request slots: ``shs_python`` carries show_pred and ``keep_alive``
    carries show_prompt.

    ``render_train_fn(cam, smod, show_prompt, show_pred) -> image | None``:
    the teacher-forced composite served while training continues
    (train=True).

    ``stream``: None, or an object with ``.decoding()`` (a context for the
    decode), ``.start() -> carry``, ``.step(carry) -> carry``,
    ``.render(carry, cam, smod, show_prompt, show_pred) -> image`` and
    ``.n_steps``. When the viewer pauses training (train=False) the decode
    runs live: each step's partial reconstruction is rendered and sent at
    once, and a request is read between steps so the viewer can interrupt.
    The tick returns to training as soon as the viewer asks for train=True.

    ``group``: every rank of this ``torch.distributed`` group calls the
    tick; rank 0 alone owns the socket, and each request is shared with
    every rank (``share``) before any rank computes, so all ranks make the
    same calls in the same order; rank 0 alone sends. None: this process
    alone. A socket error, or a request that does not parse, drops the
    connection and ends the tick (on every rank); an error of
    ``render_train_fn`` or ``stream`` is raised."""
    import torch.distributed as dist

    lead = group is None or dist.get_rank(group) == 0
    if lead and conn is None:
        try_connect()

    def next_request():
        message = _next_request() if lead else None
        return message if group is None else share(message, group)

    while True:
        message = next_request()
        if message is None:
            return
        net_image_bytes = None
        cam, do_training, show_pred, _, show_prompt, smod = parse(message, device)
        if cam is not None and (do_training or stream is None or stream.n_steps == 0):
            image = render_train_fn(cam, smod, show_prompt, show_pred)
            if image is not None and lead:
                net_image_bytes = image_to_bytes(image)
        elif cam is not None:
            with stream.decoding():
                carry = stream.start()
                for _ in range(stream.n_steps):
                    carry = stream.step(carry)
                    image = stream.render(carry, cam, smod, show_prompt, show_pred)
                    if lead:
                        net_image_bytes = image_to_bytes(image)
                        _reply(net_image_bytes, source_path)
                    message = next_request()
                    if message is None:
                        return
                    cam, do_training, show_pred, _, show_prompt, smod = parse(message, device)
                    if cam is None or do_training:
                        break
        if lead:
            _reply(net_image_bytes, source_path)
        if do_training:
            return


def share(obj, group):
    """``obj`` of rank 0 of ``group`` on every rank of it (a collective)."""
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
    return box[0]


def _next_request():
    """The next request as its JSON object, or None: no connection, or a
    read or a parse that failed (the connection is dropped)."""
    global conn
    if conn is None:
        return None
    try:
        message = read()
        parse(message, "cpu")  # checked on the host: a request that does not parse is never served
        return message
    except Exception:
        conn = None
        return None


def _reply(message_bytes, verify: str) -> None:
    """``send``; a failure drops the connection."""
    global conn
    if conn is None:
        return
    try:
        send(message_bytes, verify)
    except Exception:
        conn = None


def pump(render_fn, source_path: str = "", keep_alive_default: bool = False, device=None) -> None:
    """One viewer service tick of the 3DGS trainer: accept a pending
    connection, then serve requests until the client asks to train, lets
    keep_alive drop or errors. ``render_fn(custom_cam, scaling_modifier) ->
    [3, H, W] image or None``; the camera lies on ``device``.
    ``keep_alive_default`` is the JAX signature's, and unused there too."""
    global conn
    if conn is None:
        try_connect()
    while conn is not None:
        try:
            net_image_bytes = None
            custom_cam, do_training, _, _, keep_alive, scaling_modifier = receive(device)
            if custom_cam is not None:
                image = render_fn(custom_cam, scaling_modifier)
                if image is not None:
                    net_image_bytes = image_to_bytes(image)
            send(net_image_bytes, source_path)
            if do_training or not keep_alive:
                break
        except Exception:
            conn = None

"""Faults planted in the port's timed path, for the readings that bound the
correctness limits from above (``calibrate.py --fault``, at a cell's own
size on the card) and for the tests that see ``correct`` come out false
(``tests/test_perfbench_faults.py``, at a tiny size on the CPU). Each takes
a patcher with ``setattr(obj, name, value)`` (pytest's ``monkeypatch``, or
``Patcher`` below). No cell spans chips, so none can leave out an exchange
between them."""

import torch


class Patcher:
    """``monkeypatch.setattr`` and ``undo`` outside pytest."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self.saved:
            obj, name, value = self.saved.pop()
            setattr(obj, name, value)


def state_unchanged_splat(mp):
    """Adam returns the scene and its state as they came."""
    from gaussian_transformer_tpu_torch.train import splat

    mp.setattr(splat, "adam_step", lambda scene, grads, state, lrs: (scene, state))


def half_batch_splat(mp):
    """The L1 term over the left half of the image alone."""
    from gaussian_transformer_tpu_torch.train import splat

    mp.setattr(splat, "l1_loss", lambda a, b: torch.mean(torch.abs(a - b)[..., : a.shape[-1] // 2]))


def instances_dropped_splat(mp):
    """The trainer's render budget cut to 1,024 instances, so that its
    renders drop what lies past it."""
    from gaussian_transformer_tpu_torch.train import splat

    mp.setattr(splat, "tuned_config", lambda cfg, gaussians, camera, bg: cfg.replace(max_instances=1024))


def state_unchanged_stacked(mp):
    """The optimizer's step does nothing."""
    from gaussian_transformer_tpu_torch.train import stacked

    class Frozen(torch.optim.Adam):
        def step(self, closure=None):
            return None

    mp.setattr(stacked, "make_optimizer", lambda model, lr=5e-4: Frozen(model.parameters(), lr=lr, eps=1e-4))


def half_batch_stacked(mp):
    """Chamfer over the first half of the target and prediction rows."""
    from gaussian_transformer_tpu_torch.train import stacked

    original = stacked.chamfer_distance

    def half(a, b, a_valid=None, b_valid=None, block=512):
        keep = torch.arange(a.shape[1], device=a.device) < a.shape[1] // 2
        return original(a, b, a_valid=a_valid & keep, b_valid=b_valid & keep, block=block)

    mp.setattr(stacked, "chamfer_distance", half)


def camera_missing_stacked(mp):
    """A batch made from all but the last of its cameras' visibility, while
    it still names them all."""
    import dataclasses

    from gaussian_transformer_tpu_torch.train import stacked

    original = stacked.TrainingScene.make_batch

    def missing(self, cam_idxs):
        b = original(self, list(cam_idxs)[:-1])
        return None if b is None else dataclasses.replace(b, cameras=[self.cameras[i] for i in cam_idxs])

    mp.setattr(stacked.TrainingScene, "make_batch", missing)


def frame_altered(mp):
    """A 16 x 16 corner of every served frame's bytes flipped in bit 6."""
    import numpy as np

    from gaussian_transformer_tpu_torch.viewer import network_gui

    original = network_gui.image_to_bytes

    def altered(image):
        arr = np.array(original(image))
        arr[:16, :16] ^= 0x40
        return memoryview(arr)

    mp.setattr(network_gui, "image_to_bytes", altered)


FAULTS = {
    "splat_train": {"state_unchanged": state_unchanged_splat, "half_batch": half_batch_splat,
                    "instances_dropped": instances_dropped_splat},
    "splat_serve": {"frame_altered": frame_altered},
    "stacked_train": {"state_unchanged": state_unchanged_stacked, "half_batch": half_batch_stacked,
                      "camera_missing": camera_missing_stacked},
}

"""Snapshots of training state: atomic, bounded in number, written by a
background thread (port of ``gaussian_transformer_tpu/train/orbax_ckpt.py``).

The card's machine has no Orbax, so a snapshot is one ``torch.save`` file of
the state tree (nested dicts, lists and tuples of tensors and plain values),
with every tensor copied to the host first. The layout under a run dir:

    <run_dir>/orbax/<step>/state.pt       a finished snapshot
    <run_dir>/orbax/.tmp-<step>-<id>/     one being written

The guarantees are the JAX layer's:
  * atomic: a snapshot is written into a temporary directory, then renamed
    to ``<step>`` (``os.replace``); a temporary one left by a killed run is
    never restored, and the next manager over the dir removes it;
  * bounded history: the newest ``max_to_keep`` snapshots are kept;
  * asynchronous: ``save`` copies the tensors to the host and returns; a
    writer thread serialises them, one snapshot at a time, and
    ``wait_until_finished`` joins it (raising what a write raised);
  * resume across shape changes: ``restore_raw`` returns the shapes the
    snapshot holds, not the live state's (the splat trainer's capacity grows).

A dir written by the JAX package (Orbax's own format) is refused with an
error, never read as empty.

Usage:
    mgr = make_manager(run_dir, max_to_keep=3)
    save(mgr, step, {"params": params, "opt_state": opt_state})  # async
    restored = restore(mgr, {"params": params, "opt_state": opt_state})
    mgr.wait_until_finished()   # before exiting
"""

from __future__ import annotations

import os
import shutil
import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, List, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

STATE_FILE = "state.pt"
TMP_PREFIX = ".tmp-"


def available() -> bool:
    """Always true: the layer needs only ``torch.save`` (the JAX layer's
    ``available`` asks whether Orbax imports)."""
    return True


def _to_host(tree: Any) -> Any:
    """The tree with every tensor (and numpy array) as a CPU tensor copy. A
    DTensor raises: its local shard is not the tensor (``save_state``
    gathers it)."""
    if isinstance(tree, DTensor):
        raise TypeError("a DTensor in a snapshot tree: only this rank's shard would be saved; "
                        "save a sharded module with save_state, which gathers every shard whole")
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class SnapshotManager:
    """Snapshots under ``<root>`` (a run dir's ``orbax/``): the steps on
    disk, one writer thread, and the history bound."""

    def __init__(self, root: str, max_to_keep: int = 3, async_save: bool = True):
        self.root = root
        self.max_to_keep = max_to_keep
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: List[Future] = []
        self._pending_steps: set = set()
        self.write_s: dict = {}  # step -> seconds its write took (the writer thread's clock)
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="snapshot") if async_save else None
        for name in os.listdir(root):
            if name.startswith(TMP_PREFIX):  # torn by a killed run
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)
        self._scan()

    def _scan(self) -> List[int]:
        """The finished snapshots' steps, ascending; raises on anything in
        the dir that is not one of this layer's snapshots."""
        steps = []
        for name in os.listdir(self.root):
            if name.startswith(TMP_PREFIX):
                continue
            path = os.path.join(self.root, name)
            if name.isdigit() and os.path.isfile(os.path.join(path, STATE_FILE)):
                steps.append(int(name))
                continue
            raise ValueError(
                f"{path} is not a snapshot of this package (no {STATE_FILE}): a directory written "
                "by Orbax (the JAX package's --orbax_every / --orbax) cannot be resumed here; "
                "move it away or train into a fresh directory"
            )
        return sorted(steps)

    def all_steps(self) -> List[int]:
        with self._lock:
            return sorted(set(self._scan()) | self._pending_steps)

    def latest_step(self) -> Optional[int]:
        """The newest step saved, a write still in flight included."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _write(self, step: int, host_tree: Any) -> None:
        t0 = time.perf_counter()
        tmp = os.path.join(self.root, f"{TMP_PREFIX}{step}-{uuid.uuid4().hex}")
        os.makedirs(tmp)
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(host_tree, f)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(self.root, str(step))
        with self._lock:
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._pending_steps.discard(step)
            for old in self._scan()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.root, str(old)), ignore_errors=True)
        self.write_s[step] = time.perf_counter() - t0

    def _reap(self, wait: bool) -> None:
        """Drop finished writes; re-raise the first error a write raised."""
        done = [f for f in self._pending if wait or f.done()]
        self._pending = [f for f in self._pending if f not in done]
        for f in done:
            f.result()

    def save(self, step: int, tree: Any) -> None:
        self._submit(step, _to_host(tree))

    def _submit(self, step: int, host_tree: Any) -> None:
        """Write ``host_tree`` (its tensors already host copies) at ``step``."""
        self._reap(wait=False)
        with self._lock:
            self._pending_steps.add(int(step))
        if self._pool is None:
            self._write(int(step), host_tree)
        else:
            self._pending.append(self._pool.submit(self._write, int(step), host_tree))

    def restore(self, step: int) -> Any:
        """The snapshot at ``step``; its tensors map the file (read as they
        are used)."""
        path = os.path.join(self.root, str(step), STATE_FILE)
        return torch.load(path, map_location="cpu", weights_only=True, mmap=True)

    def wait_until_finished(self) -> None:
        self._reap(wait=True)


def make_manager(run_dir: str, max_to_keep: int = 3, async_save: bool = True) -> SnapshotManager:
    """A manager rooted at ``run_dir/orbax``."""
    return SnapshotManager(os.path.abspath(os.path.join(run_dir, "orbax")), max_to_keep, async_save)


def save(mgr: SnapshotManager, step: int, tree: Any) -> None:
    """Save a tree at ``step``: the tensors are copied to the host now, the
    file is written in the background."""
    mgr.save(step, tree)


def restore(mgr: SnapshotManager, like: Any, step: Optional[int] = None) -> Any:
    """The latest (or given) snapshot, checked to have ``like``'s top-level
    keys; its tensors are on the CPU (``load_state_dict`` places them).
    None when there is no snapshot."""
    tree = restore_raw(mgr, step)
    if tree is not None and isinstance(like, dict) and set(tree) != set(like):
        raise ValueError(f"snapshot keys {sorted(tree)} are not the expected {sorted(like)}")
    return tree


def restore_raw(mgr: SnapshotManager, step: Optional[int] = None) -> Any:
    """The latest (or given) snapshot with the shapes it was saved with;
    None when there is no snapshot."""
    mgr.wait_until_finished()
    step = mgr.latest_step() if step is None else step
    if step is None:
        return None
    return mgr.restore(step)


def _rank0_step(step: Optional[int]) -> Optional[int]:
    """Rank 0's ``step`` on every rank (the snapshot every rank restores)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return step
    box = [step]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def save_state(mgr: SnapshotManager, step: int, model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> None:
    """Snapshot ``model`` and ``optimizer`` at ``step`` with whole tensors. A
    collective under ``torch.distributed``: every rank calls it, in the same
    order, and each FSDP2 shard is gathered whole (``full_tensor``); rank 0
    copies each tensor to the host as it is gathered and hands the tree to
    the writer thread, the other ranks keep nothing. Returns once the host
    copy is taken. Without shards (one process, ``--dp``) nothing is
    gathered and only rank 0 copies."""
    from gaussian_transformer_tpu_torch.parallel.fsdp import full_tensor
    from gaussian_transformer_tpu_torch.parallel.mesh import is_lead

    lead = is_lead()

    def host(t):
        if not isinstance(t, torch.Tensor):
            return t
        whole = full_tensor(t.detach())
        return whole.to("cpu", copy=True) if lead else None

    params = {k: host(v) for k, v in model.state_dict().items()}
    sd = optimizer.state_dict()
    opt_state = {"state": {i: {k: host(v) for k, v in st.items()} for i, st in sd["state"].items()},
                 "param_groups": sd["param_groups"]}
    if lead:
        mgr._submit(int(step), {"params": params, "opt_state": opt_state})


@torch.no_grad()
def restore_state(mgr: SnapshotManager, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                  step: Optional[int] = None) -> Optional[int]:
    """Load the latest (or given) snapshot of ``save_state``'s format, from
    any world size, into ``model`` and ``optimizer`` in place; returns its
    step, or None when there is none. A collective under
    ``torch.distributed``: every rank calls it and restores rank 0's step.
    Each whole tensor is laid out as the live one (``like``: this rank's
    shard of a DTensor); an optimizer state tensor of its parameter's shape
    (Adam's moments) likewise, any other entry (``step``) as saved. The
    optimizer keeps its own ``foreach`` (it follows the sharding)."""
    from gaussian_transformer_tpu_torch.parallel.fsdp import like

    mgr.wait_until_finished()
    step = _rank0_step(mgr.latest_step() if step is None else step)
    if step is None:
        return None
    tree = mgr.restore(step)
    live = dict(model.named_parameters())
    live.update(model.named_buffers())
    saved = tree["params"]
    if set(saved) != set(live):
        raise ValueError(f"snapshot {step} does not fit the model: missing {sorted(set(live) - set(saved))}, "
                         f"unexpected {sorted(set(saved) - set(live))}")
    for name, ref in live.items():  # one order on every rank: like() is a collective on a DTensor
        ref.copy_(like(saved[name].to(ref.device, ref.dtype), ref))

    sd = tree["opt_state"]
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def laid_out(v, p):
        if isinstance(v, torch.Tensor) and tuple(v.shape) == tuple(p.shape) and v.dim() > 0:
            return like(v.to(p.device, p.dtype, copy=True), p)
        return v

    state = {i: {k: laid_out(v, params[int(i)]) for k, v in st.items()} for i, st in sd["state"].items()}
    foreach = [g.get("foreach") for g in optimizer.param_groups]
    optimizer.load_state_dict({"state": state, "param_groups": sd["param_groups"]})
    for g, f in zip(optimizer.param_groups, foreach):
        g["foreach"] = f
    return step

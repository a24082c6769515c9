"""Snapshots of the stacked trainer's sharded state: ``cli.train_stacked
--orbax`` under ``--fsdp 2`` (2 gloo ranks) and ``--dp 2 --fsdp 2`` (4),
spawned by ``tests/torch_dist_workers.py orbax_cli``, and the port's
snapshot layer (train/orbax_ckpt.py ``save_state``/``restore_state``) on
one process.

The CLI shards every leaf of 1024 elements or more in the spawns (its
``shard_model`` at ``min_size`` 1024), so that STACK 2's weights are
DTensors. Each spawn trains to a snapshot at epoch 1 and keeps the state gathered
then, runs again on the same run dir (it resumes at epoch 2 and trains no
further) and keeps the state restored, and restores a one-process run's
snapshot. Every comparison is bit for bit: parameters, Adam's moments and
its step count, by parameter name; the snapshot file against the state
gathered at the save; a sharded snapshot restored on one process through
the CLI; a one-process snapshot restored under both sharded layouts. So
one snapshot format holds at world sizes 1, 2 and 4. No JAX: the snapshot
format is the port's own (the JAX package's Orbax directories are refused,
tests/test_torch_orbax.py).

Cost: one one-process run (~5 s) and two spawns side by side (~10-20 s).
"""

import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gaussian_transformer_tpu_torch.cli import train_stacked as stacked_cli
from gaussian_transformer_tpu_torch.parallel.fsdp import make_fsdp_mesh, shard_model
from gaussian_transformer_tpu_torch.parallel.mesh import free_port, init_distributed
from gaussian_transformer_tpu_torch.train import orbax_ckpt
from gaussian_transformer_tpu_torch.train import stacked as ps

from tests.torch_dist_workers import Spawned, stacked_argv, whole_state, write_stacked_model_dir

LAYOUTS = {"fsdp2": (2, ["--fsdp", "2"]), "dp2_fsdp2": (4, ["--dp", "2", "--fsdp", "2"])}
STEPS = {"fsdp2": 4, "dp2_fsdp2": 2}  # two epochs of 4 cameras: batch 2, or 2 windows of batch 2


def _run_cli(argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)  # TensorBoard is optional
        return stacked_cli.main(argv)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_stacked_model_dir(tmp_path_factory.mktemp("orbax_fsdp"))


@pytest.fixture(scope="module")
def one_process(root):
    """A one-process run to a snapshot at epoch 1, and the state then."""
    run = root / "run1"
    out = _run_cli(stacked_argv(root, "--orbax", "--ip", "127.0.0.1", "--port", "0", "--run_name", str(run),
                                "--epochs", "2"))
    return run, whole_state("saved", out["model"], out["optimizer"])


@pytest.fixture(scope="module")
def spawned(root, one_process, tmp_path_factory):
    run1, _ = one_process
    return {name: Spawned("orbax_cli", world, {"root": np.asarray(str(root)), "argv": np.asarray(argv),
                                               "from1": np.asarray(str(run1))},
                          tmp_path_factory.mktemp(f"orbax_{name}"))
            for name, (world, argv) in LAYOUTS.items()}


def _equal_states(got: dict, got_prefix: str, ref: dict, ref_prefix: str) -> None:
    names = {k[len(ref_prefix) + 1:] for k in ref if k.startswith(ref_prefix + ".")}
    names = {n for n in names if n.startswith(("p.", "exp_avg.", "exp_avg_sq.", "step."))}
    assert any(n.startswith("exp_avg_sq.") for n in names) and any(n.startswith("step.") for n in names)
    for n in sorted(names):
        a, b = got[f"{got_prefix}.{n}"], ref[f"{ref_prefix}.{n}"]
        assert a.dtype == b.dtype and a.shape == b.shape, n
        assert a.tobytes() == b.tobytes(), f"{n} differs"


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sharded_snapshot_resumes_bit_for_bit(spawned, layout):
    """A second run on the run dir resumes at the snapshot's epoch + 1 with
    the state gathered at the save, on every rank."""
    results = spawned[layout].result()
    for r in results:
        assert int(r["saved.sharded"]) == int(r["restored.sharded"]) > 0  # DTensors, gathered and laid out
        assert int(r["saved.first_epoch"]) == 0 and int(r["saved.steps"]) == STEPS[layout]
        assert list(r["saved.snapshots"]) == [1]
        assert int(r["restored.first_epoch"]) == 2 and int(r["restored.steps"]) == 0
        _equal_states(r, "restored", r, "saved")
        _equal_states(r, "saved", results[0], "saved")  # every rank gathered the same whole state


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_snapshot_file_holds_the_gathered_state(spawned, layout):
    """The snapshot on disk is the unsharded trainer's tree
    (``{"params": state_dict, "opt_state": optimizer.state_dict()}``),
    whole tensors under the unsharded optimizer's parameter indices."""
    r = spawned[layout].result()[0]
    mgr = orbax_ckpt.make_manager(str(r["run"]))
    assert mgr.all_steps() == [1]
    tree = mgr.restore(1)
    model = ps.make_stacked_model(2, 1, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert list(tree["params"]) == list(model.state_dict())
    got = {f"file.p.{n}": t.numpy() for n, t in tree["params"].items()}
    state = tree["opt_state"]["state"]
    assert sorted(state) == list(range(len(names)))
    for i, n in enumerate(names):
        got.update({f"file.{k}.{n}": v.numpy() for k, v in state[i].items()})
    _equal_states(got, "file", r, "saved")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sharded_snapshot_restores_on_one_process(root, spawned, layout):
    """The unsharded CLI resumes a sharded run's snapshot bit for bit."""
    r = spawned[layout].result()[0]
    out = _run_cli(stacked_argv(root, "--orbax", "--ip", "127.0.0.1", "--port", "0", "--run_name", str(r["run"]),
                                "--epochs", "2"))
    assert out["first_epoch"] == 2 and out["snapshots"]["restored"] == 1 and not out["history"]
    _equal_states(whole_state("one", out["model"], out["optimizer"]), "one", r, "saved")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_one_process_snapshot_restores_sharded(spawned, one_process, layout):
    """A one-process run's snapshot resumes under each sharded layout, with
    the one-process state bit for bit."""
    _, ref = one_process
    for r in spawned[layout].result():
        assert int(r["from1.first_epoch"]) == 2 and int(r["from1.steps"]) == 0
        _equal_states(r, "from1", ref, "saved")


def test_snapshots_of_the_plain_writer_restore(tmp_path):
    """A snapshot written by ``save`` of the live state dicts (the
    unsharded trainer's writer) restores through ``restore_state`` bit for
    bit, and an optimizer keeps its own ``foreach``."""
    torch.manual_seed(0)
    model = ps.make_stacked_model(2, 1, device="cpu")
    opt = ps.make_optimizer(model)
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    mgr = orbax_ckpt.make_manager(str(tmp_path))
    orbax_ckpt.save(mgr, 7, {"params": model.state_dict(), "opt_state": opt.state_dict()})
    mgr.wait_until_finished()
    again = ps.make_stacked_model(2, 1, seed=1, device="cpu")
    opt2 = torch.optim.Adam(again.parameters(), lr=1.0, foreach=False)
    assert orbax_ckpt.restore_state(orbax_ckpt.make_manager(str(tmp_path)), again, opt2) == 7
    _equal_states(whole_state("b", again, opt2), "b", whole_state("a", model, opt), "a")
    assert opt2.param_groups[0]["foreach"] is False and opt2.param_groups[0]["lr"] == opt.param_groups[0]["lr"]
    assert orbax_ckpt.restore_state(orbax_ckpt.make_manager(str(tmp_path / "empty")), again, opt2) is None


def test_save_refuses_a_dtensor_and_save_state_gathers(tmp_path):
    """``save`` raises on a DTensor (its local shard is not the tensor) and
    writes nothing; ``save_state`` of the same sharded model writes whole
    tensors that ``restore_state`` lays out as shards again (a one-rank
    gloo world in this process)."""
    owned = not dist.is_initialized()
    if owned:
        init_distributed("cpu", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    try:
        model = ps.make_stacked_model(2, 1, device="cpu")
        shard_model(model, make_fsdp_mesh(1), min_size=1024)
        opt = ps.make_optimizer(model)
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
        mgr = orbax_ckpt.make_manager(str(tmp_path))
        with pytest.raises(TypeError, match="DTensor"):
            orbax_ckpt.save(mgr, 3, {"params": model.state_dict()})
        assert mgr.all_steps() == []
        orbax_ckpt.save_state(mgr, 3, model, opt)
        mgr.wait_until_finished()
        tree = mgr.restore(3)
        assert all(type(t) is torch.Tensor for t in tree["params"].values())
        again = ps.make_stacked_model(2, 1, seed=1, device="cpu")
        shard_model(again, make_fsdp_mesh(1), min_size=1024)
        opt2 = ps.make_optimizer(again)
        assert orbax_ckpt.restore_state(mgr, again, opt2) == 3
        assert all(type(p).__name__ == type(q).__name__ for p, q in zip(model.parameters(), again.parameters()))
        _equal_states(whole_state("b", again, opt2), "b", whole_state("a", model, opt), "a")
    finally:
        if owned:
            dist.destroy_process_group()

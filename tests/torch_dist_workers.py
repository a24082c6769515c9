"""Multi-process harness of the parallel-tier parity tests
(tests/test_torch_parallel*.py): ``spawn`` starts one process per rank on
gloo, as ``torchrun`` would (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), and each runs one worker of this module
on the inputs the parent wrote, then saves its results to
``<out>.<rank>.npz``. Workers import torch and the port only, never JAX:
the parent computes the JAX references.

    python -m tests.torch_dist_workers <worker> <inputs.npz> <out prefix>
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from gaussian_transformer_tpu_torch.parallel.mesh import free_port

ROOT = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT_S = 420


class Spawned:
    """``world`` gloo ranks running ``worker``; ``result()`` waits for them."""

    def __init__(self, worker: str, world: int, inputs: dict, tmp_path, timeout_s: float = SPAWN_TIMEOUT_S):
        tmp_path = Path(tmp_path)
        self.worker, self.world, self.timeout_s = worker, world, timeout_s
        tag = f"{worker}_{world}"
        inp = tmp_path / f"{tag}_in.npz"
        np.savez(inp, **inputs)
        self.out = tmp_path / tag
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
                   OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
        self.procs, self.logs = [], []
        for r in range(world):
            log = open(tmp_path / f"{tag}.{r}.log", "w+")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_dist_workers", worker, str(inp), str(self.out)],
                cwd=str(tmp_path), env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=log,
                stderr=subprocess.STDOUT))
        self.deadline = time.time() + timeout_s
        self._results = None

    def result(self):
        """Each rank's results (a dict of numpy arrays). A rank that fails, or
        a run past the timeout, fails the caller with the ranks' output."""
        if self._results is not None:
            return self._results
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, self.deadline - time.time()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        text = []
        for r, log in enumerate(self.logs):
            log.seek(0)
            text.append(f"--- rank {r} (exit {self.procs[r].returncode}):\n{log.read()[-4000:]}")
            log.close()
        if any(p.returncode != 0 for p in self.procs):
            raise AssertionError(f"{self.worker} on {self.world} ranks failed or timed out after "
                                 f"{self.timeout_s}s\n" + "\n".join(text))
        self._results = [dict(np.load(f"{self.out}.{r}.npz", allow_pickle=False)) for r in range(self.world)]
        return self._results


def spawn(worker: str, world: int, inputs: dict, tmp_path, timeout_s: float = SPAWN_TIMEOUT_S):
    """Run ``worker`` on ``world`` gloo ranks on ``inputs`` (a dict of numpy
    arrays) and wait: each rank's results."""
    return Spawned(worker, world, inputs, tmp_path, timeout_s).result()


# ------------------------------------------------------------ the workers ---


def _setup():
    import torch

    torch.set_num_threads(1)
    from gaussian_transformer_tpu_torch.parallel.mesh import init_distributed

    init_distributed("cpu")
    return torch


def _scene(inp, prefix="scene."):
    from gaussian_transformer_tpu_torch.convert import scene_from_numpy

    fields = {k[len(prefix):]: inp[k] for k in inp if k.startswith(prefix)}
    sh = int(fields.pop("active_sh_degree"))
    return scene_from_numpy(fields, sh, "cpu")


def cameras(inp, prefix="cam."):
    """The cameras packed by ``pack_cameras`` (the parent's side)."""
    import torch

    from gaussian_transformer_tpu_torch.convert import camera_from_numpy

    out = []
    for i in range(int(inp[prefix + "n"])):
        a = lambda k: inp[f"{prefix}{i}.{k}"]
        cam = camera_from_numpy(a("wvt"), a("fpt"), a("center"), float(a("fovx")), float(a("fovy")),
                                int(a("width")), int(a("height")), "cpu")
        cam.original_image = torch.from_numpy(np.array(a("image"), np.float32))
        out.append(cam)
    return out


def _recorded(rec) -> dict:
    """A collective record as arrays: op names, byte counts, output shapes."""
    return {"rec.ops": np.array([c.op for c in rec]), "rec.bytes": np.array([c.bytes for c in rec], np.int64),
            "rec.shapes": np.array([";".join(c.shape_strings()) for c in rec])}


def tier_3dgs(inp) -> dict:
    """The 3DGS tier on this world: the manual step on a (data, gauss) mesh
    of ``inp["mesh"]``, the tile-sharded render (forward and gradients, its
    collectives recorded) and the tile-sharded step over every rank, and a
    heartbeat."""
    torch = _setup()
    from gaussian_transformer_tpu_torch.config import OptConfig
    from gaussian_transformer_tpu_torch.parallel import collectives as cc
    from gaussian_transformer_tpu_torch.parallel.health import heartbeat
    from gaussian_transformer_tpu_torch.parallel.mesh import camera_rows, make_mesh, shard_adam, shard_scene
    from gaussian_transformer_tpu_torch.parallel.step import cameras_of, make_sharded_train_step, stack_cameras
    from gaussian_transformer_tpu_torch.parallel.tile_shard import render_tile_sharded
    from gaussian_transformer_tpu_torch.render import RenderConfig
    from gaussian_transformer_tpu_torch.scene.densify import DensifyStats
    from gaussian_transformer_tpu_torch.train.optim import PARAM_LEAVES, AdamState

    res = {}
    opt, bg = OptConfig(), torch.zeros(3)
    batch = stack_cameras(cameras(inp))

    # The manual step.
    data, gauss = (int(v) for v in inp["mesh"])
    mesh = make_mesh(data, gauss)
    full = _scene(inp)
    scene, adam = shard_scene(full, mesh), shard_adam(AdamState.init(full), mesh)
    stats = DensifyStats.init(scene.capacity)
    step = make_sharded_train_step(opt, RenderConfig(max_per_tile=64), mesh=mesh)
    cams_l = cameras_of(batch, camera_rows(batch.world_view_transform.shape[0], mesh))
    with cc.recording() as rec:
        scene, adam, stats, m = step(scene, adam, stats, cams_l, bg, 1, 1.0)
    res.update({f"manual.{k}": getattr(scene, k).detach().numpy() for k in PARAM_LEAVES})
    res.update({f"manual.mu.{k}": v.numpy() for k, v in adam.mu.items()})
    res.update({f"manual.nu.{k}": v.numpy() for k, v in adam.nu.items()})
    res.update({"manual.accum": stats.xyz_gradient_accum.numpy(), "manual.denom": stats.denom.numpy(),
                "manual.max_radii2d": stats.max_radii2d.numpy(), "manual.loss": m["loss"].numpy(),
                "manual.n_visible": m["n_visible"].numpy(), "manual.coord": np.array([mesh.get_local_rank("data"),
                                                                                        mesh.get_local_rank("gauss")])})
    res.update({f"manual.{k}": v for k, v in _recorded(rec).items()})

    # The tile-sharded render over every rank: forward and gradients.
    cam = cameras(inp)[0]
    scene = _scene(inp)
    xyz = scene.xyz.detach().clone().requires_grad_()
    opacity = scene.opacity.detach().clone().requires_grad_()
    off = torch.zeros(scene.capacity, 2, requires_grad=True)
    from gaussian_transformer_tpu_torch.scene.gaussians import TensorScene

    s = TensorScene.of(scene).replace(xyz=xyz, opacity=opacity)
    with cc.recording() as rec:
        out = render_tile_sharded(cam, s, RenderConfig(), None, bg_color=torch.from_numpy(inp["tile_bg"]),
                                  screenspace_offset=off)
        loss = (out["render"] ** 2).sum() + 0.1 * out["final_T"].sum()
        g = torch.autograd.grad(loss, [xyz, opacity, off])
    res.update({"tile.render": out["render"].detach().numpy(), "tile.final_T": out["final_T"].detach().numpy(),
                "tile.g_xyz": g[0].numpy(), "tile.g_opacity": g[1].numpy(), "tile.g_offset": g[2].numpy()})
    res.update({f"tile.{k}": v for k, v in _recorded(rec).items()})

    # The tile-sharded step over every rank (the whole scene, every camera).
    tmesh = make_mesh(1)
    full = _scene(inp)
    step = make_sharded_train_step(opt, RenderConfig(), mesh=tmesh, tile_axis="gauss")
    full, adam, stats, m = step(full, AdamState.init(full), DensifyStats.init(full.capacity), batch, bg, 1, 1.0)
    res.update({"tstep.xyz": full.xyz.detach().numpy(), "tstep.accum": stats.xyz_gradient_accum.numpy(),
                "tstep.loss": m["loss"].numpy()})
    res["heartbeat"] = np.array(heartbeat(30.0))
    res.update(collective_transposes())
    return res


def collective_transposes() -> dict:
    """Each autograd collective's forward and its gradient, on inputs made
    from the rank (the parent checks them against their closed forms)."""
    import torch

    from gaussian_transformer_tpu_torch.parallel import collectives as cc

    n, r = cc.size(), cc.rank()
    out = {}

    def run(name, x, fn, cot):
        x = x.clone().requires_grad_()
        y = fn(x)
        (g,) = torch.autograd.grad(y, [x], cot(y))
        out[f"cc.{name}.y"], out[f"cc.{name}.g"] = y.detach().numpy(), g.numpy()

    A = torch.arange(6.0).reshape(3, 2)
    run("all_gather", (r + 1) * A, cc.all_gather, lambda y: torch.arange(float(y.numel())).reshape(y.shape))
    run("reduce_scatter", (r + 1) * torch.arange(4.0 * n).reshape(2 * n, 2), cc.reduce_scatter,
        lambda y: torch.full_like(y, r + 1.0))
    run("all_reduce", torch.full((2,), r + 1.0), cc.all_reduce, lambda y: torch.full_like(y, r + 1.0))
    run("all_reduce_mean", torch.full((2,), r + 1.0), lambda x: cc.all_reduce(x, op="mean"),
        lambda y: torch.full_like(y, r + 1.0))
    run("all_to_all", 10.0 * r + torch.arange(2.0 * n).reshape(2, n), lambda x: cc.all_to_all(x, 1, 0),
        lambda y: 100.0 * r + torch.arange(float(y.numel())).reshape(y.shape))
    run("ring_shift", torch.full((2,), float(r)), cc.ring_shift, lambda y: torch.full_like(y, 10.0 * r))
    run("replicated_slice", torch.arange(2.0 * n), lambda x: cc.replicated_slice(x, 2 * r, 2 * r + 2),
        lambda y: torch.full_like(y, r + 1.0))
    run("replicated_output", torch.ones(2), cc.replicated_output, lambda y: torch.full_like(y, r + 1.0))
    return out


def _attention(inp, res):
    """Ring and Ulysses attention of this rank's token rows, forward and the
    gradients of sum(out * cot) for every mask case of ``inp``."""
    import torch

    from gaussian_transformer_tpu_torch.parallel import collectives as cc
    from gaussian_transformer_tpu_torch.parallel.ring import ring_attention
    from gaussian_transformer_tpu_torch.parallel.ulysses import ulysses_attention

    n, r = cc.size(), cc.rank()
    rows = lambda t: torch.from_numpy(t).chunk(n, dim=2)[r]
    for case in [k[len("attn.mask."):] for k in inp if k.startswith("attn.mask.")]:
        mask = torch.from_numpy(inp[f"attn.mask.{case}"])
        for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
            q, k, v = (rows(inp[f"attn.{x}"]).clone().requires_grad_() for x in "qkv")
            m = mask if name == "ulysses" or mask.shape[-2] == 1 else mask.chunk(n, dim=2)[r]
            out = fn(q, k, v, m)
            g = torch.autograd.grad(out, [q, k, v], rows(inp["attn.cot"]))
            res[f"{name}.{case}.out"] = out.detach().numpy()
            for x, gx in zip("qkv", g):
                res[f"{name}.{case}.g{x}"] = gx.numpy()


def _stacked(inp, prefix):
    """The port's stacked TrainingScene and small model of ``inp``."""
    import types

    import torch

    from gaussian_transformer_tpu_torch.models import transformer as tf
    from gaussian_transformer_tpu_torch.render import RenderConfig
    from gaussian_transformer_tpu_torch.train import stacked as ps

    stack = int(inp["stacked.stack"])
    tcams = cameras(inp, f"{prefix}cam.")
    ts = ps.TrainingScene(types.SimpleNamespace(gaussians=_scene(inp, f"{prefix}scene."),
                                                get_train_cameras=lambda: tcams),
                          RenderConfig(), batch_size=2, stack=stack, bucket=4)
    ts.set_epoch(1000)
    D = ps.stacked_token_dim(stack)
    model = tf.make_model(stack, D, D, N=1, d_model=D, dropout=0.0, device="cpu")
    model.load_state_dict({k[len("stacked.w."):]: torch.from_numpy(v) for k, v in inp.items()
                           if k.startswith("stacked.w.")})
    return ts, model, stack


def _full_params(model) -> dict:
    from gaussian_transformer_tpu_torch.models import transformer as tf
    from gaussian_transformer_tpu_torch.parallel.fsdp import full_tensor

    return {f"p.{n}": tf.tensor_to_jax(n, full_tensor(p)) for n, p in model.named_parameters()}


def tier_seq(inp) -> dict:
    """The transformer half on this world: ring and Ulysses attention; at 2
    ranks data parallelism over 2 windows; at 4 FSDP over 4 ranks, DP x
    FSDP on a 2 x 2 mesh and the flat trainer's step with a ring over 4."""
    import numpy as np
    import numpy.random as npr

    torch = _setup()
    from torch.distributed.device_mesh import init_device_mesh

    import torch.distributed as dist

    from gaussian_transformer_tpu_torch.parallel import collectives as cc
    from gaussian_transformer_tpu_torch.parallel.fsdp import full_tensor, make_fsdp_mesh, shard_model
    from gaussian_transformer_tpu_torch.train import stacked as ps

    res = {}
    _attention(inp, res)
    n, lr = cc.size(), float(inp["stacked.lr"])
    if n == 2:
        ts, model, stack = _stacked(inp, "stacked.")
        ts.rng = npr.RandomState(5)
        group = ts.make_batch_group(2)
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
        step = ps.make_dp_train_step(model, ts.handler, ts.render_cfg, ps.make_optimizer(model), stack, mesh=mesh)
        loss, _ = step(group.src, group.trg_y, group.cameras, lr, group.src_mask)
        res["dp.loss"] = loss.numpy()
        res.update({f"dp.{k}": v for k, v in _full_params(model).items()})
    if n == 4:
        ts, model, stack = _stacked(inp, "stacked.")
        ts.rng = npr.RandomState(3)
        b = ts.make_batch([0, 1])
        shard_model(model, make_fsdp_mesh(4), min_size=1024)
        res["fsdp.sharded"] = np.array([type(p).__name__ == "DTensor" for p in model.parameters()])
        opt = ps.make_optimizer(model)
        step = ps.make_train_step(model, ts.handler, ts.render_cfg, opt, stack)
        loss, _ = step(b.src, b.trg_y, b.cameras, lr, b.src_mask)
        res["fsdp.loss"] = loss.numpy()
        res.update({f"fsdp.{k}": v for k, v in _full_params(model).items()})
        # A checkpoint of the shards (rank 0 writes the whole tensors), read
        # back into a fresh sharded model and optimizer.
        run = os.path.join(os.getcwd(), "fsdp_run")
        ps.save_checkpoint(run, 1, model, opt)
        dist.barrier()
        _, again, _ = _stacked(inp, "stacked.")
        shard_model(again, make_fsdp_mesh(4), min_size=1024)
        opt2 = ps.make_optimizer(again)
        ps.load_checkpoint(run, 1, again, opt2)
        res["fsdp.run"] = np.array(run)
        res["fsdp.reload_err"] = np.array(max(
            max(float((full_tensor(p) - full_tensor(q)).abs().max()),
                max(float((full_tensor(opt.state[p][k]) - full_tensor(opt2.state[q][k])).abs().max())
                    for k in ("exp_avg", "exp_avg_sq")))
            for p, q in zip(model.parameters(), again.parameters())))

        ts, model, stack = _stacked(inp, "stacked.")
        ts.rng = npr.RandomState(5)
        group = ts.make_batch_group(2)
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "fsdp"))
        shard_model(model, mesh, min_size=1024)
        step = ps.make_dp_train_step(model, ts.handler, ts.render_cfg, ps.make_optimizer(model), stack, mesh=mesh)
        loss, _ = step(group.src, group.trg_y, group.cameras, lr, group.src_mask)
        res["dpfsdp.loss"] = loss.numpy()
        res.update({f"dpfsdp.{k}": v for k, v in _full_params(model).items()})
        res.update(_flat_ring(inp))
    return res


def _flat_ring(inp) -> dict:
    """One step of the flat trainer with a ring over every rank: the loss,
    its weight gradients (summed over the ring) and the Adamax update."""
    import types

    import numpy as np
    import torch
    import torch.distributed as dist

    from gaussian_transformer_tpu_torch.models import transformer as tf
    from gaussian_transformer_tpu_torch.render import RenderConfig
    from gaussian_transformer_tpu_torch.train import flat as pf

    tcams = cameras(inp, "flat.cam.")
    pts = pf.FlatTrainingScene(types.SimpleNamespace(gaussians=_scene(inp, "flat.scene."),
                                                     get_train_cameras=lambda: tcams),
                               RenderConfig(), max_len=15000, min_len=10, bucket=32)
    pts.set_epoch(1000)
    pts.rng = np.random.RandomState(7)
    b = pts.make_batch(int(inp["flat.cam_idx"]))
    model = pf.EmbeddedEncoderDecoder(N=1, d_model=int(inp["flat.d_model"]), dropout=0.0, device="cpu",
                                      seq_group=dist.group.WORLD)
    model.load_state_dict({k[len("flat.w."):]: torch.from_numpy(v) for k, v in inp.items() if k.startswith("flat.w.")})
    optimizer, scheduler = pf.make_noam_adamax(model.parameters(), int(inp["flat.d_model"]))
    loss_fn = pf.make_flat_loss(model, pts.render_cfg, use_lpips=False)
    loss, met = loss_fn(*[b[k] for k in ("src", "trg", "trg_y", "src_mask", "trg_mask", "cam")])
    loss.backward()
    pf.reduce_grads(model.parameters(), dist.group.WORLD)
    res = {"flat.loss": loss.detach().numpy(), **{f"flat.{k}": met[k].detach().numpy() for k in ("base", "gen", "l2")}}
    res.update({f"flat.g.{n}": tf.tensor_to_jax(n, p.grad) for n, p in model.named_parameters()})
    optimizer.step()
    res.update({f"flat.p.{n}": tf.tensor_to_jax(n, p) for n, p in model.named_parameters()})
    return res


def cli_pair(inp) -> dict:
    """``cli.train_stacked --dp 2``, ``cli.train_transformer --seq_shard 2``
    and ``--fsdp 2``, then ``cli.train_stacked --fsdp 2`` twice (the second
    run resumes) on this world, as torchrun would start them (the first CLI
    joins the process group itself)."""
    import torch

    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None  # TensorBoard is optional
    from gaussian_transformer_tpu_torch.cli import train_stacked, train_transformer

    root = str(inp["root"])
    res = {}
    out = train_stacked.main(["-s", f"{root}/data", "-m", f"{root}/model", "--eval", "--stack", "2", "--layers", "1",
                              "--batch_size", "2", "--run_name", f"{root}/run", "--checkpoint_every", "1",
                              "--epochs", "2", "--quiet", "--device", "cpu", "--dp", "2"])
    res["stacked.loss"] = np.array([h["loss"] for h in out["history"]])
    res["stacked.epoch_loss"] = np.array([e["loss"] for e in out["epochs"]])
    train_transformer.MIN_LEN = 100  # this scene's cameras see 100-400 Gaussians
    out = train_transformer.main(["-s", f"{root}/data", "-m", f"{root}/model", "--eval", "--d_model", "32",
                                  "--layers", "1", "--epochs", "1", "--quiet", "--device", "cpu",
                                  "--seq_shard", "2"])
    res["flat.loss"] = np.array([h["loss"] for h in out["history"]])
    res["flat.src_len"] = np.array([h["src_len"] for h in out["history"]])
    os.makedirs("fsdp", exist_ok=True)
    os.chdir("fsdp")  # its own best_model.npz
    out = train_transformer.main(["-s", f"{root}/data", "-m", f"{root}/model", "--eval", "--d_model", "32",
                                  "--layers", "1", "--epochs", "1", "--quiet", "--device", "cpu", "--fsdp", "2"])
    res["flat_fsdp.loss"] = np.array([h["loss"] for h in out["history"]])
    stacked = ["-s", f"{root}/data", "-m", f"{root}/model", "--eval", "--stack", "2", "--layers", "1",
               "--batch_size", "2", "--run_name", f"{root}/run_fsdp", "--checkpoint_every", "1", "--quiet",
               "--device", "cpu", "--fsdp", "2"]
    train_stacked.main(stacked + ["--epochs", "2"])
    out = train_stacked.main(stacked + ["--epochs", "3"])  # resumes from checkpoint_1
    res["stacked_fsdp.first_epoch"] = np.array(out["first_epoch"])
    res["stacked_fsdp.loss"] = np.array([h["loss"] for h in out["history"]])
    return res


WORKERS = {"tier_3dgs": tier_3dgs, "tier_seq": tier_seq, "cli_pair": cli_pair}


def main(argv):
    worker, inp, out = argv
    rank = int(os.environ["RANK"])
    res = WORKERS[worker](dict(np.load(inp, allow_pickle=False)))
    np.savez(f"{out}.{rank}.npz", **res)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])

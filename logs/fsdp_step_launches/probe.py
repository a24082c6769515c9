"""Probe: does one --fsdp 1 stacked step launch the same kernels every run?
Host-side events (torch.profiler CPU events by thread) and device events,
under three settings: default, the autograd engine on the calling thread,
checkpoint early stop off. The model is the stacked CLI's at full width
(STACK 8, d_model 6656, 2 layers) under FSDP2 on a one-rank NCCL mesh, on
random tokens (the chamfer gate shut). Run on one card from the repo root:

    python3 logs/fsdp_step_launches/probe.py

It prints each run's device events, host launch calls and events by
thread, and writes them with the op-sequence diffs to
chiprun_out/probe_step_count.json (kept here as result.json)."""
import collections, contextlib, json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
from torch.profiler import ProfilerActivity, profile
from gaussian_transformer_tpu_torch.parallel.mesh import free_port, init_distributed
from gaussian_transformer_tpu_torch.parallel.fsdp import make_fsdp_mesh, shard_model
from gaussian_transformer_tpu_torch.train import stacked as ps
import torch.utils.checkpoint as ckpt

init_distributed("cuda", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
dev = torch.device("cuda")
stack, layers, Ls, Lt = 8, int(os.environ.get("LAYERS", "2")), 33, 31
model = ps.make_stacked_model(stack, layers, 0, seed=0, device=dev)
shard_model(model, make_fsdp_mesh(1))
model.train()
opt = ps.make_optimizer(model)
step = ps.make_train_step(model, None, None, opt, stack)
D = ps.stacked_token_dim(stack)
g = torch.Generator().manual_seed(0)
src = (torch.randn(1, Ls, D, generator=g) * 10).to(dev)
trg_y = (torch.randn(1, Lt, D, generator=g) * 10).to(dev)
mask = torch.ones(1, 1, Ls, dtype=torch.bool, device=dev)
run = lambda: step(src, trg_y, [], 5e-4, mask, (42, 32))
out = {}
settings = {
    "default": contextlib.nullcontext,
    "engine_on_caller_thread": lambda: torch.autograd.set_multithreading_enabled(False),
    "early_stop_off": lambda: ckpt.set_checkpoint_early_stop(False),
}
for name, ctx in settings.items():
    with ctx():
        run(); run(); torch.cuda.synchronize()
        runs = []
        for k in range(5):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run(); torch.cuda.synchronize()
            ev = prof.events()
            dev_n = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in ev)
            cpu = sorted((e for e in ev if e.device_type == torch.autograd.DeviceType.CPU), key=lambda e: e.time_range.start)
            launches = sum(e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx") for e in cpu)
            threads = collections.Counter(e.thread for e in cpu)
            seq = [(e.thread, e.name) for e in cpu if e.name.startswith(("FSDP::", "aten::", "CheckpointFunction", "autograd::"))]
            runs.append({"device_events": dev_n, "host_launches": launches, "threads": {str(t): n for t, n in threads.items()},
                         "seq": seq})
            print(name, k, dev_n, launches, dict(threads), flush=True)
    base = runs[0]
    res = {"device_events": [r["device_events"] for r in runs], "host_launches": [r["host_launches"] for r in runs],
           "threads": [r["threads"] for r in runs], "diffs": []}
    for k, r in enumerate(runs[1:], 1):
        a = collections.Counter(base["seq"]); b = collections.Counter(r["seq"])
        if a != b:
            # thread-wise first divergence with context
            d = {"run": k, "only_base": {f"{t}|{n}": c for (t, n), c in (a - b).items()},
                 "only_run": {f"{t}|{n}": c for (t, n), c in (b - a).items()}}
            for t in sorted(set(x for x, _ in base["seq"]) | set(x for x, _ in r["seq"])):
                sa = [n for x, n in base["seq"] if x == t]; sb = [n for x, n in r["seq"] if x == t]
                i = next((j for j in range(min(len(sa), len(sb))) if sa[j] != sb[j]), None)
                if i is None and len(sa) == len(sb):
                    continue
                i = min(len(sa), len(sb)) if i is None else i
                d[f"thread {t} first diff at {i} of {len(sa)}/{len(sb)}"] = {"base": sa[max(0, i - 25):i + 25], "run": sb[max(0, i - 25):i + 25]}
            res["diffs"].append(d)
    out[name] = res
    print(name, json.dumps({k: v for k, v in res.items() if k != "diffs"}), flush=True)
    print(name, "diffs", json.dumps(res["diffs"])[:6000], flush=True)
json.dump(out, open("chiprun_out/probe_step_count.json", "w"), indent=1)
print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read())
import torch.distributed as dist; dist.destroy_process_group()

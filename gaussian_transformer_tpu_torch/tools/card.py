"""What a run on the card reads about it: the card's name and power limit,
and the launch counters of the train step's kernels (K1-K4)."""

from __future__ import annotations

import subprocess


def smi_line(device=None) -> str:
    """The card's ``name, power.limit`` as nvidia-smi prints them; "cpu"
    when ``device`` is given and is not a CUDA device."""
    if device is not None and device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_counters() -> dict:
    """The launch counters of K1-K4 (the stream compositor's and the fused
    SSIM's wrappers), by kernel."""
    from gaussian_transformer_tpu_torch.ops import fused_ssim
    from gaussian_transformer_tpu_torch.render import stream

    return {"K1": stream.STREAM_FWD, "K2": stream.STREAM_BWD, "K3": fused_ssim.SSIM_FWD, "K4": fused_ssim.SSIM_BWD}


def zero_counts(counters) -> None:
    for k in counters.values():
        k.launches = 0


def read_counts(counters) -> dict:
    return {k: v.launches for k, v in counters.items()}

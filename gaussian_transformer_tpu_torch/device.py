"""Device policy: entry points run on the CUDA card unless the caller asks for
the CPU. Without a card and without an explicit CPU request they raise; they
never fall back to the CPU quietly."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> the first CUDA device (raises when there is none); any
    explicit device is returned as given (``"cpu"`` is how tests and CPU
    callers opt out of the card)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
                "to run on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device

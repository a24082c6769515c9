"""Filesystem helpers (copy of ``gaussian_transformer_tpu/utils/system.py``)."""

from __future__ import annotations

import os


def search_for_max_iteration(folder: str):
    """Largest numeric suffix among 'name_<int>' entries; None when the folder
    has no such entries."""
    if not os.path.isdir(folder):
        return None
    saved = []
    for fname in os.listdir(folder):
        if "_" in fname:
            try:
                saved.append(int(fname.split("_")[-1]))
            except ValueError:
                continue
    return max(saved) if saved else None

"""Viewer bridge (the SIBR remote-viewer protocol)."""

from gaussian_transformer_tpu_torch.viewer import network_gui

__all__ = ["network_gui"]

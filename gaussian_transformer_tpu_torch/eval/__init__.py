"""Evaluation metrics (port of ``gaussian_transformer_tpu/eval``): LPIPS."""

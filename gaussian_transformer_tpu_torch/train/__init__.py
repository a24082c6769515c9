"""Training (port of ``gaussian_transformer_tpu/train``): the per-scene Adam
optimizer with state surgery (``optim``), the 3DGS train step and loop
(``splat``), the stacked-transformer trainer (``stacked``) and the flat
masked-Gaussian trainer (``flat``)."""

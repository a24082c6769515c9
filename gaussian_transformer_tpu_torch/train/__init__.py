"""Per-scene training (port of ``gaussian_transformer_tpu/train``): the Adam
optimizer with state surgery (``optim``) and the 3DGS train step and loop
(``splat``)."""

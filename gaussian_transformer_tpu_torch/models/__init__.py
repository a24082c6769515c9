"""The Gaussian-sequence transformer (port of ``gaussian_transformer_tpu/models``):
the token codec, the box sort, the encoder-decoder and its cached decode, and
the Gaussian autoencoders."""

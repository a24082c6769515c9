"""Counterparts of the JAX package's ``tools/`` scripts that hold a kernel."""

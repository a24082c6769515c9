"""Counterparts of the JAX package's ``attic/``: implementations the reference
keeps off its code paths, ported so that every TPU kernel has a Hopper one."""

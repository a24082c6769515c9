"""Plain PyTorch references the benchmark judges the port against. They
import nothing of the port, JAX or the JAX package."""

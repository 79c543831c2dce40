"""Utilities of the port (copies of the JAX package's `utils/` it needs)."""

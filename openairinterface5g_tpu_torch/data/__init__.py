"""Spec constant tables of the port (copied, not shared, with the JAX package)."""

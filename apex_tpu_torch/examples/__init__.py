"""Recipes of the port, beside the JAX package's ``examples/``."""

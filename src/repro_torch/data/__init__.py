"""Synthetic token batches for training (``pipeline.py``, a copy of the
JAX package's module without its unused ``import jax``)."""

"""Optimizers (AdamW, Adafactor) and int8 gradient compression, over dicts
of tensors keyed by parameter name."""

from . import ckpt

__all__ = ["ckpt"]

from . import backend, ref

__all__ = ["backend", "ref"]

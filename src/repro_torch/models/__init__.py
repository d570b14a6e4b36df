"""The model zoo for serving: dense, ssm and hybrid families."""
from .api import ModelAPI, build_model, params_from_reference

__all__ = ["ModelAPI", "build_model", "params_from_reference"]

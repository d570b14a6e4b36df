"""The model zoo for serving and training: dense, moe, ssm and hybrid
families."""
from .api import ModelAPI, build_model, params_from_reference, train_params

__all__ = ["ModelAPI", "build_model", "params_from_reference",
           "train_params"]

from . import cost_model, directives, estimate, solver

__all__ = ["cost_model", "directives", "estimate", "solver"]

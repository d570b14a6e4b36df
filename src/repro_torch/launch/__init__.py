"""Serving entry points of the model zoo (``serve.py``, ``steps.py``)."""

"""Training and serving entry points of the model zoo (``train.py``,
``serve.py``, ``steps.py``)."""

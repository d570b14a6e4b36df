"""repro_torch: the KAPLA dataflow solver and its lowering, with the
network tier's kernels written by hand in CUDA C++ for Hopper.

The solver, cost model, workloads, hardware templates and the two
planners (``lower/plan.py``, ``lower/netplan.py``) are byte-identical
copies of their ``repro`` counterparts (same relative paths), so both
packages pick the same schedules.  The execution side (``kernels/``,
``lower/exec.py``, ``lower/netexec.py``, ``csrc/``) is PyTorch + CUDA.
This package never imports ``jax`` or ``repro``."""

__version__ = "1.0.0"

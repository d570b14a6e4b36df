"""Seconds of the fused network's CUDA-graph capture, the
``("net", "boundary")`` variant the window replays: its eager warm-up call
and the capture itself, as the program counts them in its
``graph_capture_seconds`` histogram (owner ``net.boundary``; read from the
program's registry in the run's process, ``bench/harness/program.py``)."""
from bench.harness import program


def read(rec):
    return program.capture_seconds("net.boundary")

"""Seconds of the train step's CUDA-graph capture: its eager warm-up step
and the capture itself, as the program counts them in its
``graph_capture_seconds`` histogram (owner ``train``; read from the
program's registry in the run's process, ``bench/harness/program.py``)."""
from bench.harness import program


def read(rec):
    return program.capture_seconds("train")

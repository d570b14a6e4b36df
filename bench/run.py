"""Run one benchmark cell once, from the root of a checkout:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration, traffic mix, limits and per-layer metrics are files under
``bench/`` (``bench/harness/cells.py``).  The last line of standard
output is the result's JSON object; the numbers compared with their
limits are the last lines of standard error.  Without as many CUDA cards
as the cell asks for, it exits non-zero and prints no result.
"""
import sys
import time

T_START = time.monotonic()

if __name__ == "__main__":
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from bench.harness import runner
    sys.exit(runner.main(t_start=T_START))

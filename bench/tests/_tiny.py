"""Small stand-ins of the configurations, for tests on the CPU."""
import contextlib
import json

from bench.harness import runner

NETWORK = {"batch": 2,
           "stem": {"in_channels": 3, "channels": 8, "conv_out": 16,
                    "conv_window": 7, "conv_stride": 2, "pool_out": 8,
                    "pool_window": 3, "pool_stride": 2},
           "stages": [{"blocks": 1, "mid": 4, "out": 8, "extent": 8},
                      {"blocks": 2, "mid": 8, "out": 16, "extent": 4}],
           "head": {"pool_window": 4, "classes": 10}}
MAMBA2 = {"num_layers": 3, "d_model": 64, "vocab_size": 256, "ssm_state": 16,
          "ssm_head_dim": 16}
#: smaller mixes of each traffic, same shape of loop
TRAFFIC = {"train": {"batch": 4, "seq": 32}}


def overrides(cell_name: str) -> dict:
    return NETWORK if "resnet" in cell_name else MAMBA2


@contextlib.contextmanager
def small_traffic():
    """``cells.load_cell`` giving each cell its mix at the small sizes of
    ``TRAFFIC``."""
    from bench.harness import cells
    real = cells.load_cell

    def load_cell(cell, root=cells.ROOT, benchmark=None):
        c = real(cell, root, benchmark)
        c.traffic = dict(c.traffic, **TRAFFIC.get(c.driver, {}))
        return c
    cells.load_cell = load_cell
    try:
        yield
    finally:
        cells.load_cell = real


def run_cell(name: str, capsys, seed: int = 2**31 + 5,
             seconds: float = 0.5) -> dict:
    """One run of ``name`` on the CPU at a small size; its result line."""
    with small_traffic():
        rc = runner.main(["--workload", name, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", "0"],
                         require_device=False, device="cpu",
                         overrides=overrides(name))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

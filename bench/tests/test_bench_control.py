"""Each cell's control (the plain reference a precision step below the
configuration's, in the program's place) and its faults come out as not
correct.  On the CPU at a small size the control must read at least three
times what the program reads on one of the cell's numbers; on the card
(``gpu``), at the cell's own size on three seeds, the control and every
fault must fail one of the cell's limits."""
import pytest

from bench import control
from bench.harness import cells
from bench.tests import _tiny

CELLS = [w["name"] for w in cells.load_benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_separates_from_the_program(cell, capsys):
    sound = _tiny.run_cell(cell, capsys)["checks"]
    with _tiny.small_traffic():
        got = control.main(["--workload", cell, "--seeds", "7"],
                           require_device=False, device="cpu",
                           overrides=_tiny.overrides(cell), seconds=0.5)[0]
    ratios = {k: v / max(sound[k]["value"], 1e-30)
              for k, v in got["control"].items() if k in sound}
    assert max(ratios.values()) >= 3, (got["control"], sound)
    for fault, numbers in got["faults"].items():
        assert any(v > sound[k]["limit"] for k, v in numbers.items()
                   if k in sound), fault


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    limits = cells.load_cell(cell).limits
    for r in control.main(["--workload", cell, "--seeds", "901,902,903"]):
        assert any(v > limits[k] for k, v in r["control"].items()
                   if k in limits), r
        for fault, numbers in r["faults"].items():
            assert any(v > limits[k] for k, v in numbers.items()
                       if k in limits), (fault, r)

"""The readers of what the program records about itself
(``bench/harness/program.py``): each on a hand-made registry, and None
where the registry, the histogram or the owner's capture is missing."""
import sys
import types

import pytest

from bench.harness import cells, program
from repro_torch.obs.metrics import Registry

READERS = {"capture_s.train": "train", "capture_s.net": "net.boundary"}


def _registry(observations):
    reg = Registry()
    h = reg.histogram("graph_capture_seconds", "", ("owner", "phase"))
    for owner, phase, seconds in observations:
        h.observe(seconds, owner=owner, phase=phase)
    return reg


@pytest.fixture
def program_registry(monkeypatch):
    """Stands in for the program's registry in this process."""
    def install(reg):
        monkeypatch.setitem(sys.modules, "repro_torch.obs.metrics",
                            types.SimpleNamespace(REGISTRY=reg))
    return install


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_adds_the_warmup_and_the_capture(name, program_registry):
    owner = READERS[name]
    program_registry(_registry([
        (owner, "warmup", 12.5), (owner, "capture", 1.25),
        ("decode", "warmup", 100.0), ("decode", "capture", 100.0)]))
    assert cells.metric_reader(name).read({}) == pytest.approx(13.75)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_finds_nothing_to_read(name, program_registry, monkeypatch):
    reader = cells.metric_reader(name)
    # a program without the histogram (the parent commit's)
    program_registry(Registry())
    assert reader.read({}) is None
    # the histogram without this owner's capture
    program_registry(_registry([("decode", "capture", 1.0)]))
    assert reader.read({}) is None
    # a run that never loaded the program
    monkeypatch.delitem(sys.modules, "repro_torch.obs.metrics")
    assert reader.read({"trace": {}}) is None


def test_several_captures_read_their_mean():
    reg = _registry([("train", "warmup", 10.0), ("train", "capture", 2.0),
                     ("train", "warmup", 6.0), ("train", "capture", 2.0)])
    assert program.capture_seconds("train", reg) == pytest.approx(10.0)


def test_the_programs_histogram_is_the_one_read():
    """The name and labels the reader reads are the program's own."""
    import repro_torch.kernels.graph  # noqa: F401  (registers it)
    from repro_torch.obs.metrics import REGISTRY
    h = REGISTRY.get("graph_capture_seconds")
    assert h is not None and h.labelnames == ("owner", "phase")

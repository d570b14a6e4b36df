"""The port's data pipeline: ``data/pipeline.py`` is the reference's with
its unused ``import jax`` dropped (``tests/test_torch_copies.py`` holds the
text), gives the reference's batches, and passes the reference's own cases
(``tests/test_data.py``)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import pipeline as jpipe
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, Prefetcher, synth_batch

CFG = get_config("yi-6b")
SHAPE = ShapeConfig("t", 32, 8, "train")


@pytest.mark.parametrize("arch", ["yi-6b", "musicgen-large", "zamba2-1.2b"])
def test_batches_equal_the_reference(arch):
    from repro.configs import get_config as j_get_config
    from repro.configs.base import ShapeConfig as JShape
    dc = DataConfig(seed=7, host_count=2, host_index=1)
    got = synth_batch(get_config(arch), SHAPE, 3, dc)
    want = jpipe.synth_batch(j_get_config(arch), JShape("t", 32, 8, "train"),
                             3, jpipe.DataConfig(seed=7, host_count=2,
                                                 host_index=1))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_deterministic():
    a = synth_batch(CFG, SHAPE, 5)
    b = synth_batch(CFG, SHAPE, 5)
    np.testing.assert_array_equal(a["inputs"], b["inputs"])
    c = synth_batch(CFG, SHAPE, 6)
    assert not np.array_equal(a["inputs"], c["inputs"])


def test_targets_are_shifted_inputs():
    b = synth_batch(CFG, SHAPE, 0)
    np.testing.assert_array_equal(b["inputs"][:, 1:], b["targets"][:, :-1])


def test_host_sharding_partitions_global_batch():
    full = synth_batch(CFG, SHAPE, 3, DataConfig(host_count=1))
    h0 = synth_batch(CFG, SHAPE, 3, DataConfig(host_count=2, host_index=0))
    h1 = synth_batch(CFG, SHAPE, 3, DataConfig(host_count=2, host_index=1))
    np.testing.assert_array_equal(full["inputs"][:4], h0["inputs"])
    np.testing.assert_array_equal(full["inputs"][4:], h1["inputs"])


def test_embed_frontend_stub():
    cfg = get_config("musicgen-large")
    b = synth_batch(cfg, SHAPE, 0)
    assert b["inputs"].shape == (8, 32, cfg.d_model)
    assert b["inputs"].dtype == np.float32


def test_prefetcher_yields_in_order():
    pf = Prefetcher(CFG, SHAPE, start_step=10)
    first = next(pf)
    second = next(pf)
    pf.close()
    want1 = synth_batch(CFG, SHAPE, 10)
    want2 = synth_batch(CFG, SHAPE, 11)
    np.testing.assert_array_equal(first["inputs"], want1["inputs"])
    np.testing.assert_array_equal(second["inputs"], want2["inputs"])

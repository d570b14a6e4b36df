"""A run of each cell on the CPU at a small size, past the harness's look
for a card: sound, its check passes; with the timed path broken
underneath in each way the cell can break, ``correct`` comes out false."""
import dataclasses

import pytest

from bench.tests import _tiny

NET, TRAIN = "resnet50-b64.fused", "mamba2-1.3b.train.8x512"


@pytest.mark.parametrize("cell", [NET, TRAIN])
def test_sound_run_is_correct(cell, capsys):
    line = _tiny.run_cell(cell, capsys)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


def test_network_answer_altered(monkeypatch, capsys):
    """Two images' outputs swapped where the classifier writes them."""
    from repro_torch.lower import netexec
    real = netexec.run_fc

    def swapped(plan, x, w):
        out = real(plan, x, w)
        return out[[1, 0] + list(range(2, out.shape[0]))]
    monkeypatch.setattr(netexec, "run_fc", swapped)
    assert not _tiny.run_cell(NET, capsys)["correct"]


def test_train_state_unchanged(monkeypatch, capsys):
    """The optimizer's update returns parameters and state untouched."""
    from repro_torch.optim import optimizers
    real = optimizers.adamw

    def frozen(**kw):
        opt = real(**kw)
        return dataclasses.replace(
            opt, update=lambda grads, state, params, *a: (params, state))
    monkeypatch.setattr(optimizers, "adamw", frozen)
    line = _tiny.run_cell(TRAIN, capsys)
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_the_batch(monkeypatch, capsys):
    """The loss leaves out half of the batch, its mean over the rest."""
    from repro_torch.models import api as mapi
    real = mapi.build_model

    def halved(*a, **kw):
        api = real(*a, **kw)
        loss = api.loss_fn

        def half(params, batch):
            return loss(params, {k: v[:v.shape[0] // 2]
                                 for k, v in batch.items()})
        return dataclasses.replace(api, loss_fn=half)
    monkeypatch.setattr(mapi, "build_model", halved)
    assert not _tiny.run_cell(TRAIN, capsys)["correct"]

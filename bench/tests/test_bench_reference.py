"""Each plain reference agrees with the program at a small size on the
CPU, where the program runs its plain kernel versions, in float32."""
import json

import pytest
import torch

from bench.harness import cells
from bench.reference import mamba2, resnet
from bench.tests import _tiny

CFG_NET = dict(json.loads((cells.ROOT / "bench/configs/resnet50-b64-16x16"
                                        ".json").read_text()), **_tiny.NETWORK)
CFG_LM = dict(json.loads((cells.ROOT / "bench/configs/mamba2-1.3b.json")
                         .read_text()), **_tiny.MAMBA2)


def test_network_reference_matches_the_program():
    from repro_torch.core.solver import solve
    from repro_torch.hw import presets
    from repro_torch.lower import lower_network, network_runner
    from bench.drivers import network
    graph = network.program_graph(CFG_NET)
    hw = presets.eyeriss_multinode()
    nplan = lower_network(solve(graph, hw), graph, hw)
    w = resnet.make_weights(CFG_NET, 3, "cpu")
    image = resnet.make_images(CFG_NET, 3, "cpu", 1)[0]
    inputs = dict(w, **{"conv1.I": image})
    got = network_runner(nplan, inputs, device="cpu")().outputs
    want = resnet.forward(CFG_NET, w, image,
                          keep=tuple(l["name"] for l in
                                     resnet.layers(CFG_NET)))
    for name, ref in want.items():
        assert resnet.rel_error(got[name], ref) < 1e-5, name


def _port(dtype=torch.float32):
    from repro_torch.models.api import build_model
    from bench.drivers import _lm
    api = build_model(_lm.model_config(CFG_LM), device="cpu",
                      dtype=dtype)
    w = mamba2.make_weights(CFG_LM, 4, "cpu", dtype)
    model = _lm.port_model(CFG_LM, w)
    _lm.check_shapes(CFG_LM, api, model)
    return api, model, w


def test_lm_forward_and_loss_match_the_program():
    api, model, w = _port()
    toks = torch.randint(1, 256, (2, 64), generator=torch.Generator()
                         .manual_seed(0), dtype=torch.int32)
    with torch.no_grad():
        got = api.forward(model, toks)
        want = mamba2.logits(w, toks, CFG_LM)
        assert float((got - want).abs().max() / want.abs().max()) < 1e-4
        batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
        assert float(api.loss_fn(model, batch)) == pytest.approx(
            float(mamba2.loss(w, batch["inputs"], batch["targets"], CFG_LM,
                              remat=False)), rel=1e-5)


def test_training_readings_match_the_programs_step():
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim.optimizers import make_optimizer
    api, model, w = _port()
    for p in model.parameters():
        p.requires_grad_(True)
    hp = dict(CFG_LM["optimizer"])
    opt = make_optimizer(hp["name"], **{k: v for k, v in hp.items()
                                        if k != "name"})
    state = opt.init(dict(model.named_parameters()))
    step = build_train_step(api, opt)
    g = torch.Generator().manual_seed(2)
    batches = []
    for _ in range(2):
        rows = torch.randint(1, 256, (2, 33), generator=g, dtype=torch.int32)
        batches.append({"inputs": rows[:, :-1], "targets": rows[:, 1:]})
    losses = []
    for k, b in enumerate(batches):
        losses.append(float(step(model, state, b)[2]["loss"]))
        if k == 0:
            first = {n: float(m.norm()) / (1 - hp["b1"])
                     for n, m in state["m"].items()}
    want = mamba2.train_readings(CFG_LM, w, batches, hp)
    assert losses == pytest.approx(want["losses"], rel=1e-5)
    assert mamba2.worst(mamba2.norm_gaps(first, want["first_grad"]))[0] < 1e-4
    named = dict(model.named_parameters())
    change = {one: float((named[one].detach()
                          - mamba2.layer_leaf(w, st, i)).norm())
              for one, st, i in mamba2.leaf_names(CFG_LM)}
    assert mamba2.median(mamba2.norm_gaps(change, want["change"])) < 1e-3

"""Show the KAPLA-style autoshard plan for an architecture x shape on a
production mesh, without its devices: the candidate log, the chosen plan,
the HBM per chip, and example parameter specs under the port's per-layer
names.  The port of ``examples/autoshard_plan.py``: the same arguments and
sections, the parameters and optimizer state as ``meta`` tensors.  It
plans for the example's target, the reference's v5e pod spec
(``hw/template.py`` ``TPUPodSpec``, a copy), so its candidate log and
chosen plan are the example's line for line; the dry-run plans the same
cells for the H100 (``python -m repro_torch.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.autoshard_plan --arch kimi-k2-1t-a32b
"""
from __future__ import annotations

import argparse
import sys

from .configs import SHAPES, get_config
from .core.autoshard import plan_sharding
from .hw.template import TPUPodSpec
from .launch.mesh import make_production_mesh
from .models.api import build_model, layer_stacks
from .optim.optimizers import make_optimizer

#: the parameter names whose specs are shown (the reference's filter)
SHOWN = ("wq", ".wi", "embed", "lm_head", "w_x", "moe")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="kimi-k2-1t-a32b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    mesh = make_production_mesh(multi_pod=args.multi_pod)
    train = shape.mode == "train"
    api = build_model(cfg, device="meta", trainable=train, mesh=mesh)
    params = api.init(0)
    opt = make_optimizer(cfg.optimizer, stacks=layer_stacks(cfg, params)
                         ).init(dict(params.named_parameters())) \
        if train else {}
    plan = plan_sharding(cfg, shape, mesh, params, opt, pod=TPUPodSpec())

    print(f"plan for {args.arch} x {args.shape} on {mesh.shape}:")
    print("  solver candidate log (validity check + cost estimate):")
    for n in plan.notes:
        print(f"    {n}")
    print(f"  chosen: zero={plan.zero_opt} attn_sharded={plan.attn_sharded} "
          f"hbm/chip={plan.hbm_gb_per_chip:.1f} GiB")
    print("  example param specs:")
    shown = 0
    for name, spec in list(plan.param_specs.items())[:60]:
        if any(t in name for t in SHOWN):
            print(f"    {name}: {spec}")
            shown += 1
            if shown > 8:
                break
    return 0


if __name__ == "__main__":
    sys.exit(main())

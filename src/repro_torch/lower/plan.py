"""Lower a solved ``LayerScheme`` to a concrete, executable ``KernelPlan``.

This is the bridge between the two halves of the repo: the numpy solver
produces tensor-centric directives (temporal factors + loop order + spatial
factors per memory level); this module compiles them into the exact
quantities a ``pl.pallas_call`` needs:

  * the **grid**: one axis per DRAM-level temporal loop, ordered exactly as
    the solver's outermost loop order (outer -> inner, lexicographic Pallas
    iteration);
  * per-dim **block sizes**: everything inside one grid step — the on-chip
    working set (all node GBUF tiles plus the spatial unrolling below them);
  * per-tensor **BlockSpec index maps**: a tensor's block index along an
    array axis is the grid coordinate of the dim mapped to that axis, or 0
    for dims the tensor is blocked over entirely on-chip — the direct
    analogue of the directive rule "a tensor refetches when a relevant
    outer loop advances".

Validity is re-checked at lowering time: the factors must exactly tile the
layer dims, and each tensor's per-buffer tile at every on-chip level must
fit the ``HWTemplate`` capacity the solver assumed (the scheme's own
footprint model, so the check can never diverge from what was scored).  A
plan that fails any check is returned with ``valid=False`` and a reason,
never half executable.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..hw.template import HWTemplate
from ..workloads.layers import DIMS, LayerSpec
from ..core.cost_model import CostBreakdown, evaluate_layer
from ..core.directives import LayerScheme, smallest_prime_factor

SUPPORTED_KINDS = ("conv", "fc", "attention", "pool", "eltwise")


@dataclasses.dataclass(frozen=True)
class GridAxis:
    dim: str        # blocking dim ("N", "C", "K", "X", "Y")
    steps: int      # number of grid steps along this axis


@dataclasses.dataclass
class KernelPlan:
    """A fully-resolved execution recipe for one layer scheme."""

    layer: LayerSpec
    scheme: LayerScheme            # the (possibly repaired) scheme executed
    kind: str                      # conv | fc | attention
    grid: Tuple[GridAxis, ...]     # outer -> inner
    block: Dict[str, int]          # per-dim on-chip block size per grid step
    valid: bool
    reason: str = ""
    level_footprints: Tuple[float, ...] = ()   # bytes per on-chip level
    predicted: Optional[CostBreakdown] = None  # detailed-model standalone cost

    @property
    def invalid_reason(self) -> str:
        """Why the plan cannot execute ("" for valid plans)."""
        return "" if self.valid else self.reason

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        return tuple(ax.steps for ax in self.grid)

    @property
    def grid_steps(self) -> int:
        p = 1
        for ax in self.grid:
            p *= ax.steps
        return p

    def axis_of(self, dim: str) -> int:
        """Grid-axis position of ``dim`` (-1 when the dim is not blocked)."""
        for i, ax in enumerate(self.grid):
            if ax.dim == dim:
                return i
        return -1

    def index_map(self, axes: Sequence[str]) -> Callable:
        """Pallas ``BlockSpec`` index map for a tensor laid out with one
        array axis per entry of ``axes`` (a dim name, or "*" for axes that
        are never blocked, e.g. conv's R/S)."""
        pos = [self.axis_of(d) if d != "*" else -1 for d in axes]

        def imap(*gidx):
            return tuple(gidx[p] if p >= 0 else 0 for p in pos)
        return imap

    def describe(self) -> str:
        g = " x ".join(f"{ax.dim}:{ax.steps}" for ax in self.grid) or "1"
        blk = ", ".join(f"{d}={v}" for d, v in sorted(self.block.items())
                        if self.layer.dim(d) > 1)
        return (f"plan[{self.layer.name}/{self.kind}] grid({g}) "
                f"block({blk})" + ("" if self.valid else
                                   f" INVALID: {self.reason}"))


def _invalid(scheme: LayerScheme, kind: str, reason: str) -> KernelPlan:
    return KernelPlan(layer=scheme.layer, scheme=scheme, kind=kind,
                      grid=(), block={}, valid=False, reason=reason)


def _grid_axes(scheme: LayerScheme) -> List[GridAxis]:
    """DRAM-level temporal loops as grid axes, outer -> inner, following the
    solver's loop order; dims blocked but missing from the order (custom
    orders) append innermost, mirroring the cost model's nest."""
    top = scheme.levels[-1]
    axes = [GridAxis(d, top.tf(d)) for d in top.order if top.tf(d) > 1]
    listed = {ax.dim for ax in axes}
    axes += [GridAxis(d, top.tf(d)) for d in DIMS
             if top.tf(d) > 1 and d not in listed]
    return axes


def _concrete_footprints(scheme: LayerScheme, hw: HWTemplate
                         ) -> Tuple[Tuple[float, ...], str]:
    """Per-buffer footprint bytes at every on-chip level vs the capacities
    the solver assumed (returns (footprints, error)).  Uses the scheme's
    own footprint model so lowering validity can never diverge from what
    the cost model scored."""
    fps: List[float] = []
    for lv in range(len(hw.levels) - 1):
        fp = scheme.level_footprint_bytes(lv)
        cap = hw.levels[lv].capacity_bytes
        if fp > cap:
            return tuple(fps), (f"{hw.levels[lv].name} block footprint "
                                f"{fp:.0f}B > {cap:.0f}B")
        fps.append(fp)
    return tuple(fps), ""


def _repair_attention(scheme: LayerScheme, hw: HWTemplate
                      ) -> Optional[LayerScheme]:
    """Attention plans need the head dim (K) resident per block — softmax
    statistics are per (N, X) row and the PV product consumes whole rows.
    If the solver split K at the DRAM level, hoist that factor into the
    outermost on-chip level; when that overflows the buffer, demote query /
    batch / KV-position blocking to the DRAM nest to make room (the
    standard flash-attention shape: full head dim, blocked rows)."""
    top = scheme.levels[-1]
    if top.tf("K") == 1:
        return scheme
    fixed = LayerScheme(scheme.layer, [lv.copy() for lv in scheme.levels])
    gbuf = fixed.levels[-2]
    gbuf.t["K"] = gbuf.tf("K") * top.tf("K")
    fixed.levels[-1].t["K"] = 1
    _, err = _concrete_footprints(fixed, hw)
    for d in ("X", "N", "C"):
        while err and gbuf.tf(d) > 1:
            p = smallest_prime_factor(gbuf.tf(d))
            gbuf.t[d] = gbuf.tf(d) // p
            fixed.levels[-1].t[d] = fixed.levels[-1].tf(d) * p
            _, err = _concrete_footprints(fixed, hw)
        if not err:
            break
    return None if err else fixed


def lower_scheme(scheme: LayerScheme, hw: HWTemplate,
                 repair: bool = True) -> KernelPlan:
    """Compile one solved intra-layer scheme into a ``KernelPlan``.

    The returned plan's ``predicted`` cost is the detailed model evaluated
    on the *executed* scheme (standalone: all boundary tensors streamed
    from DRAM), so calibration compares like with like even when
    ``repair`` adjusted the scheme.
    """
    layer = scheme.layer
    kind = layer.kind
    if kind not in SUPPORTED_KINDS:
        return _invalid(scheme, kind, f"unsupported layer kind {kind!r}")
    if len(scheme.levels) != len(hw.levels) or len(hw.levels) < 3:
        return _invalid(scheme, kind, "level count mismatch")
    if not scheme.validate_factors():
        return _invalid(scheme, kind, "factors do not multiply to dims")
    if kind in ("conv", "pool") and not {"R", "S", "stride"} <= set(layer.meta):
        return _invalid(scheme, kind, f"{kind} layer lacks R/S/stride meta")

    if kind == "attention":
        reshaped = _repair_attention(scheme, hw) if repair else \
            (scheme if scheme.levels[-1].tf("K") == 1 else None)
        if reshaped is None:
            return _invalid(scheme, kind,
                            "attention head-dim split at DRAM level "
                            "(K rows must stay block-resident)")
        scheme = reshaped

    top = scheme.levels[-1]
    block: Dict[str, int] = {}
    for d in DIMS:
        if layer.dim(d) % top.tf(d) != 0:
            return _invalid(scheme, kind,
                            f"dim {d}={layer.dim(d)} not divisible by "
                            f"DRAM factor {top.tf(d)}")
        block[d] = layer.dim(d) // top.tf(d)

    fps, err = _concrete_footprints(scheme, hw)
    if err:
        return _invalid(scheme, kind, err)

    plan = KernelPlan(layer=layer, scheme=scheme, kind=kind,
                      grid=tuple(_grid_axes(scheme)), block=block,
                      valid=True, level_footprints=fps,
                      predicted=evaluate_layer(scheme, hw))
    return plan


def lower_schedule(schedule, graph, hw: HWTemplate,
                   repair: bool = True) -> Dict[str, KernelPlan]:
    """Lower every supported layer of a solved ``NetworkSchedule``;
    unsupported kinds come back as invalid plans (with reasons) so callers
    can see exactly what is and is not executable."""
    plans: Dict[str, KernelPlan] = {}
    for name, scheme in schedule.layer_schemes.items():
        plans[name] = lower_scheme(scheme, hw, repair=repair)
    return plans

"""Layer and network specifications for the KAPLA dataflow solver.

The paper (§II-A) targets CONV and FC layers plus depthwise CONV, pooling and
element-wise layers, for both inference and training (backward layers "modeled
similarly to the forward layers with different data layouts").

We use a *generic* layer description: a set of named loop dimensions, a set of
named tensors each relevant to a subset of those dimensions, and per-tensor
"unit" multipliers that absorb the within-unit footprint (e.g. the R*S filter
window, the input halo).  This lets one analytic model cover forward CONV/FC,
depthwise CONV, pooling, element-wise ops, and all backward layer types.

Cross-level blocking dimensions are N, C, K, X, Y (filter dims R, S are kept at
the PE/unit level, which matches row-stationary and systolic PE mappings).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Tuple

DIMS = ("N", "C", "K", "X", "Y")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """A single NN layer, in solver-generic form.

    dims:    loop dimension name -> total size (absent dims have size 1).
    tensors: tensor name -> frozenset of relevant dims (dims that index it).
    unit:    tensor name -> per-point element multiplier (R*S for weights,
             input halo ratio for inputs, 1 otherwise).
    macs_per_point: MAC (or op) count per point of the full dim iteration
             space (R*S for conv, 1 for fc).
    reduction_dims: dims accumulated into the output tensor 'O' (partial-sum
             traffic doubles when these loops sit outside O's residency).
    """

    name: str
    kind: str
    dims: Mapping[str, int]
    tensors: Mapping[str, FrozenSet[str]]
    unit: Mapping[str, float]
    macs_per_point: float
    reduction_dims: FrozenSet[str]
    src: Tuple[str, ...] = ()
    bytes_per_elem: int = 2
    has_weights: bool = True
    # per-tensor unit multipliers at the innermost (PE/REGF) level: a PE's
    # working set is one 1-D conv row (one filter row, one input row span,
    # one psum), not the full R*S window — matching row-stationary /
    # systolic PE mappings.  Defaults to ``unit`` when None.
    unit_inner: Optional[Mapping[str, float]] = None
    # kind-specific execution parameters needed to *run* the layer (the
    # analytic model folds them into ``unit``/``macs_per_point``): R, S and
    # stride for conv-family layers, causal for attention.  Excluded from
    # the solver memo signature — it only affects lowering/execution.
    meta: Mapping[str, float] = dataclasses.field(default_factory=dict)

    def inner_unit(self, t: str) -> float:
        u = self.unit_inner if self.unit_inner is not None else self.unit
        return u.get(t, 1.0)

    # ---- derived quantities -------------------------------------------------
    def dim(self, d: str) -> int:
        return int(self.dims.get(d, 1))

    def tensor_size(self, t: str) -> float:
        """Total element count of tensor ``t``."""
        sz = self.unit.get(t, 1.0)
        for d in self.tensors[t]:
            sz *= self.dim(d)
        return sz

    def total_macs(self) -> float:
        macs = self.macs_per_point
        for d in DIMS:
            macs *= self.dim(d)
        return macs

    def total_points(self) -> float:
        p = 1.0
        for d in DIMS:
            p *= self.dim(d)
        return p

    @property
    def weight_tensor(self) -> Optional[str]:
        return "W" if "W" in self.tensors else None

    def footprint_bytes(self) -> float:
        return sum(self.tensor_size(t) for t in self.tensors) * self.bytes_per_elem

    def ofmap_size(self) -> float:
        return self.tensor_size("O")

    # ---- JSON (de)serialization --------------------------------------------
    def to_json_dict(self) -> Dict:
        """Stable JSON-safe form (frozensets become sorted lists)."""
        return {
            "name": self.name, "kind": self.kind,
            "dims": dict(self.dims),
            "tensors": {t: sorted(rel) for t, rel in self.tensors.items()},
            "unit": dict(self.unit),
            "macs_per_point": self.macs_per_point,
            "reduction_dims": sorted(self.reduction_dims),
            "src": list(self.src),
            "bytes_per_elem": self.bytes_per_elem,
            "has_weights": self.has_weights,
            "unit_inner": None if self.unit_inner is None
            else dict(self.unit_inner),
            "meta": dict(self.meta),
        }

    @staticmethod
    def from_json_dict(d: Mapping) -> "LayerSpec":
        return LayerSpec(
            name=d["name"], kind=d["kind"],
            dims={k: int(v) for k, v in d["dims"].items()},
            tensors={t: frozenset(rel) for t, rel in d["tensors"].items()},
            unit=dict(d["unit"]),
            macs_per_point=float(d["macs_per_point"]),
            reduction_dims=frozenset(d["reduction_dims"]),
            src=tuple(d.get("src", ())),
            bytes_per_elem=int(d.get("bytes_per_elem", 2)),
            has_weights=bool(d.get("has_weights", True)),
            unit_inner=None if d.get("unit_inner") is None
            else dict(d["unit_inner"]),
            meta=dict(d.get("meta", {})))

    def ifmap_size(self) -> float:
        return self.tensor_size("I") if "I" in self.tensors else 0.0


def conv(name: str, n: int, c: int, k: int, xo: int, yo: int, r: int, s: int,
         stride: int = 1, src: Sequence[str] = ()) -> LayerSpec:
    xi = xo * stride + max(r - stride, 0)
    yi = yo * stride + max(s - stride, 0)
    halo = (xi * yi) / float(xo * yo)
    return LayerSpec(
        name=name, kind="conv",
        dims={"N": n, "C": c, "K": k, "X": xo, "Y": yo},
        tensors={"I": frozenset({"N", "C", "X", "Y"}),
                 "W": frozenset({"C", "K"}),
                 "O": frozenset({"N", "K", "X", "Y"})},
        unit={"I": halo, "W": float(r * s), "O": 1.0},
        unit_inner={"I": xi / float(xo), "W": float(r), "O": 1.0},
        macs_per_point=float(r * s),
        reduction_dims=frozenset({"C"}),
        src=tuple(src),
        meta={"R": r, "S": s, "stride": stride})


def fc(name: str, n: int, c: int, k: int, src: Sequence[str] = ()) -> LayerSpec:
    return LayerSpec(
        name=name, kind="fc",
        dims={"N": n, "C": c, "K": k},
        tensors={"I": frozenset({"N", "C"}),
                 "W": frozenset({"C", "K"}),
                 "O": frozenset({"N", "K"})},
        unit={"I": 1.0, "W": 1.0, "O": 1.0},
        macs_per_point=1.0,
        reduction_dims=frozenset({"C"}),
        src=tuple(src))


def dwconv(name: str, n: int, c: int, xo: int, yo: int, r: int, s: int,
           stride: int = 1, src: Sequence[str] = ()) -> LayerSpec:
    xi = xo * stride + max(r - stride, 0)
    yi = yo * stride + max(s - stride, 0)
    halo = (xi * yi) / float(xo * yo)
    return LayerSpec(
        name=name, kind="dwconv",
        dims={"N": n, "C": c, "X": xo, "Y": yo},
        tensors={"I": frozenset({"N", "C", "X", "Y"}),
                 "W": frozenset({"C"}),
                 "O": frozenset({"N", "C", "X", "Y"})},
        unit={"I": halo, "W": float(r * s), "O": 1.0},
        unit_inner={"I": xi / float(xo), "W": float(r), "O": 1.0},
        macs_per_point=float(r * s),
        reduction_dims=frozenset(),
        src=tuple(src),
        meta={"R": r, "S": s, "stride": stride})


def pool(name: str, n: int, c: int, xo: int, yo: int, r: int, s: int,
         stride: int = 2, src: Sequence[str] = ()) -> LayerSpec:
    xi = xo * stride + max(r - stride, 0)
    yi = yo * stride + max(s - stride, 0)
    halo = (xi * yi) / float(xo * yo)
    return LayerSpec(
        name=name, kind="pool",
        dims={"N": n, "C": c, "X": xo, "Y": yo},
        tensors={"I": frozenset({"N", "C", "X", "Y"}),
                 "O": frozenset({"N", "C", "X", "Y"})},
        unit={"I": halo, "O": 1.0},
        unit_inner={"I": xi / float(xo), "O": 1.0},
        macs_per_point=float(r * s),
        reduction_dims=frozenset(),
        src=tuple(src), has_weights=False,
        meta={"R": r, "S": s, "stride": stride})


def attention(name: str, batch: int, heads: int, seq_q: int, d_head: int,
              seq_kv: Optional[int] = None,
              src: Sequence[str] = ()) -> LayerSpec:
    """Fused attention scores+context op (softmax(QK^T) V) for one head
    group, in solver-generic form.

    Dim mapping: N = batch*heads (independent rows), X = query positions,
    C = KV positions (the softmax/weighted-sum reduction), K = head dim.
    Tensors: I = Q [N, X, K]; W = the K/V pair [N, C, K] (unit 2.0 — both
    operands stream together); O [N, X, K].  Two MACs per point of the
    N x X x C x K space (QK^T and PV).  The scores/probs matrix never
    appears as a tensor — like flash attention, it lives within a block.
    """
    skv = seq_kv if seq_kv is not None else seq_q
    return LayerSpec(
        name=name, kind="attention",
        dims={"N": batch * heads, "X": seq_q, "C": skv, "K": d_head},
        tensors={"I": frozenset({"N", "X", "K"}),
                 "W": frozenset({"N", "C", "K"}),
                 "O": frozenset({"N", "X", "K"})},
        unit={"I": 1.0, "W": 2.0, "O": 1.0},
        macs_per_point=2.0,
        reduction_dims=frozenset({"C"}),
        src=tuple(src),
        meta={"batch": batch, "heads": heads})


def eltwise(name: str, n: int, c: int, xo: int, yo: int,
            src: Sequence[str] = ()) -> LayerSpec:
    return LayerSpec(
        name=name, kind="eltwise",
        dims={"N": n, "C": c, "X": xo, "Y": yo},
        tensors={"I": frozenset({"N", "C", "X", "Y"}),
                 "O": frozenset({"N", "C", "X", "Y"})},
        unit={"I": 2.0, "O": 1.0},   # two summands
        macs_per_point=1.0,
        reduction_dims=frozenset(),
        src=tuple(src), has_weights=False)


# ---------------------------------------------------------------------------
# Backward layers (training).  Modeled as CONV-like layers with transposed
# data layouts, per §II-A of the paper.
# ---------------------------------------------------------------------------

def backward_data(fwd: LayerSpec) -> LayerSpec:
    """dI = dO (*) W^T: same shape family as forward with C and K swapped."""
    d = dict(fwd.dims)
    c, k = d.get("C", 1), d.get("K", 1)
    d["C"], d["K"] = k, c
    return dataclasses.replace(
        fwd, name=fwd.name + ".bd", kind=fwd.kind + "_bd", dims=d,
        src=(fwd.name + ".grad_in",))


def backward_weight(fwd: LayerSpec) -> LayerSpec:
    """dW = I (*) dO: output is the weight tensor; N, X, Y are reduced."""
    return dataclasses.replace(
        fwd, name=fwd.name + ".bw", kind=fwd.kind + "_bw",
        tensors={"I": fwd.tensors["I"],
                 "W": fwd.tensors["O"],        # dO plays the streamed role
                 "O": fwd.tensors.get("W", frozenset({"C", "K"}))},
        unit={"I": fwd.unit.get("I", 1.0),
              "W": 1.0,
              "O": fwd.unit.get("W", 1.0)},
        reduction_dims=frozenset({"N", "X", "Y"} & set(fwd.dims)),
        src=(fwd.name,))


@dataclasses.dataclass
class LayerGraph:
    """An NN as a topologically-ordered list of layers with data deps."""

    name: str
    layers: List[LayerSpec]

    def __post_init__(self) -> None:
        self.by_name: Dict[str, LayerSpec] = {l.name: l for l in self.layers}
        if len(self.by_name) != len(self.layers):
            raise ValueError("duplicate layer names in " + self.name)

    def __len__(self) -> int:
        return len(self.layers)

    def total_macs(self) -> float:
        return sum(l.total_macs() for l in self.layers)

    def training_graph(self) -> "LayerGraph":
        """Extend with backward-data and backward-weight layers."""
        out = list(self.layers)
        for l in reversed(self.layers):
            if l.kind in ("conv", "fc", "dwconv"):
                out.append(backward_data(l))
                out.append(backward_weight(l))
        return LayerGraph(self.name + "+train", out)

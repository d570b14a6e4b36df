"""Plain reference of a layer graph of the ResNet family, as the solved
network runs it: weights, inputs and the forward.

The graph is He et al.'s ResNet-50 (arXiv:1512.03385) as a dataflow
solver sees it: convolutions, max pools, element-wise sums and one fully
connected layer, with no batch norm and no ReLU.  A stem convolution and
pool; four stages of bottleneck blocks (1x1 -> 3x3 -> 1x1, the first
block of a stage projecting its input by a strided 1x1 convolution, the
first block of stages 2-4 striding its 1x1 reduction); a 7x7 max pool;
the classifier.  Layer names follow ``r{stage}{block}.{a,b,c,p,add}``.

Each layer takes its input at the extent it needs: a convolution or pool
of output X, stride s and window R reads (X - 1) s + R positions with no
padding of its own; a producer's output of another extent is padded with
zeros, centred (the odd element after), or cropped, centred (the odd
element off the end), as a network executor adapts it; a tensor of the same size per image is reshaped (the classifier's
flatten); the summands of an element-wise layer are adapted alike and
added in order.

Everything is float32, one PyTorch call a layer; ``precision`` rounds the
operands of the convolutions and the classifier for the control.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .precision import full_fp32, operand

#: a layer: {"name", "kind", "N", "C", "K", "X", "Y", "R", "S", "stride",
#: "src"} (a classifier has no extent, window or stride)
Layer = Dict


def layers(cfg: Mapping) -> List[Layer]:
    """The layer list of the configuration's graph, in order."""
    n = int(cfg["batch"])
    stem = cfg["stem"]
    out: List[Layer] = []

    def conv(name, c, k, x, r, stride, src):
        out.append({"name": name, "kind": "conv", "N": n, "C": c, "K": k,
                    "X": x, "Y": x, "R": r, "S": r, "stride": stride,
                    "src": list(src)})

    def pool(name, c, x, r, stride, src):
        out.append({"name": name, "kind": "pool", "N": n, "C": c, "K": c,
                    "X": x, "Y": x, "R": r, "S": r, "stride": stride,
                    "src": list(src)})

    conv("conv1", stem["in_channels"], stem["channels"], stem["conv_out"],
         stem["conv_window"], stem["conv_stride"], [])
    pool("pool1", stem["channels"], stem["pool_out"], stem["pool_window"],
         stem["pool_stride"], ["conv1"])
    prev, c_in = "pool1", stem["channels"]
    for s, st in enumerate(cfg["stages"]):
        for b in range(st["blocks"]):
            name = f"r{s + 2}{chr(97 + b)}"
            stride = 2 if (b == 0 and s > 0) else 1
            x, cm, co = st["extent"], st["mid"], st["out"]
            conv(f"{name}.a", c_in, cm, x, 1, stride, [prev])
            conv(f"{name}.b", cm, cm, x, 3, 1, [f"{name}.a"])
            conv(f"{name}.c", cm, co, x, 1, 1, [f"{name}.b"])
            srcs = [f"{name}.c"]
            if b == 0:
                conv(f"{name}.p", c_in, co, x, 1, stride, [prev])
                srcs.append(f"{name}.p")
            else:
                srcs.append(prev)
            out.append({"name": f"{name}.add", "kind": "eltwise", "N": n,
                        "C": co, "K": co, "X": x, "Y": x, "src": srcs})
            prev, c_in = f"{name}.add", co
    head = cfg["head"]
    pool("gap", c_in, 1, head["pool_window"], head["pool_window"], [prev])
    out.append({"name": "fc", "kind": "fc", "N": n, "C": c_in,
                "K": head["classes"], "src": ["gap"]})
    return out


def input_shape(layer: Layer) -> Tuple[int, ...]:
    """The input a layer reads: [N, C] for the classifier, else
    [N, C, XI, YI] with XI = (X - 1) stride + R (element-wise: the
    output's extent)."""
    if layer["kind"] == "fc":
        return (layer["N"], layer["C"])
    if layer["kind"] == "eltwise":
        return (layer["N"], layer["C"], layer["X"], layer["Y"])
    s = layer["stride"]
    return (layer["N"], layer["C"], (layer["X"] - 1) * s + layer["R"],
            (layer["Y"] - 1) * s + layer["S"])


def weight_shape(layer: Layer) -> Optional[Tuple[int, ...]]:
    if layer["kind"] == "conv":
        return (layer["K"], layer["C"], layer["R"], layer["S"])
    if layer["kind"] == "fc":
        return (layer["C"], layer["K"])
    return None


def adapt(t: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """A producer's output at the extent its consumer reads."""
    shape = tuple(shape)
    if tuple(t.shape) == shape:
        return t
    per_src = t[0].numel()
    per_dst = 1
    for d in shape[1:]:
        per_dst *= d
    if per_src == per_dst:
        return t.reshape(shape)
    if t.dim() == 4 and len(shape) == 4 and t.shape[1] == shape[1]:
        for ax in (2, 3):
            d = shape[ax] - t.shape[ax]
            if d > 0:
                pad = [0, 0, 0, 0]
                pad[2 * (3 - ax)], pad[2 * (3 - ax) + 1] = d // 2, d - d // 2
                t = F.pad(t, pad)
            elif d < 0:
                t = t.narrow(ax, (-d) // 2, shape[ax])
        return t
    if per_src % per_dst == 0:
        k = per_src // per_dst
        return t.reshape(shape[0], k, per_dst).sum(1).reshape(shape)
    raise ValueError(f"cannot adapt {tuple(t.shape)} to {shape}")


def make_weights(cfg: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """``<layer>.W`` of every convolution and the classifier, N(0, 1 /
    fan-in), drawn by one call of a generator seeded with ``seed`` on
    ``device`` and cut into the layers' shapes."""
    shapes = [(f"{l['name']}.W", weight_shape(l)) for l in layers(cfg)
              if weight_shape(l) is not None]
    sizes = [_numel(s) for _, s in shapes]
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        fan_in = shape[0] if len(shape) == 2 else _numel(shape[1:])
        out[name] = (flat[at:at + n].view(shape) * fan_in ** -0.5).clone()
        at += n
    return out


def make_images(cfg: Mapping, seed: int, device, count: int) -> torch.Tensor:
    """``count`` input batches [count, N, C, XI, YI], N(0, 1), one call of
    a generator seeded apart from the weights' one."""
    first = layers(cfg)[0]
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed) + 1)
    return torch.randn((count,) + input_shape(first), generator=g,
                       device=device)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


@torch.no_grad()
def forward(cfg: Mapping, weights: Mapping[str, torch.Tensor],
            image: torch.Tensor, precision: str = "f32",
            keep: Sequence[str] = ("fc",)) -> Dict[str, torch.Tensor]:
    """The outputs ``keep`` of one batch ``image`` [N, C, XI, YI]; each
    value is dropped after its last reader."""
    full_fp32()
    graph = layers(cfg)
    last = {}
    for i, l in enumerate(graph):
        for s in l["src"]:
            last[s] = i
    vals: Dict[str, torch.Tensor] = {}
    out = {}
    for i, l in enumerate(graph):
        shape = input_shape(l)
        srcs = [vals[s] for s in l["src"]]
        kind = l["kind"]
        if kind == "eltwise":
            y = adapt(srcs[0], shape).float()
            for s in srcs[1:]:
                y = y + adapt(s, shape).float()
        else:
            x = adapt(srcs[0], shape) if srcs else image
            if kind == "conv":
                y = F.conv2d(operand(x, precision),
                             operand(weights[f"{l['name']}.W"], precision),
                             stride=l["stride"])
            elif kind == "pool":
                y = F.max_pool2d(x.float(), (l["R"], l["S"]),
                                 stride=l["stride"])
            else:
                y = operand(x, precision) @ operand(
                    weights[f"{l['name']}.W"], precision)
        vals[l["name"]] = y
        if l["name"] in keep:
            out[l["name"]] = y
        for s in l["src"]:
            if last[s] == i:
                vals.pop(s, None)
    return out


def rel_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref|."""
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30))

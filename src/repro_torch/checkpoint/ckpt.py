"""Checkpointing: per-host npz payloads + a JSON manifest, written
atomically (tmp + rename) so a mid-write failure never corrupts the latest
checkpoint.

The port of ``repro/checkpoint/ckpt.py``, with its layout: ``step_%08d/``
holding ``params_h{i}.npz``, ``opt_h{i}.npz`` and ``manifest.json``, written
in a tmp dir beside it and renamed into place; the newest ``keep`` (3)
kept.  A tree is a ``Model`` (or any ``nn.Module``: its leaves are its
``named_parameters()``), a dict, or a leaf (a tensor, a numpy array or a
number); leaves are flattened to keys joined by ``/``.  bfloat16 is stored
as float32 (npz has no bf16) and cast back on restore.  ``restore`` takes
templates and writes every tensor leaf in place, after every leaf of both
trees was read and checked (a missing leaf or a shape mismatch raises and
writes nothing): a module comes back as itself, a dict as a new dict
holding the template's own tensors, and a numpy or number leaf as a new
array of the template's type.  The reference returns new arrays, which
its jitted step takes as arguments; the port's compiled train step
(``launch/steps.py`` ``CompiledTraining``) is a graph over the
parameters' and the optimizer state's addresses, so a restore writes
into them.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

Tree = Any


def _items(tree: Tree, path: Tuple[str, ...] = ()) -> Iterator:
    """(key, leaf) of every leaf of ``tree``."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield "/".join(path + (name,)), p
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, path + (str(k),))
    else:
        yield "/".join(path), tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()                  # npz has no native bf16
        return t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fiub" or arr.dtype.itemsize == 0:
        raise TypeError(f"checkpoint: unsupported leaf of type "
                        f"{type(leaf).__name__} ({arr.dtype})")
    return arr


def _flatten(tree: Tree) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _items(tree)}


def _restored(key: str, arr: np.ndarray, leaf):
    """``arr`` as the template leaf ``leaf``'s kind, type and device."""
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
    if tuple(arr.shape) != shape:
        raise ValueError(f"{key}: shape {arr.shape} != {shape}")
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.array(arr, copy=True)).to(
            device=leaf.device, dtype=leaf.dtype)
    return arr.astype(np.asarray(leaf).dtype)


def _read(template: Tree, flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Every leaf of ``template`` from ``flat``, checked, by key."""
    values = {}
    for key, leaf in _items(template):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        values[key] = _restored(key, flat[key], leaf)
    return values


def _write(template: Tree, values: Dict[str, Any]) -> Tree:
    """``values`` written into the tensor leaves of ``template``; returns
    the tree (a module as itself, a dict as a new dict)."""
    def build(tree, path):
        if isinstance(tree, nn.Module):
            return tree
        if isinstance(tree, dict):
            return {k: build(v, path + (str(k),)) for k, v in tree.items()}
        value = values["/".join(path)]
        return tree if isinstance(tree, torch.Tensor) else value

    with torch.no_grad():
        for key, leaf in _items(template):
            if isinstance(leaf, torch.Tensor):
                leaf.copy_(values[key])
    return build(template, ())


def save(ckpt_dir: str, step: int, params: Tree, opt_state: Tree,
         extra: Optional[Dict[str, Any]] = None, host_index: int = 0,
         keep: int = 3) -> str:
    """Write checkpoint ``step`` atomically; returns the final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f".tmp_step_{step}_", dir=ckpt_dir)
    try:
        np.savez(os.path.join(tmp, f"params_h{host_index}.npz"),
                 **_flatten(params))
        np.savez(os.path.join(tmp, f"opt_h{host_index}.npz"),
                 **_flatten(opt_state))
        manifest = {"step": step, "time": time.time(),
                    "host_index": host_index,
                    "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)           # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and
             os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, params_template: Tree,
            opt_template: Tree, step: Optional[int] = None,
            host_index: int = 0) -> Tuple[Tree, Tree, Dict[str, Any]]:
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, f"params_h{host_index}.npz"),
                 allow_pickle=False) as z:
        p = dict(z)
    with np.load(os.path.join(d, f"opt_h{host_index}.npz"),
                 allow_pickle=False) as z:
        o = dict(z)
    # read and check every leaf of both trees before writing any
    p, o = _read(params_template, p), _read(opt_template, o)
    return _write(params_template, p), _write(opt_template, o), manifest


__all__ = ["latest_step", "restore", "save"]

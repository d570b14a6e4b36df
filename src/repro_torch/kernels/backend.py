"""Where a run goes, and the build of the CUDA kernels.

The one source of truth for the port's device choice:

``resolve_device(None)``
    the card (``cuda``).  With no card it raises; it never falls back to
    the CPU quietly.
``resolve_device("cpu")``
    the CPU, where every kernel wrapper takes its plain PyTorch version
    (the port's counterpart of Pallas interpret mode).
``resolve_device("meta")``
    shapes and types only, as ``jax.eval_shape`` traces: nothing is
    allocated or computed, and a kernel wrapper returns outputs of the
    right shape and type and launches nothing.  The dry-run traces its
    steps there (``launch/dryrun.py``).

The kernels live in two sources under ``repro_torch/csrc/``:
``lower_kernels.cu`` (the layer and network tiers: fc, conv, pool,
eltwise, attention) and
``model_kernels.cu`` (the model zoo: flash attention, the SSD intra-chunk
term, the train step's multi-tensor AdamW).  Each is compiled at first use
with ``nvcc`` for ``sm_90a`` into a shared library of its own with a plain
C interface, loaded with ``ctypes``.
A library goes into ``build/repro_torch/<hash>/`` under the repository root
(``REPRO_TORCH_BUILD_DIR`` overrides it), keyed by the hash of its source,
the headers both include (``online_softmax.cuh``, ``hopper.cuh``) and the
flags, so an edit rebuilds only what it touches and an unchanged tree
reuses the build.  A missing ``nvcc`` or a failed build raises with the
compiler's message.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional, Union

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

CSRC = Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
#: where the CUDA toolkit is looked for after $NVCC, PATH and $CUDA_HOME
CUDA_HOMES = ("/usr/local/cuda",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SOURCE = CSRC / "lower_kernels.cu"
MODEL_SOURCE = CSRC / "model_kernels.cu"
#: C entry points of each source and their argument counts; every argument
#: is a pointer (device buffers, the host parameter arrays, the stream)
ENTRY_POINTS = {
    SOURCE.name: {"kapla_fc": 6, "kapla_conv": 6, "kapla_conv_weights": 5,
                  "kapla_pool": 4,
                  "kapla_eltwise": 4, "kapla_attention": 7},
    MODEL_SOURCE.name: {"kapla_flash_attention": 8,
                        "kapla_ssd_intra_chunk": 9, "kapla_mt_sumsq": 3,
                        "kapla_mt_total": 4, "kapla_mt_adamw": 6},
}

#: element-type codes the model kernels' C entry points take
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
#: loaded libraries by source file name
_libs: Dict[str, ctypes.CDLL] = {}


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """The device a run goes to: ``None`` means the card and raises when
    there is none; ``"cpu"`` selects the plain PyTorch versions;
    ``"meta"`` shapes only."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type in ("cpu", "meta"):
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; expected cuda, cpu or "
                         "meta")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the card by default; pass "
            "device='cpu' to run the plain PyTorch versions instead")
    return dev if dev.index is not None else \
        torch.device("cuda", torch.cuda.current_device())


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                               REPO_ROOT / "build" / "repro_torch"))


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$NVCC``, then ``PATH``, then ``$CUDA_HOME/bin``
    and ``/usr/local/cuda/bin``."""
    cands = [os.environ.get("NVCC"), shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), *CUDA_HOMES):
        if home:
            cands.append(os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found ($NVCC, PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "repro_torch builds its CUDA kernels from src/repro_torch/csrc at "
        "first use and needs the CUDA toolkit for that")


def library_path(source: Path = SOURCE) -> Path:
    """Where the build of ``source`` goes (keyed by the source, the
    headers beside it that both sources share, and the flags)."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return build_dir() / digest[:16] / (source.stem + ".so")


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` (a ``.cu`` file under ``csrc/``) unless its build
    exists; returns the library's path.  ``nvcc``'s ``-Xptxas -v`` report
    (registers, shared memory, spills per kernel) is kept beside it as
    ``<stem>.ptxas.txt``."""
    out = library_path(source)
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}) building "
                           f"{source.name}:\n{proc.stdout}{proc.stderr}")
    out.with_name(out.stem + ".ptxas.txt").write_text(proc.stdout
                                                      + proc.stderr)
    os.replace(tmp, out)
    return out


def library(source: Path = SOURCE) -> ctypes.CDLL:
    """The loaded kernel library of ``source`` (built at first use), with
    every entry point's ``argtypes`` set: pointers and the stream as
    ``c_void_p``."""
    with _lock:
        lib = _libs.get(source.name)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            for name, n_args in ENTRY_POINTS[source.name].items():
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p] * n_args
                fn.restype = ctypes.c_int
            _libs[source.name] = lib
        return lib


def stream_handle(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream, for a C entry
    point (``torch.cuda.current_stream(device).cuda_stream`` without
    building a ``Stream`` object: a few microseconds a launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check_launch(name: str, status: int) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


@contextlib.contextmanager
def kernel_call(name: str, *args, **params) -> Iterator[None]:
    """Wraps one call of a hand kernel's wrapper (``name``, its arguments).
    An active dispatch mode with a ``kernel_call`` method (the cost counter
    of ``launch/op_cost.py``) counts the call as one unit, whatever runs
    inside it: the kernel on the card, the plain version on the CPU, a fake
    output on ``meta``.  Without one it does nothing."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        hook = getattr(mode, "kernel_call", None)
        if hook is not None:
            with hook(name, *args, **params):
                yield
            return
    yield


# ---------------------------------------------------------------------------
# launch counts under CUDA-graph capture
# ---------------------------------------------------------------------------

_recording = threading.local()
#: the tallies of the captures in progress, by the raw handle of the stream
#: each captures: autograd's device thread runs a captured backward on
#: that stream, and its launches belong to the capture too
_stream_tallies: Dict[int, "LaunchTally"] = {}


class LaunchTally(dict):
    """The launches of each kind recorded while a CUDA graph is captured
    (kind -> count; 0 for a kind not recorded), and the table (a module's
    ``LAUNCHES``) each kind belongs to."""

    def __init__(self):
        super().__init__()
        self.tables: Dict[str, Dict[str, int]] = {}

    def __missing__(self, kind: str) -> int:
        return 0

    def add(self, table: Dict[str, int], kind: str, n: int) -> None:
        self[kind] = self[kind] + n
        self.tables[kind] = table

    def replay(self) -> None:
        """Add the recorded launches to their tables: a graph replay runs
        every kernel it captured once."""
        for kind, n in self.items():
            self.tables[kind][kind] += n


def count_launch(table: Dict[str, int], kind: str, n: int = 1) -> None:
    """Add ``n`` launches of ``kind`` to ``table``, or, while this thread
    captures a CUDA graph or the launch goes to a stream being captured
    (``recording_launches``), to the capture's tally, which every replay
    of the graph adds to ``table``: the counts stay those of kernels that
    ran, not of kernels captured."""
    tally = getattr(_recording, "tally", None)
    if tally is None and _stream_tallies:
        tally = _stream_tallies.get(torch.cuda.current_stream().cuda_stream)
    if tally is None:
        table[kind] += n
    else:
        tally.add(table, kind, n)


@contextlib.contextmanager
def recording_launches(stream: Optional[int] = None
                       ) -> Iterator[LaunchTally]:
    """Within the block, this thread's launches, and any thread's onto the
    stream with the raw handle ``stream`` (the one a graph captures), go
    to the yielded tally and not to their tables: a launch inside a graph
    capture runs nothing until the graph replays."""
    prev = getattr(_recording, "tally", None)
    _recording.tally = tally = LaunchTally()
    if stream is not None:
        with _lock:
            _stream_tallies[stream] = tally
    try:
        yield tally
    finally:
        _recording.tally = prev
        if stream is not None:
            with _lock:
                _stream_tallies.pop(stream, None)


__all__ = ["DTYPE_CODES", "ENTRY_POINTS", "LaunchTally", "MODEL_SOURCE",
           "SOURCE", "build", "build_dir", "check_launch", "count_launch",
           "find_nvcc", "kernel_call", "library", "library_path",
           "recording_launches", "resolve_device", "stream_handle"]

"""Deterministic synthetic token pipeline, host-sharded, double-buffered.

At pod scale every host feeds only its local devices; the pipeline is
keyed on (seed, step, host_index) so restarts and elastic re-shards
reproduce the exact global batch without coordination.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    vocab_limit: Optional[int] = None     # sample below this id
    host_index: int = 0
    host_count: int = 1


def _host_slice(global_batch: int, dc: DataConfig):
    per = global_batch // dc.host_count
    lo = per * dc.host_index
    return lo, per


def synth_batch(cfg: ModelConfig, shape: ShapeConfig, step: int,
                dc: DataConfig = DataConfig()) -> Dict[str, np.ndarray]:
    """The global batch for ``step``, restricted to this host's rows."""
    lo, per = _host_slice(shape.global_batch, dc)
    vocab = dc.vocab_limit or min(cfg.vocab_size, 32000)
    rows = []
    tgts = []
    for r in range(lo, lo + per):
        rng = np.random.default_rng(
            np.random.SeedSequence([dc.seed, step, r]))
        seq = rng.integers(1, vocab, size=shape.seq_len + 1, dtype=np.int32)
        rows.append(seq[:-1])
        tgts.append(seq[1:])
    tokens = np.stack(rows)
    targets = np.stack(tgts)
    if cfg.frontend == "embed":
        # modality stub: precomputed frame/patch embeddings
        rng = np.random.default_rng(
            np.random.SeedSequence([dc.seed, step, 10 ** 6 + lo]))
        inputs = rng.standard_normal(
            (per, shape.seq_len, cfg.d_model)).astype(np.float32) * 0.02
        return {"inputs": inputs, "targets": targets}
    return {"inputs": tokens, "targets": targets}


class Prefetcher:
    """Double-buffered background prefetch (overlap host data generation
    with device compute)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 dc: DataConfig = DataConfig(), start_step: int = 0,
                 depth: int = 2):
        self.cfg, self.shape, self.dc = cfg, shape, dc
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            batch = synth_batch(self.cfg, self.shape, self._step, self.dc)
            self._step += 1
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)

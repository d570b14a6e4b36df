"""Persistent, content-addressed schedule store — with self-healing.

On-disk layout (sqlite-free, human-inspectable) under one store dir:

    <root>/
      records/<signature>.json      one versioned record per solve
      index.jsonl                   append-only put log (sig, family,
                                    graph, batch, timestamp)
      quarantine/<signature>.json   corrupt records, moved aside on read

Records wrap ``NetworkSchedule.to_json`` with the signature, the family
signature, the normalized solver options, hardware name, the layer
order, a sha256 ``checksum`` over the record body, plus an optional
``measured`` block the autotuner fills in when it promotes a
measured-fastest schedule.  All writes are atomic (temp file +
``os.replace``; index appends are single short lines), so a killed
writer never leaves a torn record.

Failure semantics (the resilience contract the service tier builds on):

* a **missing** record is a miss (``None``);
* a **corrupt** record (unparseable JSON, checksum mismatch, wrong
  shape) is quarantined to ``<root>/quarantine/`` — never silently
  re-read — and reads as a miss; ``corrupt``/``quarantined`` counters
  track it;
* a **store I/O failure** (disk error, injected fault) raises the typed
  ``StoreError`` so callers (the server's circuit breaker) can degrade
  to solve-without-caching instead of crashing;
* a **damaged index** (torn tail from a killed appender, garbage bytes)
  is rebuilt from the records dir on open — records are the source of
  truth, the index is a cache; stale ``*.tmp`` files from killed writers
  are swept on open.  Killing a ``put`` mid-write therefore always
  leaves a store that loads clean.

Reads are content-addressed: ``get(signature)`` either misses or returns
a schedule that re-scores bit-identically to the original solve
(parity-tested).  A graph whose layer *names* differ from the stored ones
(same signature — signatures never see names) is re-bound positionally.
``warm_records(family)`` returns near-misses — same graph family,
different batch — whose chains can seed a warm-start solve
(``kapla.seed_chains_from``).

Eviction is LRU over record-file mtimes (hits refresh the mtime), bounded
by ``max_entries``; hit/miss/eviction counts are exposed via ``stats()``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import time
from typing import Dict, List, Mapping, Optional, Sequence

from ..core.solver.kapla import NetworkSchedule
from ..hw.template import HWTemplate
from ..obs import metrics
from ..runtime import inject
from ..workloads.layers import LayerGraph
from .signature import family_signature, schedule_signature, solver_options

STORE_VERSION = 2
#: default store dir (overridable per-store or via REPRO_STORE_DIR)
DEFAULT_ROOT = os.environ.get("REPRO_STORE_DIR", ".repro_store")


class StoreError(RuntimeError):
    """A store I/O failure (not a miss, not corruption): the record may
    be fine but the store could not be reached.  The server's circuit
    breaker counts these and degrades to solve-without-caching."""


class _Corrupt(ValueError):
    """Internal: a record that parsed wrongly or failed its checksum."""


@dataclasses.dataclass
class StoreRecord:
    """One versioned store entry (the JSON record, typed)."""

    signature: str
    family: str
    graph_name: str
    batch: int
    options: Dict
    hw_name: str
    created: float
    predicted_energy_pj: float
    predicted_latency_cycles: float
    layer_order: List[str]
    schedule: Dict                      # NetworkSchedule.to_json()
    measured: Optional[Dict] = None     # autotune promotion metadata
    version: int = STORE_VERSION
    checksum: Optional[str] = None      # sha256 over the body (see below)

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Mapping) -> "StoreRecord":
        known = {f.name for f in dataclasses.fields(StoreRecord)}
        return StoreRecord(**{k: v for k, v in d.items() if k in known})


def record_checksum(d: Mapping) -> str:
    """sha256 over the canonical JSON of the record minus its
    ``checksum`` field — what ``put`` stamps and reads verify."""
    body = {k: v for k, v in d.items() if k != "checksum"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()).hexdigest()


def _graph_batch(graph: LayerGraph) -> int:
    return graph.layers[0].dim("N") if graph.layers else 1


def _atomic_write(path: str, text: str) -> None:
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class ScheduleStore:
    """Content-addressed schedule store rooted at ``root`` (created on
    first use).  Thread-compatible for the in-process server: all state
    lives on disk; counters are advisory."""

    def __init__(self, root: str = DEFAULT_ROOT, max_entries: int = 512):
        self.root = root
        self.records_dir = os.path.join(root, "records")
        self.index_path = os.path.join(root, "index.jsonl")
        self.quarantine_dir = os.path.join(root, "quarantine")
        os.makedirs(self.records_dir, exist_ok=True)
        self.max_entries = max_entries
        # per-instance counters mirrored into the process registry as
        # store_events_total{event=...} (repro.obs.metrics)
        self._events = metrics.CounterGroup("store", (
            "reads", "writes", "hits", "misses", "evictions",
            "warm_hits", "corrupt", "quarantined", "io_errors",
            "rebuilds"))
        # family -> [signatures], replayed from the index, filtered to
        # records that still exist (evicted entries drop out naturally)
        self._family: Dict[str, List[str]] = {}
        self._sweep_tmp()
        damaged = self._replay_index()
        if damaged or (len(self) > 0 and not os.path.exists(self.index_path)):
            self.rebuild_index()

    # -- counter views (the numbers live in obs.metrics via CounterGroup) ----
    @property
    def hits(self) -> int:
        return self._events["hits"]

    @property
    def misses(self) -> int:
        return self._events["misses"]

    @property
    def evictions(self) -> int:
        return self._events["evictions"]

    @property
    def warm_hits(self) -> int:
        return self._events["warm_hits"]

    @property
    def corrupt(self) -> int:
        return self._events["corrupt"]

    @property
    def quarantined(self) -> int:
        return self._events["quarantined"]

    @property
    def io_errors(self) -> int:
        return self._events["io_errors"]

    @property
    def rebuilds(self) -> int:
        return self._events["rebuilds"]

    # -- signatures (convenience passthroughs) -------------------------------
    def signature(self, graph: LayerGraph, hw: HWTemplate,
                  options: Optional[Mapping] = None) -> str:
        return schedule_signature(graph, hw, options)

    def family(self, graph: LayerGraph, hw: HWTemplate,
               options: Optional[Mapping] = None) -> str:
        return family_signature(graph, hw, options)

    # -- paths / existence ---------------------------------------------------
    def _rec_path(self, sig: str) -> str:
        return os.path.join(self.records_dir, f"{sig}.json")

    def has(self, sig: str) -> bool:
        return os.path.exists(self._rec_path(sig))

    def __len__(self) -> int:
        return sum(1 for n in os.listdir(self.records_dir)
                   if n.endswith(".json"))

    def signatures(self) -> List[str]:
        return sorted(n[:-5] for n in os.listdir(self.records_dir)
                      if n.endswith(".json"))

    # -- crash hygiene -------------------------------------------------------
    def _sweep_tmp(self) -> None:
        """Remove temp files a killed writer left behind (``put`` is
        tmp + ``os.replace``; a crash between the two strands a tmp)."""
        for d in (self.records_dir, self.root):
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for n in names:
                if n.endswith(".tmp"):
                    try:
                        os.unlink(os.path.join(d, n))
                    except OSError:
                        pass

    def _quarantine(self, sig: str) -> None:
        """Move a corrupt record aside (never silently re-read it)."""
        self._events.inc("corrupt")
        path = self._rec_path(sig)
        try:
            os.makedirs(self.quarantine_dir, exist_ok=True)
            os.replace(path, os.path.join(self.quarantine_dir,
                                          f"{sig}.json"))
            self._events.inc("quarantined")
        except OSError:
            # quarantine is best-effort; at worst the next read re-detects
            pass
        for fam, sigs in self._family.items():
            if sig in sigs:
                self._family[fam] = [s for s in sigs if s != sig]

    # -- index ---------------------------------------------------------------
    def _replay_index(self) -> int:
        """Replay ``index.jsonl`` into the family map; returns the number
        of damaged (undecodable) lines so the caller can rebuild."""
        if not os.path.exists(self.index_path):
            return 0
        damaged = 0
        try:
            with open(self.index_path) as f:
                lines = f.readlines()
        except OSError:
            return 1
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
                sig, fam = e["sig"], e["family"]
            except (ValueError, TypeError, KeyError):
                damaged += 1                # torn tail or garbage
                continue
            if self.has(sig):
                sigs = self._family.setdefault(fam, [])
                if sig not in sigs:
                    sigs.append(sig)
        return damaged

    def rebuild_index(self) -> int:
        """Rebuild ``index.jsonl`` and the family map from the records
        dir — records are the source of truth, the index is a cache.
        Corrupt records found on the way are quarantined.  Returns the
        number of indexed records."""
        self._family = {}
        entries: List[str] = []
        for sig in self.signatures():
            try:
                rec = self._read_record(sig)
            except _Corrupt:
                self._quarantine(sig)
                continue
            except StoreError:
                continue
            if rec is None:
                continue
            entries.append(json.dumps(
                {"sig": rec.signature, "family": rec.family,
                 "graph": rec.graph_name, "batch": rec.batch,
                 "t": rec.created}) + "\n")
            sigs = self._family.setdefault(rec.family, [])
            if rec.signature not in sigs:
                sigs.append(rec.signature)
        try:
            _atomic_write(self.index_path, "".join(entries))
        except OSError as e:
            raise StoreError(f"index rebuild failed: {e}") from e
        self._events.inc("rebuilds")
        return len(entries)

    def _index_append(self, entry: Dict) -> None:
        spec = inject.maybe_fault("store.index", key=entry.get("sig", ""))
        line = json.dumps(entry) + "\n"
        if spec is not None and spec.kind == "corrupt":
            line = line[:max(1, len(line) // 2)]    # torn appender
        try:
            with open(self.index_path, "a") as f:
                f.write(line)
        except OSError as e:
            raise StoreError(f"index append failed: {e}") from e

    # -- record I/O ----------------------------------------------------------
    def _read_record(self, sig: str) -> Optional[StoreRecord]:
        """Read + verify one record.  None on a miss; ``_Corrupt`` on a
        damaged record (caller quarantines); ``StoreError`` on I/O
        failure."""
        path = self._rec_path(sig)
        try:
            spec = inject.maybe_fault("store.read", key=sig)
        except inject.InjectedFault as e:
            self._events.inc("io_errors")
            raise StoreError(str(e)) from e
        if spec is not None and spec.kind == "corrupt":
            inject.truncate_file(path)
        self._events.inc("reads")
        try:
            with open(path) as f:
                d = json.load(f)
        except FileNotFoundError:
            return None
        except OSError as e:
            self._events.inc("io_errors")
            raise StoreError(f"record read failed: {e}") from e
        except ValueError as e:
            raise _Corrupt(f"unparseable record {sig[:12]}: {e}") from e
        try:
            rec = StoreRecord.from_json(d)
        except TypeError as e:
            raise _Corrupt(f"malformed record {sig[:12]}: {e}") from e
        if rec.checksum is not None and record_checksum(d) != rec.checksum:
            raise _Corrupt(f"checksum mismatch on {sig[:12]}")
        return rec

    # -- core API ------------------------------------------------------------
    def get_record(self, sig: str) -> Optional[StoreRecord]:
        try:
            rec = self._read_record(sig)
        except _Corrupt:
            self._quarantine(sig)
            self._events.inc("misses")
            return None
        if rec is None:
            self._events.inc("misses")
            return None
        self._events.inc("hits")
        path = self._rec_path(sig)
        now = time.time()
        try:
            os.utime(path, (now, now))          # LRU touch
        except OSError:
            pass
        return rec

    def get(self, sig: str, graph: Optional[LayerGraph] = None
            ) -> Optional[NetworkSchedule]:
        """The stored schedule for ``sig``, re-bound to ``graph`` when
        given (positionally if the graph's layer names differ from the
        stored ones — signatures are name-insensitive)."""
        rec = self.get_record(sig)
        if rec is None:
            return None
        return self._bind(rec, graph)

    def _bind(self, rec: StoreRecord, graph: Optional[LayerGraph]
              ) -> NetworkSchedule:
        sj = rec.schedule
        if graph is None:
            return NetworkSchedule.from_json(sj)
        names = list(sj["layer_schemes"].keys())
        if all(n in graph.by_name for n in names):
            return NetworkSchedule.from_json(sj, graph)
        if len(names) != len(graph.layers):
            raise ValueError(
                f"record {rec.signature[:12]} has {len(names)} layers, "
                f"graph {graph.name!r} has {len(graph.layers)}")
        # positional re-bind: stored order is the solve's topological
        # order, which the signature guarantees matches the graph's
        order = rec.layer_order or names
        mapping = {old: l.name for old, l in zip(order, graph.layers)}
        sj = dict(sj)
        sj["graph_name"] = graph.name
        sj["layer_schemes"] = {mapping[n]: v
                               for n, v in sj["layer_schemes"].items()}
        sj["layer_costs"] = {mapping[n]: v
                             for n, v in sj.get("layer_costs", {}).items()}
        return NetworkSchedule.from_json(sj, graph)

    def put(self, schedule: NetworkSchedule, graph: LayerGraph,
            hw: HWTemplate, options: Optional[Mapping] = None,
            sig: Optional[str] = None, family: Optional[str] = None,
            measured: Optional[Dict] = None) -> StoreRecord:
        """Insert (or overwrite) the record for one solved schedule;
        returns the written record.  Invalid schedules are refused.
        Raises ``StoreError`` on I/O failure (the record is atomic: it is
        either fully written or absent)."""
        if not schedule.valid:
            raise ValueError("refusing to store an invalid schedule")
        opts = solver_options(**dict(options or {}))
        sig = sig if sig is not None else self.signature(graph, hw, opts)
        family = family if family is not None \
            else self.family(graph, hw, opts)
        rec = StoreRecord(
            signature=sig, family=family, graph_name=graph.name,
            batch=_graph_batch(graph), options=opts, hw_name=hw.name,
            created=time.time(),
            predicted_energy_pj=schedule.total_energy_pj,
            predicted_latency_cycles=schedule.total_latency_cycles,
            layer_order=[l.name for l in graph.layers],
            schedule=schedule.to_json(), measured=measured)
        d = rec.to_json()
        rec.checksum = d["checksum"] = record_checksum(d)
        try:
            spec = inject.maybe_fault("store.write", key=sig)
        except inject.InjectedFault as e:
            self._events.inc("io_errors")
            raise StoreError(str(e)) from e
        path = self._rec_path(sig)
        try:
            _atomic_write(path, json.dumps(d, indent=1))
        except OSError as e:
            self._events.inc("io_errors")
            raise StoreError(f"record write failed: {e}") from e
        self._events.inc("writes")
        if spec is not None and spec.kind == "corrupt":
            inject.truncate_file(path)          # writer killed mid-put
        self._index_append({"sig": sig, "family": family,
                            "graph": graph.name, "batch": rec.batch,
                            "t": rec.created})
        fam = self._family.setdefault(family, [])
        if sig not in fam:
            fam.append(sig)
        self._evict_to_capacity()
        return rec

    # -- warm-start near-misses ----------------------------------------------
    def warm_records(self, family: str, exclude: Sequence[str] = ()
                     ) -> List[StoreRecord]:
        """Records in the same graph family (same layers/hardware/options,
        different batch), newest first — warm-start seeds.  Corrupt
        records encountered on the way are quarantined and skipped;
        I/O failures raise ``StoreError``."""
        out: List[StoreRecord] = []
        for sig in list(reversed(self._family.get(family, []))):
            if sig in exclude or not self.has(sig):
                continue
            try:
                rec = self._read_record(sig)
            except _Corrupt:
                self._quarantine(sig)
                continue
            if rec is not None:
                out.append(rec)
        if out:
            self._events.inc("warm_hits")
        return out

    # -- eviction ------------------------------------------------------------
    def _evict_to_capacity(self) -> None:
        names = [n for n in os.listdir(self.records_dir)
                 if n.endswith(".json")]
        if len(names) <= self.max_entries:
            return
        paths = [os.path.join(self.records_dir, n) for n in names]
        paths.sort(key=lambda p: os.path.getmtime(p))   # oldest first
        for p in paths[:len(paths) - self.max_entries]:
            try:
                os.unlink(p)
                self._events.inc("evictions")
            except OSError:
                pass
        # drop evicted sigs from the family map
        for fam, sigs in self._family.items():
            self._family[fam] = [s for s in sigs if self.has(s)]

    # -- stats ---------------------------------------------------------------
    def stats(self) -> Dict:
        return {"root": self.root, "entries": len(self),
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "warm_hits": self.warm_hits,
                "corrupt": self.corrupt, "quarantined": self.quarantined,
                "io_errors": self.io_errors, "rebuilds": self.rebuilds,
                "families": sum(1 for v in self._family.values() if v)}


__all__ = ["ScheduleStore", "StoreRecord", "StoreError", "record_checksum",
           "STORE_VERSION", "DEFAULT_ROOT"]

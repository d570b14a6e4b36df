"""Schedule service of the port: the tier above solver and lowering.

The port of ``repro/service``.  ``signature``, ``store``, ``client`` and
``server`` are byte-identical copies of the reference's (numpy and the
standard library); ``autotune`` is the port's own, measuring on the card
through ``repro_torch.lower`` (the fused tier by default).

Three cooperating pieces turn the solver + lowering stack into a system
that *keeps* its winners and serves them to many concurrent clients:

  store
      ``store.ScheduleStore`` — a persistent, content-addressed schedule
      store: canonical signatures of (graph, hardware, solver options)
      built on the packed per-layer arrays the inter-layer solver itself
      consumes (``signature.schedule_signature``), an on-disk JSON layout
      with atomic writes, versioned records wrapping
      ``NetworkSchedule.to_json``, and hit/miss/eviction stats.  A
      *family* signature (batch-size stripped) lets a near-miss — same
      graph, different batch — seed a warm-start solve instead of a cold
      one.
  serve
      ``server.SolveServer`` + ``client.LocalClient`` — an async batched
      solve front-end: clients enqueue ``SolveRequest``s, a coalescing
      loop dedupes identical in-flight signatures, batches distinct
      segments across requests into the solver's ThreadPoolExecutor path
      (``kapla.solve_many``), and answers from the store when fresh.
      ``python -m repro_torch.service`` exposes solve | get | stats | warm |
      autotune verbs.
  autotune
      ``autotune.autotune_network`` — measured re-ranking: the k best
      chains from ``kapla.solve_topk`` are each lowered
      (``lower_network``) and executed (``netexec``, on the card), and the
      measured-fastest schedule is promoted into the store with its
      measured latency recorded alongside the predicted cost.
"""
from .signature import family_signature, schedule_signature, solver_options
from .store import ScheduleStore, StoreError, StoreRecord
from .client import (LocalClient, ServiceError, ServiceResult,
                     SolveRequest, StoreGuard, attach_mesh_plan,
                     resolve_request)
from .server import SolveServer, serve_batch, serve_batch_settled
from .autotune import autotune_network

__all__ = [
    "family_signature", "schedule_signature", "solver_options",
    "ScheduleStore", "StoreError", "StoreRecord",
    "LocalClient", "ServiceError", "ServiceResult", "SolveRequest",
    "StoreGuard", "attach_mesh_plan", "resolve_request",
    "SolveServer", "serve_batch", "serve_batch_settled",
    "autotune_network",
]

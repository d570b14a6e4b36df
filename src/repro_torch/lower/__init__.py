"""Lowering: compile solved dataflow schemes into executable plans, run
them through the hand-written CUDA kernels, and calibrate the cost model
against the measured times, at two tiers:

  layer tier
      solver (LayerScheme)
          -> plan.lower_scheme                      (KernelPlan)
          -> exec.execute_plan / verify_plan / measure_plan
  network tier
      solver (NetworkSchedule, or schedule.lower(graph, hw))
          -> netplan.lower_network                  (NetworkPlan: ordered
             kernel plans + segment buffer schedule w/ on-chip forwarding)
          -> netexec.network_runner / execute_network / verify_network /
             measure_network (drift: netexec.record_latency_drift)
  fused tier
      fuse.fused_runner                  (FusedNetwork: the whole net or
         one segment replayed as one CUDA graph over the port's kernels,
         process-wide cache keyed by fuse.plan_signature; the default of
         measure_network; network_runner(fused=True),
         exec.plan_runner(fused=True))
  mesh tier
      meshexec.build_segment_tasks       (one SegmentTask per chain segment,
         per-layer or fused; boundaries are host-numpy checkpoints)
      meshexec.MeshExecutor              (requests over a NodePool along a
         MultiNodePlan: speculate, re-dispatch, re-partition, fallback)
  calibration
      calibrate.run_calibration          (per-kernel Spearman + fit,
         backend "cuda", "cuda-graph" (fused) or "cpu")
      calibrate.run_network_calibration  (end-to-end network Spearman)

``plan.py`` and ``netplan.py`` are byte-identical copies of ``repro``'s.
"""
from .plan import GridAxis, KernelPlan, lower_scheme, lower_schedule
from .exec import (LAUNCHES, execute_plan, make_inputs, measure_plan,
                   plan_runner, reference_output, rel_error,
                   reset_launch_counts, verify_plan)
from .netplan import (NetworkPlan, SegmentPlan, TensorPlacement,
                      lower_cached, lower_network)
from .netexec import (NetworkExecution, NetworkVerification,
                      compare_network, execute_network,
                      from_reference_inputs, make_network_inputs,
                      measure_network, network_runner,
                      record_latency_drift, reference_network,
                      verify_network)
from .fuse import (FusedNetwork, cache_stats, clear_cache,
                   compiled_plan_fn, fused_runner, plan_signature)
from .calibrate import (Calibration, default_hw, default_network_sweep,
                        default_sweep, fit_calibration, load_record,
                        run_calibration, run_network_calibration,
                        save_record, scheme_variants, spearman)

__all__ = [
    "GridAxis", "KernelPlan", "lower_scheme", "lower_schedule",
    "LAUNCHES", "execute_plan", "make_inputs", "measure_plan",
    "plan_runner", "reference_output", "rel_error", "reset_launch_counts",
    "verify_plan",
    "NetworkPlan", "SegmentPlan", "TensorPlacement", "lower_cached",
    "lower_network",
    "NetworkExecution", "NetworkVerification", "compare_network",
    "execute_network", "from_reference_inputs", "make_network_inputs",
    "measure_network", "network_runner", "record_latency_drift",
    "reference_network", "verify_network",
    "FusedNetwork", "cache_stats", "clear_cache", "compiled_plan_fn",
    "fused_runner", "plan_signature",
    "Calibration", "default_hw", "default_network_sweep", "default_sweep",
    "fit_calibration", "load_record", "run_calibration",
    "run_network_calibration", "save_record", "scheme_variants", "spearman",
]

from . import annealing, exhaustive, memo, random_search
from .interlayer import (Chain, PruneStats, dp_prioritize,
                         dp_prioritize_scalar, enumerate_segments,
                         enumerate_segments_scalar, segment_pool)
from .intralayer import Constraints, solve_intra_layer
from .kapla import (NetworkSchedule, greedy_chain, rebatch_scheme,
                    seed_chains_from, solve, solve_greedy, solve_many,
                    solve_topk, warm_layer_solver)
from .multinode import (MultiNodePlan, NodeMesh, plan_multinode,
                        repartition)

__all__ = [
    "Chain", "Constraints", "MultiNodePlan", "NetworkSchedule",
    "NodeMesh", "PruneStats", "annealing",
    "dp_prioritize", "dp_prioritize_scalar", "enumerate_segments",
    "enumerate_segments_scalar", "exhaustive", "greedy_chain", "memo",
    "plan_multinode", "random_search", "rebatch_scheme", "repartition",
    "seed_chains_from", "segment_pool",
    "solve", "solve_greedy", "solve_intra_layer", "solve_many",
    "solve_topk", "warm_layer_solver",
]

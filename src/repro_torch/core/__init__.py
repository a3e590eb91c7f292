"""The paper's primary contribution: DAGPS scheduling (offline §4 + online §5 + bounds §6)."""
from .dag import DAG, dag_digest, from_stage_graph
from .faults import FaultPlan, FaultSpec, InjectedFault, RecoveryPolicy
from .space import Space, SpaceSnapshot
from .engine import (BatchedBackend, PlacementBackend,
                     ReferenceBackend, available_backends, get_backend)
from .builder import Schedule, build_schedule, partition_totally_ordered
from .memo import ConstructionMemo, counters_snapshot, reset_counters
from .bounds import all_bounds, cp_length, mod_cp, new_lb, t_work
from .baselines import (
    bfs_order, cp_order, cg_order, random_order, run_baseline,
    simulate_execution, strip_levels,
)
from .online import (
    CandidateBatch, DeficitCounters, JobView, Matcher, MatcherConfig,
    PendingTask, TaskPool, drf_fairness, slot_fairness,
)
from .shard import ShardPlan, ShardedMatcher, auto_shards, route_exposure

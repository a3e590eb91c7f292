"""Cluster simulation substrate: event-driven simulator + workload generators."""
from .cluster import (ClusterSim, SimConfig, SimResult, clear_schedule_cache,
                      run_workload, scheme)
from .workload import (make_workload, online_mix_workload, periodic_dag,
                       production_dag, query_dag, build_system_dag,
                       workflow_dag)

"""The port's main path as a whole, on the CPU, against the reference.

The simulator run end to end on ``device="cpu"`` (the kernels' plain torch
versions) must reproduce the committed goldens and the reference package's
own runs to the last bit: JCTs, makespan and Jain index by ``repr``,
placements by ``==``.  The builder reproduces ``golden_builder.json``, DAG
digests match the reference byte for byte, and an injected ``kernel_impl``
fault demotes an implementation without changing a decision.  Small seeded
twins of the reference's own corpora hold the paths no golden covers:
dynamic DAGs (``mutations=``, exact and routed), a heartbeat-fault plan and
``memo``-fault plans, each compared with the reference's run by ``==``
(the ``shard_launch`` recovery twins are in ``test_torch_faults.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

from repro.core import build_schedule as j_build_schedule
from repro.core import faults as j_faults
from repro.core.dag import dag_digest as j_digest
from repro.sim import make_workload as j_make_workload
from repro.sim import run_workload as j_run_workload
from repro.sim.workload import periodic_dag as j_periodic_dag
from repro.sim.workload import s12_dynamic as j_s12_dynamic

from repro_torch.core import build_schedule, faults
from repro_torch.core.dag import dag_digest, dag_from_arrays
from repro_torch.core.engine import kernels as tk
from repro_torch.launch import TPUJob, schedule_cluster
from repro_torch.sim import clear_schedule_cache, make_workload, run_workload
from repro_torch.sim.workload import (periodic_dag, production_dag,
                                      query_dag, s12_dynamic)

# the tensors here are tiny: one intra-op thread is several times
# faster than a pool, and leaves the other test workers their cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


def _port(dags):
    return [dag_from_arrays(d.duration, d.demand, d.stage_of, d.parents,
                            d.name) for d in dags]


def _decisions(res):
    return ({str(j.job_id): repr(j.jct) for j in res.jobs},
            repr(res.makespan), repr(res.jain_index(60.0, {0: 1.0, 1: 1.0})),
            res.placements)


@pytest.mark.parametrize("name,bench,n,sch,kw", [
    ("tpch_tez", "tpch", 8, "tez",
     dict(n_machines=10, interarrival=8.0, seed=3)),
    ("prod_tetris", "production", 6, "tez+tetris",
     dict(n_machines=10, interarrival=6.0, seed=5)),
    ("tpcds_drf", "tpcds", 6, "tez+drf",
     dict(n_machines=8, interarrival=10.0, seed=21, n_groups=2)),
    ("prod_churn", "production", 5, "dagps",
     dict(n_machines=10, interarrival=5.0, seed=9, failure_rate=1 / 150.0,
          repair_time=60.0, straggle_prob=0.08, straggle_factor=(4.0, 8.0))),
])
def test_golden_sim_on_cpu(name, bench, n, sch, kw):
    golden = json.load(open(os.path.join(DATA, "golden_sim.json")))[name]
    tk.reset_profile()
    res = run_workload(make_workload(bench, n, seed=kw["seed"]), sch,
                       device="cpu", **kw)
    assert {str(j.job_id): repr(j.jct) for j in res.jobs} == golden["jcts"]
    assert repr(res.makespan) == golden["makespan"]
    assert repr(res.jain_index(60.0, {0: 1.0, 1: 1.0})) == golden["jain_60"]
    assert res.speculative_launches == golden["spec"]
    assert res.failed_tasks_requeued == golden["requeued"]
    prof = tk.profile_snapshot()
    assert prof["match_wave.torch"][0] > 0      # the plain wave really ran
    if sch == "dagps":
        assert prof["scan.torch"][0] > 0


@pytest.mark.parametrize("name", ["production-0", "production-7", "tpcds-0"])
def test_golden_builder_on_cpu(name):
    golden = {e["name"]: e for e in json.load(
        open(os.path.join(DATA, "golden_builder.json")))["entries"]}[name]
    kind, seed = name.split("-")
    rng = np.random.default_rng(int(seed))
    dag = (production_dag(rng, scale=0.35, share=3) if kind == "production"
           else query_dag(rng, preset="tpcds"))
    s = build_schedule(dag, golden["m"], ticks=golden["ticks"], device="cpu")
    assert s.tick == golden["tick"]
    assert [float(x) for x in s.start] == golden["start"]
    assert [int(x) for x in s.machine] == golden["machine"]


def test_dag_digest_matches_reference():
    for bench in ("production", "tpcds", "tpch", "periodic", "workflow"):
        ref_dags = j_make_workload(bench, 3, seed=17)
        for rd, pd in zip(ref_dags, make_workload(bench, 3, seed=17)):
            assert dag_digest(pd) == j_digest(rd)
        for rd, pd in zip(ref_dags, _port(ref_dags)):
            assert dag_digest(pd) == j_digest(rd)


@pytest.mark.parametrize("mode", ["exact", "routed"])
def test_sim_matches_reference_run(mode):
    ref_dags = j_make_workload("tpch", 5, seed=11)
    kw = dict(n_machines=8, interarrival=5.0, seed=11, n_groups=2,
              matcher_shards=2, matcher_mode=mode, record_placements=True)
    want = _decisions(j_run_workload(ref_dags, "dagps", **kw))
    tk.reset_profile()
    got = _decisions(run_workload(_port(ref_dags), "dagps", device="cpu",
                                  **kw))
    assert got == want
    key = "match_wave.torch" if mode == "exact" \
        else "machines_with_candidates.torch"
    assert tk.profile_snapshot()[key][0] > 0


def _run_key(res):
    """Decisions, placements and the run's mutation and fault counters
    (``recovery_secs`` is wall time, not a decision)."""
    stats = {k: v for k, v in res.fault_stats.items()
             if k != "recovery_secs"}
    return _decisions(res), res.mutation_stats, stats


@pytest.mark.parametrize("mode", ["exact", "routed"])
def test_dynamic_dags_match_reference_run(mode):
    """tests/test_dynamic.py's midrun corpus: a stage appended to a running
    job and a machine-speed change, rebuilt while the run goes on."""
    kw = dict(n_machines=16, interarrival=10.0, seed=5, matcher_mode=mode,
              matcher_shards=2, record_placements=True)
    dags, muts = j_s12_dynamic("midrun", n_jobs=3)
    want = j_run_workload(dags, "dagps", mutations=muts, **kw)
    dags, muts = s12_dynamic("midrun", n_jobs=3)
    got = run_workload(dags, "dagps", mutations=muts, device="cpu", **kw)
    assert _run_key(got) == _run_key(want)
    assert got.mutation_stats["applied"] >= 1
    assert got.mutation_stats["speed_changes"] == 1


def test_heartbeat_fault_plan_matches_reference_run():
    """tests/test_sim_and_fault.py's heartbeat loss: every beat of machine
    2 drops, it is suspected, lost, and its tasks requeue."""
    kw = dict(n_machines=8, interarrival=6.0, seed=19, heartbeat_period=5.0,
              fault_plan="seed=2;heartbeat:drop@1.0,machine=2",
              record_placements=True)
    want = j_run_workload(j_make_workload("production", 5, seed=19), "dagps",
                          **kw)
    got = run_workload(make_workload("production", 5, seed=19), "dagps",
                       device="cpu", **kw)
    assert _run_key(got) == _run_key(want)
    assert got.fault_stats["heartbeat"]["losses"] >= 1


@pytest.mark.parametrize("spec", ["seed=2;memo:corrupt@0.5",
                                  "seed=3;memo:drop@0.4"])
def test_memo_fault_plan_matches_reference_build(spec):
    """tests/test_faults.py's memo corpus: corrupted or dropped memo
    entries cost a rebuild, never a placement, on both sides alike."""
    with j_faults.scope(spec):
        want = j_build_schedule(j_periodic_dag(np.random.default_rng(6)), 6,
                                memoize=True)
        want_fired = j_faults.active_plan().snapshot()
    with faults.scope(spec):
        got = build_schedule(periodic_dag(np.random.default_rng(6)), 6,
                             memoize=True, device="cpu")
        fired = faults.active_plan().snapshot()
    assert fired and fired == want_fired
    assert got.tick == want.tick
    assert [float(x) for x in got.start] == [float(x) for x in want.start]
    assert [int(x) for x in got.machine] == [int(x) for x in want.machine]


def test_injected_kernel_fault_demotes_decision_exactly():
    dags = make_workload("tpch", 3, seed=2)
    kw = dict(n_machines=6, interarrival=5.0, seed=2, device="cpu")
    healthy = run_workload(dags, "dagps", **kw)
    try:
        faulty = run_workload(
            dags, "dagps",
            fault_plan="seed=1;kernel_impl:raise@1,impl=torch,count=2", **kw)
    finally:
        tk.reset_demotions()
    assert _decisions(faulty)[:3] == _decisions(healthy)[:3]
    demoted = faulty.fault_stats["kernel_demotions"]
    assert sum(demoted.values()) == 2
    assert all(k.endswith(".torch.demoted") for k in demoted)


def test_unported_options_raise(monkeypatch):
    dags = make_workload("production", 1, seed=0)
    # build workers are ported (core/buildsvc.py, held against the
    # reference in test_torch_buildsvc.py): they no longer raise
    monkeypatch.setenv("REPRO_BUILD_MODE", "thread")
    clear_schedule_cache()
    serial = run_workload(dags, "dagps", n_machines=4, device="cpu")
    clear_schedule_cache()
    par = run_workload(dags, "dagps", n_machines=4, build_workers=2,
                       device="cpu")
    assert _decisions(par) == _decisions(serial)
    job = TPUJob("j", "arch", [dict(seconds=10.0)])
    # the service is ported too (svc/, held against the reference in
    # test_torch_svc.py): serve=True no longer raises; it makes the
    # non-speculative simulator's decisions
    served = schedule_cluster([job], n_slices=4, serve=True, device="cpu")
    plain = schedule_cluster([job], n_slices=4, speculate=False,
                             device="cpu")
    assert [repr(j.jct) for j in served.jobs] == \
        [repr(j.jct) for j in plain.jobs]
    res = schedule_cluster([job], n_slices=4, device="cpu")
    assert len(res.jobs) == 1

"""The port's scheduler service under faults (``repro_torch.svc``) on the
CPU: twins of ``tests/test_service.py``'s chaos, silent-machine and
ambient-plan runs, on the workloads both packages build from the same
seeds.  Every task has exactly one effective placement, and the lease and
channel machinery visibly worked.  The healthy-path parity, the wire, the
transports and the wall-clock agent are in ``tests/test_torch_svc.py``.

Each run is an inproc service in virtual time; the last test asserts that
no child process or non-daemon thread started here is left alive.
"""

import multiprocessing
import threading
import time

import numpy as np
import pytest
import torch

from repro.sim import make_workload as j_make_workload

from repro_torch.sim import make_workload
from repro_torch.sim.cluster import scheme
from repro_torch.svc import ServiceConfig, run_service_workload

torch.set_num_threads(1)

#: the bound on the wait for leftover threads and children
WAIT = 60.0
CPU = dict(device="cpu")


def _arrivals(make, n, seed, interarrival, rng_seed):
    dags = make("production", n, seed=seed)
    rng = np.random.default_rng(rng_seed)
    arrivals, t = [], 0.0
    for dag in dags:
        arrivals.append((t, dag, 0))
        t += float(rng.exponential(interarrival))
    return arrivals


def _chaos_workload(n=5, seed=5, interarrival=20.0):
    """The port's arrivals, after checking that the reference's generator
    makes the same DAGs and times from the seed."""
    mine = _arrivals(make_workload, n, seed, interarrival, 1)
    theirs = _arrivals(j_make_workload, n, seed, interarrival, 1)
    assert [t for t, _, _ in mine] == [t for t, _, _ in theirs]
    for (_, a, _), (_, b, _) in zip(mine, theirs):
        for f in ("duration", "demand", "stage_of"):
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes()
        assert [p.tolist() for p in a.parents] == \
            [p.tolist() for p in b.parents]
    return mine


# ----------------------------------------------------------------------
# chaos: liveness + exactly-once under comm/agent/heartbeat faults
# ----------------------------------------------------------------------

#: the reference's chaos plan (tests/test_service.py)
CHAOS_PLAN = ("seed=5;comm_send:drop@0.08;comm_send:dup@0.08;"
              "comm_send:delay@0.05,delay=0.5;"
              "agent:crash@1.0,machine=3,count=1;"
              "agent:partition@0.03,delay=4.0;heartbeat:drop@0.08")


def test_chaos_run_completes_every_job_exactly_once():
    """Drops, dups, delays, one agent crash and transient partitions:
    every job completes, every task has exactly one effective placement,
    and the lease machinery visibly worked."""
    arrivals = _chaos_workload()
    res = run_service_workload(arrivals, ServiceConfig(n_machines=10,
                                                       seed=0, **CPU),
                               scheme("dagps"), fault_plan=CHAOS_PLAN)
    assert len(res.jobs) == len(arrivals)
    assert all(v == 1 for v in res.effective.values())
    n_tasks = sum(a[1].n for a in arrivals)
    assert len(res.effective) == n_tasks
    svc = res.fault_stats["service"]
    assert svc["completions"] == n_tasks
    assert svc["lease_reclaims"] > 0
    assert res.fault_stats["heartbeat"]["losses"] >= 1   # the crash
    comm = res.fault_stats["comm"]
    assert comm["dropped"] > 0 and comm["duped"] > 0
    assert comm["retransmits"] > 0
    # the stats themselves travelled over the chaotic wire
    assert res.fault_stats["injections"].get("comm_send.drop", 0) > 0


def test_silent_machine_leases_reclaimed_and_requeued():
    """All beats from one machine drop: it is declared lost, its leases
    are reclaimed and requeued elsewhere; the workload completes."""
    arrivals = _chaos_workload(4, seed=11)
    res = run_service_workload(
        arrivals, ServiceConfig(n_machines=8, seed=0, **CPU),
        scheme("dagps"), fault_plan="seed=2;heartbeat:drop@1.0,machine=2")
    assert len(res.jobs) == 4
    assert all(v == 1 for v in res.effective.values())
    assert len(res.effective) == sum(a[1].n for a in arrivals)
    assert res.fault_stats["heartbeat"]["losses"] >= 1
    assert res.fault_stats["service"]["lease_reclaims"] >= 0
    assert res.fault_stats["injections"].get("heartbeat.drop", 0) > 0


def test_ambient_env_plan_chaos_smoke():
    """Runs under whatever REPRO_FAULTS carries (healthy without it); the
    liveness invariants hold either way."""
    arrivals = _chaos_workload(3, seed=17)
    res = run_service_workload(arrivals, ServiceConfig(n_machines=8, seed=0,
                                                       **CPU),
                               scheme("dagps"))
    assert len(res.jobs) == 3
    assert all(v == 1 for v in res.effective.values())


# ----------------------------------------------------------------------
# nothing left running
# ----------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def started_before():
    """The children and non-daemon threads this process had before this
    file's first test."""
    return ({p.pid for p in multiprocessing.active_children()},
            {t.ident for t in threading.enumerate() if not t.daemon})


def test_nothing_left_running(started_before):
    """Every run above closed its service: no child process and no
    non-daemon thread it started is still alive."""
    kids0, threads0 = started_before
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        kids = {p.pid for p in multiprocessing.active_children()} - kids0
        threads = [t for t in threading.enumerate()
                   if not t.daemon and t.ident not in threads0]
        if not kids and not threads:
            break
        time.sleep(0.05)
    assert not kids
    assert not threads, [t.name for t in threads]

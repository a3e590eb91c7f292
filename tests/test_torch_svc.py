"""The port's scheduler service (``repro_torch.svc``) on the CPU, against
the reference package.

Twins of ``tests/test_service.py``, on workloads both packages build from
the same seeds:

  * the wire codec (every payload type, the port's `DAG`), `SeqGate`, and
    the `Channel` reliability protocol under drop/dup/delay plans, the
    re-ack case, and a few hypothesis examples;
  * the transports: inproc without a listener, a tcp channel round-trip;
  * the parity pair: a healthy inproc service run on ``device="cpu"``
    equals the port's ``ClusterSim(speculate=False)``, the reference's
    ``run_service_workload`` of the same arrivals and
    ``tests/data/golden_service.json``, grant for grant and by ``repr``;
    so does the same run with two build workers;
  * ``schedule_cluster(serve=True)`` against ``speculate=False`` and the
    reference's served JCTs, and ``examples/torch_cluster_sim.py --serve``;
  * the wall-clock agent (backoff, reconnect, clock-derived beats) and the
    tcp deployment shape end to end on 4 agents.

The chaos, silent-machine and ambient-plan runs are in
``tests/test_torch_svc_chaos.py``, so that the two files run side by side.
Every wait is bounded (60 s at most), every service is closed by a
``finally``, and the last test asserts that no child process or
non-daemon thread started here is left alive.
"""

import itertools
import json
import multiprocessing
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import FaultPlan as JFaultPlan
from repro.launch.cluster import TPUJob as JTPUJob
from repro.launch.cluster import schedule_cluster as j_schedule_cluster
from repro.sim import make_workload as j_make_workload
from repro.sim.cluster import scheme as j_scheme
from repro.svc import ServiceConfig as JServiceConfig
from repro.svc import run_service_workload as j_run_service_workload

from repro_torch.core import FaultPlan, RecoveryPolicy, faults
from repro_torch.core.dag import DAG
from repro_torch.launch import TPUJob, schedule_cluster
from repro_torch.sim import make_workload
from repro_torch.sim.cluster import ClusterSim, SimConfig, scheme
from repro_torch.svc import (Client, Msg, SeqGate, ServiceConfig, connect,
                             decode, encode, listen, run_service_workload)
from repro_torch.svc import wire
from repro_torch.svc.agent import Agent
from repro_torch.svc.comm import Channel, CommClosed
from repro_torch.svc.scheduler import SchedulerCore, SchedulerService

try:
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
GOLDEN = os.path.join(ROOT, "tests", "data", "golden_service.json")
#: the bound on every wall-clock wait (a hang fails, it does not stall)
WAIT = 60.0
CPU = dict(device="cpu")

_ADDRS = itertools.count()


def _addr() -> str:
    return f"inproc://torch-svc-test-{next(_ADDRS)}"


def _same_dags(port, ref) -> None:
    """The two packages' generators made the same DAGs from one seed."""
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        for f in ("duration", "demand", "stage_of"):
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes()
        assert [p.tolist() for p in a.parents] == \
            [p.tolist() for p in b.parents]


def _arrivals(make, n, seed, interarrival, rng_seed, groups):
    dags = make("production", n, seed=seed)
    rng = np.random.default_rng(rng_seed)
    arrivals, t = [], 0.0
    for i, dag in enumerate(dags):
        arrivals.append((t, dag, i % 2 if groups else 0))
        t += float(rng.exponential(interarrival))
    return arrivals


def _workloads(n, seed, interarrival, rng_seed, groups):
    """(port arrivals, reference arrivals) of one seeded workload."""
    mine = _arrivals(make_workload, n, seed, interarrival, rng_seed, groups)
    theirs = _arrivals(j_make_workload, n, seed, interarrival, rng_seed,
                       groups)
    _same_dags([a[1] for a in mine], [a[1] for a in theirs])
    assert [(t, g) for t, _, g in mine] == [(t, g) for t, _, g in theirs]
    return mine, theirs


# ----------------------------------------------------------------------
# wire codec
# ----------------------------------------------------------------------

def test_wire_roundtrip_all_payload_types():
    dag = make_workload("production", 1, seed=4)[0]
    arr = np.linspace(0.0, 1.0, 7, dtype=np.float64).reshape(1, 7)
    msg = Msg(wire.SUBMIT, "client", 3, {
        "dag": dag, "arr": arr, "blob": b"\x00\xffraw",
        "f": 0.1 + 0.2, "i": 41, "s": "x", "none": None,
        "nested": {"inner": [1.5, {"deep": np.int64(9)}]},
        "i32": np.arange(5, dtype=np.int32),
    })
    raw = encode(msg)
    assert raw.startswith(b"{")            # tagged JSON, never pickle
    back = decode(raw)
    assert (back.kind, back.sender, back.seq) == (msg.kind, msg.sender, 3)
    p = back.payload
    # repr-exact floats: the parity contract rides on this
    assert repr(p["f"]) == repr(0.1 + 0.2)
    np.testing.assert_array_equal(p["arr"], arr)
    assert p["arr"].dtype == arr.dtype
    assert p["i32"].dtype == np.int32 and p["i32"].tolist() == list(range(5))
    assert p["blob"] == b"\x00\xffraw"
    assert p["i"] == 41 and p["s"] == "x" and p["none"] is None
    assert p["nested"]["inner"][1]["deep"] == 9
    d2 = p["dag"]
    # rebuilt through the port's DAG: derived state recomputed
    assert isinstance(d2, DAG)
    _same_dags([d2], [dag])
    assert d2.name == dag.name
    assert [c.tolist() for c in d2.children] == \
        [c.tolist() for c in dag.children]
    assert d2.n_stages == dag.n_stages


# ----------------------------------------------------------------------
# SeqGate: exactly-once, in-order
# ----------------------------------------------------------------------

def _m(seq, sender="a"):
    return Msg(wire.TASK_DONE, sender, seq, {"n": seq})


def test_seqgate_dups_and_reorders():
    g = SeqGate()
    assert [x.seq for x in g.admit(_m(1))] == [1]
    assert g.admit(_m(1)) == []                      # dup of admitted
    assert g.admit(_m(4)) == []                      # future: parked
    assert g.admit(_m(4)) == []                      # dup of parked
    assert g.admit(_m(3)) == []                      # still gapped on 2
    assert [x.seq for x in g.admit(_m(2))] == [2, 3, 4]   # gap fills
    assert [x.seq for x in g.admit(_m(5))] == [5]
    assert g.stats == {"admitted": 5, "dups": 2, "reorders": 2}
    # senders are independent streams
    assert [x.seq for x in g.admit(_m(1, "b"))] == [1]


def test_seqgate_unsequenced_passthrough():
    g = SeqGate()
    hb = Msg(wire.HEARTBEAT, "a", 0, {"machine": 1})
    assert g.admit(hb) == [hb]
    assert g.admit(hb) == [hb]           # no dedup outside the protocol
    assert g.stats["admitted"] == 0


# ----------------------------------------------------------------------
# Channel reliability: lossy delivery == clean-delivery oracle
# ----------------------------------------------------------------------

_CH_REC = RecoveryPolicy(rpc_timeout=0.1, backoff_cap=0.5)


def _lossy_exchange(plan_text, n_msgs=40, max_cycles=600):
    """Send ``n_msgs`` sequenced messages through an inproc pair under
    ``plan_text``; drive virtual time until everything is admitted and
    acked.  Returns (admitted payload ids, sender chan, receiver chan)."""
    with faults.scope(plan_text):
        accepted = []
        lst = listen(_addr(), accepted.append)
        try:
            cli = connect(lst.addr)
            srv = accepted[0]
            clk = [0.0]
            snd = Channel(cli, "cli", _CH_REC, lambda: clk[0])
            rcv = Channel(srv, "srv", _CH_REC, lambda: clk[0])
            for i in range(n_msgs):
                snd.send(wire.TASK_DONE, lease=i, t=float(i))
            got = []
            for _ in range(max_cycles):
                got += [int(m.payload["lease"]) for m in rcv.poll(clk[0])]
                snd.poll(clk[0])
                if len(got) == n_msgs and snd.unacked == 0:
                    break
                clk[0] += 0.13
        finally:
            lst.close()
        return got, snd, rcv


@pytest.mark.parametrize("plan,lossy", [
    ("seed=0", False),
    ("seed=7;comm_send:drop@0.25;comm_send:dup@0.2;"
     "comm_send:delay@0.15,delay=0.3", True),
])
def test_channel_delivery(plan, lossy):
    got, snd, rcv = _lossy_exchange(plan)
    assert got == list(range(40))         # exactly once, in order
    assert snd.unacked == 0               # every message eventually acked
    if lossy:
        assert snd.stats["retransmits"] > 0   # the protocol actually worked
        assert rcv.gate.stats["dups"] > 0
        assert sum(snd.comm.stats[k] + rcv.comm.stats[k]
                   for k in ("dropped", "duped", "delayed")) > 0
    else:
        assert snd.stats["retransmits"] == 0
        assert rcv.gate.stats["dups"] == 0


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
def test_channel_reliability_property():
    @settings(max_examples=6, deadline=None, derandomize=True,
              suppress_health_check=[HealthCheck.too_slow])
    @given(seed=st.integers(0, 2**16),
           p_drop=st.floats(0.0, 0.4),
           p_dup=st.floats(0.0, 0.4),
           p_delay=st.floats(0.0, 0.4),
           n=st.integers(1, 25))
    def run(seed, p_drop, p_dup, p_delay, n):
        plan = (f"seed={seed};comm_send:drop@{p_drop:.3f};"
                f"comm_send:dup@{p_dup:.3f};"
                f"comm_send:delay@{p_delay:.3f},delay=0.2")
        got, snd, _ = _lossy_exchange(plan, n_msgs=n)
        assert got == list(range(n))
        assert snd.unacked == 0

    run()


def test_channel_reacks_when_first_ack_is_lost():
    """Receiver's first ack dropped -> sender retransmits -> receiver
    treats the dup as a no-op but re-acks it, so the sender drains."""
    got, snd, rcv = _lossy_exchange("seed=0;comm_send:drop@1.0,n=1",
                                    n_msgs=3)
    assert got == [0, 1, 2]
    assert snd.unacked == 0
    assert snd.stats["retransmits"] >= 1
    assert rcv.gate.stats["dups"] >= 1


# ----------------------------------------------------------------------
# transports
# ----------------------------------------------------------------------

def test_inproc_connect_requires_listener():
    with pytest.raises(CommClosed):
        connect("inproc://torch-nobody-home")


def test_tcp_channel_roundtrip():
    with faults.scope(FaultPlan()):
        accepted = []
        lst = listen("tcp://127.0.0.1:0", accepted.append)
        snd = rcv = None
        try:
            assert lst.addr.startswith("tcp://127.0.0.1:")
            snd = Channel(connect(lst.addr), "cli")
            arr = np.arange(6, dtype=np.float32)
            snd.send(wire.TASK_DONE, lease=1, arr=arr)
            deadline = time.monotonic() + WAIT
            while not accepted and time.monotonic() < deadline:
                time.sleep(0.005)
            rcv = Channel(accepted[0], "srv")
            got = []
            while not got and time.monotonic() < deadline:
                got = rcv.poll()
                time.sleep(0.005)
            assert got and got[0].kind == wire.TASK_DONE
            np.testing.assert_array_equal(got[0].payload["arr"], arr)
            assert got[0].payload["arr"].dtype == np.float32
            while snd.unacked and time.monotonic() < deadline:
                snd.poll()
                time.sleep(0.005)
            assert snd.unacked == 0
            assert any(t.name == "repro-svc-io" and t.daemon
                       for t in threading.enumerate())
        finally:
            for ch in (snd, rcv):
                if ch is not None:
                    ch.close()
            lst.close()


# ----------------------------------------------------------------------
# healthy-path decision parity
# ----------------------------------------------------------------------

def _golden_doc(res):
    return {
        "jcts": {str(j.job_id): repr(j.jct) for j in res.jobs},
        "makespan": repr(res.makespan),
        "placements": [[repr(t), j, tk, m] for t, j, tk, m in
                       res.placements],
    }


@pytest.fixture(scope="module")
def parity():
    """The parity pair's runs: the port's simulator and service on the
    CPU, and the reference's service, of one seeded workload (12 machines,
    6 production jobs, seed 3, interarrival 25)."""
    mine, theirs = _workloads(6, 3, 25.0, 0, groups=True)
    sim = ClusterSim(SimConfig(n_machines=12, seed=0, speculate=False,
                               record_placements=True,
                               fault_plan=FaultPlan(), **CPU),
                     scheme("dagps")).run(mine)
    svc = run_service_workload(mine, ServiceConfig(n_machines=12, seed=0,
                                                   **CPU),
                               scheme("dagps"), fault_plan=FaultPlan())
    ref = j_run_service_workload(theirs, JServiceConfig(n_machines=12,
                                                        seed=0),
                                 j_scheme("dagps"), fault_plan=JFaultPlan())
    return dict(arrivals=mine, sim=sim, svc=svc, ref=ref)


def test_service_matches_simulator_bit_for_bit(parity):
    """Healthy inproc service run == the port's `ClusterSim`, placement
    for placement: same (time, job, task, machine) grant sequence, same
    JCTs and makespan at full float precision."""
    sim, svc = parity["sim"], parity["svc"]
    assert len(svc.placements) == len(sim.placements) > 0
    assert svc.placements == sim.placements
    assert sorted((j.job_id, repr(j.jct)) for j in svc.jobs) == \
        sorted((j.job_id, repr(j.jct)) for j in sim.jobs)
    assert repr(svc.makespan) == repr(sim.makespan)
    assert all(v == 1 for v in svc.effective.values())
    assert len(svc.effective) == sum(a[1].n for a in parity["arrivals"])
    assert svc.fault_stats["service"]["lease_reclaims"] == 0


def test_service_matches_reference_and_golden(parity):
    """... and equals the reference's service run and the committed
    golden, by ``repr``; the accounting keys are the reference's."""
    svc, ref = parity["svc"], parity["ref"]
    assert _golden_doc(svc) == _golden_doc(ref)
    with open(GOLDEN) as f:
        assert _golden_doc(svc) == json.load(f)
    assert svc.effective == ref.effective
    assert svc.fault_stats == ref.fault_stats


def test_service_with_build_workers_matches_serial(parity):
    """Two build workers (the port's process pool, builds on the CPU)
    make the serial service's decisions."""
    res = run_service_workload(
        parity["arrivals"], ServiceConfig(n_machines=12, seed=0,
                                          build_workers=2, **CPU),
        scheme("dagps"), fault_plan=FaultPlan())
    assert _golden_doc(res) == _golden_doc(parity["svc"])
    build = res.fault_stats["build"]
    assert build and not any(build[k] for k in
                             ("retries", "worker_crashes", "inline_fallbacks",
                              "quarantined_digests"))


def _tpu_jobs(cls):
    return [cls(f"j{i}", "generic", [
        dict(name="a", seconds=40.0 + 5 * i, chips=0.4, hbm=0.3, deps=[]),
        dict(name="b", seconds=25.0, chips=0.5, hbm=0.4, deps=[0]),
        dict(name="c", seconds=10.0, chips=0.2, hbm=0.2, deps=[1]),
    ], group=i % 2) for i in range(4)]


def test_serve_passthrough_matches_simulator_and_reference():
    """`schedule_cluster(serve=True)` routes the workload through the
    service and lands on the simulator path's exact JCTs, and on the
    reference's served JCTs."""
    kw = dict(n_slices=8, interarrival=30.0, seed=1, policy="dagps")
    plain = schedule_cluster(_tpu_jobs(TPUJob), speculate=False,
                             fault_plan=FaultPlan(), **kw, **CPU)
    served = schedule_cluster(_tpu_jobs(TPUJob), serve=True,
                              fault_plan=FaultPlan(), **kw, **CPU)
    theirs = j_schedule_cluster(_tpu_jobs(JTPUJob), serve=True,
                                fault_plan=JFaultPlan(), **kw)
    jcts = sorted((j.job_id, repr(j.jct)) for j in served.jobs)
    assert jcts == sorted((j.job_id, repr(j.jct)) for j in plain.jobs)
    assert jcts == sorted((j.job_id, repr(j.jct)) for j in theirs.jobs)
    assert repr(served.makespan) == repr(plain.makespan) \
        == repr(theirs.makespan)
    assert served.placements == theirs.placements
    assert served.fault_stats["service"]["placements"] > 0


@pytest.mark.parametrize("kw,match", [
    (dict(mutations=[(30.0, "speed", 0, 1.5)]), "mutations"),
    (dict(matcher_mode="routed"), "exact"),
])
def test_serve_refuses_what_the_service_lacks(kw, match):
    with pytest.raises(ValueError, match=match):
        schedule_cluster(_tpu_jobs(TPUJob), n_slices=8, serve=True, **kw,
                         **CPU)


def test_example_serve_json_emits_service_fault_stats():
    """examples/torch_cluster_sim.py --serve --json surfaces the service's
    fault_stats."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.pop(faults.FAULTS_ENV, None)
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "torch_cluster_sim.py"),
         "--serve", "--json", "--jobs", "3", "--slices", "8",
         "--schemes", "dagps", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=WAIT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc["jobs"] == 3
    fs = doc["fault_stats"]
    assert fs["service"]["placements"] > 0
    assert fs["service"]["lease_reclaims"] == 0
    assert "comm" in fs and fs["comm"]["sent"] > 0


# ----------------------------------------------------------------------
# wall-clock agent: reconnect backoff + clock-derived beats
# ----------------------------------------------------------------------

def test_agent_backoff_capped_by_probe_secs():
    rec = RecoveryPolicy(backoff=0.1, backoff_cap=5.0, probe_secs=0.8)
    ag = Agent("inproc://nowhere", 0, recovery=rec)
    assert [ag.backoff_delay(a) for a in range(6)] == \
        [0.1, 0.2, 0.4, 0.8, 0.8, 0.8]
    ag2 = Agent("inproc://nowhere", 0,
                recovery=RecoveryPolicy(backoff=0.1, backoff_cap=5.0,
                                        probe_secs=None))
    assert ag2.backoff_delay(10) == 5.0


def test_agent_reconnect_retries_on_schedule_then_connects():
    """connect_with_retry sleeps the capped-backoff schedule between
    failures (a fake clock: no wall time passes) and returns the comm as
    soon as the connector succeeds."""
    rec = RecoveryPolicy(backoff=0.1, backoff_cap=5.0, probe_secs=0.8)
    clk = [0.0]
    slept = []

    def fake_sleep(s):
        slept.append(s)
        clk[0] += s

    sentinel = object()
    attempts = [0]

    def connector(addr):
        attempts[0] += 1
        if attempts[0] <= 5:
            raise CommClosed("scheduler down")
        return sentinel

    ag = Agent("inproc://nowhere", 0, recovery=rec, clock=lambda: clk[0],
               sleep=fake_sleep, connector=connector)
    assert ag.connect_with_retry() is sentinel
    assert ag.reconnect_delays == [0.1, 0.2, 0.4, 0.8, 0.8]
    assert slept == ag.reconnect_delays
    assert clk[0] == pytest.approx(sum(ag.reconnect_delays))


def test_agent_reconnect_gives_up_after_max_attempts():
    ag = Agent("inproc://nowhere", 0,
               recovery=RecoveryPolicy(backoff=0.001, backoff_cap=0.002),
               sleep=lambda s: None,
               connector=lambda a: (_ for _ in ()).throw(CommClosed("x")))
    with pytest.raises(CommClosed):
        ag.connect_with_retry(max_attempts=3)
    assert len(ag.reconnect_delays) == 2


def test_agent_beats_advance_off_the_clock():
    """The beat deadline is clock-derived: a frozen clock emits one beat;
    a long stall emits one (late) beat, not a burst; the next deadline is
    period after the beat that fired."""
    with faults.scope(FaultPlan()):
        accepted = []
        lst = listen(_addr(), accepted.append)
        try:
            comm = connect(lst.addr)
            clk = [100.0]
            ag = Agent("unused", 3, period=1.0, clock=lambda: clk[0],
                       sleep=lambda s: None)
            ch = Channel(comm, "agent-3", None, lambda: clk[0])
            nb = ag.step(ch, clk[0])               # due now -> beat fires
            for _ in range(5):
                nb = ag.step(ch, nb)               # frozen clock: no beats
            assert len(ag.beats) == 1
            clk[0] += 3.7                          # poll-loop stall
            nb = ag.step(ch, nb)
            assert len(ag.beats) == 2              # one catch-up beat
            assert nb == pytest.approx(103.7 + 1.0)
            srv = Channel(accepted[0], "srv", None, lambda: clk[0])
            kinds = [m.kind for m in srv.poll()]
            assert kinds.count(wire.HEARTBEAT) == 2
        finally:
            lst.close()


def test_wall_clock_service_over_tcp_end_to_end():
    """The deployment shape: the scheduler served from a thread on real
    sockets, 4 wall-clock `Agent` threads, a `Client` fetching stats over
    the wire.  Compressed lease durations keep it fast."""
    with faults.scope(FaultPlan()):
        cfg = ServiceConfig(n_machines=4, seed=0, heartbeat_period=0.2,
                            groups=(0,), **CPU)
        core = SchedulerCore(cfg, scheme("dagps"))
        svc = SchedulerService(core, "tcp://127.0.0.1:0")
        agents, client = [], None
        try:
            svc.serve_in_thread(poll_interval=0.005)
            for m in range(4):
                ag = Agent(svc.addr, m, period=0.2, time_scale=0.0005)
                ag.start()
                agents.append(ag)
            client = Client(connect(svc.addr))
            dags = make_workload("production", 2, seed=21)
            handles = [client.submit(dag, t=0.0) for dag in dags]
            deadline = time.monotonic() + WAIT
            while client.pending and time.monotonic() < deadline:
                client.poll()
                time.sleep(0.01)
            assert client.pending == 0, "jobs did not complete over tcp"
            assert all(h.result is not None for h in handles)
            fs = client.stats(timeout=10.0)["fault_stats"]
            assert fs["service"]["completions"] == sum(d.n for d in dags)
            assert fs["comm"]["sent"] > 0
            assert all(v == 1 for v in core.effective.values())
            assert sum(len(a.beats) for a in agents) > 0
        finally:
            for ag in agents:
                ag.stop()
            if client is not None:
                client.ch.close()
            svc.close()
        assert not any(a._thread.is_alive() for a in agents)
        assert not svc._thread.is_alive()


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
    """Every service above closed: no child process (build worker) and no
    non-daemon thread (a pool's manager) it started is still alive."""
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

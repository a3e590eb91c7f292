"""The port's build service (``repro_torch.core.buildsvc``) on the CPU,
against the reference package.

Twins of ``tests/test_buildsvc.py`` (digest dedup, the three modes, the
simulator's build workers, the thread-safety counters),
``tests/test_builder_parity.py::TestBuildServiceParity``,
``tests/test_dynamic.py::test_buildsvc_resubmit_parity_and_dedup`` and
the four ``build_worker`` cases of ``tests/test_faults.py``.  The same
seeded DAGs go through both packages: every schedule the port's service
returns equals the reference's serial ``build_schedule`` by ``==``, and the
simulator's runs with two build workers equal the reference's serial run.

Where the port differs, so do the tests: process workers start by
forkserver or spawn and get the fault plan from the pool's initializer
(the reference's two crash cases fail there: its crash supervision shuts
the broken pool down from the pool's own manager thread and deadlocks;
these pass); ``REPRO_BUILD_MP=fork`` raises once a thread or a
CUDA context exists; a worker's own exception reaches the handle without a
retry.  XLA's compile cache and platform probe have no counterpart: the
kernel library loading once under concurrent first use and the jit
backend's batch floor (``REPRO_JIT_MIN_BATCH``, else the device) stand in
for them.  Every ``result()`` takes a timeout, every service is shut down
by its ``with`` block, and the last test asserts that no worker process is
left.
"""

import functools
import multiprocessing
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import build_schedule as j_build_schedule
from repro.core.dag import dag_digest as j_digest
from repro.sim import clear_schedule_cache as j_clear_schedule_cache
from repro.sim import run_workload as j_run_workload
from repro.sim.workload import mut_resize_stage as j_mut_resize_stage
from repro.sim.workload import periodic_dag as j_periodic_dag
from repro.sim.workload import production_dag as j_production_dag
from repro.sim.workload import query_dag as j_query_dag

from repro_torch.core import RecoveryPolicy, build_schedule, faults
from repro_torch.core import buildsvc
from repro_torch.core.builder import assert_schedules_equal
from repro_torch.core.buildsvc import MP_ENV, BuildService, build_many
from repro_torch.core.dag import DAG, dag_digest, dag_from_arrays
from repro_torch.core.engine import jit as J
from repro_torch.core.engine import kernels
from repro_torch.core.engine.base import ceil32
from repro_torch.core.memo import COUNTERS
from repro_torch.kernels import build as kbuild
from repro_torch.launch import TPUJob, schedule_cluster
from repro_torch.sim import clear_schedule_cache, run_workload
from repro_torch.sim.workload import mut_resize_stage, periodic_dag

torch.set_num_threads(1)

#: the bound on every wait for a build (a hang fails, it does not stall)
WAIT = 60
CPU = dict(device="cpu")


def _port(d):
    return dag_from_arrays(d.duration, d.demand, d.stage_of, d.parents,
                           d.name)


def _dag_copy(dag, parents=None, duration=None, demand=None, stage_of=None):
    return DAG(
        duration=dag.duration.copy() if duration is None else duration,
        demand=dag.demand.copy() if demand is None else demand,
        stage_of=dag.stage_of.copy() if stage_of is None else stage_of,
        parents=[p.copy() for p in dag.parents] if parents is None else parents,
        name=dag.name,
    )


def _assert_same_schedule(a, b, ctx=""):
    """Port schedule against a port or a reference schedule, by ``==``."""
    assert a.makespan == b.makespan, f"makespan differs {ctx}"
    assert np.array_equal(a.start, b.start), f"starts differ {ctx}"
    assert np.array_equal(a.machine, b.machine), f"machines differ {ctx}"
    assert np.array_equal(a.order, b.order), f"order differs {ctx}"


def _ref_dags(n=4, seed0=0):
    return [j_production_dag(np.random.default_rng(s), scale=0.35, share=3)
            for s in range(seed0, seed0 + n)]


@functools.lru_cache(maxsize=None)
def _ref_build(seed: int, m: int = 3, ticks: int = 96,
               backend: str = "batched", memoize: bool = True):
    """The reference's serial build of the production DAG of ``seed`` (the
    jit backend's schedules equal the batched ones), made once per run."""
    ref = j_production_dag(np.random.default_rng(seed), scale=0.35, share=3)
    return j_build_schedule(ref, m, ticks=ticks, memoize=memoize,
                            backend="batched" if backend == "jit" else backend)


class TestDagDigest:
    def _base(self):
        ref = j_production_dag(np.random.default_rng(0), scale=0.35, share=3)
        return _port(ref), ref

    def test_equal_content_collides(self):
        dag, ref = self._base()
        assert dag_digest(dag) == dag_digest(_dag_copy(dag)) == j_digest(ref)

    def test_parent_row_order_is_presentation_not_content(self):
        dag, ref = self._base()
        perm = [p[::-1].copy() for p in dag.parents]
        assert any(len(p) > 1 for p in perm), "corpus DAG lost its joins"
        assert dag_digest(_dag_copy(dag, parents=perm)) == j_digest(ref)

    def test_permuted_identical_siblings_collide(self):
        def stage_dag(sib_durs):
            n = 1 + len(sib_durs)
            return DAG(duration=np.array([4.0] + list(sib_durs)),
                       demand=np.vstack([[0.5, 0.2]] * n),
                       stage_of=np.array([0] + [1] * len(sib_durs)),
                       parents=[np.empty(0, np.int64)]
                       + [np.array([0])] * len(sib_durs))

        assert dag_digest(stage_dag([1.0, 1.0, 1.0])) == \
            dag_digest(stage_dag([1.0, 1.0, 1.0]))
        assert dag_digest(stage_dag([1.0, 2.0, 1.0])) != \
            dag_digest(stage_dag([2.0, 1.0, 1.0]))

    def test_differing_demand_and_duration_do_not_collide(self):
        dag, _ref = self._base()
        dem = dag.demand.copy()
        dem[0, 0] = min(dem[0, 0] + 0.01, 1.0)
        assert dag_digest(dag) != dag_digest(_dag_copy(dag, demand=dem))
        dur = dag.duration.copy()
        dur[1] += 0.5
        assert dag_digest(dag) != dag_digest(_dag_copy(dag, duration=dur))

    def test_differing_structure_does_not_collide(self):
        dag, _ref = self._base()
        stage = dag.stage_of.copy()
        stage[-1] = stage[-2]
        assert dag_digest(dag) != dag_digest(_dag_copy(dag, stage_of=stage))
        parents = [p.copy() for p in dag.parents]
        victim = next(i for i, p in enumerate(parents) if len(p) > 1)
        parents[victim] = parents[victim][:-1]
        assert dag_digest(dag) != dag_digest(_dag_copy(dag, parents=parents))

    def test_simulator_cache_and_service_share_the_digest(self):
        dag, ref = self._base()
        svc = BuildService(workers=1, mode="serial", **CPU)
        assert svc.key_for(dag, 3)[0] == dag_digest(dag) == j_digest(ref)


class TestBuildService:
    @pytest.mark.parametrize("mode", ["serial", "thread", "process"])
    def test_build_many_parity(self, mode):
        want = [_ref_build(s) for s in range(2)]
        dags = [_port(r) for r in _ref_dags(2)]
        got = build_many(dags, 3, workers=2, mode=mode, ticks=96, **CPU)
        for w, g, d in zip(want, got, dags):
            _assert_same_schedule(g, w, f"(mode={mode})")
            assert g.dag is d, "Schedule must rebind the submitted DAG"

    def test_dedup_front(self):
        dag = _port(_ref_dags(1)[0])
        twin = _dag_copy(dag)
        with BuildService(workers=2, mode="thread", **CPU) as svc:
            a = svc.submit(dag, 3, ticks=96)
            b = svc.submit(dag, 3, ticks=96)       # same object
            c = svc.submit(twin, 3, ticks=96)      # equal content
            d = svc.submit(dag, 4, ticks=96)       # different share: rebuild
            _assert_same_schedule(a.result(WAIT), b.result(WAIT))
            _assert_same_schedule(a.result(WAIT), c.result(WAIT))
            assert c.result(WAIT).dag is twin
            assert svc.stats["submitted"] == 4
            assert svc.stats["built"] == 2
            assert svc.stats["deduped"] == 2
            d.result(WAIT)

    def test_completed_entries_serve_as_cache(self):
        dag = _port(_ref_dags(1)[0])
        with BuildService(workers=2, mode="thread", **CPU) as svc:
            first = svc.submit(dag, 3, ticks=96)
            first.result(WAIT)
            again = svc.submit(dag, 3, ticks=96)
            assert svc.stats["built"] == 1
            _assert_same_schedule(first.result(WAIT), again.result(WAIT))

    def test_knobs_partition_the_key(self):
        dag = _port(_ref_dags(1)[0])
        svc = BuildService(workers=1, mode="serial", **CPU)
        keys = {svc.key_for(dag, 3),
                svc.key_for(dag, 3, ticks=128),
                svc.key_for(dag, 3, memoize=False),
                svc.key_for(dag, 3, backend="reference"),
                svc.key_for(dag, 3, backend="jit"),
                svc.key_for(dag, 4)}
        assert len(keys) == 6
        with pytest.raises(TypeError):
            svc.key_for(dag, 3, bogus_knob=1)
        # the device is where a build runs, not what it computes
        assert BuildService(workers=1, mode="serial",
                            **CPU).key_for(dag, 3) == svc.key_for(dag, 3)

    def test_shutdown_rejects_new_work(self):
        svc = BuildService(workers=1, mode="serial", **CPU)
        svc.shutdown()
        with pytest.raises(RuntimeError):
            svc.submit(_port(_ref_dags(1)[0]), 3)

    def test_bad_mode_and_workers(self):
        with pytest.raises(ValueError):
            BuildService(workers=2, mode="fibers", **CPU)
        with pytest.raises(ValueError):
            BuildService(workers=0, **CPU)
        with pytest.raises(ValueError):
            BuildService(workers=1, device="meta")

    def test_build_and_clear_cache(self):
        dag = _port(_ref_dags(1)[0])
        with BuildService(workers=1, mode="serial", **CPU) as svc:
            a = svc.build(dag, 3, ticks=96)
            svc.clear_cache()
            b = svc.build(dag, 3, ticks=96)
            assert svc.stats["built"] == 2
            _assert_same_schedule(a, b)

    def test_env_defaults(self, monkeypatch):
        monkeypatch.setenv(buildsvc.WORKERS_ENV, "3")
        monkeypatch.setenv(buildsvc.MODE_ENV, "thread")
        svc = BuildService(**CPU)
        assert svc.workers == 3 and svc.mode == "thread"
        monkeypatch.delenv(buildsvc.WORKERS_ENV)
        assert buildsvc.default_workers() >= 1
        monkeypatch.delenv(MP_ENV, raising=False)
        assert buildsvc._default_mp_context().get_start_method() in (
            "forkserver", "spawn")
        monkeypatch.setenv(MP_ENV, "spawn")
        assert buildsvc._default_mp_context().get_start_method() == "spawn"
        # fork only where nothing a child cannot inherit is alive
        monkeypatch.setattr(buildsvc, "_fork_hazards", lambda: [])
        monkeypatch.setenv(MP_ENV, "fork")
        assert buildsvc._default_mp_context().get_start_method() == "fork"

    def test_fork_refused_once_a_thread_is_alive(self, monkeypatch):
        monkeypatch.setenv(MP_ENV, "fork")
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
        stop = threading.Event()
        t = threading.Thread(target=stop.wait, args=(WAIT,))
        t.start()
        try:
            with pytest.raises(RuntimeError, match="thread"):
                buildsvc._default_mp_context()
        finally:
            stop.set()
            t.join(WAIT)
        assert not t.is_alive()

    def test_unimportable_main_forks_only_when_safe(self, monkeypatch):
        """A heredoc parent cannot have its __main__ re-imported by a
        forkserver or spawn worker: it forks while that is safe, and
        otherwise gets an error, never an unsafe fork."""
        monkeypatch.delenv(MP_ENV, raising=False)
        monkeypatch.setattr(buildsvc, "_main_survives_reimport",
                            lambda: False)
        monkeypatch.setattr(buildsvc, "_fork_hazards", lambda: [])
        assert buildsvc._default_mp_context().get_start_method() == "fork"
        monkeypatch.setattr(buildsvc, "_fork_hazards",
                            lambda: ["a CUDA context"])
        with pytest.raises(RuntimeError, match="CUDA context"):
            buildsvc._default_mp_context()

    def test_fork_refused_with_a_cuda_context(self, monkeypatch):
        monkeypatch.setenv(MP_ENV, "fork")
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        with pytest.raises(RuntimeError, match="CUDA context"):
            buildsvc._default_mp_context()

    def test_cuda_service_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a card")
        with pytest.raises(RuntimeError, match="cuda"):
            BuildService(workers=2, mode="thread")

    @pytest.mark.parametrize("mode", ["thread", "process"])
    def test_worker_error_reaches_the_handle_without_retry(self, mode):
        """A build's own exception (on the card: a CUDA error, a refused
        launch) completes the handle: no retry, no inline build."""
        dag = _port(_ref_dags(1)[0])
        with BuildService(workers=2, mode=mode, **CPU) as svc:
            h = svc.submit(dag, 3, ticks=96, backend="reference",
                           n_long=-1.5)     # n_long must be an int
            with pytest.raises(TypeError):
                h.result(WAIT)
        assert svc.stats["retries"] == 0
        assert svc.stats["inline_fallbacks"] == 0
        assert svc.stats["worker_crashes"] == 0


def test_settings_reach_the_workers_at_pool_creation(monkeypatch):
    """A forkserver's environment is frozen when it starts; the parent's
    ``REPRO_*`` settings as of each pool's creation reach its workers
    through the initializer (here a pin the worker's dispatch rejects)."""
    dag = _port(_ref_dags(1)[0])
    monkeypatch.delenv(kernels.KERNELS_ENV, raising=False)
    with BuildService(workers=1, mode="process", **CPU) as svc:
        _assert_same_schedule(svc.build(dag, 3, ticks=96), _ref_build(0))
    monkeypatch.setenv(kernels.KERNELS_ENV, "scan=bogus")
    with BuildService(workers=1, mode="process", **CPU) as svc:
        with pytest.raises(ValueError, match="bogus"):
            svc.submit(dag, 3, ticks=96).result(WAIT)
    assert svc.stats["retries"] == svc.stats["inline_fallbacks"] == 0


def test_shutdown_without_wait_stops_a_running_worker():
    """``shutdown(wait=False)`` (the simulator's, on any exit) leaves no
    worker behind, even one stuck in a build; the handle resolves."""
    dag = _port(_ref_dags(1)[0])
    with faults.scope("seed=1;build_worker:hang@1,delay=30"):
        svc = BuildService(workers=1, mode="process", **CPU)
        h = svc.submit(dag, 3, ticks=96)
        time.sleep(3.0)                     # the worker is in its build
        procs = list(svc._pool._processes.values())
        t0 = time.monotonic()
        svc.shutdown(wait=False)
    assert time.monotonic() - t0 < 15
    assert procs and not any(p.is_alive() for p in procs)
    try:
        _assert_same_schedule(h.result(WAIT), _ref_build(0))
    except RuntimeError as exc:            # stopped mid-build
        assert "shut down" in str(exc)


class TestBuildServiceParity:
    """``tests/test_builder_parity.py::TestBuildServiceParity`` against the
    reference's serial builds."""

    @staticmethod
    def _corpus():
        ref = j_production_dag(np.random.default_rng(0), scale=0.35,
                               share=3)
        out = [("production-0", ref, 3, 96)]
        ref = j_query_dag(np.random.default_rng(3), preset="tpcds")
        out.append(("tpcds-3", ref, 4, 128))
        return out

    @pytest.mark.parametrize("memoize", [True, False])
    @pytest.mark.parametrize("backend", ["reference", "batched", "jit"])
    def test_build_many_equals_serial_loop(self, backend, memoize):
        corpus = self._corpus()
        want = [_ref_build(0, memoize=memoize, backend=backend),
                j_build_schedule(corpus[1][1], 4, ticks=128, memoize=memoize,
                                 backend="batched" if backend == "jit"
                                 else backend)]
        with BuildService(workers=2, mode="thread", **CPU) as svc:
            handles = [svc.submit(_port(ref), m, ticks=ticks, backend=backend,
                                  memoize=memoize)
                       for _n, ref, m, ticks in corpus]
            pooled = [h.result(WAIT) for h in handles]
        for (name, *_), w, p in zip(corpus, want, pooled):
            _assert_same_schedule(p, w, f"({name}, {backend}, {memoize})")

    def test_process_mode_equals_serial_loop(self):
        corpus = self._corpus()
        want = [_ref_build(0), j_build_schedule(corpus[1][1], 3, ticks=96)]
        pooled = build_many([_port(ref) for _n, ref, _m, _t in corpus], 3,
                            workers=2, mode="process", ticks=96, **CPU)
        for (name, *_), w, p in zip(corpus, want, pooled):
            _assert_same_schedule(p, w, f"({name}, mode=process)")


def test_buildsvc_resubmit_parity_and_dedup():
    """``tests/test_dynamic.py``'s twin: a delta resubmission equals a
    fresh build of the edited DAG, here and in the reference."""
    dag = periodic_dag(np.random.default_rng(5), name="recurring")
    new, delta = mut_resize_stage(stage=1, delta_q=1)(dag)
    j_new, _ = j_mut_resize_stage(stage=1, delta_q=1)(
        j_periodic_dag(np.random.default_rng(5), name="recurring"))
    want = build_schedule(new, 4, **CPU)
    _assert_same_schedule(want, j_build_schedule(j_new, 4))
    with BuildService(workers=2, mode="thread", **CPU) as svc:
        h = svc.submit(dag, 4)
        h.result(WAIT)
        h2 = svc.resubmit(h, new, delta)
        assert_schedules_equal(h2.result(WAIT), want)
        before = svc.stats["resubmit_deduped"]
        h3 = svc.resubmit(h, new, delta)
        assert_schedules_equal(h3.result(WAIT), want)
        assert svc.stats["resubmit_deduped"] == before + 1
        assert svc.stats["resubmits"] == 2


class TestBuildWorkerFaults:
    """The ``build_worker`` cases of ``tests/test_faults.py``."""

    _TINY_REC = dict(backoff=0.001, backoff_cap=0.002)

    @staticmethod
    def _dag(seed):
        ref = j_production_dag(np.random.default_rng(seed), scale=0.3,
                               share=3)
        return _port(ref), j_build_schedule(ref, 8)

    def test_build_retries_then_succeeds_and_dedup_shares(self):
        dag, want = self._dag(1)
        with faults.scope("seed=1;build_worker:raise@1,attempt_lt=2"):
            with BuildService(workers=2, mode="thread",
                              recovery=RecoveryPolicy(**self._TINY_REC),
                              **CPU) as svc:
                h1 = svc.submit(dag, 8)
                h2 = svc.submit(dag, 8)
                _assert_same_schedule(h1.result(WAIT), want)
                _assert_same_schedule(h2.result(WAIT), want)
        assert svc.stats["retries"] == 2
        assert svc.stats["deduped"] == 1
        assert svc.stats["inline_fallbacks"] == 0
        assert svc.stats["recovery_secs"] > 0

    def test_exhausted_retries_fall_back_inline(self):
        dag, want = self._dag(2)
        with faults.scope("seed=1;build_worker:raise@1"):
            with BuildService(workers=2, mode="thread",
                              recovery=RecoveryPolicy(build_retries=1,
                                                      **self._TINY_REC),
                              **CPU) as svc:
                got = svc.submit(dag, 8).result(WAIT)
        _assert_same_schedule(got, want)
        assert svc.stats["retries"] == 2
        assert svc.stats["inline_fallbacks"] == 1

    @pytest.mark.parametrize("method", ["forkserver", "spawn"])
    def test_injected_raise_in_a_worker_process_is_retried(self, method,
                                                           monkeypatch):
        """The plan reaches process workers through the pool's initializer,
        under either start method: the seam fires there and the raise is
        retried."""
        monkeypatch.setenv(MP_ENV, method)
        dag, want = self._dag(1)
        with faults.scope("seed=1;build_worker:raise@1,attempt_lt=1"):
            with BuildService(workers=2, mode="process",
                              recovery=RecoveryPolicy(**self._TINY_REC),
                              **CPU) as svc:
                _assert_same_schedule(svc.submit(dag, 8).result(WAIT), want)
        assert svc.stats["retries"] == 1
        assert svc.stats["inline_fallbacks"] == 0

    def test_worker_crash_neither_hangs_nor_loses_sharers(self, monkeypatch):
        """A worker process dying mid-build must not hang
        ``BuildHandle.result()`` and every dedup sharer of the crashed
        digest still gets its schedule.  The plan comes from the
        environment, as in the reference, and reaches the workers by the
        initializer, whatever the start method."""
        monkeypatch.delenv(MP_ENV, raising=False)
        monkeypatch.setenv(faults.FAULTS_ENV,
                           "seed=1;build_worker:crash@1,attempt_lt=1")
        dag, want = self._dag(3)
        with faults.scope(None):
            with BuildService(workers=2, mode="process",
                              recovery=RecoveryPolicy(backoff=0.01,
                                                      backoff_cap=0.02),
                              **CPU) as svc:
                h1 = svc.submit(dag, 8)
                h2 = svc.submit(dag, 8)
                _assert_same_schedule(h1.result(WAIT), want)
                _assert_same_schedule(h2.result(WAIT), want)
        assert svc.start_method in ("forkserver", "spawn")
        assert svc.stats["worker_crashes"] >= 1
        assert svc.stats["deduped"] == 1
        assert svc.stats["quarantined_digests"] == 0

    def test_crash_looping_digest_quarantined_to_inline(self, monkeypatch):
        monkeypatch.delenv(MP_ENV, raising=False)
        monkeypatch.setenv(faults.FAULTS_ENV, "seed=1;build_worker:crash@1")
        dag, want = self._dag(4)
        with faults.scope(None):
            with BuildService(workers=1, mode="process",
                              recovery=RecoveryPolicy(backoff=0.01,
                                                      backoff_cap=0.02,
                                                      quarantine_after=2,
                                                      build_retries=5),
                              **CPU) as svc:
                got = svc.submit(dag, 8).result(WAIT)
        _assert_same_schedule(got, want)
        assert svc.stats["worker_crashes"] == 2
        assert svc.stats["quarantined_digests"] == 1
        assert svc.stats["inline_fallbacks"] == 1


_SIM_KW = dict(n_machines=20, interarrival=4.0, seed=9, build_machines=3)


@pytest.fixture(scope="module")
def sim_serial():
    """The reference's serial run and the port's, on the same DAGs."""
    refs = _ref_dags(3, seed0=60)
    j_clear_schedule_cache()
    want = j_run_workload(refs, "dagps", **_SIM_KW)
    dags = [_port(r) for r in refs]
    clear_schedule_cache()
    base = run_workload(dags, "dagps", **CPU, **_SIM_KW)
    assert [repr(j.jct) for j in base.jobs] == \
        [repr(j.jct) for j in want.jobs]
    assert base.makespan == want.makespan
    return dags, base


class TestSimIntegration:
    @pytest.mark.parametrize("mode", ["process", "thread"])
    def test_build_workers_bit_identical(self, mode, monkeypatch,
                                         sim_serial):
        """Overlapped construction changes wall clock only: every decision
        matches the serial path, which matches the reference's serial
        run."""
        dags, base = sim_serial
        kw = _SIM_KW
        monkeypatch.setenv(buildsvc.MODE_ENV, mode)
        clear_schedule_cache()
        par = run_workload(dags, "dagps", build_workers=2, **CPU, **kw)
        assert [repr(j.jct) for j in par.jobs] == \
            [repr(j.jct) for j in base.jobs]
        assert par.makespan == base.makespan
        assert par.fault_stats["build"] == dict.fromkeys(
            ("retries", "worker_crashes", "quarantined_digests",
             "inline_fallbacks", "resubmits", "resubmit_deduped"), 0)
        clear_schedule_cache()
        nocache = run_workload(dags, "dagps", build_workers=2,
                               schedule_cache=False, **CPU, **kw)
        assert np.array_equal(base.jcts(), nocache.jcts())

    def test_non_dagps_schemes_skip_the_service(self):
        dags = [_port(j_production_dag(np.random.default_rng(70), scale=0.35,
                                       share=3))]
        res = run_workload(dags, "tez", n_machines=10, seed=1,
                           build_workers=4, **CPU)
        assert len(res.jobs) == 1

    def test_schedule_cluster_passes_build_workers(self, monkeypatch):
        monkeypatch.setenv(buildsvc.MODE_ENV, "thread")
        jobs = [TPUJob(f"j{i}", "arch", [dict(seconds=10.0 + i),
                                         dict(seconds=5.0, deps=[0])])
                for i in range(3)]
        serial = schedule_cluster(jobs, n_slices=8, **CPU)
        par = schedule_cluster(jobs, n_slices=8, build_workers=2, **CPU)
        assert [repr(j.jct) for j in par.jobs] == \
            [repr(j.jct) for j in serial.jobs]
        assert par.fault_stats["build"]["retries"] == 0


class TestThreadSafetyHardening:
    def test_counters_add_is_atomic(self):
        base = COUNTERS["places_evaluated"]
        n_threads, n_adds = 8, 5000

        def work():
            for _ in range(n_adds):
                COUNTERS.add("places_evaluated")

        ts = [threading.Thread(target=work) for _ in range(n_threads)]
        [t.start() for t in ts]
        [t.join(WAIT) for t in ts]
        assert not any(t.is_alive() for t in ts)
        assert COUNTERS["places_evaluated"] == base + n_threads * n_adds

    def test_dispatch_profile_counts_exact_under_threads(self):
        kernels.reset_profile()
        avail = np.ones((4, 64, 2), dtype=np.float32)
        Vs = ceil32(np.full((3, 2), 0.4))
        ks = np.array([2, 3, 4])
        n_threads, n_calls = 8, 40
        ref = kernels.scan_starts(avail, Vs, ks, 0, 32)
        errs = []

        def work():
            try:
                with kernels.use_device("cpu"):   # the device is per thread
                    for _ in range(n_calls):
                        got = kernels.scan(avail, Vs, ks, 0, 32)
                        assert np.array_equal(got, ref)
            except Exception as e:  # pragma: no cover - failure path
                errs.append(e)

        ts = [threading.Thread(target=work) for _ in range(n_threads)]
        [t.start() for t in ts]
        [t.join(WAIT) for t in ts]
        assert not errs
        snap = kernels.profile_snapshot()
        total = sum(calls for key, (calls, _s) in snap.items()
                    if key in ("scan.torch", "scan.cuda", "scan.numpy"))
        assert total == n_threads * n_calls, "dispatch accounting dropped calls"

    def test_device_choice_is_per_thread(self):
        """A build thread's ``use_device`` neither leaks into another
        thread nor is undone by a thread leaving its block first."""
        seen = []
        entered = threading.Barrier(2)
        left = threading.Event()

        def early():
            with kernels.use_device("cpu"):
                entered.wait(WAIT)
            left.set()

        def late():
            with kernels.use_device("cpu"):
                entered.wait(WAIT)
                left.wait(WAIT)
                seen.append(kernels.current_device())
            seen.append(kernels.current_device())

        ts = [threading.Thread(target=early), threading.Thread(target=late)]
        [t.start() for t in ts]
        [t.join(WAIT) for t in ts]
        assert seen == ["cpu", "cuda"]

    def test_library_loads_once_under_concurrent_first_use(self,
                                                           monkeypatch):
        """Replaces the reference's compile-cache test: worker threads
        calling a kernel family's first launch at once load (and bind) its
        library once."""
        loads, binds = [], []
        monkeypatch.setattr(kbuild.NvccLibrary, "build",
                            lambda self, verbose=False: "libfake.so")
        monkeypatch.setattr(kbuild.ctypes, "CDLL",
                            lambda path: loads.append(path) or object())
        lib = kbuild.NvccLibrary("fake", __file__, (),
                                 lambda handle: binds.append(handle))
        barrier = threading.Barrier(8)
        got = []

        def work():
            barrier.wait(WAIT)
            got.append(lib.lib())

        ts = [threading.Thread(target=work) for _ in range(8)]
        [t.start() for t in ts]
        [t.join(WAIT) for t in ts]
        assert loads == ["libfake.so"] and len(binds) == 1
        assert len(got) == 8 and all(h is got[0] for h in got)

    def test_concurrent_builds_all_backends(self):
        """Thread-mode builds through every backend at once — the jit
        sessions run per-Space mirrors from worker threads; outputs equal
        the reference's solo builds."""
        refs = _ref_dags(1)
        want = {be: [_ref_build(0, backend=be)]
                for be in ("reference", "batched", "jit")}
        with BuildService(workers=4, mode="thread", **CPU) as svc:
            handles = [(be, i, svc.submit(_port(r), 3, ticks=96, backend=be))
                       for be in want for i, r in enumerate(refs)]
            for be, i, h in handles:
                _assert_same_schedule(h.result(WAIT), want[be][i],
                                      f"(backend={be}, dag={i})")


class TestMinBatch:
    """Replaces the reference's platform probe: the jit backend's batch
    floor is REPRO_JIT_MIN_BATCH, else 4 on the cuda device, 16 on the
    cpu."""

    def test_env_override_wins(self, monkeypatch):
        monkeypatch.setattr(J, "MIN_DEVICE_G", None)
        monkeypatch.setenv(J.MIN_BATCH_ENV, "7")
        assert J.min_device_g() == 7
        monkeypatch.setattr(kernels, "current_device", lambda: "cuda")
        assert J.min_device_g() == 7

    def test_default_by_device(self, monkeypatch):
        monkeypatch.setattr(J, "MIN_DEVICE_G", None)
        monkeypatch.delenv(J.MIN_BATCH_ENV, raising=False)
        with kernels.use_device("cpu"):
            assert J.min_device_g() == 16
        monkeypatch.setattr(kernels, "current_device", lambda: "cuda")
        assert J.min_device_g() == 4

    def test_monkeypatched_constant_is_honored(self, monkeypatch):
        monkeypatch.setattr(J, "MIN_DEVICE_G", 3)
        assert J.min_device_g() == 3


@pytest.fixture(scope="module", autouse=True)
def children_before():
    """The children this process had before this file's first test (a test
    of another file that ran here first may have left some)."""
    return {p.pid for p in multiprocessing.active_children()}


def test_no_worker_process_left(children_before):
    """Every service above shut its pool down: no child of theirs is alive;
    the forkserver the pools forked from stops on request."""
    left = {p.pid for p in multiprocessing.active_children()}
    assert not left - children_before
    buildsvc.stop_forkserver()
    from multiprocessing import forkserver
    assert forkserver._forkserver._forkserver_pid is None

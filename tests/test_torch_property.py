"""Property-based twins of ``tests/test_property.py`` on the port
(``repro_torch``), on the CPU.

The same invariants on the same random inputs (hypothesis), each also
held against the reference where the two compute the same thing: the
schedule respects dependencies and capacity, never beats NewLB, and is
the reference's schedule; the execution simulator is work conserving,
bounded by NewLB and the serial sum, and gives the reference's makespan;
deficit counters stay within their bound; the space's
snapshot/branch/restore leaves the grid bit-identical to a clone; the
memoized builder is bit-identical to the plain one; int8 compression
(on tensors) is within half a step of its grid, with the reference's
quantized values.
"""

import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need hypothesis (pip install -e .[test])")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import build_schedule as j_build_schedule  # noqa: E402
from repro.core import simulate_execution as j_simulate  # noqa: E402
from repro.core.dag import from_stage_graph as j_from_stage_graph  # noqa: E402
from repro.core.online import DeficitCounters as JDeficitCounters  # noqa: E402
from repro.optim.compression import quantize_int8 as j_quantize  # noqa: E402
from repro_torch.core import (DeficitCounters, Space, build_schedule,  # noqa: E402
                              new_lb, simulate_execution)
from repro_torch.core.baselines import bfs_order  # noqa: E402
from repro_torch.core.dag import from_stage_graph  # noqa: E402
from repro_torch.optim.compression import dequantize, quantize_int8  # noqa: E402

torch.set_num_threads(1)


@st.composite
def small_dags(draw):
    """(port DAG, reference DAG): the reference's strategy, drawn once and
    built by both packages' ``from_stage_graph`` from equal generators."""
    n_stages = draw(st.integers(2, 7))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    tasks, durs, dems, deps = [], [], [], []
    for s in range(n_stages):
        tasks.append(int(rng.integers(1, 5)))
        durs.append(float(rng.uniform(0.5, 20.0)))
        dems.append(np.clip(rng.uniform(0.05, 0.8, 4), 0.05, 0.8))
        n_par = int(rng.integers(0, min(s, 2) + 1))
        deps.append(sorted(rng.choice(s, size=n_par, replace=False).tolist())
                    if s and n_par else [])
    state = rng.bit_generator.state
    jrng = np.random.default_rng()
    jrng.bit_generator.state = state
    return (from_stage_graph(tasks, durs, dems, deps, rng=rng),
            j_from_stage_graph(tasks, durs, dems, deps, rng=jrng))


@settings(max_examples=15, deadline=None)
@given(small_dags(), st.integers(1, 4))
def test_schedule_respects_dependencies_and_beats_nothing(dags, m):
    dag, jdag = dags
    sched = build_schedule(dag, m=m, ticks=128, device="cpu")
    sched.validate()                       # deps + capacity
    assert dag.validate_order(sched.order)
    lb = new_lb(dag, m)
    assert sched.makespan >= lb * 0.98 - 2 * sched.tick
    want = j_build_schedule(jdag, m=m, ticks=128)
    assert sched.makespan == want.makespan
    assert np.array_equal(sched.start, want.start)
    assert np.array_equal(sched.machine, want.machine)


@settings(max_examples=15, deadline=None)
@given(small_dags(), st.integers(1, 4))
def test_executor_work_conserving_and_bounded(dags, m):
    dag, jdag = dags
    ms = simulate_execution(dag, m, order=bfs_order(dag))
    assert new_lb(dag, m) * 0.999 <= ms <= float(dag.duration.sum()) + 1e-6
    assert ms == j_simulate(jdag, m, order=bfs_order(dag))


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(0, 3), min_size=5, max_size=60),
       st.floats(0.05, 0.5))
def test_deficit_counters_never_exceed_bound_when_enforced(allocs, kappa):
    """Serving must_serve() whenever it is set keeps every deficit within
    kappa * C plus one allocation; the port's counters follow the
    reference's step for step."""
    C = 10.0
    shares = {0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0}
    dc = DeficitCounters(shares, capacity=C, kappa=kappa)
    jdc = JDeficitCounters(shares, capacity=C, kappa=kappa)
    for g in allocs:
        forced = dc.must_serve()
        assert forced == jdc.must_serve()
        dc.allocated(forced if forced is not None else g, 1.0)
        jdc.allocated(forced if forced is not None else g, 1.0)
        assert max(dc.deficit.values()) <= kappa * C + 1.0 + 1e-9
        assert dc.deficit == jdc.deficit


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(5, 60))
def test_space_restore_matches_clone_oracle(seed, n_ops):
    """Random snapshot/branch/restore interleavings of the port's `Space`
    leave the grid bit-identical to a clone taken at each snapshot."""
    rng = np.random.default_rng(seed)
    s = Space(m=int(rng.integers(1, 4)), d=int(rng.integers(1, 3)),
              horizon=int(rng.integers(8, 24)))
    stack = []
    tid = 0

    def same(oracle):
        assert s.T == oracle.T and s.off == oracle.off
        assert np.array_equal(s.avail, oracle.avail)
        assert len(s.placements) == len(oracle.placements)
        assert s._min_start == oracle._min_start
        assert s._max_end == oracle._max_end
        assert s.makespan_ticks == oracle.makespan_ticks
    for _ in range(n_ops):
        op = rng.random()
        if op < 0.45:
            v = rng.uniform(0.05, 0.9, s.d)
            k = int(rng.integers(1, 6))
            if rng.random() < 0.5:
                m, t0 = s.earliest_fit(v, k, int(rng.integers(0, 12)))
            else:
                m, t0 = s.latest_fit(v, k, int(rng.integers(4, 16)))
            s.commit(tid, m, t0, k, v)
            tid += 1
        elif op < 0.6:
            (s._grow_front if rng.random() < 0.5 else s._grow_back)()
        elif op < 0.8 or not stack:
            stack.append((s.snapshot(), s.clone()))
        else:
            depth = int(rng.integers(0, len(stack)))
            snap, oracle = stack[depth]
            del stack[depth + 1:]
            s.restore(snap)
            same(oracle)
    while stack:
        snap, oracle = stack.pop()
        s.restore(snap)
        same(oracle)


@settings(max_examples=15, deadline=None)
@given(small_dags(), st.integers(1, 4))
def test_memoized_build_matches_plain(dags, m):
    dag, _ = dags
    a = build_schedule(dag, m=m, ticks=128, memoize=True, device="cpu")
    b = build_schedule(dag, m=m, ticks=128, memoize=False, device="cpu")
    assert a.makespan == b.makespan
    assert np.array_equal(a.start, b.start)
    assert np.array_equal(a.machine, b.machine)
    assert np.array_equal(a.order, b.order)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 512))
def test_int8_compression_relative_error(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32) * rng.uniform(1e-3, 1e3)
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    err = (dequantize(q, s) - torch.from_numpy(x)).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-12


@pytest.mark.parametrize("n", [1, 37, 512])
def test_int8_compression_matches_reference(n):
    """The port's quantized values and scale are the reference's (a fixed
    few sizes: each new size compiles the reference's jnp ops anew)."""
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32) * 3.0
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = j_quantize(x)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)

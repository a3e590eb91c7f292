"""The port's shard-launch fault seam against the reference, on the CPU.

The reference's exact-mode recovery tests (``tests/test_faults.py``
``test_exact_recoverable_plan_is_decision_exact`` and
``test_exact_recovery_property``) run 24 machines in 2 shards, where the
reference's wave is its numpy host loop: the loop asks
``ShardedMatcher.eligibility`` for each wave's machine filter, and that
call passes the ``shard_launch`` seam with its retry and quarantine.  Its
device wave (auto-promoted at 1536 machines or more) never calls it.  The
port's device wave runs at every machine count, so its twins pin
``REPRO_KERNELS=match_wave=numpy``, the configuration the reference runs at
this size, and must reproduce the reference's injections, shard statistics
and decisions exactly.  On the port's default wave the seam is not passed,
as on the reference's device wave: no injection, the same decisions.
"""

import pytest
import torch

from repro.core import FaultPlan as JFaultPlan
from repro.core import RecoveryPolicy as JRecoveryPolicy
from repro.sim.cluster import run_workload as j_run_workload
from repro.sim.workload import online_mix_workload as j_online_mix_workload

from repro_torch.core import FaultPlan, RecoveryPolicy
from repro_torch.core.engine import kernels as tk
from repro_torch.sim import online_mix_workload, run_workload

# the tensors here are tiny: one intra-op thread is several times
# faster than a pool, and leaves the other test workers their cores
torch.set_num_threads(1)

#: tests/test_faults.py's simulator and recovery settings
_SIM_KW = dict(n_machines=24, interarrival=2.0, n_groups=2, seed=6,
               build_machines=4, matcher_shards=2)
_REC = dict(launch_timeout=5.0, launch_retries=1, backoff=0.001,
            backoff_cap=0.002, quarantine_after=2, probe_every=3)

#: test_exact_recoverable_plan_is_decision_exact's plans (seeds 0-2) and a
#: few draws of test_exact_recovery_property's (seed, raise probability)
_PLANS = ([f"seed={s};shard_launch:raise@0.5;shard_launch:hang@0.2,"
           "delay=0.005" for s in range(3)]
          + [f"seed={s};shard_launch:raise@{p:.3f}"
             for s, p in ((17, 0.3), (4242, 0.7))])

_REFERENCE: dict = {}


def _decision_key(res):
    return ([(j.job_id, repr(j.jct)) for j in
             sorted(res.jobs, key=lambda j: j.job_id)],
            repr(res.makespan))


def _reference(plan: str):
    """The reference's run of ``plan`` (healthy: ``""``), once per process."""
    if plan not in _REFERENCE:
        kw = dict(_SIM_KW)
        if plan:
            kw.update(fault_plan=JFaultPlan.parse(plan),
                      recovery=JRecoveryPolicy(**_REC))
        else:
            kw.update(fault_plan=JFaultPlan())
        _REFERENCE[plan] = j_run_workload(j_online_mix_workload(6, seed=6),
                                          "dagps", **kw)
    return _REFERENCE[plan]


def _port(plan: str):
    plan_obj = FaultPlan.parse(plan)
    assert plan_obj.is_exact_recoverable()
    return run_workload(online_mix_workload(6, seed=6), "dagps",
                        fault_plan=plan_obj,
                        recovery=RecoveryPolicy(**_REC), device="cpu",
                        **_SIM_KW)


@pytest.mark.parametrize("plan", _PLANS)
def test_numpy_wave_recovery_equals_reference(plan, monkeypatch):
    monkeypatch.setenv(tk.KERNELS_ENV, "match_wave=numpy")
    want = _reference(plan)
    tk.reset_profile()
    got = _port(plan)
    assert got.fault_stats["injections"]              # the plan fired
    assert got.fault_stats["injections"] == want.fault_stats["injections"]
    assert got.fault_stats["shard"] == want.fault_stats["shard"]
    shard = got.fault_stats["shard"]
    assert shard["launch_retries"] + shard["quarantined_launches"] > 0
    assert got.fault_stats["recovery_secs"] > 0
    assert _decision_key(got) == _decision_key(want)
    assert _decision_key(got) == _decision_key(_reference(""))
    prof = tk.profile_snapshot()
    assert prof["match_wave.numpy"][0] > 0
    assert prof["machines_with_candidates.torch"][0] > 0


@pytest.mark.parametrize("plan", _PLANS[:1] + _PLANS[3:4])
def test_device_wave_passes_no_shard_launch_seam(plan, monkeypatch):
    """The default wave (the plain version of the device kernel on the
    CPU) never asks for the eligibility filter, like the reference's
    device wave: the plan never fires, the decisions stay exact."""
    monkeypatch.delenv(tk.KERNELS_ENV, raising=False)
    tk.reset_profile()
    got = _port(plan)
    assert got.fault_stats["injections"] == {}
    shard = got.fault_stats["shard"]
    assert shard["launch_retries"] == shard["quarantined_launches"] == 0
    assert _decision_key(got) == _decision_key(_reference(""))
    prof = tk.profile_snapshot()
    assert prof["match_wave.torch"][0] > 0
    assert "machines_with_candidates.torch" not in prof

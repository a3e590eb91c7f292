"""Where the scheduler service's time goes, on one workload.

Runs ``chip_smoke.py``'s ``path:service`` workload (``online_mix_workload(12,
seed=88)``, interarrival 0.5 from ``default_rng(0)``, groups ``i % 2``,
``build_machines=4``) through ``run_service_workload`` and through
``ClusterSim(speculate=False)`` on ``--device``, checks that both make the
same decisions, and prints one JSON line: both walls, the service's pumps
and agent polls, its kernel launches, and the dispatch layer's calls and
seconds per op.  With ``--profile`` the service run is repeated under
cProfile and the line also gives the cumulative seconds of the control
plane's parts (agent polls, pumps, the silence walk, channel polls,
builds) and the run's total; cProfile inflates small calls, so read those
as proportions.  ``chip_smoke.py`` imports `measure` for ``path:service``.

    PYTHONPATH=src python3 scripts/service_profile.py [--device cpu]
        [--machines 256] [--jobs 12] [--profile]
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import json
import os
import pstats
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (label, file suffix, function) of the control plane's parts
PARTS = (("agent_poll", "svc/agent.py", "poll"),
         ("pump", "svc/scheduler.py", "pump"),
         ("check_silence", "svc/scheduler.py", "check_silence"),
         ("channel_poll", "svc/comm.py", "poll"),
         ("build", "svc/scheduler.py", "_make_pri"))


def arrivals(dags, interarrival: float, rng_seed: int, groups: int) -> list:
    """``(t, dag, group)`` arrivals: exponential gaps from a seed, group
    ``i % groups``."""
    import numpy as np

    rng = np.random.default_rng(rng_seed)
    out, t = [], 0.0
    for i, dag in enumerate(dags):
        out.append((t, dag, i % groups))
        t += float(rng.exponential(interarrival))
    return out


def service_config(device: str, machines: int):
    from repro_torch.svc import ServiceConfig

    return ServiceConfig(n_machines=machines, seed=0, build_machines=4,
                         device=device)


def simulate(arr, device: str, machines: int):
    """``ClusterSim(speculate=False)`` of the arrivals, configured as the
    service is."""
    from repro_torch.core import FaultPlan
    from repro_torch.sim.cluster import ClusterSim, SimConfig, scheme

    return ClusterSim(SimConfig(n_machines=machines, seed=0,
                                build_machines=4, speculate=False,
                                record_placements=True,
                                fault_plan=FaultPlan(), device=device),
                      scheme("dagps")).run(arr)


def measure(device: str, machines: int, jobs: int,
            around=contextlib.nullcontext) -> dict:
    """The service's run (inside ``around()``), then the simulator's on
    the same arrivals: both results and walls, the service's pumps and
    agent polls, the kernel launches and dispatch-layer ``(calls,
    seconds)`` of the service run alone."""
    from repro_torch.core import FaultPlan
    from repro_torch.core.engine import kernels as K
    from repro_torch.kernels.placement_scan import kernel
    from repro_torch.sim import clear_schedule_cache, online_mix_workload
    from repro_torch.sim.cluster import scheme
    from repro_torch.svc import run_service_workload
    from repro_torch.svc.scheduler import SchedulerService

    arr = arrivals(online_mix_workload(jobs, seed=88), 0.5, 0, 2)
    pump, pumps = SchedulerService.pump, [0]

    def counted(self, *a, **kw):
        pumps[0] += 1
        return pump(self, *a, **kw)

    K.reset_profile()
    kernel.reset_launches()
    SchedulerService.pump = counted
    try:
        with around():
            t0 = time.perf_counter()
            svc = run_service_workload(arr, service_config(device, machines),
                                       scheme("dagps"),
                                       fault_plan=FaultPlan())
            wall = time.perf_counter() - t0
    finally:
        SchedulerService.pump = pump
    launches = kernel.launch_counts()
    ops = K.profile_snapshot()
    clear_schedule_cache()                    # the simulator builds too
    t0 = time.perf_counter()
    sim = simulate(arr, device, machines)
    sim_wall = time.perf_counter() - t0
    # every pump but the first and the last is followed by a poll of every
    # agent (svc/client.py); counting 15 million polls with a wrapper would
    # add its own cost to the wall
    return dict(arrivals=arr, svc=svc, sim=sim, wall_s=wall,
                sim_wall_s=sim_wall, pumps=pumps[0],
                agent_polls=(pumps[0] - 2) * machines, launches=launches,
                ops=ops)


def profile(device: str, machines: int, jobs: int) -> dict:
    """The service's run under cProfile: the total and each part's
    cumulative seconds."""
    from repro_torch.core import FaultPlan
    from repro_torch.sim import online_mix_workload
    from repro_torch.sim.cluster import scheme
    from repro_torch.svc import run_service_workload

    arr = arrivals(online_mix_workload(jobs, seed=88), 0.5, 0, 2)
    pr = cProfile.Profile()
    pr.runcall(run_service_workload, arr, service_config(device, machines),
               scheme("dagps"), fault_plan=FaultPlan())
    stats = pstats.Stats(pr)
    cum: dict = {}
    for (path, _line, fn), (_cc, _nc, _tt, ct, _callers) in \
            stats.stats.items():
        for label, suffix, name in PARTS:
            if fn == name and path.replace(os.sep, "/").endswith(suffix):
                cum[label] = cum.get(label, 0.0) + ct
    return {"profile_total_s": stats.total_tt, "profile_cum_s": cum}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--machines", type=int, default=256)
    ap.add_argument("--jobs", type=int, default=12)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    if args.device == "cpu":
        torch.set_num_threads(1)
    m = measure(args.device, args.machines, args.jobs)
    svc, sim = m["svc"], m["sim"]
    if svc.placements != sim.placements \
            or repr(svc.makespan) != repr(sim.makespan):
        print("service_profile: the service's decisions differ from the "
              "simulator's", file=sys.stderr)
        return 1
    out = {"device": args.device, "machines": args.machines,
           "jobs": args.jobs, "makespan": repr(svc.makespan),
           **{k: m[k] for k in ("wall_s", "sim_wall_s", "pumps",
                                "agent_polls", "launches")},
           "ops": {k: list(v) for k, v in m["ops"].items()
                   if k.count(".") == 1}}
    if args.device == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    if args.profile:
        out.update(profile(args.device, args.machines, args.jobs))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Multi-job TPU-cluster gang scheduler (DESIGN.md L2 adaptation).

The paper's online matcher schedules *jobs' stage executions* onto pod
slices: a job = a DAG of stages (data prep -> train epochs -> eval ->
export, or prefill/decode phases of a serving rollout), each stage = a
gang-scheduled step program with a d-resource demand vector derived from
its dry-run roofline (chips-fraction, HBM, HBM-bw-seconds, ICI-bw-seconds
-> normalized per slice).

This reuses the cluster simulator with machines = pod slices, which is how
scheduling policy is validated at 1000+ node scale: the simulator *is* the
control plane; on a real deployment the `start_task` callback launches the
stage's program on the slice instead of advancing virtual time.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from ..core.dag import DAG, from_stage_graph
from ..sim.cluster import ClusterSim, SimConfig, scheme
from .roofline import HBM_PER_DEVICE


@dataclasses.dataclass
class TPUJob:
    """A training/serving job expressed as a stage DAG over slices."""

    name: str
    arch: str
    stages: list[dict]        # {name, slices, seconds, hbm, hbm_bw, ici_bw, deps}
    group: int = 0

    def to_dag(self) -> DAG:
        q, durs, dems, deps = [], [], [], []
        for st in self.stages:
            q.append(int(st.get("slices", 1)))
            durs.append(float(st["seconds"]))
            dems.append(np.clip(np.array([
                st.get("chips", 0.5),
                st.get("hbm", 0.5),
                st.get("hbm_bw", 0.3),
                st.get("ici_bw", 0.3),
            ]), 0.01, 0.9))
            deps.append(list(st.get("deps", [])))
        return from_stage_graph(q, durs, dems, deps, name=self.name)


def job_from_roofline(name: str, arch: str, dryrun_dir: str,
                      steps: int = 100, group: int = 0) -> TPUJob:
    """Build a train job whose stage profile comes from the dry-run
    artifacts (§7.1 adapted: counted-cost profiles instead of container
    histories): ``launch/dryrun.py``'s ``{arch}_train_4k_single.json``,
    its peak memory as a share of one device's (`HBM_PER_DEVICE`).
    Without a record the job takes a built-in profile."""
    path = os.path.join(dryrun_dir, f"{arch}_train_4k_single.json")
    secs, hbm_frac, bw, ici = 60.0, 0.5, 0.5, 0.3
    if os.path.exists(path):
        rec = json.load(open(path))
        if "roofline" in rec:
            rl = rec["roofline"]
            step_s = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
            secs = step_s * steps
            hbm_frac = min(rec["memory"]["peak_live_bytes"] / HBM_PER_DEVICE,
                           0.9)
            total = step_s or 1.0
            bw = min(rl["memory_s"] / total, 0.9)
            ici = min(rl["collective_s"] / total, 0.9)
    stages = [
        dict(name="warmup", slices=1, seconds=30.0, chips=0.2, hbm=0.2,
             hbm_bw=0.1, ici_bw=0.05, deps=[]),
        dict(name="train", slices=1, seconds=secs, chips=0.9, hbm=hbm_frac,
             hbm_bw=bw, ici_bw=ici, deps=[0]),
        dict(name="eval", slices=1, seconds=secs * 0.1, chips=0.5,
             hbm=hbm_frac * 0.7, hbm_bw=bw * 0.5, ici_bw=ici * 0.3, deps=[1]),
        dict(name="export", slices=1, seconds=20.0, chips=0.1, hbm=0.3,
             hbm_bw=0.6, ici_bw=0.05, deps=[2]),
    ]
    return TPUJob(name=name, arch=arch, stages=stages, group=group)


def schedule_cluster(jobs: list[TPUJob], n_slices: int = 32,
                     interarrival: float = 60.0, seed: int = 0,
                     policy: str = "dagps",
                     placement_backend: str | None = None,
                     build_workers: int | None = 1,
                     matcher_shards: int | None = None,
                     matcher_mode: str = "exact",
                     profile: bool = False,
                     fault_plan=None,
                     heartbeat_period: float | None = None,
                     hb_suspect_after: float | None = None,
                     hb_lost_after: float | None = None,
                     recovery=None,
                     mutations=None,
                     speculate: bool = True,
                     serve: bool = False,
                     device: str = "cuda"):
    """Gang-schedule the jobs' stage DAGs onto pod slices with DAGPS.

    ``placement_backend`` selects the offline construction engine
    (reference / batched / jit) for the schemes that build preferred
    schedules; ``build_workers`` overlaps per-arrival construction across
    a core.buildsvc worker pool on ``device`` (1 = serial, None = the host's
    CPU count; decisions are bit-identical either way); ``matcher_shards``
    partitions the online matcher's
    machine axis (None = auto by slice count; any value is bit-identical,
    see core/shard.py); ``matcher_mode`` selects the online wave —
    "exact" (default, decision-exact for any shard count) or "routed"
    (fully distributed per-shard matching, an explicitly lossy preset);
    ``profile`` collects per-phase wall-clock timings on the returned
    result.

    Degraded-mode knobs (core/faults.py + docs/architecture.md):
    ``fault_plan`` is a ``FaultPlan`` or its spec string, installed for
    the run; ``heartbeat_period`` (+ ``hb_suspect_after`` /
    ``hb_lost_after``) turns on heartbeat-loss semantics in the
    simulator; ``recovery`` is a shared ``RecoveryPolicy``.

    ``mutations`` scripts mid-run dynamics (SimConfig.mutations): DAG
    edits via the core.dag mutation helpers — repaired incrementally
    through delta rebuilds — and slice speed changes.  The result's
    ``fault_stats`` and ``mutation_stats`` report what fired and how much
    of the previous placements each repair replayed.

    ``serve=True`` routes the same workload through the scheduler
    *service* instead of the simulator: a `svc.SchedulerService` plus one
    agent per slice over inproc comms, driven in virtual time
    (`svc.run_service_workload`).  Healthy runs produce placements and
    JCTs bit-identical to the simulator path with ``speculate=False``
    (the service places by lease, never speculatively); with a
    ``fault_plan`` touching the ``comm_send``/``agent`` seams the run
    exercises the lease-reclaim/exactly-once machinery instead.

    ``device`` is where the kernel ops run, on either path: "cuda" (the
    default; raises without a card) or "cpu".
    """
    rng = np.random.default_rng(seed)
    arrivals = []
    t = 0.0
    for j in jobs:
        arrivals.append((t, j.to_dag(), j.group))
        t += float(rng.exponential(interarrival))
    if serve:
        if mutations:
            raise ValueError("serve=True does not support scripted "
                             "mutations (simulator-only for now)")
        if matcher_mode != "exact":
            raise ValueError("serve=True supports matcher_mode='exact' only")
        from ..svc import ServiceConfig, run_service_workload
        scfg = ServiceConfig(n_machines=n_slices, seed=seed,
                             build_machines=max(n_slices // 8, 2),
                             placement_backend=placement_backend,
                             build_workers=build_workers,
                             matcher_shards=matcher_shards,
                             heartbeat_period=heartbeat_period or 1.0,
                             hb_suspect_after=hb_suspect_after,
                             hb_lost_after=hb_lost_after,
                             recovery=recovery,
                             device=device)
        return run_service_workload(arrivals, scfg, scheme(policy),
                                    fault_plan=fault_plan)
    cfg = SimConfig(n_machines=n_slices, seed=seed,
                    build_machines=max(n_slices // 8, 2),
                    placement_backend=placement_backend,
                    build_workers=build_workers,
                    matcher_shards=matcher_shards,
                    matcher_mode=matcher_mode, profile=profile,
                    fault_plan=fault_plan,
                    heartbeat_period=heartbeat_period,
                    hb_suspect_after=hb_suspect_after,
                    hb_lost_after=hb_lost_after,
                    recovery=recovery,
                    speculate=speculate,
                    mutations=mutations,
                    device=device)
    return ClusterSim(cfg, scheme(policy)).run(arrivals)

"""Cluster-scale scenario on the PyTorch/CUDA port: a day of
training/serving jobs gang-scheduled onto cluster slices with DAGPS vs
Tez-style FIFO, with stage profiles pulled from the dry-run roofline
artifacts when available (``python -m repro_torch.launch.dryrun --all
--out artifacts/dryrun`` writes them).

All engine backends and scheme presets are reachable from the CLI; the
kernel ops run on ``--device`` (cuda by default, cpu for the plain torch
versions):

  PYTHONPATH=src python examples/torch_cluster_sim.py
  PYTHONPATH=src python examples/torch_cluster_sim.py --backend jit --profile
  PYTHONPATH=src python examples/torch_cluster_sim.py --serve --json
  PYTHONPATH=src python examples/torch_cluster_sim.py --device cpu \
      --schemes tez,tez+tetris,dagps --slices 64 --jobs 30
"""

import argparse
import json

import numpy as np

from repro_torch.core import available_backends
from repro_torch.launch.cluster import job_from_roofline, schedule_cluster


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default=None, choices=available_backends(),
                    help="placement engine for offline construction "
                         "(default: batched, or $REPRO_PLACEMENT_BACKEND)")
    ap.add_argument("--schemes", default="tez,dagps",
                    help="comma-separated scheme presets to compare "
                         "(tez, tez+cp, tez+tetris, tez+drf, random, dagps, "
                         "dagps-noob)")
    ap.add_argument("--slices", type=int, default=32, help="pod slices")
    ap.add_argument("--jobs", type=int, default=15, help="jobs to schedule")
    ap.add_argument("--interarrival", type=float, default=30.0,
                    help="mean Poisson interarrival seconds")
    ap.add_argument("--build-workers", type=int, default=1,
                    help="overlap offline constructions across this many "
                         "build-service workers (0 = auto/CPU count; "
                         "decisions are bit-identical to serial)")
    ap.add_argument("--shards", type=int, default=0,
                    help="online-matcher machine shards (0 = auto by "
                         "slice count; decisions are bit-identical for "
                         "any shard count)")
    ap.add_argument("--matcher-mode", choices=["exact", "routed"],
                    default="exact",
                    help="online wave mode: exact (decision-exact global "
                         "wave, default) or routed (distributed per-shard "
                         "matching — lossy preset, see core/shard.py)")
    ap.add_argument("--profile", action="store_true",
                    help="print per-phase wall-clock timings")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="fault-injection plan spec (core/faults.py "
                         "grammar), e.g. "
                         "'seed=7;shard_launch:raise@0.3;"
                         "heartbeat:drop@0.05' — exact-recoverable seams "
                         "reproduce the healthy decisions bit-for-bit")
    ap.add_argument("--heartbeat-period", type=float, default=None,
                    help="simulated machine heartbeat period in seconds "
                         "(enables heartbeat-loss semantics: suspicion, "
                         "declared-lost requeue, rejoin on flap)")
    ap.add_argument("--hb-suspect-after", type=float, default=None,
                    help="silence before a machine stops receiving tasks "
                         "(default 2.5 heartbeat periods)")
    ap.add_argument("--hb-lost-after", type=float, default=None,
                    help="silence before a machine is declared lost and "
                         "its tasks requeue (default 5 periods)")
    ap.add_argument("--dynamic", action="store_true",
                    help="script mid-run dynamics: a deadline pull-in on "
                         "a running job (repaired via delta rebuild) and "
                         "a slice speed change")
    ap.add_argument("--serve", action="store_true",
                    help="run through the scheduler service (svc/) instead "
                         "of the simulator: inproc scheduler + one agent "
                         "per slice, lease-based placements, real "
                         "heartbeats; healthy runs match the simulator "
                         "bit-for-bit")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON document per scheme instead of "
                         "text: JCT stats plus fault_stats, "
                         "mutation_stats and phase timings")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the kernel ops run (cuda raises without a "
                         "card; cpu runs the plain torch versions)")
    args = ap.parse_args()

    archs = ["granite3_8b", "gemma2_2b", "mixtral_8x7b", "rwkv6_7b",
             "phi4_mini_3_8b"]
    jobs = []
    for i in range(args.jobs):
        arch = archs[i % len(archs)]
        jobs.append(job_from_roofline(f"job-{i}-{arch}", arch,
                                      "artifacts/dryrun", steps=50 + 20 * (i % 4),
                                      group=i % 2))
    mutations = None
    if args.dynamic:
        from repro_torch.sim.workload import mut_retarget
        mutations = [(30.0, min(1, args.jobs - 1), mut_retarget(0.8)),
                     (60.0, "speed", 0, 1.5)]
    for policy in args.schemes.split(","):
        res = schedule_cluster(jobs, n_slices=args.slices,
                               interarrival=args.interarrival, policy=policy,
                               placement_backend=args.backend,
                               build_workers=args.build_workers or None,
                               matcher_shards=args.shards or None,
                               matcher_mode=args.matcher_mode,
                               profile=args.profile,
                               fault_plan=args.fault_plan,
                               heartbeat_period=args.heartbeat_period,
                               hb_suspect_after=args.hb_suspect_after,
                               hb_lost_after=args.hb_lost_after,
                               mutations=mutations,
                               serve=args.serve,
                               device=args.device)
        jcts = res.jcts()
        if args.json:
            print(json.dumps({
                "policy": policy,
                "median_jct": float(np.median(jcts)),
                "p75_jct": float(np.percentile(jcts, 75)),
                "makespan": res.makespan,
                "jobs": len(res.jobs),
                "phase_times": res.phase_times,
                "fault_stats": res.fault_stats,
                "mutation_stats": res.mutation_stats,
            }))
            continue
        print(f"{policy:10s}: median JCT {np.median(jcts):8.1f}s  "
              f"p75 {np.percentile(jcts, 75):8.1f}s  makespan {res.makespan:8.1f}s")
        if args.profile and res.phase_times:
            pt = res.phase_times
            print(f"{'':10s}  phases: build {pt['build']:.2f}s  "
                  f"match {pt['match']:.2f}s  recovery {pt['recovery']:.2f}s  "
                  f"event {pt['event']:.2f}s  total {pt['total']:.2f}s")
        if args.fault_plan or args.heartbeat_period:
            fs = res.fault_stats or {}
            hb = fs.get("heartbeat", {})
            print(f"{'':10s}  faults: injected {fs.get('injections', {})}  "
                  f"shard {fs.get('shard', {})}")
            if args.heartbeat_period:
                print(f"{'':10s}  heartbeats: {hb}")
        if args.dynamic and res.mutation_stats:
            print(f"{'':10s}  mutations: {res.mutation_stats}")


if __name__ == "__main__":
    main()

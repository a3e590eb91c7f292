"""Quickstart on the PyTorch/CUDA port: build a DAGPS schedule for one job
DAG and compare it with the baselines the paper evaluates (Fig. 2 +
Fig. 12 in miniature).  The builder's scan runs on ``--device`` (cuda by
default, cpu for its plain torch version).

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import all_bounds, build_schedule
from repro_torch.core.baselines import bfs_order, cp_order, simulate_execution
from repro_torch.sim.workload import production_dag


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the builder's scan runs (cuda raises "
                         "without a card)")
    args = ap.parse_args()
    dag = production_dag(np.random.default_rng(0), share=4, name="demo")
    m = 4
    print(f"DAG '{dag.name}': {dag.n} tasks, {dag.n_stages} stages")
    bounds = all_bounds(dag, m)
    print("lower bounds:", {k: round(v, 1) for k, v in bounds.items()})

    sched = build_schedule(dag, m, device=args.device)
    sched.validate()
    trouble = int(sched.trouble_mask.sum()) if sched.trouble_mask is not None else 0
    print(f"\nDAGPS constructed schedule: makespan={sched.makespan:.1f}s "
          f"({sched.makespan / bounds['newlb']:.2f}x NewLB), "
          f"{trouble} troublesome tasks placed first")

    rows = {
        "bfs (Tez)": simulate_execution(dag, m, order=bfs_order(dag)),
        "critical path": simulate_execution(dag, m, order=cp_order(dag)),
        "tetris (packer)": simulate_execution(dag, m, policy="tetris"),
        "dagps (online)": simulate_execution(dag, m, policy="dagps",
                                             pri_score=sched.pri_score),
    }
    print("\nexecuted makespans on %d machines:" % m)
    for k, v in rows.items():
        print(f"  {k:18s} {v:8.1f}s   ({v / bounds['newlb']:.2f}x NewLB)")


if __name__ == "__main__":
    main()

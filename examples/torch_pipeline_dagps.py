"""The paper's technique inside one training step, on the PyTorch/CUDA
port (the twin of ``examples/pipeline_dagps.py``, plus ``--device``):
DAGPS builds the pipeline-parallel microbatch schedule and rediscovers
1F1B-quality interleaving; on heterogeneous stage times it beats the
uniform baselines.

  PYTHONPATH=src python examples/torch_pipeline_dagps.py
  PYTHONPATH=src python examples/torch_pipeline_dagps.py --device cpu
"""

import argparse

from repro_torch.train import (gpipe_makespan, ideal_makespan,
                               one_f_one_b_makespan, schedule_pipeline)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the builder's feasibility scan runs: cuda "
                         "(the kernel; the default) or cpu")
    args = ap.parse_args()
    for P, M in ((4, 8), (4, 16), (8, 16)):
        plan = schedule_pipeline(P, M, t_fwd=1.0, device=args.device)
        print(f"{P} stages x {M} microbatches: "
              f"dagps={plan.makespan:6.1f}  gpipe={gpipe_makespan(P, M, 1.0):6.1f}  "
              f"1f1b={one_f_one_b_makespan(P, M, 1.0):6.1f}  "
              f"ideal={ideal_makespan(P, M, 1.0):6.1f}  "
              f"bubble={plan.bubble_fraction:.2f}")
        first = ["FB"[k == "B"] + f"{s}{m}" for (k, s, m) in plan.order[:12]]
        print("   first events:", " ".join(first))


if __name__ == "__main__":
    main()

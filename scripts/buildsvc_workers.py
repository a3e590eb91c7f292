"""Build-service workers on the card: each worker's CUDA context (start-up
time and device memory) and the staged scan call's time inside W workers
scanning at once, beside one worker alone.

Run from the repository root on a machine with a CUDA device:

    python3 scripts/buildsvc_workers.py [--workers W] [--calls N]
                                        [--sweep 1,2,4]

W defaults to min(8, the CPU count), as in ``chip_smoke.py``'s phase 3;
``--sweep`` adds rounds at other worker counts.
Workers start by the build service's own start method
(``core/buildsvc.py`` ``_default_mp_context``: forkserver with its
preload, else spawn).  Each worker initializes CUDA and the placement-scan
library (``ready_s``: from entering the worker to a context that has run a
scan; ``start_s``: from the parent's ``Process.start`` to that point), then
all workers make N staged scan calls (``kernel.scan_call``, the cuda scan
impl's C call) at once at the exact path's modal shape (m=4, W=192, L=255,
g=1), timed on each worker's host clock; then one worker alone does the
same.  Context memory, three ways: the card's free memory
(``torch.cuda.mem_get_info``) from the parent before the workers start
and while all of them hold their contexts, over W; ``nvidia-smi``'s used
memory the same way; and the used memory each worker's own
``mem_get_info`` reports.  Results print as JSON and go to
``chiprun_out/buildsvc_workers.json``.  ``chip_smoke.py`` imports `probe`
for its phase-3 line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the exact path's modal scan (m, W, L, g)
SHAPE = (4, 192, 255, 1)


def _worker(idx: int, calls: int, q, go, stop, t_started: float) -> None:
    """One worker: make a CUDA context, report, scan when told to."""
    t0 = time.perf_counter()
    import numpy as np
    import torch

    from repro_torch.core.engine.base import ceil32
    from repro_torch.kernels.placement_scan import kernel

    m, W, L, g = SHAPE
    rng = np.random.default_rng(idx)
    grid = rng.uniform(0.3, 1.0, (m, L, 4)).astype(np.float32)
    Vs = ceil32(rng.uniform(0.01, 0.3, (g, 4))).astype(np.float32)
    ks = np.full(g, 64, dtype=np.int64)
    torch.cuda.init()
    kernel.scan_call(grid, 0, L, Vs, ks, W)
    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info()
    q.put(("ready", idx, time.perf_counter() - t0, time.time() - t_started,
           (total - free) / 2**20))
    go.wait(600)
    t1 = time.perf_counter()
    for _ in range(calls):
        kernel.scan_call(grid, 0, L, Vs, ks, W)
    q.put(("scan", idx, (time.perf_counter() - t1) * 1e3 / calls))
    stop.wait(600)


def _smi_used_mb() -> float | None:
    """The card's used memory as ``nvidia-smi`` reads it (MiB)."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _round(ctx, n: int, calls: int) -> dict:
    """n workers at once: their start-up, context memory and scan ms."""
    import torch

    free0 = torch.cuda.mem_get_info()[0]
    smi0 = _smi_used_mb()
    q, go, stop = ctx.Queue(), ctx.Event(), ctx.Event()
    procs = [ctx.Process(target=_worker,
                         args=(i, calls, q, go, stop, time.time()))
             for i in range(n)]
    try:
        for p in procs:
            p.start()
        ready = [q.get(timeout=600) for _ in range(n)]
        free1 = torch.cuda.mem_get_info()[0]
        smi1 = _smi_used_mb()
        go.set()
        scans = [q.get(timeout=600) for _ in range(n)]
        stop.set()
        for p in procs:
            p.join(60)
    finally:
        stop.set()
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return dict(
        workers=n,
        ready_s=sorted(r[2] for r in ready),
        start_s=sorted(r[3] for r in ready),
        # three readings of a worker context's memory: the card's free
        # memory seen from the parent, nvidia-smi's used memory, and the
        # used memory each worker sees from inside its own context
        context_mb_per_worker=(free0 - free1) / n / 2**20,
        smi_mb_per_worker=(None if smi0 is None or smi1 is None
                           else (smi1 - smi0) / n),
        used_mb_seen_in_worker=sorted(r[4] for r in ready),
        scan_call_ms=sorted(s[2] for s in scans))


def probe(workers: int, calls: int = 500) -> dict:
    """``workers`` workers at once, then one alone (see the module
    docstring)."""
    import torch

    from repro_torch.core import buildsvc

    torch.cuda.init()
    torch.zeros(1, device="cuda")
    ctx = buildsvc._default_mp_context()
    together = _round(ctx, workers, calls)
    alone = _round(ctx, 1, calls)
    return dict(start_method=ctx.get_start_method(), shape=SHAPE,
                calls=calls, together=together, alone=alone)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workers", type=int,
                    default=min(8, os.cpu_count() or 1))
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--sweep", default="2,4",
                    help="comma-separated worker counts of extra rounds")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("buildsvc_workers: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    from repro_torch.core import buildsvc

    try:
        out = dict(probe(args.workers, args.calls), device=smi)
        ctx = buildsvc._default_mp_context()
        out["sweep"] = [_round(ctx, int(n), args.calls)
                        for n in args.sweep.split(",") if n.strip()]
    finally:
        buildsvc.stop_forkserver()
    print(json.dumps(out), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "buildsvc_workers.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

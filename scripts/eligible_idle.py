"""What the staged eligibility call costs when the card has idled, in one run.

Run from the repository root on one CUDA device:

    python3 scripts/eligible_idle.py

On the main path the matcher calls the eligibility op once a wave, and the
card idles between waves while the host picks.  This times the staged call
(`kernels._machines_with_candidates_on` on the card) at a main-path wave
(32 candidates; 2048 machines, and one 512-machine shard) back to back and
after gaps of 0.2, 1 and 5 ms (not counted) in which the host either spins
(the card alone idles, as between the path's waves) or sleeps (both idle).
Beside it, the same gaps before the smallest round trip the card offers
(one launch of a one-element add and a synchronize) and before the numpy
op, so that the cost of waking the card shows apart from the call's own.
The call's result is held bitwise against the host-rounded plain
version.  It prints one line
per reading and the card's name and power limit, and writes every reading
to ``chiprun_out/eligible_idle.json``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GAPS_S = (0.0, 2e-4, 1e-3, 5e-3)
REPS = 200


def spaced_ms(fn, gap_s: float, spin: bool, reps: int = REPS) -> float:
    """Mean ms a call, each call after a gap of ``gap_s``: the host sleeps
    through it, or with ``spin`` keeps its core busy (as the path's Python
    does between waves), so that only the card idles."""
    for _ in range(10):
        fn()
    total = 0.0
    for _ in range(reps):
        if gap_s and spin:
            end = time.perf_counter() + gap_s
            while time.perf_counter() < end:
                pass
        elif gap_s:
            time.sleep(gap_s)
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    return total * 1e3 / reps


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("eligible_idle: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.core.engine import kernels as K
    from repro_torch.core.engine import packing
    from repro_torch.core.online import FUNGIBLE, RIGID
    from repro_torch.kernels.placement_scan import kernel as pk

    fd, rd, gd = np.arange(4), np.asarray(RIGID), np.asarray(FUNGIBLE)
    batch, avail0, _ = smoke.busy_corpus()
    dem = batch.dem
    shapes = {"m2048": avail0, "m512": np.ascontiguousarray(avail0[:512])}
    f2, r2, g2, sl = K._eligibility_dims(fd, rd, gd, 0.25, True)
    bits = K._dim_bits(4, f2, r2, g2)
    one = torch.zeros(1, device="cuda")

    def round_trip():
        one.add_(1.0)
        torch.cuda.synchronize()

    readings: dict = {}
    bad = []
    for label, avail in shapes.items():
        want = K._machines_with_candidates_on(avail, dem, fd, rd, gd, 0.25,
                                              True, device="cpu")
        def call(avail=avail):
            return pk.eligible_call(avail, dem, max(sl, 0.0), packing.EPS,
                                    *bits)

        got = call()
        if (got[0].tobytes() != want[0].tobytes()
                or got[1].tobytes() != want[1].tobytes()):
            bad.append(label)
        forms = {"call": call, "round_trip": round_trip,
                 "numpy": lambda avail=avail: packing.machines_with_candidates(
                     avail, dem, fd, rd, gd, 0.25, True)}
        for spin in (True, False):
            wait = "spin" if spin else "sleep"
            for name, fn in forms.items():
                for gap in GAPS_S:
                    ms = spaced_ms(fn, gap, spin)
                    readings.setdefault(label, {}).setdefault(
                        f"{name}/{wait}", {})[str(gap)] = ms
                    print(f"[eligible_idle] shape={label} form={name} "
                          f"wait={wait} gap_ms={gap * 1e3:g} "
                          f"call_ms={ms:.6f}", flush=True)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "eligible_idle.json").write_text(json.dumps(dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=smi,
        readings=readings), indent=1))
    if bad:
        print(f"eligible_idle: call != plain version for {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

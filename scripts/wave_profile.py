"""Where one heartbeat wave's time goes inside the wave kernel.

Run from the repository root on one CUDA device:

    python3 scripts/wave_profile.py

A copy of ``src/repro_torch/kernels/placement_scan/csrc/placement_scan.cu``
with ``clock64()`` stamps around the phases of the walk is written to a
temporary directory (never the checkout), built there and swapped in as the
library the wave wrapper launches.  Thread 0 sums the SM cycles of each
phase; the copy is otherwise the kernel itself (its outputs are held
bitwise against the plain version).  For ``chip_smoke.py``'s two wave
corpora (s13 and the busy cluster) it prints the pick iterations and each
phase's cycles per iteration:

  pass    the fused pass over this thread's candidates
  reduce  the warp argmax, and the warps' exchange behind its barrier
  pick    the pick's state update up to the ledger
  ledger  the deficit ledger's argmax after the pick
  start   an iteration's thresholds
  chunk   loading and testing 32 upcoming visits
  min     the demand minimum after a visit that picked

and writes them with the card's name and power limit to
``chiprun_out/wave_profile.json``.  The stamps cost cycles of their own:
compare phases with each other, not the sum with ``chip_smoke.py``'s time.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("pass", "reduce", "pick", "ledger", "start", "chunk", "min")
# (anchor in the kernel source, the text that replaces it)
STAMPS = (
    ("#define WAVE_MAXD 8\n",
     "#define WAVE_MAXD 8\n__device__ unsigned long long g_prof[16];\n"
     "#define TIC(v) long long v = clock64();\n"
     "#define TOC(slot, v) if (threadIdx.x == 0) prof[slot] += clock64() - v;"
     "\n"),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  unsigned long long prof[16] = {0};\n"),
    ("    const int v = v0 + lane;\n", "    TIC(tc)\n    const int v = v0 + lane;\n"),
    ("    unsigned todo = __ballot_sync(FULL_MASK, lane < nvalid && "
     "may_pick(vrow));\n",
     "    unsigned todo = __ballot_sync(FULL_MASK, lane < nvalid && "
     "may_pick(vrow));\n    TOC(5, tc)\n"),
    ("        double thr[DM], thr_g[DM];\n",
     "        TIC(t0)\n        if (threadIdx.x == 0) prof[8] += 1;\n"
     "        double thr[DM], thr_g[DM];\n"),
    ("        const bool gate = gbest >= p.thresh;\n",
     "        TOC(4, t0)\n        TIC(t1)\n"
     "        const bool gate = gbest >= p.thresh;\n"),
    ("        warp_tkmax(bt, bk, bi);\n",
     "        TOC(0, t1)\n        TIC(t2)\n        warp_tkmax(bt, bk, bi);\n"),
    ("        if (!isfinite(okey_value(bk))) break;\n",
     "        if (!isfinite(okey_value(bk))) break;\n        TOC(1, t2)\n"
     "        TIC(t3)\n"),
    ("        ledger_argmax(my_def, G, lane, gstar, gbest);\n"
     "        if (live == 0) break;",
     "        TOC(2, t3)\n        TIC(t4)\n"
     "        ledger_argmax(my_def, G, lane, gstar, gbest);\n"
     "        TOC(3, t4)\n        if (live == 0) break;"),
    ("        recompute_min();\n        todo &=",
     "        TIC(t6)\n        recompute_min();\n        TOC(6, t6)\n"
     "        todo &="),
    ("  if (tid == 0) {\n    ema[0] = ema0;",
     "  if (tid == 0) for (int k = 0; k < 16; ++k) g_prof[k] = prof[k];\n"
     "  if (tid == 0) {\n    ema[0] = ema0;"),
)
READER = '''
extern "C" int ps_wave_profile(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
'''


def stamped(src: str) -> str:
    for anchor, text in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, text)
    return src + READER


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("wave_profile: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.core.engine import wave as W
    from repro_torch.core.online import MatcherConfig
    from repro_torch.core.shard import ShardedMatcher
    from repro_torch.kernels import build as B
    from repro_torch.kernels.placement_scan import kernel as pk
    from repro_torch.kernels.placement_scan import ref

    readings, bad = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[B.BUILD_DIR_ENV] = tmp
        path = Path(tmp) / "placement_scan_profile.cu"
        path.write_text(stamped(pk._SRC.read_text()))
        lib = B.NvccLibrary("placement_scan_profile", path, pk.NVCC_FLAGS,
                            pk._bind)
        pk.lib = lib.lib
        reader = lib.lib().ps_wave_profile
        reader.argtypes = [ctypes.c_void_p]
        for label, (batch, avail0, alive) in (("s13", smoke.s13_corpus()),
                                              ("busy", smoke.busy_corpus())):
            m = avail0.shape[0]
            sm = ShardedMatcher(MatcherConfig(), m, {0: 1.0, 1: 1.0},
                                n_shards=1, capacity=float(m))
            args, kw, _ = W.wave_launch_args(W.DeviceWaveState("cuda"), sm,
                                             batch, avail0, alive, "profile")
            got = pk.match_wave_walk(*args, **kw)
            want = ref.match_wave_walk(*args, **kw)
            if [g.cpu().numpy().tobytes() for g in got] != \
                    [w.cpu().numpy().tobytes() for w in want]:
                bad.append(label)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 16)()
            if reader(ctypes.addressof(buf)) != 0:
                raise RuntimeError("reading the phase counters failed")
            its = max(int(buf[8]), 1)
            row = {"iterations": int(buf[8])}
            row.update({ph: int(buf[i]) / its for i, ph in enumerate(PHASES)})
            readings[label] = row
            print(f"[wave_profile] case={label} iterations={buf[8]} "
                  + " ".join(f"{ph}={row[ph]:.0f}" for ph in PHASES)
                  + " (SM cycles per iteration)", flush=True)
        os.environ.pop(B.BUILD_DIR_ENV, None)
        pk.lib = pk.LIBRARY.lib
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "wave_profile.json").write_text(json.dumps(dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=smi,
        unit="SM cycles per pick iteration", readings=readings), indent=1))
    if bad:
        print(f"wave_profile: the stamped kernel != plain version for {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""How many warps the wave kernel runs best with: 1, 2 and 4, measured.

Run from the repository root on one CUDA device:

    python3 scripts/wave_warps.py

``src/repro_torch/kernels/placement_scan/csrc/placement_scan.cu`` is copied
once per warp count, with its ``#define WAVE_WARPS`` line set to that count,
into a temporary directory (never the checkout) and built there, and each
build is swapped in as the library the wave wrapper launches.  Each is held bitwise against the plain version and timed with
CUDA events on ``chip_smoke.py``'s two wave corpora: s13 (m=2048, n=512,
d=4, every pick iteration walked) and a busy cluster (m=2048, n=32, most
visits skipped).  It prints one line per warp count, the card's name and
power limit, and writes every reading to ``chiprun_out/wave_warps.json``.
It exits non-zero if a build disagrees with the plain version.
"""

from __future__ import annotations

import json
import os
import re
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WARPS = (1, 2, 4)
REPS = 50


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("wave_warps: needs a CUDA device", file=sys.stderr)
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

    corpora = {}
    for label, (batch, avail0, alive) in (("s13", smoke.s13_corpus()),
                                          ("busy", smoke.busy_corpus())):
        m = avail0.shape[0]
        sm = ShardedMatcher(MatcherConfig(), m, {0: 1.0, 1: 1.0},
                            n_shards=1, capacity=float(m))
        args, kw, _ = W.wave_launch_args(W.DeviceWaveState("cuda"), sm,
                                         batch, avail0, alive, "warps")
        want = ref.match_wave_walk(*args, **kw)
        corpora[label] = (args, kw, [w.cpu().numpy().tobytes() for w in want],
                          smoke.wave_work(args, kw, want)[1])
    readings, bad = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[B.BUILD_DIR_ENV] = tmp
        src = pk._SRC.read_text()
        libs = {}
        for k in WARPS:
            text, hits = re.subn(r"^#define WAVE_WARPS \d+$",
                                 f"#define WAVE_WARPS {k}", src, flags=re.M)
            if hits != 1:
                raise RuntimeError("no '#define WAVE_WARPS' line to set")
            path = Path(tmp) / f"placement_scan_w{k}.cu"
            path.write_text(text)
            libs[k] = B.NvccLibrary(f"placement_scan_w{k}", path,
                                    pk.NVCC_FLAGS, pk._bind)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(libs)) as pool:
            list(pool.map(lambda lib: lib.build(verbose=True), libs.values()))
        print(f"[warps] built {len(libs)} variants in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        for k, lib in libs.items():
            pk.lib = lib.lib
            row = {}
            for label, (args, kw, want, chain) in corpora.items():
                got = pk.match_wave_walk(*args, **kw)
                same = [g.cpu().numpy().tobytes() for g in got] == want
                if not same:
                    bad.append((k, label))
                ms = smoke.cuda_time_ms(
                    lambda: pk.match_wave_walk(*args, **kw), REPS, 2)
                row[label] = dict(bitwise=same, ms=ms, **chain,
                                  ns_per_iteration=ms * 1e6
                                  / max(chain["iterations"], 1))
            readings[k] = row
            print(f"[warps] warps={k} " + " ".join(
                f"{lab}_ms={r['ms']:.6f} {lab}_bitwise={r['bitwise']} "
                f"{lab}_ns_per_iteration={r['ns_per_iteration']:.1f}"
                for lab, r in row.items()), flush=True)
        os.environ.pop(B.BUILD_DIR_ENV, None)
        pk.lib = pk.LIBRARY.lib
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "wave_warps.json").write_text(json.dumps(dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=smi, reps=REPS,
        readings=readings), indent=1))
    if bad:
        print(f"wave_warps: kernel != plain version for {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

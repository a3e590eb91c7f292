"""The scan kernel against other versions of it, in one run on one card.

Run from the repository root on one CUDA device:

    python3 scripts/scan_versions.py [--source NAME=PATH ...]

``src/repro_torch/kernels/placement_scan/csrc/placement_scan.cu`` and each
``--source`` given (another version of the file with the same
``ps_scan_bitmaps`` entry point, e.g. an earlier one) are built in a
temporary directory, never the checkout, and each is swapped in as the
library the scan wrapper launches.  On ``chip_smoke.py``'s scan cases each
is held bitwise against the plain version and timed two ways: 200 wrapper
calls back to back (CUDA events: ``ms``, which the host's rate of issuing
calls may bound) and 200 launches captured in one CUDA graph (``device_ms``,
the kernel alone).  Builds are timed in turns (in order, then in reverse).
It prints one line per build, case and turn, the card's name and power
limit, and writes every reading to ``chiprun_out/scan_versions.json``.  It
exits non-zero if a build disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def bind_scan(handle: ctypes.CDLL) -> None:
    """Bind ``ps_scan_bitmaps`` alone (an older file may lack the rest)."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    handle.ps_scan_bitmaps.argtypes = [vp, vp, vp, i, i, i, i, i, i, vp, vp]
    handle.ps_scan_bitmaps.restype = ctypes.c_int


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH")
    opts = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("scan_versions: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.core.engine.base import ceil32
    from repro_torch.kernels import build as B
    from repro_torch.kernels.placement_scan import kernel as pk
    from repro_torch.kernels.placement_scan import ref

    cases = {}
    for i, (label, m, W, L, g, kmax) in enumerate(smoke.SCAN_CASES):
        rng = np.random.default_rng(7 + i)
        win = rng.uniform(0.3, 1.0, (m, L, 4)).astype(np.float32)
        dips = rng.random(win.shape) < 0.005
        win[dips] = rng.uniform(0.0, 0.3, int(dips.sum()))
        Vs = ceil32(rng.uniform(0.01, 0.3, (g, 4))).astype(np.float32)
        ks = rng.integers(1, kmax + 1, g).astype(np.int32)
        ks[0] = kmax
        args = tuple(torch.from_numpy(a).cuda() for a in (win, Vs, ks))
        cases[label] = (args, L, W, ref.scan_bitmaps(*args, L, W))
    readings, bad = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[B.BUILD_DIR_ENV] = tmp
        libs = {"current": B.NvccLibrary("ps_current", pk._SRC,
                                         pk.NVCC_FLAGS, bind_scan)}
        for spec in opts.source:
            name, path = spec.split("=", 1)
            libs[name] = B.NvccLibrary(f"ps_{name}", Path(path),
                                       pk.NVCC_FLAGS, bind_scan)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(libs)) as pool:
            list(pool.map(lambda lib: lib.build(), libs.values()))
        print(f"[scan_versions] built {len(libs)} versions in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        order = list(libs)
        for turn, names in enumerate((order, order[::-1])):
            for name in names:
                pk.lib = libs[name].lib
                for label, (args, L, W, want) in cases.items():
                    got = pk.scan_bitmaps(*args, L, W)
                    same = bool(torch.equal(got, want))
                    if not same:
                        bad.append((name, label))
                    row = dict(
                        turn=turn, bitwise=same,
                        ms=smoke.cuda_time_ms(
                            lambda: pk.scan_bitmaps(*args, L, W), 200),
                        device_ms=smoke.graph_time_ms(
                            lambda: pk.scan_bitmaps(*args, L, W), 200))
                    readings.setdefault(name, {}).setdefault(
                        label, []).append(row)
                    print(f"[scan_versions] build={name} case={label} "
                          f"turn={turn} bitwise={same} ms={row['ms']:.6f} "
                          f"device_ms={row['device_ms']:.6f}", flush=True)
        os.environ.pop(B.BUILD_DIR_ENV, None)
        pk.lib = pk.LIBRARY.lib
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "scan_versions.json").write_text(json.dumps(dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=smi,
        readings=readings), indent=1))
    if bad:
        print(f"scan_versions: kernel != plain version for {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

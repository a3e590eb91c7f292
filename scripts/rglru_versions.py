"""The RG-LRU scan kernel against other versions of it, in one run on one card.

Run from the repository root on one CUDA device:

    python3 scripts/rglru_versions.py [--backward] [--source NAME=PATH ...]

``src/repro_torch/kernels/rg_lru/csrc/rg_lru.cu`` is built at its default
ring (``RGLRU_T`` steps a stage, ``RGLRU_STAGES`` stages) and at the
``RINGS`` below, and each ``--source`` given (another version of the file
with the same ``rglru_scan`` entry point, e.g. an earlier one) as it is;
every build goes to a temporary directory, never the checkout, and each is
swapped in as the library the wrapper launches.  At the serving path's
shapes (the recurrentgemma-2b prefill, B=4, S=4096, D=2560, and its decode
steps at B=4 and B=8, S=1) each is held bitwise against the plain loop and
timed two ways: calls back to back (CUDA events: ``ms``) and the same calls
captured in one CUDA graph (``device_ms``, the kernel without the host's
rate of issuing it).  Builds are timed in turns (in order, then in
reverse).  It prints one line per build, case and turn, the card's name and
power limit, and writes every reading to ``chiprun_out/rglru_versions.json``.
It exits non-zero if a build disagrees with the plain version.

``--backward`` does the same for the backward, ``rglru_scan_bwd``: the
default build (a ring of ``RGLRU_BWD_STAGES`` stages of ``RGLRU_BWD_T``
steps) against the ``BWD_RINGS`` below and each ``--source``, at the
training path's shapes (B=1 and B=4, S=4096, D=2560), bitwise against
``ref.rglru_scan_bwd``; readings go to
``chiprun_out/rglru_bwd_versions.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (steps a stage, stages) rebuilt beside the default
RINGS = ((16, 6), (8, 12), (4, 16))
#: (label, B, S, D, calls timed)
CASES = (("prefill", 4, 4096, 2560, 20), ("decode_b4", 4, 1, 2560, 200),
         ("decode_b8", 8, 1, 2560, 200))
#: the backward's (stages, steps a stage) rebuilt beside the default
BWD_RINGS = ((4, 32), (8, 8), (8, 16), (16, 16), (4, 64))
#: (label, B, S, D, calls timed) of the backward
BWD_CASES = (("train", 1, 4096, 2560, 20), ("b4", 4, 4096, 2560, 20))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--backward", action="store_true")
    opts = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("rglru_versions: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.kernels import build as B
    from repro_torch.kernels.rg_lru import kernel as rk
    from repro_torch.kernels.rg_lru import ref

    back = opts.backward
    op, plain = ((rk.rglru_scan_bwd, ref.rglru_scan_bwd) if back else
                 (rk.rglru_scan, ref.rglru_scan))
    cases = {}
    for i, (label, b, s, d, reps) in enumerate(BWD_CASES if back else CASES):
        rng = np.random.default_rng(31 + i)
        x = torch.from_numpy(rng.standard_normal((b, s, d), np.float32))
        a = torch.from_numpy(rng.uniform(0.499, 0.999, (b, s, d)).astype(
            np.float32))
        h0 = torch.from_numpy(rng.standard_normal((b, d), np.float32))
        args = tuple(t.cuda() for t in (x, a, h0))
        if back:   # a, h, h0, dh, dhT
            h, _ = ref.rglru_scan(*args)
            args = (args[1], h, args[2], *(torch.from_numpy(
                rng.standard_normal(sz, np.float32)).cuda()
                for sz in ((b, s, d), (b, d))))
        cases[label] = (args, reps, plain(*args))
    readings, bad = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[B.BUILD_DIR_ENV] = tmp
        libs = {"current": B.NvccLibrary("rglru_current", rk._SRC, (),
                                         rk._bind)}
        if back:
            for st, t in BWD_RINGS:
                libs[f"current_S{st}_T{t}"] = B.NvccLibrary(
                    f"rglru_S{st}_T{t}", rk._SRC,
                    (f"-DRGLRU_BWD_STAGES={st}", f"-DRGLRU_BWD_T={t}"),
                    rk._bind)
        else:
            for t, st in RINGS:
                libs[f"current_T{t}_S{st}"] = B.NvccLibrary(
                    f"rglru_T{t}_S{st}", rk._SRC,
                    (f"-DRGLRU_T={t}", f"-DRGLRU_STAGES={st}"), rk._bind)
        for spec in opts.source:
            name, path = spec.split("=", 1)
            libs[name] = B.NvccLibrary(f"rglru_{name}", Path(path), (),
                                       rk._bind)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(libs)) as pool:
            list(pool.map(lambda lib: lib.build(), libs.values()))
        print(f"[rglru_versions] built {len(libs)} versions in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        order = list(libs)
        for turn, names in enumerate((order, order[::-1])):
            for name in names:
                rk.lib = libs[name].lib
                for label, (args, reps, want) in cases.items():
                    got = op(*args)
                    same = all(bool(torch.equal(g, w))
                               for g, w in zip(got, want))
                    if not same:
                        bad.append((name, label))
                    row = dict(
                        turn=turn, bitwise=same,
                        ms=smoke.cuda_time_ms(lambda: op(*args), reps),
                        device_ms=smoke.graph_time_ms(lambda: op(*args),
                                                      reps))
                    readings.setdefault(name, {}).setdefault(
                        label, []).append(row)
                    print(f"[rglru_versions] build={name} case={label} "
                          f"turn={turn} bitwise={same} ms={row['ms']:.6f} "
                          f"device_ms={row['device_ms']:.6f}", flush=True)
        os.environ.pop(B.BUILD_DIR_ENV, None)
        rk.lib = rk.LIBRARY.lib
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    out_name = "rglru_bwd_versions.json" if back else "rglru_versions.json"
    (out_dir / out_name).write_text(json.dumps(dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=smi,
        readings=readings), indent=1))
    if bad:
        print(f"rglru_versions: kernel != plain version for {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

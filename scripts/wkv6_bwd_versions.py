"""The WKV6 backward kernel against other versions of it, in one run on one card.

Run from the repository root on one CUDA device:

    python3 scripts/wkv6_bwd_versions.py [--source NAME=PATH ...]

``src/repro_torch/kernels/rwkv6/csrc/wkv6.cu`` is built as it is and at the
``VARIANTS`` below (another number of state columns a CTA, another depth
of the TMA ring), and each ``--source`` given (another version of the file
with the same ``wkv6_bwd`` and ``wkv6_bwd_ckpt_floats`` entry points, e.g.
an earlier one: ``git show REV:src/repro_torch/kernels/rwkv6/csrc/wkv6.cu
> build/wkv6_old.cu``, then ``--source old=build/wkv6_old.cu``); every
build goes to a temporary directory, never the checkout, and each is
swapped in as the library the wrapper launches.  At rwkv6-7b's training
shapes (B=1 and B=4, S=4,096, 64 heads of 64, bf16 r, k, v and dy, the
model's decays, `chip_smoke.wkv_draw`) each build's six gradients are held
within twice ``ref.f32_bwd_error_bound`` of ``ref.wkv6_bwd`` and a second
call must give the same bits; then each is timed two ways: calls back to
back (CUDA events: ``ms``) and the same calls captured in one CUDA graph
(``device_ms``, the kernel without the host's rate of issuing it).  Builds
are timed in turns (in order, then in reverse).  It prints one line per
build, case and turn, the card's name and power limit, and writes every
reading to ``chiprun_out/wkv6_bwd_versions.json``.  It exits non-zero if a
build leaves the bound or does not repeat.
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

#: (name, nvcc flags) rebuilt beside the default
VARIANTS = (("cols16", ("-DWKV_BWD_COLS=16", "-DWKV_BWD_RING=2")),
            ("ring2", ("-DWKV_BWD_RING=2",)))
#: (label, (B, S, H, N), calls timed)
CASES = (("train", (1, 4096, 64, 64), 10), ("b4", (4, 4096, 64, 64), 5))
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("wkv6_bwd_versions: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.kernels import build as B
    from repro_torch.kernels.rwkv6 import kernel as wk
    from repro_torch.kernels.rwkv6 import ref

    cases = {}
    for i, (label, shape, reps) in enumerate(CASES):
        r, k, v, w, u, s0 = smoke.wkv_draw(shape, "bfloat16", 61 + i, True)
        gen = torch.Generator(device="cuda").manual_seed(1061 + i)
        dy = torch.randn(shape, generator=gen, device="cuda").to(r.dtype)
        args = (r, k, v, w, u, s0, dy, None)
        cases[label] = (args, reps, ref.wkv6_bwd(*args),
                        ref.f32_bwd_error_bound(*args))
    readings, bad = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[B.BUILD_DIR_ENV] = tmp
        libs = {"current": B.NvccLibrary("wkv6_current", wk._SRC, (),
                                         wk._bind)}
        for name, flags in VARIANTS:
            libs[f"current_{name}"] = B.NvccLibrary(f"wkv6_{name}", wk._SRC,
                                                    flags, wk._bind)
        for spec in opts.source:
            name, path = spec.split("=", 1)
            libs[name] = B.NvccLibrary(f"wkv6_{name}", Path(path), (),
                                       wk._bind)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(libs)) as pool:
            list(pool.map(lambda lib: lib.build(), libs.values()))
        print(f"[wkv6_bwd_versions] built {len(libs)} versions in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        order = list(libs)
        for turn, names in enumerate((order, order[::-1])):
            for name in names:
                wk.lib = libs[name].lib
                for label, (args, reps, want, bound) in cases.items():
                    got = wk.wkv6_bwd(*args)
                    fracs = {}
                    for gname, g, w_, b in zip(NAMES, got, want, bound):
                        d = (g.double() - w_.double()).abs()
                        fracs[gname] = float(torch.where(
                            d == 0, torch.zeros_like(d), d / (2 * b)).max())
                    frac = max(fracs.values())
                    again = wk.wkv6_bwd(*args)
                    repeat = all(bool(torch.equal(a, b))
                                 for a, b in zip(got, again))
                    del got, again
                    if not (frac <= 1.0 and repeat):
                        bad.append((name, label))
                    row = dict(
                        turn=turn, bound_frac=frac, bound_fracs=fracs,
                        repeat_bitwise=repeat,
                        ms=smoke.cuda_time_ms(lambda: wk.wkv6_bwd(*args),
                                              reps, 1),
                        device_ms=smoke.graph_time_ms(
                            lambda: wk.wkv6_bwd(*args), reps))
                    readings.setdefault(name, {}).setdefault(
                        label, []).append(row)
                    print(f"[wkv6_bwd_versions] build={name} case={label} "
                          f"turn={turn} bound_frac={frac:.3e} "
                          f"repeat={repeat} ms={row['ms']:.6f} "
                          f"device_ms={row['device_ms']:.6f}", flush=True)
                    torch.cuda.empty_cache()
        os.environ.pop(B.BUILD_DIR_ENV, None)
        wk.lib = wk.LIBRARY.lib
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "wkv6_bwd_versions.json").write_text(json.dumps(dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=smi,
        cases={label: dict(shape=shape, reps=reps)
               for label, shape, reps in CASES},
        variants={name: list(flags) for name, flags in VARIANTS},
        readings=readings), indent=1))
    if bad:
        print(f"wkv6_bwd_versions: out of bound or not repeating: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

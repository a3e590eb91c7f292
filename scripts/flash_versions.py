"""The flash-attention forward against other versions of its source, in one
run on one card: the serving launches' times, in turns.

Run from the repository root on one CUDA device:

    python3 scripts/flash_versions.py [--source NAME=PATH ...]

``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu`` and each
``--source`` given (another version of the file, e.g. an earlier commit's;
one whose ``flash_attention_fwd`` takes no ``lse`` argument is called
without it) are built in a temporary directory, never the checkout, and
called as the serving path calls the forward: no log-sum-exp (a null
``lse``).  At phase 5's serving shapes of ``chip_smoke.py`` (the
recurrentgemma-2b prefill, gemma2-2b's global layer, deepseek-moe-16b's)
each build's output is compared bitwise with the first build's, and its
calls back to back are timed with CUDA events, the builds in turns (in
order, reversed, in order, reversed).  It prints one line per build, case
and turn, the card's name and power limit, and writes every reading to
``chiprun_out/flash_versions.json``.  It exits non-zero if two builds'
outputs differ.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (label, (B, S, H, KV, hd), opts, calls timed): phase 5's shapes
CASES = (("path", (4, 4096, 10, 1, 256), dict(causal=True, window=2048), 20),
         ("gemma2_global", (4, 4096, 8, 4, 256), dict(causal=True, cap=50.0),
          20),
         ("deepseek", (4, 4096, 16, 16, 128), dict(causal=True), 20))


def bind(handle, with_lse: bool):
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = handle.flash_attention_fwd
    fn.argtypes = [vp] * 4 + [i] * 9 + [f, f] + ([vp] if with_lse else []) \
        + [vp]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_versions: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.kernels import build as B
    from repro_torch.kernels.build import check_launch, ptr, stream
    from repro_torch.kernels.flash_attention import kernel as fk

    srcs = {"current": fk._SRC}
    for spec in opts.source:
        name, path = spec.split("=", 1)
        srcs[name] = Path(path)
    cases = {}
    for i, (label, (b, s, h, kv, hd), o, reps) in enumerate(CASES):
        gen = torch.Generator(device="cuda").manual_seed(61 + i)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for shape in ((b, s, h, hd), (b, s, kv, hd),
                                          (b, s, kv, hd)))
        cases[label] = (q, k, v, o, reps)
    readings, first, bad = {}, {}, []
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[B.BUILD_DIR_ENV] = tmp
        libs = {n: B.NvccLibrary(f"flash_{n}", p, (), lambda h: None)
                for n, p in srcs.items()}
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(libs)) as pool:
            list(pool.map(lambda lib: lib.build(), libs.values()))
        print(f"[flash_versions] built {len(libs)} versions in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        fns = {n: bind(lib.lib(), "float* lse" in srcs[n].read_text())
               for n, lib in libs.items()}

        def call(fn, q, k, v, o, out):
            b, s, h, hd = q.shape
            args = [ptr(q), ptr(k), ptr(v), ptr(out), b, s, s, h,
                    k.shape[2], hd, 1, int(o.get("causal", True)),
                    int(o.get("window") or 0), 1.0 / math.sqrt(hd),
                    float(o.get("cap") or 0.0)]
            if len(fn.argtypes) == 17:
                args.append(None)
            check_launch(fn(*args, stream(q)), "flash_attention")

        order = list(fns)
        for turn, names in enumerate((order, order[::-1]) * 2):
            for name in names:
                for label, (q, k, v, o, reps) in cases.items():
                    out = torch.empty_like(q)
                    call(fns[name], q, k, v, o, out)
                    torch.cuda.synchronize()
                    ref = first.setdefault(label, out)
                    same = bool(torch.equal(out, ref))
                    if not same:
                        bad.append((name, label))
                    ms = smoke.cuda_time_ms(
                        lambda: call(fns[name], q, k, v, o, out), reps)
                    readings.setdefault(name, {}).setdefault(
                        label, []).append(dict(turn=turn, ms=ms,
                                               same_as_first=same))
                    print(f"[flash_versions] build={name} case={label} "
                          f"turn={turn} same_as_first={same} ms={ms:.6f}",
                          flush=True)
        os.environ.pop(B.BUILD_DIR_ENV, None)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "flash_versions.json").write_text(json.dumps(dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=smi,
        sources={n: str(p) for n, p in srcs.items()}, readings=readings),
        indent=1))
    if bad:
        print(f"flash_versions: outputs differ between builds: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Which state tile the wkv6 kernel runs best with at N = 64, measured.

Run from the repository root on one CUDA device:

    python3 scripts/wkv6_tiles.py [--source NAME=PATH ...]

``src/repro_torch/kernels/rwkv6/csrc/wkv6.cu`` is built once per tile in
`TILES` (``-DWKV_ROWS=R -DWKV_COLS=C``: each thread holds R rows x C
columns of a head's state), and once for each ``--source`` given (another
version of the kernel with the same C entry point, e.g. an earlier one,
built with its own defaults), in a temporary directory, never the
checkout.  Each build is swapped in as the library the wkv6 wrapper
launches and read at rwkv6-7b's shapes (``chip_smoke.py``'s draws): the
prefill (B=4, S=4096, H=64, N=64, bf16) and a ragged S=1000 against the
plain version within 2e-2, the prefill chained over two halves bitwise;
the prefill's time (CUDA events over 10 calls, and one CUDA graph of 5
calls) and the decode step's device time at B=4 and B=8 (a CUDA graph of
200 calls).  Builds are timed in turns (in order, then in reverse), so
drift of the card's clock shows as a spread between the two readings.  It
prints one line per build and turn, the card's name and power limit, and
writes every reading to ``chiprun_out/wkv6_tiles.json``.  It exits non-zero
if a build disagrees with the plain version.
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
#: (rows, columns) of the state each thread holds at N = 64
TILES = ((16, 4), (16, 2), (8, 8))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("wkv6_tiles: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.kernels import build as B
    from repro_torch.kernels.rwkv6 import kernel as wk
    from repro_torch.kernels.rwkv6 import ref as wref

    prefill = smoke.wkv_draw((smoke.GEN_B, smoke.GEN_S, 64, 64), "bfloat16",
                             41, True)
    ragged = smoke.wkv_draw((2, 1000, 64, 64), "bfloat16", 44, True)
    decode = {b: smoke.wkv_draw((b, 1, 64, 64), "bfloat16", 42, True)
              for b in (smoke.GEN_B, smoke.SERVE_B)}
    want = {"prefill": wref.wkv6(*prefill)[0], "ragged": wref.wkv6(*ragged)[0]}
    readings, bad = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[B.BUILD_DIR_ENV] = tmp
        libs = {}
        for rows, cols in TILES:
            name = f"r{rows}c{cols}"
            libs[name] = B.NvccLibrary(
                f"wkv6_{name}", wk._SRC,
                (f"-DWKV_ROWS={rows}", f"-DWKV_COLS={cols}"), wk._bind)
        for spec in opts.source:
            name, path = spec.split("=", 1)
            libs[name] = B.NvccLibrary(f"wkv6_{name}", Path(path), (),
                                       wk._bind)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(libs)) as pool:
            list(pool.map(lambda lib: lib.build(verbose=True), libs.values()))
        print(f"[tiles] built {len(libs)} variants in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        order = list(libs)
        for turn, names in enumerate((order, order[::-1])):
            for name in names:
                wk.lib = libs[name].lib
                row = readings.setdefault(name, {"turns": []})
                if turn == 0:
                    for label, args in (("prefill", prefill),
                                        ("ragged", ragged)):
                        ok, err = smoke.close(wk.wkv6(*args)[0], want[label],
                                              2e-2)
                        row[f"{label}_err"] = err
                        if not ok:
                            bad.append((name, label))
                    r, k, v, w, u, s0 = prefill
                    h = smoke.GEN_S // 2
                    y, sT = wk.wkv6(*prefill)
                    ya, sA = wk.wkv6(*[t[:, :h].contiguous()
                                       for t in (r, k, v, w)], u, s0)
                    yb, sB = wk.wkv6(*[t[:, h:].contiguous()
                                       for t in (r, k, v, w)], u, sA)
                    row["halves_bitwise"] = bool(
                        torch.equal(torch.cat([ya, yb], 1), y)
                        and torch.equal(sB, sT))
                    if not row["halves_bitwise"]:
                        bad.append((name, "halves"))
                reading = dict(
                    prefill_ms=smoke.cuda_time_ms(
                        lambda: wk.wkv6(*prefill), 10),
                    prefill_device_ms=smoke.graph_time_ms(
                        lambda: wk.wkv6(*prefill), 5),
                    **{f"decode_b{b}_device_ms": smoke.graph_time_ms(
                        lambda a=a: wk.wkv6(*a), 200)
                       for b, a in decode.items()})
                row["turns"].append(reading)
                print(f"[tiles] build={name} turn={turn} " + " ".join(
                    f"{k}={v:.6f}" for k, v in reading.items())
                    + (f" prefill_err={row['prefill_err']:.3e} "
                       f"halves_bitwise={row['halves_bitwise']}"
                       if turn == 0 else ""), flush=True)
        os.environ.pop(B.BUILD_DIR_ENV, None)
        wk.lib = wk.LIBRARY.lib
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "wkv6_tiles.json").write_text(json.dumps(dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=smi,
        readings=readings), indent=1))
    if bad:
        print(f"wkv6_tiles: kernel != plain version for {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

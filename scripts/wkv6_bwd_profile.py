"""Where a CTA of the WKV6 backward kernel spends its cycles, on one card.

Run from the repository root on one CUDA device:

    python3 scripts/wkv6_bwd_profile.py [--ablate]

Builds, in a temporary directory, a copy of
``src/repro_torch/kernels/rwkv6/csrc/wkv6.cu`` whose backward kernel reads
``clock64()`` between its phases (thread 0 of each CTA adds the SM cycles
of each phase up and writes them out at its end), runs it at rwkv6-7b's
training shapes (B=1 and B=4, S=4,096, 64 heads of 64, bf16) and prints
the mean cycles a CTA spends in each phase, with each phase's share.
The stamps are text inserted at `STAMPS`' anchors: a change to the
kernel's source that moves an anchor makes the script raise; re-point
the anchors then.  ``--ablate`` adds builds with the walk's lane trees
(its shuffles) and its stores to the rows' owners taken out: their
results are wrong, only their times count, and they show what those parts
cost.  Readings go to ``chiprun_out/wkv6_bwd_profile.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: the phases, in the order of their slots
PHASES = ("pass1_wait", "pass1_steps", "pass1_sync", "pass1_other",
          "wait", "convert", "sync_issue", "rebuild", "cluster_barrier",
          "exchange", "walk", "other")
SLOT = {name: i for i, name in enumerate(PHASES)}


def _stamp(name: str) -> str:
    return f"STAMP({SLOT[name]});"


#: (anchor, text put after it): each anchor occurs once in the source
STAMPS = (
    ("  for (int e = tid; e < N; e += NT) sh.u[e] = u[(size_t)h * N + e];\n",
     "  unsigned long long pf[%d] = {};\n"
     "  unsigned long long tk = clock64();\n"
     "#define STAMP(i) { const unsigned long long nw = clock64(); "
     "pf[i] += nw - tk; tk = nw; }\n" % len(PHASES)),
    ("    if (c + 1 == nch) break;  // the last chunk's steps are not needed\n",
     "    " + _stamp("pass1_other") + "\n"),
    ("    mbar_wait(&sh.bar[L % kRing], (L / kRing) & 1);\n"
     "    const Raw& rw = sh.raw[L % kRing];\n",
     "    " + _stamp("pass1_wait") + "\n"),
    ("      advance(cur, cur, f[m & 1]);\n    }\n",
     "    " + _stamp("pass1_steps") + "\n"),
    ("    Stage& sg = sh.stage[slot];\n",
     "    " + _stamp("other") + "\n"
     "    mbar_wait(&sh.bar[L % kRing], (L / kRing) & 1);\n"
     "    " + _stamp("wait") + "\n"),
    ("    convert(L, sg);\n", "    " + _stamp("convert") + "\n"),
    ("    ++L;\n    float sp[HK][R][C];\n",
     "    " + _stamp("sync_issue") + "\n"),
)
#: (anchor, replacement) pairs that put stamps inside a statement
WRAPS = (
    ("    if (wi == 0 && L + kRing < n_loads) issue(L + kRing);\n"
     "    ++L;\n  }\n",
     "    if (wi == 0 && L + kRing < n_loads) issue(L + kRing);\n"
     "    ++L;\n    " + _stamp("pass1_sync") + "\n  }\n"),
    ("      if (c + 1 < nch) {\n        cluster_arrive();\n"
     "        cluster_wait();\n        exchange(c + 1, prev);\n      }\n"
     "      if (n == K)\n        walk(sp, sg, HK, bx);\n"
     "      else\n        walk_ragged(sp, sg, HK, n - HK, bx);\n"
     "      rebuild(sp, c0, sg, 0, HK);\n      walk(sp, sg, 0, bx);\n",
     "      " + _stamp("rebuild") + "\n"
     "      if (c + 1 < nch) {\n        cluster_arrive();\n"
     "        cluster_wait();\n        " + _stamp("cluster_barrier") + "\n"
     "        exchange(c + 1, prev);\n        " + _stamp("exchange") + "\n"
     "      }\n"
     "      if (n == K)\n        walk(sp, sg, HK, bx);\n"
     "      else\n        walk_ragged(sp, sg, HK, n - HK, bx);\n"
     "      " + _stamp("walk") + "\n"
     "      rebuild(sp, c0, sg, 0, HK);\n      " + _stamp("rebuild") + "\n"
     "      walk(sp, sg, 0, bx);\n      " + _stamp("walk") + "\n"),
    ("  // no CTA leaves while another may still read its shared memory\n"
     "  cluster_arrive();\n  cluster_wait();\n}\n",
     "  // no CTA leaves while another may still read its shared memory\n"
     "  cluster_arrive();\n  cluster_wait();\n  " + _stamp("other") + "\n"
     "  if (tid == 0)\n    for (int i = 0; i < %d; ++i) "
     "wkv6_prof[blockIdx.x][i] = pf[i];\n}\n" % len(PHASES)),
    ("template <typename T, int N>\n__global__ void __launch_bounds__"
     "(Bwd<N>::NT)\n",
     "__device__ unsigned long long wkv6_prof[4096][%d];\n"
     "template <typename T, int N>\n__global__ void __launch_bounds__"
     "(Bwd<N>::NT)\n" % len(PHASES)),
)
#: --ablate: (name, [(anchor, replacement)]), results wrong, times only
ABLATIONS = (
    ("no_lane_trees", (
        ("    const float xr = (b0 ? p.r[1] : p.r[0]) +\n"
         "                     __shfl_xor_sync(kFull, b0 ? p.r[0] : p.r[1], "
         "1);\n",
         "    const float xr = p.r[0];\n"),
        ("    const float xk = (b0 ? p.k[1] : p.k[0]) +\n"
         "                     __shfl_xor_sync(kFull, b0 ? p.k[0] : p.k[1], "
         "1);\n",
         "    const float xk = p.k[0];\n"),
        ("    const float xw = (b0 ? p.w[1] : p.w[0]) +\n"
         "                     __shfl_xor_sync(kFull, b0 ? p.w[0] : p.w[1], "
         "1);\n",
         "    const float xw = p.w[0];\n"),
        ("    const float y = (b1 ? xk : xr) + __shfl_xor_sync(kFull, "
         "b1 ? xr : xk, 2);\n    const float z = xw + __shfl_xor_sync("
         "kFull, xw, 2);\n",
         "    const float y = b1 ? xk : xr;\n    const float z = xw;\n"),
        ("      to[0] = (b2 ? z : y) + __shfl_xor_sync(kFull, b2 ? y : z, "
         "4);\n",
         "      to[0] = b2 ? z : y;\n"),
        ("    reduce_scatter<C, RGW, LC>(p.v, rg);\n", ""),
    )),
    ("no_owner_stores", (
        ("      to[0] = (b2 ? z : y) + __shfl_xor_sync(kFull, b2 ? y : z, "
         "4);\n",
         "      const float t_ = (b2 ? z : y) + __shfl_xor_sync(kFull, "
         "b2 ? y : z, 4);\n      if (t_ == 1.2345f) to[0] = t_;\n"),
    )),
)


def instrument(src: str, extra=()) -> str:
    out = src
    for anchor, text in STAMPS:
        if out.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        out = out.replace(anchor, anchor + text)
    for anchor, text in tuple(WRAPS) + tuple(extra):
        if out.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        out = out.replace(anchor, text)
    return out + (
        "\nextern \"C\" int wkv6_bwd_profile(unsigned long long* out) {\n"
        "  return (int)cudaMemcpyFromSymbol(out, wkv6_prof, "
        "sizeof(wkv6_prof));\n}\n")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ablate", action="store_true")
    opts = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("wkv6_bwd_profile: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.kernels import build as B
    from repro_torch.kernels.rwkv6 import kernel as wk

    src = wk._SRC.read_text()
    builds = [("stamped", ())]
    if opts.ablate:
        builds += list(ABLATIONS)
    shapes = (("train", (1, 4096, 64, 64)), ("b4", (4, 4096, 64, 64)))
    n_phases = len(PHASES)
    readings = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[B.BUILD_DIR_ENV] = tmp
        for name, extra in builds:
            path = Path(tmp) / f"wkv6_{name}.cu"
            path.write_text(instrument(src, extra))
            lib = B.NvccLibrary(f"wkv6_{name}", path, (), wk._bind)
            handle = lib.lib()
            handle.wkv6_bwd_profile.argtypes = [ctypes.c_void_p]
            handle.wkv6_bwd_profile.restype = ctypes.c_int
            wk.lib = lib.lib
            for label, shape in shapes:
                Bn, S, H, N = shape
                r, k, v, w, u, s0 = smoke.wkv_draw(shape, "bfloat16", 61,
                                                   True)
                gen = torch.Generator(device="cuda").manual_seed(1061)
                dy = torch.randn(shape, generator=gen, device="cuda").to(
                    r.dtype)
                args = (r, k, v, w, u, s0, dy, None)
                ms = smoke.cuda_time_ms(lambda: wk.wkv6_bwd(*args), 5, 1)
                wk.wkv6_bwd(*args)
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * (4096 * n_phases))()
                handle.wkv6_bwd_profile(ctypes.addressof(buf))
                n_ctas = Bn * H * (N // min(N, 32))
                a = np.frombuffer(buf, dtype=np.uint64).reshape(
                    4096, n_phases)[:n_ctas].astype(np.float64)
                total = a.sum(1)
                row = dict(ms=ms, ctas=n_ctas,
                           cycles_mean=float(total.mean()),
                           cycles_max=float(total.max()),
                           phases={p: float(a[:, i].mean())
                                   for i, p in enumerate(PHASES)})
                readings.setdefault(name, {})[label] = row
                print(f"[wkv6_bwd_profile] build={name} case={label} "
                      f"ms={ms:.6f} cycles_a_cta={row['cycles_mean']:.0f}",
                      flush=True)
                for p, c in row["phases"].items():
                    print(f"  {p:16s} {c:12.0f} "
                          f"{c / row['cycles_mean']:.3f}", flush=True)
                del args, r, k, v, w, u, s0, dy
                torch.cuda.empty_cache()
        os.environ.pop(B.BUILD_DIR_ENV, None)
        wk.lib = wk.LIBRARY.lib
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "wkv6_bwd_profile.json").write_text(json.dumps(dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=smi,
        readings=readings), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

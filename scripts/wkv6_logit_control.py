"""Control for the rwkv6-7b limits of ``chip_smoke.py``: what defects of the
wkv6 kernel read on the checks that hold it.

Run from the repository root on one CUDA device:

    python3 scripts/wkv6_logit_control.py

Each variant of ``src/repro_torch/kernels/rwkv6/csrc/wkv6.cu`` (the sound
source, and mutants made from it by one textual edit) is written and built
in a temporary directory, never in the checkout, and swapped in as the
library the wkv6 wrapper launches.  For each variant it reads:

  * phase 8's kernel checks: its ragged case (B=2, S=1000, H=64, N=64,
    bf16, the model's draw), y within 2e-2 abs + 2e-2 rel of the plain
    version; and its float32 case at the model's draw (B=2, S=256, H=4,
    N=16), y and the final state within twice ``ref.f32_error_bound``;
  * phase 9's model checks: full-width rwkv6-7b (seed-88 bf16 weights)
    prefilled on 4 prompts of 4,096 tokens, last-position logits against
    the plain-pinned twin (max and mean |diff| within ``LOGIT_TOL``) and
    their distance to the same weights in float32 against the twin's
    (within ``F32_DISTANCE_RATIO``).

It prints one line per variant and writes every reading to
``chiprun_out/wkv6_logit_control.json``.  It exits non-zero if the sound
variant fails a check or a mutant never launched.
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

# a mutant: (pattern, replacement, expected matches), its defect above it
MUTANTS = {
    # y reads the state after this step's decay instead of before it
    "readout_after_decay": (
        r"acc\[cc\] = fmaf\(rr\[i\], st\[i\]\[cc\], acc\[cc\]\);",
        "acc[cc] = fmaf(rr[i], ww[i] * st[i][cc], acc[cc]);", 1),
    # the bonus u_i k_i v_j of the current token dropped from y
    "no_bonus": (r"fmaf\(vs\[buf\]\[c\]\[j\], bonus\[buf\]\[c\], "
                 r"acc\[q\]\)", "acc[q]", 1),
    # the bonus taken with the next head's u
    "u_of_next_head": (r"u\[\(size_t\)h \* N \+ part \* EPU \+ e\]",
                       "u[(size_t)((h + 1) % H) * N + part * EPU + e]", 1),
    # y rounded to bf16 toward zero instead of to nearest
    "y_round_toward_zero": (r"__float2bfloat16_rn\(x\)",
                            "__float2bfloat16_rz(x)", 1),
}


def mutate(src: str, pattern: str, repl: str, count: int) -> str:
    out, n = re.subn(pattern, repl, src)
    if n != count:
        raise RuntimeError(f"mutation {pattern!r} matched {n} times, "
                           f"expected {count}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("wkv6_logit_control: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.kernels import build as B
    from repro_torch.kernels.rwkv6 import kernel as wk
    from repro_torch.kernels.rwkv6 import ref as wref
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = smoke.RWKV_ARCH
    tol_max, tol_mean = smoke.LOGIT_TOL[arch]
    src = wk._SRC.read_text()
    variants = {"sound": src}
    variants.update({name: mutate(src, *m) for name, m in MUTANTS.items()})
    readings = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[B.BUILD_DIR_ENV] = tmp
        libs = {}
        for name, text in variants.items():
            path = Path(tmp) / f"wkv6_{name}.cu"
            path.write_text(text)
            libs[name] = B.NvccLibrary(f"wkv6_{name}", path, (), wk._bind)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(libs)) as pool:
            list(pool.map(lambda lib: lib.build(), libs.values()))
        print(f"[control] built {len(libs)} variants in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)

        # phase 8's ragged case and its float32 case at the model's draw
        args = smoke.wkv_draw((2, 1000, 64, 64), "bfloat16", 44, True)
        y_plain = wref.wkv6(*args)[0]
        args32 = smoke.wkv_draw((2, 256, 4, 16), "float32", 45, True)
        y32, s32 = wref.wkv6(*args32)
        yb, sb = wref.f32_error_bound(*args32)

        def bound_frac():
            y, s = wk.wkv6(*args32)
            return max(float(((y.double() - y32.double()).abs()
                              / (2 * yb)).max()),
                       float(((s.double() - s32.double()).abs()
                              / (2 * sb)).max()))
        cfg, params, _ = smoke.full_model(arch)
        gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 1)
        prompt = torch.randint(0, cfg.vocab, (smoke.GEN_B, smoke.GEN_S),
                               generator=gen, device="cuda")

        def prefill():
            out = M.prefill(params, cfg, {"tokens": prompt}, last_only=True)
            return out[0].float()
        smoke.set_pin(True)
        t0 = time.perf_counter()
        twin = prefill()
        twin_s = time.perf_counter() - t0
        smoke.set_pin(False)
        ref32 = smoke.f32_logits(cfg, params, prompt)
        twin32 = [float(f((twin - ref32).abs())) for f in (torch.max,
                                                           torch.mean)]
        for name, lib in libs.items():
            wk.lib = lib.lib
            wk.reset_launches()
            ok8, err8 = smoke.close(wk.wkv6(*args)[0], y_plain, 2e-2)
            frac = bound_frac()
            ok8 = ok8 and frac <= 1.0
            logits = prefill()
            torch.cuda.synchronize()
            launches = wk.LAUNCHES["wkv6"]
            diff = (logits - twin).abs()
            d_max, d_mean = float(diff.max()), float(diff.mean())
            to32 = [float(f((logits - ref32).abs())) for f in (torch.max,
                                                                torch.mean)]
            ratio = [a / b for a, b in zip(to32, twin32)]
            ok9 = d_max <= tol_max and d_mean <= tol_mean
            ok_ratio = all(x <= smoke.F32_DISTANCE_RATIO for x in ratio)
            readings[name] = dict(
                phase8_ragged_err=err8, phase8_f32_bound_frac=frac,
                phase8_pass=ok8,
                logits_max_abs_diff=d_max, logits_mean_abs_diff=d_mean,
                logit_tol_pass=ok9, f32_distance=to32,
                f32_distance_ratio=ratio, f32_ratio_pass=ok_ratio,
                caught=not (ok8 and ok9 and ok_ratio),
                first_token_same=bool(torch.equal(logits.argmax(-1),
                                                  twin.argmax(-1))),
                launches=launches)
            print(f"[control] variant={name} phase8_err={err8:.4e} "
                  f"phase8_f32_bound_frac={frac:.4e} "
                  f"phase8_pass={ok8} logits_max={d_max:.4e} "
                  f"logits_mean={d_mean:.4e} tol={tol_max}/{tol_mean} "
                  f"tol_pass={ok9} f32_ratio={ratio[0]:.4f}/{ratio[1]:.4f} "
                  f"ratio_pass={ok_ratio} caught={readings[name]['caught']} "
                  f"launches={launches}", flush=True)
        os.environ.pop(B.BUILD_DIR_ENV, None)
        wk.lib = wk.LIBRARY.lib
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
               limits=dict(logit_tol=[tol_max, tol_mean],
                           f32_distance_ratio=smoke.F32_DISTANCE_RATIO),
               twin_prefill_s=twin_s, twin_f32_distance=twin32,
               variants=readings)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "wkv6_logit_control.json").write_text(json.dumps(out,
                                                                indent=1))
    print(json.dumps({k: v["caught"] for k, v in readings.items()}),
          flush=True)
    sound = readings["sound"]
    if sound["caught"]:
        print("wkv6_logit_control: the sound kernel fails a check",
              file=sys.stderr)
        return 1
    if not all(r["launches"] > 0 for r in readings.values()):
        print("wkv6_logit_control: a variant never launched", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

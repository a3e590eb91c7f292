"""Control for the other families' limits of ``chip_smoke.py``: what defects
of the flash-attention kernel read on the logit checks that hold it.

Run from the repository root on one CUDA device:

    python3 scripts/flash_logit_control.py [--seed N] [arch ...]

Each variant of ``src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu`` (the sound source, and mutants made from it by one
textual edit) is written and built in a temporary directory, never in the
checkout, and swapped in as the library the flash wrapper launches.  For
each architecture (by default the eight of ``chip_smoke.py``'s phases
11-13: gemma2-2b and deepseek-moe-16b on 4 prompts of 4,096 tokens, the
six others on the phase-13 batch, mixtral cut to 16 layers as there) it
builds the bf16 model at full width from ``--seed`` (by default the
smoke's seed, 88; the prompt's seed follows it as in the smoke), prefills
it through each variant and reads the last-position logits against the
plain-pinned twin (max and mean |diff| within ``LOGIT_TOL``) and their
distance to the same weights in float32 against the twin's (within
``F32_DISTANCE_RATIO``), and for an MoE model how many routing choices
differ from the twin's.

It prints one line per (architecture, variant) and writes every reading to
``chiprun_out/flash_logit_control_seed<N>.json``.  It exits non-zero if
the sound variant fails a check or a variant never launched.
"""

from __future__ import annotations

import argparse
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
    # the logit scale one bf16 ulp too large (x (1 + 2^-8))
    "scale_one_bf16_ulp": (r"causal, window, scale, cap\};",
                           "causal, window, scale * 1.00390625f, cap};", 1),
    # P and O rounded to bf16 toward zero instead of to nearest
    "round_toward_zero": (
        r"__floats2bfloat162_rn\(lo, hi\)",
        "__halves2bfloat162(__float2bfloat16_rz(lo), "
        "__float2bfloat16_rz(hi))", 1),
    # each query's own key masked (causal: key < query)
    "diagonal_masked": (r"\(a\.causal && qp < kp\)",
                        "(a.causal && qp <= kp)", 1),
    # the running sum not rescaled when the running max grows
    "sum_not_rescaled": (r"\n\s*l_run\[r\] \*= alpha\[r\];", "", 1),
}


def mutate(src: str, pattern: str, repl: str, count: int) -> str:
    out, n = re.subn(pattern, repl, src)
    if n != count:
        raise RuntimeError(f"mutation {pattern!r} matched {n} times, "
                           f"expected {count}")
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_logit_control: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=smoke.SEED)
    ap.add_argument("archs", nargs="*")
    args = ap.parse_args(argv)
    smoke.SEED = args.seed                   # weights and prompts follow it
    from repro_torch.kernels import build as B
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    archs = args.archs or [a for a in smoke.SERVED[2:] + smoke.FAMILIES]
    src = fk._SRC.read_text()
    variants = {"sound": src}
    variants.update({name: mutate(src, *m) for name, m in MUTANTS.items()})
    readings: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[B.BUILD_DIR_ENV] = tmp
        libs = {}
        for name, text in variants.items():
            path = Path(tmp) / f"flash_{name}.cu"
            path.write_text(text)
            libs[name] = B.NvccLibrary(f"flash_{name}", path, (), fk._bind)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(libs)) as pool:
            list(pool.map(lambda lib: lib.build(), libs.values()))
        print(f"[control] built {len(libs)} variants in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        for arch in archs:
            cfg, params, _ = smoke.full_model(arch,
                                              smoke.FAMILY_LAYERS.get(arch))
            if arch in smoke.SERVED:
                gen = torch.Generator(device="cuda").manual_seed(
                    smoke.SEED + 1)
                batch = {"tokens": torch.randint(
                    0, cfg.vocab, (smoke.GEN_B, smoke.GEN_S), generator=gen,
                    device="cuda")}
            else:
                batch = smoke.family_batch(cfg)

            def prefill():
                with smoke.RouteLog() as log:
                    out = M.prefill(params, cfg, batch, last_only=True)
                return out[0].float(), log.calls
            smoke.set_pin(True)
            twin, twin_routes = prefill()
            smoke.set_pin(False)
            ref32 = smoke.f32_logits(cfg, params, batch["tokens"],
                                     batch.get("patches"))
            readings[arch] = {}
            for name, lib in libs.items():
                fk.lib = lib.lib
                fk.reset_launches()
                logits, routes = prefill()
                torch.cuda.synchronize()
                launches = fk.LAUNCHES["flash_attention"]
                got, checks = smoke.logit_checks(arch, cfg, logits, twin,
                                                 ref32)
                to32 = got["f32_max_mean_diff"]
                ratio = [a / b for a, b in zip(to32["kernels"],
                                               to32["plain_twin"])]
                got.update(smoke.routing_diff(cfg, routes, twin_routes),
                           f32_distance_ratio=ratio, launches=launches,
                           caught=not all(c for c, _ in checks),
                           first_token_same=bool(torch.equal(
                               logits.argmax(-1), twin.argmax(-1))))
                readings[arch][name] = got
                print(f"[control] arch={arch} variant={name} "
                      f"logits_max={got['logits_max_abs_diff']:.4e} "
                      f"logits_mean={got['logits_mean_abs_diff']:.4e} "
                      "tol={}/{} ".format(*got["tol"])
                      + f"f32_ratio={ratio[0]:.4f}/{ratio[1]:.4f} "
                      + "".join(f"{k}={got[k]} " for k in (
                          "routing_differ", "routing_choices") if k in got)
                      + f"caught={got['caught']} launches={launches}",
                      flush=True)
            fk.lib = fk.LIBRARY.lib
            del params, twin, ref32
            torch.cuda.empty_cache()
        os.environ.pop(B.BUILD_DIR_ENV, None)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
               seed=args.seed,
               f32_distance_ratio=smoke.F32_DISTANCE_RATIO,
               mutants={k: v[:2] for k, v in MUTANTS.items()},
               readings=readings)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"flash_logit_control_seed{args.seed}.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps({a: {k: v["caught"] for k, v in r.items()}
                      for a, r in readings.items()}), flush=True)
    if any(r["sound"]["caught"] for r in readings.values()):
        print("flash_logit_control: the sound kernel fails a check",
              file=sys.stderr)
        return 1
    if not all(v["launches"] > 0 for r in readings.values()
               for v in r.values()):
        print("flash_logit_control: a variant never launched",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""What the decode step pays for dropping a cache write past a plain cache's
end (``repro_torch.models.layers._write_slot_or_drop``) against the plain
slot write it replaces (``_write_slot``).

Run from the repository root on one CUDA device:

    python3 scripts/decode_write_cost.py [--rounds N] [arch ...]

For each architecture (by default recurrentgemma-2b and gemma2-2b, whose
attention caches are plain at ``chip_smoke.py``'s generate shape) it builds
the smoke's bf16 model at full width, prefills the smoke's 4 prompts of
4,096 tokens, and then times synchronized ``decode_step``s with the
dropping write and with the plain write in turns (drop, plain, plain,
drop, ...) on one decode state, so that both sides see the same host and
card.  No position here passes a cache's end, so the two writes store
the same values.

It prints one line per architecture and writes every step time to
``chiprun_out/decode_write_cost.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_write_cost: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serve import pad_prefill_state

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("archs", nargs="*")
    args = ap.parse_args(argv)
    archs = args.archs or ["recurrentgemma_2b", "gemma2_2b"]
    drop = L._write_slot_or_drop
    results = {}
    for arch in archs:
        cfg, params, _ = smoke.full_model(arch)
        gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 1)
        prompt = torch.randint(0, cfg.vocab, (smoke.GEN_B, smoke.GEN_S),
                               generator=gen, device="cuda")
        _, state = M.prefill(params, cfg, {"tokens": prompt}, last_only=True)
        state = pad_prefill_state(cfg, state,
                                  smoke.GEN_S + 4 * args.rounds + 4)
        plain_caches = sum(
            1 for mixer, _ in cfg.layer_plan if mixer in ("attn", "local")
            and not (mixer == "local" and cfg.window is not None
                     and smoke.GEN_S + 4 * args.rounds + 4 <= cfg.window))
        tok = prompt[:, -1:]
        pos = torch.full((smoke.GEN_B,), smoke.GEN_S, dtype=torch.long,
                         device="cuda")
        steps = {"drop": [], "plain": []}
        try:
            # one warm step a side, then the turns
            for side in ("drop", "plain") + ("drop", "plain", "plain",
                                             "drop") * args.rounds:
                L._write_slot_or_drop = drop if side == "drop" \
                    else L._write_slot
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, state = M.decode_step(params, cfg, state, tok, pos)
                torch.cuda.synchronize()
                steps[side].append((time.perf_counter() - t) * 1e3)
                tok = logits[:, -1:].argmax(-1)
                pos = pos + 1
        finally:
            L._write_slot_or_drop = drop
        for side in steps:                      # drop the warm steps
            steps[side] = steps[side][1:]
        med = {s: statistics.median(v) for s, v in steps.items()}
        results[arch] = dict(plain_caches=plain_caches, step_ms=steps,
                             median_ms=med,
                             mean_ms={s: statistics.fmean(v)
                                      for s, v in steps.items()},
                             diff_ms=med["drop"] - med["plain"])
        print(f"[decode_write] arch={arch} plain_caches={plain_caches} "
              f"steps_a_side={len(steps['drop'])} "
              f"drop_median_ms={med['drop']:.4f} "
              f"plain_median_ms={med['plain']:.4f} "
              f"drop_mean_ms={results[arch]['mean_ms']['drop']:.4f} "
              f"plain_mean_ms={results[arch]['mean_ms']['plain']:.4f}",
              flush=True)
        del params, state
        torch.cuda.empty_cache()
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "decode_write_cost.json").write_text(json.dumps(dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=smi,
        batch=smoke.GEN_B, prompt=smoke.GEN_S, results=results), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

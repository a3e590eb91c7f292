"""deepseek-moe-16b's serving at full width and depth on one CUDA device,
from the tree at ``--root``: ``greedy_generate`` of a 4 x 4,096 prompt
and 32 new tokens through the kernels (`chip_smoke.generate_run` of that
tree: its prefill wall, each decode step's wall, the whole wall), taken
``--reps`` times in one process on one set of random bf16 weights (seed
88, `chip_smoke.full_model`).  Each rep's prefill logits are hashed, so
that reps, processes and trees can be held bitwise against each other.
Where the tree has ``layers.moe_combine``, the combine alone is also
timed on the host's clock (synchronized, 200 calls) at the prefill's and
a decode step's shape.

Two trees are compared in turns on one card, the parent unpacked with
``git archive`` into a directory that ``.gitignore`` lists:

    for r in build/parent . . build/parent; do
        python3 scripts/moe_serve_ab.py --root $r; done

Each run prints one JSON line and appends it to
``chiprun_out/moe_serve_ab.jsonl``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ARCH = "deepseek_moe_16b"


def combine_ms(L, cfg, d: int, T: int, reps: int = 200) -> float:
    """Host-clock ms a call of ``L.moe_combine`` over one group of ``T``
    tokens (bf16 slots, routing drawn at random), the card synchronized
    before and after the ``reps`` calls."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(5)
    E, K = cfg.n_experts, cfg.top_k
    C = L.moe_capacity(T, cfg)
    w, idx = torch.topk(torch.softmax(torch.randn(
        (1, T, E), generator=gen, device="cuda"), -1), K, dim=-1)
    st, sw, keep, buf_idx = L.moe_plan(idx, w / w.sum(-1, keepdim=True), C,
                                       E)
    sw = torch.where(keep, sw, torch.zeros((), device="cuda")).bfloat16()
    yb = torch.randn((1, E * C + 1, d), generator=gen,
                     device="cuda").bfloat16()
    for _ in range(3):
        L.moe_combine(yb, st, sw, buf_idx, T, K)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        L.moe_combine(yb, st, sw, buf_idx, T, K)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("moe_serve_ab: needs a CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as smoke
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import layers as L

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    fk.build()
    fk.lib()
    cfg, params, n = smoke.full_model(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 1)
    prompt = torch.randint(0, cfg.vocab, (smoke.GEN_B, smoke.GEN_S),
                           generator=gen, device="cuda")
    reps = []
    for _ in range(args.reps):
        r = smoke.generate_run(cfg, params, prompt, plain=False)
        reps.append(dict(
            prefill_s=r["prefill_s"], generate_s=r["generate_s"],
            step_ms_median=statistics.median(r["step_ms"]),
            logits_sha=hashlib.sha256(
                r["logits"].cpu().numpy().tobytes()).hexdigest()[:16],
            tokens_sha=hashlib.sha256(
                r["tokens"].numpy().tobytes()).hexdigest()[:16],
            launches=r["launches"]["flash_attention"]))
    rec = dict(root=os.path.relpath(root, Path.cwd()), device=smi,
               arch=ARCH, layers=cfg.n_layers, params=n, B=smoke.GEN_B,
               S=smoke.GEN_S, n_new=smoke.GEN_NEW, reps=reps,
               logits_repeat=len({r["logits_sha"] for r in reps}) == 1,
               tokens_repeat=len({r["tokens_sha"] for r in reps}) == 1)
    if hasattr(L, "moe_combine"):
        d = cfg.d_model
        rec["combine_ms"] = {
            "prefill": combine_ms(L, cfg.moe, d, smoke.GEN_B * smoke.GEN_S),
            "decode": combine_ms(L, cfg.moe, d, smoke.GEN_B)}
    line = json.dumps(rec)
    print(line, flush=True)
    out = Path.cwd() / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "moe_serve_ab.jsonl", "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

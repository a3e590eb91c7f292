"""Phase 15's four AdamW steps under several learning-rate schedules: which
ones let a model's loss fall on the repeated batch.

Run from the repository root on one CUDA device:

    python3 scripts/train_lr_sweep.py [--arch rwkv6_7b] [--layers L]
        [--seed N] [--sched LR:WARMUP:TOTAL ...]

For each schedule, the model at full width (``--layers`` layers; for
rwkv6-7b phase 15's depth by default) is drawn afresh from seed ``--seed``
and takes phase 15's steps (B=2 x 4,096 in two microbatches, the two
alternating batches) through the kernels; the losses, the steps' lr and
grad norms are printed, one line a schedule, and written to
``chiprun_out/train_lr_sweep_<arch>_seed<N>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_SCHEDS = ("3e-4:1:10", "3e-5:1:10", "1e-5:1:10", "3e-6:1:10",
                  "3e-4:100:1000")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_lr_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=smoke.RWKV_ARCH)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seed", type=int, default=smoke.SEED)
    ap.add_argument("--sched", nargs="*", default=list(DEFAULT_SCHEDS),
                    help="lr:warmup_steps:total_steps")
    args = ap.parse_args(argv)
    smoke.SEED = args.seed
    layers = args.layers
    if layers is None and args.arch == smoke.RWKV_ARCH:
        layers = smoke.RWKV_TRAIN_LAYERS
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train import TrainConfig, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for spec in args.sched:
        lr, warm, total = spec.split(":")
        ocfg = AdamWConfig(lr=float(lr), warmup_steps=int(warm),
                           total_steps=int(total))
        cfg, params, _ = smoke.full_model(args.arch, layers)
        batches = smoke.train_batches(cfg)
        tcfg = TrainConfig(optimizer=ocfg, microbatches=smoke.TRAIN_MB)
        step = make_train_step(cfg, tcfg, device="cuda")
        opt = init_state(ocfg, params)
        losses, lrs, norms = [], [], []
        for i in range(smoke.TRAIN_STEPS):
            params, opt, m = step(params, opt, batches[i % 2])
            losses.append(float(m["loss"]))
            lrs.append(float(m["lr"]))
            norms.append(float(m["grad_norm"]))
        row = dict(sched=spec, losses=losses, lr=lrs, grad_norm=norms,
                   falls=losses[2] < losses[0])
        rows.append(row)
        print(f"[sweep] arch={args.arch} layers={cfg.n_layers} sched={spec} "
              f"losses={','.join(f'{x:.6f}' for x in losses)} "
              f"lr={','.join(f'{x:.3g}' for x in lrs)} "
              f"grad_norm={','.join(f'{x:.4g}' for x in norms)} "
              f"falls={row['falls']}", flush=True)
        del params, opt, batches, step
        torch.cuda.empty_cache()
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"train_lr_sweep_{args.arch}_seed{args.seed}.json"
     ).write_text(json.dumps(dict(device=torch.cuda.get_device_name(0),
                                  nvidia_smi=smi, arch=args.arch,
                                  layers=layers, seed=args.seed, rows=rows),
                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

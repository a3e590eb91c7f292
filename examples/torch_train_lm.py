"""End-to-end training driver of the PyTorch/CUDA port: train a small LM for
a few hundred steps (the twin of ``examples/train_lm.py``, plus
``--device``).

The default is the granite-3-8b smoke config; pass --arch and --steps to
scale up (any of the ten architectures' smoke or full configs).  On the
card the attention and RG-LRU layers train through their hand-written
forward and backward kernels.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 300
  PYTHONPATH=src python examples/torch_train_lm.py --arch recurrentgemma_2b --steps 50
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 3
"""

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.ckpt import latest_step, restore, save
from repro_torch.core.engine.kernels import check_device
from repro_torch.data import DataConfig, make_batch
from repro_torch.optim import AdamWConfig, tree_leaves
from repro_torch.train import TrainConfig, init_train_state, make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite3_8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (enables save/restore)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (their "
                         "plain versions)")
    args = ap.parse_args()

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    tcfg = TrainConfig(optimizer=AdamWConfig(
        lr=args.lr, warmup_steps=min(20, args.steps // 10 + 1),
        total_steps=args.steps))
    gen = torch.Generator(device=check_device(args.device)).manual_seed(0)
    params, opt = init_train_state(cfg, tcfg, gen, dtype=torch.float32,
                                   device=args.device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"batch={args.batch}x{args.seq} device={args.device}")

    start = 0
    if args.ckpt and latest_step(args.ckpt) is not None:
        start, tree = restore(args.ckpt, device=args.device)
        params, opt = tree["params"], tree["opt"]
        print(f"restored checkpoint at step {start} — data pipeline replays "
              f"deterministically from there")

    step_fn = make_train_step(cfg, tcfg, device=args.device)
    dcfg = DataConfig(seed=1234)
    t0 = time.time()
    for i in range(start, args.steps):
        batch = make_batch(cfg, dcfg, i, args.batch, args.seq,
                           device=args.device)
        params, opt, metrics = step_fn(params, opt, batch)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss {float(metrics['loss']):.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}  "
                  f"({(time.time()-t0):.1f}s)")
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            save(args.ckpt, i + 1, params, opt)
    print("done.")


if __name__ == "__main__":
    main()

"""Serve a small model on the PyTorch/CUDA port with batched requests
through the slot-based continuous batcher (prefill -> decode with explicit
state).  The twin of ``examples/serve_lm.py``: the same flags, plus
``--device`` (cuda by default, which raises without a card; cpu runs the
kernels' plain torch versions).

  PYTHONPATH=src python examples/torch_serve_lm.py --requests 12 --new 16 [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.serve import Batcher, ServeConfig, greedy_generate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma2_2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (cuda raises without a card)")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = M.init_params(cfg, gen, device=args.device, dtype=torch.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=rng.integers(4, 12)).astype(np.int32)
               for _ in range(args.requests)]

    def wait():
        if args.device == "cuda":
            torch.cuda.synchronize()

    # single-request path
    t0 = time.time()
    out = greedy_generate(params, cfg, torch.from_numpy(prompts[0])[None],
                          args.new, device=args.device)
    wait()
    print(f"greedy_generate: {tuple(out.shape)} in {time.time()-t0:.1f}s -> "
          f"{out[0][:8].cpu().numpy()}...")

    # batched continuous serving
    batcher = Batcher(params, cfg, ServeConfig(max_seq=64, batch=args.batch),
                      device=args.device)
    t0 = time.time()
    results = batcher.serve(prompts, n_new=args.new)
    wait()
    dt = time.time() - t0
    done = sum(r is not None for r in results)
    toks = sum(len(r) for r in results if r is not None)
    print(f"served {done}/{len(prompts)} requests, {toks} tokens "
          f"in {dt:.1f}s ({toks/dt:.1f} tok/s on {args.device})")
    return results


if __name__ == "__main__":
    main()

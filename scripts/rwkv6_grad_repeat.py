"""Whether rwkv6-7b's plain-path gradients repeat, across processes and
within one, and which op keeps them from repeating.

Run from the repository root on one CUDA device:

    python3 scripts/rwkv6_grad_repeat.py [--seed N] [--layers L]

rwkv6-7b at full width and ``--layers`` layers (phase 15's cut, 13, by
default), weights and batch from seed ``--seed`` (88), takes phase 15's
step-1 gradient pass (B=2 x 4,096 in two microbatches,
`chip_smoke.grad_pass`) with the LM ops pinned to their plain versions
(``REPRO_LM_KERNELS=plain``) in child processes:

  * ``plain_a`` and ``plain_b``: as phase 15's plain twin runs it, twice
    in each process;
  * ``f32_a`` and ``f32_b``: phase 15's float32 yardstick (the weights in
    float32, one microbatch), twice in each process;
  * ``det``: the plain pass under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, each op that has no
    deterministic CUDA path named by its warning (the frame of the port
    that called it beside it);
  * ``locate``: the same with ``warn_only=False``, which stops at the
    first such op and names it in its error.

Each child writes its first pass's loss and each gradient leaf's SHA-256
and float64 norm to a scratch file, and says whether its second pass
equals its first bitwise; the parent compares the children leaf by leaf
(the leaves that differ, the first of them, the largest relative
difference of their norms).  It prints one line per child and comparison
and writes everything to ``chiprun_out/rwkv6_grad_repeat_seed<N>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHILDREN = ("plain_a", "plain_b", "f32_a", "f32_b", "det", "locate")
#: passes each child takes (the second held against the first)
PASSES = {"plain": 2, "f32": 2, "det": 1, "locate": 1}


def port_frame(tb) -> str | None:
    """``file:line function`` of the innermost frame under
    ``src/repro_torch`` in the traceback list ``tb``."""
    for f in reversed(tb):
        name = f.filename.replace(os.sep, "/")
        if "/repro_torch/" in name:
            return f"{name.split('/repro_torch/')[1]}:{f.lineno} {f.name}"
    return None


def child(mode: str, out: str, seed: int, layers: int) -> int:
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    smoke.SEED = seed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mode in ("det", "locate"):
        torch.use_deterministic_algorithms(True, warn_only=mode == "det")
    cfg, params, _ = smoke.full_model(smoke.RWKV_ARCH, layers)
    mb = smoke.TRAIN_MB
    if mode == "f32":
        from repro_torch.optim import tree_map
        params, mb = tree_map(lambda t: t.float(), params), 1
    batch = smoke.train_batches(cfg)[0]
    names = smoke._leaf_names(params)
    rec: dict = {"mode": mode}
    seen: dict = {}
    orig = warnings.showwarning

    def note(message, category, filename, lineno, file=None, line=None):
        text = str(message)
        if "deterministic" in text and text not in seen:
            seen[text] = port_frame(traceback.extract_stack())
        elif "deterministic" not in text:
            orig(message, category, filename, lineno, file, line)
    warnings.showwarning = note
    warnings.simplefilter("always")
    passes = []
    try:
        for _ in range(PASSES[mode]):
            loss, grads, secs = smoke.grad_pass(cfg, params, batch, plain=True,
                                                microbatches=mb)
            passes.append((loss, [None if g is None else digest(g)
                                  for g in grads], secs))
            del grads
    except RuntimeError as e:
        rec["error"] = str(e).splitlines()[0]
        rec["error_frame"] = port_frame(traceback.extract_tb(e.__traceback__))
    rec["warned"] = [dict(op=k.splitlines()[0], frame=v)
                     for k, v in seen.items()]
    if passes:
        rec["pass_s"] = [p[2] for p in passes]
        rec["loss"] = passes[0][0]
        if len(passes) > 1:
            rec["in_process_equal"] = passes[0][:2] == passes[1][:2]
        with open(out, "w") as f:
            json.dump({"loss": passes[0][0], "grads": passes[0][1],
                       "names": names}, f)
    print(json.dumps(rec), flush=True)
    return 0


def digest(t) -> list:
    """[SHA-256 of the tensor's bytes, its float64 norm]."""
    import hashlib

    import torch
    t = t.detach().contiguous()
    h = hashlib.sha256(t.view(torch.uint8).reshape(-1).cpu().numpy()
                       .tobytes()).hexdigest()
    return [h, float(torch.linalg.vector_norm(t.reshape(-1),
                                              dtype=torch.float64))]


def compare(a: dict, b: dict) -> dict:
    """Leaf by leaf: the leaves that differ, the first, the largest
    relative difference of their norms."""
    diff, worst, worst_leaf = [], 0.0, None
    for n, x, y in zip(a["names"], a["grads"], b["grads"]):
        if x == y:
            continue
        diff.append(n)
        if x is None or y is None:
            continue
        d = abs(x[1] - y[1]) / max(abs(y[1]), 1e-30)
        if d >= worst:
            worst, worst_leaf = d, n
    return dict(loss_equal=a["loss"] == b["loss"], leaves=len(a["names"]),
                leaves_differ=len(diff), first_differ=diff[0] if diff else None,
                worst_rel=worst, worst_leaf=worst_leaf)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=88)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--child", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.layers is None:
        sys.path.insert(0, str(ROOT))
        import chip_smoke as smoke
        args.layers = smoke.RWKV_TRAIN_LAYERS
    if args.child:
        return child(args.child, args.out, args.seed, args.layers)
    import torch
    if not torch.cuda.is_available():
        print("rwkv6_grad_repeat: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    report: dict = {"device": smi, "seed": args.seed, "layers": args.layers,
                    "children": {}, "compare": {}}
    with tempfile.TemporaryDirectory() as tmp:
        files = {}
        for name in CHILDREN:
            mode = name.split("_")[0]
            files[name] = os.path.join(tmp, f"{name}.json")
            env = dict(os.environ, REPRO_LM_KERNELS="plain")
            if mode in ("det", "locate"):
                env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
            t = time.perf_counter()
            p = subprocess.run([sys.executable, __file__, "--child", mode,
                                "--out", files[name], "--seed",
                                str(args.seed), "--layers", str(args.layers)],
                               env=env, capture_output=True, text=True)
            lines = [x for x in p.stdout.splitlines() if x.startswith("{")]
            rec = json.loads(lines[-1]) if lines else {
                "stderr": p.stderr[-2000:]}
            rec.update(rc=p.returncode, wall_s=time.perf_counter() - t)
            report["children"][name] = rec
            print(f"rwkv6_grad_repeat: {name} {json.dumps(rec)}", flush=True)
        loaded = {}
        for n, path in files.items():
            if os.path.exists(path):
                with open(path) as f:
                    loaded[n] = json.load(f)
        for a, b in (("plain_a", "plain_b"), ("f32_a", "f32_b"),
                     ("plain_a", "det"), ("plain_a", "locate")):
            if a in loaded and b in loaded:
                c = compare(loaded[a], loaded[b])
                report["compare"][f"{a}/{b}"] = c
                print(f"rwkv6_grad_repeat: {a} vs {b} {json.dumps(c)}",
                      flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / f"rwkv6_grad_repeat_seed{args.seed}.json", "w") as f:
        json.dump(report, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Control for the gradient limits of ``chip_smoke.py``'s phase 15: what
defects of the backward kernels read on the checks that hold full-width
training.

Run from the repository root on one CUDA device:

    python3 scripts/train_grad_control.py [--seed N]

Each variant (the sound sources, and mutants made from them by one
textual edit) is written and built in a temporary directory, never in the
checkout, and swapped in as the library its wrapper launches:

  * ``no_delta``: flash's backward without the D = rowsum(dO o O) term;
  * ``group_not_summed``: dK and dV of a KV head from the first query head
    of its group only;
  * ``cap_derivative_dropped``: no (1 - tanh^2) factor under a soft-cap;
  * ``rglru_shifted``: the RG-LRU backward's da_t = g_t h_t, not h_{t-1};
  * ``wkv6_dw_dropped``: the WKV6 backward writes dw = 0;
  * ``wkv6_adjoint_undecayed``: G_{t-1} = G_t + r dy^T (no diag(w_t));
  * ``wkv6_dk_no_bonus``: dk without its bonus term r u (v . dy).

recurrentgemma-2b at full width (seed ``--seed``, 88 by default, as the
smoke's weights and batch) takes phase 15's step-1 gradient pass (B=2 x
4,096 tokens, two microbatches) through each flash and RG-LRU variant,
read against its plain-pinned twin (loss difference, per-leaf relative
gradient error) and the float32 yardstick (the ratio of the distances),
as phase 15 reads it.  recurrentgemma has no attention soft-cap, so the
cap mutant is read on gemma2-2b (attention cap 50) at full width as well,
with the sound variant beside it.  The WKV6 variants are read the same way
on rwkv6-7b at full width and phase 15's depth (``RWKV_TRAIN_LAYERS``),
but with its gradients against the twin that keeps WKV6's forward kernel
and takes its plain backward (``GRAD_TWIN``; the loss still against the
plain twin's).
``--families`` limits a run to some of the three kernel families (each
family's variants, the sound one, and the models they are read on).

Every variant is also read on phase 14's kernel checks of its family (dq,
dk, dv against the plain version on each case, RG-LRU bitwise, WKV6's six
gradients within twice the float32 bound); the sound variant on all.

It prints one line per (model, variant) and writes every reading to
``chiprun_out/train_grad_control_seed<N>.json``.  It exits non-zero if the
sound variant fails a check, a mutant passes every kernel check, or a
variant never launched its backward kernel; a mutant inside the full-width
gradient limits is reported (the cap's derivative does not move a model
whose scores stay far below its cap).
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

# a mutant: (family, pattern, replacement, expected matches), its defect
# above it
MUTANTS = {
    # the backward without D: dS = P dP instead of P (dP - D)
    "no_delta": ("flash", r"p \* \(dp - D\) \* dcap", "p * dp * dcap", 1),
    # dK and dV from the first query head of each KV group only
    "group_not_summed": ("flash", r"hh < rep; \+\+hh", "hh < 1; ++hh", 1),
    # the soft-cap's derivative (1 - tanh^2) dropped
    "cap_derivative_dropped": ("flash", r"dcap = 1\.f - th \* th;",
                               "dcap = 1.f;", 1),
    # da_t = g_t h_t instead of g_t h_{t-1}: the saved state one step late
    "rglru_shifted": ("rglru", r"const int shift = 1;",
                      "const int shift = 0;", 1),
    # the WKV6 backward without dw
    "wkv6_dw_dropped": ("wkv6", r"dwg\[o\] = a\[2\];", "dwg[o] = 0.f;", 1),
    # the adjoint carried back without its decay: G += r dy^T
    "wkv6_adjoint_undecayed": (
        "wkv6", r"g\[i\]\[x\] = fmaf\(o\.w\[i\], g\[i\]\[x\], "
                r"o\.r\[i\] \* o\.d\[x\]\);",
        "g[i][x] += o.r[i] * o.d[x];", 1),
    # dk without the bonus's share r_i u_i (v . dy)
    "wkv6_dk_no_bonus": ("wkv6", r"dkg\[o\] = a\[1\] \+ r_i \* u_i \* vd;",
                         "dkg[o] = a[1];", 1),
}
#: the models each variant is read on: the flash and RG-LRU variants on
#: recurrentgemma-2b; the sound one and the cap mutant on gemma2-2b too;
#: the WKV6 variants and the sound one on rwkv6-7b
CAP_ARCH = "gemma2_2b"
FAMILIES = ("flash", "rglru", "wkv6")


def read_arch(name: str, smoke) -> str:
    """The model a mutant is judged on."""
    if name == "cap_derivative_dropped":
        return CAP_ARCH
    return smoke.RWKV_ARCH if MUTANTS[name][0] == "wkv6" else smoke.LM_ARCH


def mutate(src: str, pattern: str, repl: str, count: int) -> str:
    out, n = re.subn(pattern, repl, src)
    if n != count:
        raise RuntimeError(f"mutation {pattern!r} matched {n} times, "
                           f"expected {count}")
    return out


def use_variant(name, libs, fams) -> None:
    """Swap in ``name``'s library for the family it mutates, the sound
    library for the other (the sound variant: both sound)."""
    for fam, kern in fams.items():
        mutated = MUTANTS.get(name, ("",))[0] == fam
        kern.lib = libs[(fam, name if mutated else "sound")].lib


def read_kernels(smoke, libs, fams, mutants) -> dict:
    """Each variant on phase 14's kernel checks of the families it touches
    (the sound one on every family read; untimed): flash's dq, dk, dv
    against the plain version on each case, RG-LRU's bitwise, WKV6's six
    gradients within twice ``ref.f32_bwd_error_bound``."""
    out = {}
    for name in ["sound", *mutants]:
        use_variant(name, libs, fams)
        touched = set(fams) if name == "sound" else {MUTANTS[name][0]}
        cases = []
        if touched & {"flash", "rglru"}:
            cases += [smoke.flash_bwd_case(*c, seed=41 + i, timed=False)
                      for i, c in enumerate(smoke.FLASH_BWD_CASES)]
            cases += [smoke.rglru_bwd_case(*c, seed=51 + i, timed=False)
                      for i, c in enumerate(smoke.RGLRU_BWD_CASES)]
        if "wkv6" in touched:
            cases += [smoke.wkv6_bwd_case(*c, seed=61 + i, timed=False)
                      for i, c in enumerate(smoke.WKV_BWD_CASES)]
        out[name] = dict(cases=cases, caught=any(c["caught"] for c in cases))
        print(f"[control] kernels variant={name} caught_by="
              + ",".join(c["case"] for c in cases if c["caught"]), flush=True)
    return out


def read_model(smoke, arch, libs, variants, fams) -> dict:
    """Every variant's step-1 gradient pass on ``arch`` at full width (at
    phase 15's depth), read as phase 15 reads it: the loss against the
    plain twin's, the gradients against the twin of `GRAD_TWIN` and the
    float32 yardstick, the launches against phase 15's count."""
    import torch

    from repro_torch.optim import tree_map

    cfg, params, _ = smoke.full_model(
        arch, smoke.RWKV_TRAIN_LAYERS if arch == smoke.RWKV_ARCH else None)
    loss_tol, grad_tol = smoke.train_limits(arch)
    want = smoke.train_launches(cfg, 1)
    batch = smoke.train_batches(cfg)[0]
    names = smoke._leaf_names(params)
    # the gradient twin (`GRAD_TWIN`: rwkv6's takes the forward kernels)
    # and the plain twin's loss
    twin = smoke.GRAD_TWIN.get(arch, True)
    use_variant("sound", libs, fams)
    loss_p, g_p, _ = smoke.grad_pass(cfg, params, batch, plain=twin)
    if twin is not True:
        loss_p = smoke.twin_loss(cfg, params, batch)
    p32 = tree_map(lambda t: t.float(), params)
    _, g_f, _ = smoke.grad_pass(cfg, p32, batch, plain=True, microbatches=1)
    del p32
    torch.cuda.empty_cache()
    _, all_p32 = smoke.grad_distances(g_p, g_f)
    out = {}
    for name in variants:
        use_variant(name, libs, fams)
        smoke.lm_reset()
        loss_k, g_k, secs = smoke.grad_pass(cfg, params, batch, plain=False)
        launches = smoke.lm_launches()
        per, all_twin = smoke.grad_distances(g_k, g_p)
        _, all_k32 = smoke.grad_distances(g_k, g_f)
        del g_k
        torch.cuda.empty_cache()
        worst = max(range(len(per)), key=lambda i: per[i])
        got = dict(layers=cfg.n_layers, loss_diff=abs(loss_k - loss_p),
                   grad_rel_err_max=per[worst],
                   grad_rel_err_max_leaf=names[worst],
                   grad_rel_err_all=all_twin, f32_ratio=all_k32 / all_p32,
                   launches=launches, launches_expected=launches == want,
                   grad_pass_s=secs, per_leaf=dict(zip(names, per)))
        got["caught"] = not (got["loss_diff"] <= loss_tol
                             and got["grad_rel_err_max"] <= grad_tol
                             and got["f32_ratio"] <= smoke.GRAD_F32_RATIO)
        out[name] = got
        print(f"[control] arch={arch} variant={name} "
              f"loss_diff={got['loss_diff']:.4e} "
              f"grad_rel_err_max={got['grad_rel_err_max']:.4e} "
              f"({got['grad_rel_err_max_leaf']}) "
              f"grad_rel_err_all={all_twin:.4e} "
              f"f32_ratio={got['f32_ratio']:.4f} caught={got['caught']} "
              f"launches={json.dumps(launches, separators=(',', ':'))}",
              flush=True)
    for kern in fams.values():
        kern.lib = kern.LIBRARY.lib
    del params, g_p, g_f
    torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_grad_control: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=smoke.SEED)
    ap.add_argument("--families", default=",".join(FAMILIES),
                    help="kernel families whose variants are read")
    args = ap.parse_args(argv)
    smoke.SEED = args.seed                   # weights and batches follow it
    chosen = [f for f in args.families.split(",") if f]
    if not chosen or set(chosen) - set(FAMILIES):
        ap.error(f"--families takes some of {FAMILIES}")
    from repro_torch.kernels import build as B
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.rg_lru import kernel as rk
    from repro_torch.kernels.rwkv6 import kernel as wk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fams = {f: k for f, k in (("flash", fk), ("rglru", rk), ("wkv6", wk))
            if f in chosen}
    mutants = [k for k, v in MUTANTS.items() if v[0] in fams]
    srcs = {fam: k._SRC.read_text() for fam, k in fams.items()}
    texts = {(fam, "sound"): src for fam, src in srcs.items()}
    for name in mutants:
        fam, *m = MUTANTS[name]
        texts[(fam, name)] = mutate(srcs[fam], *m)
    readings: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.environ[B.BUILD_DIR_ENV] = tmp
        libs = {}
        for (fam, name), text in texts.items():
            path = Path(tmp) / f"{fam}_{name}.cu"
            path.write_text(text)
            libs[(fam, name)] = B.NvccLibrary(f"{fam}_{name}", path, (),
                                              fams[fam]._bind)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(libs)) as pool:
            list(pool.map(lambda lib: lib.build(), libs.values()))
        print(f"[control] built {len(libs)} variants in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        kernels = read_kernels(smoke, libs, fams, mutants)
        archs: dict = {}
        for name in mutants:
            archs.setdefault(read_arch(name, smoke), ["sound"]).append(name)
        for arch, variants in archs.items():
            readings[arch] = read_model(smoke, arch, libs, variants, fams)
        os.environ.pop(B.BUILD_DIR_ENV, None)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
               seed=args.seed, families=list(fams),
               limits={a: dict(zip(("loss_tol", "grad_tol"),
                                   smoke.train_limits(a)),
                               f32_ratio=smoke.GRAD_F32_RATIO)
                       for a in readings},
               mutants={k: MUTANTS[k][:3] for k in mutants},
               readings=readings, kernels=kernels)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    tag = "" if len(fams) == len(FAMILIES) else "_" + "_".join(fams)
    (out_dir / f"train_grad_control_seed{args.seed}{tag}.json").write_text(
        json.dumps(out, indent=1))
    caught = {a: {k: v["caught"] for k, v in r.items()}
              for a, r in readings.items()}
    print(json.dumps(caught), flush=True)
    rc = 0
    if any(r["sound"] for r in caught.values()):
        print("train_grad_control: the sound kernels fail a check",
              file=sys.stderr)
        rc = 1
    missed = [k for k in mutants if not caught[read_arch(k, smoke)][k]]
    if missed:
        print(f"train_grad_control: mutants inside the gradient limits: "
              f"{missed}", file=sys.stderr)
        rc = int(any(k != "cap_derivative_dropped" for k in missed))
    if kernels["sound"]["caught"] or not all(
            kernels[k]["caught"] for k in mutants):
        print("train_grad_control: the kernel checks misjudge a variant",
              file=sys.stderr)
        rc = 1
    if not all(v["launches_expected"] for r in readings.values()
               for v in r.values()):
        print("train_grad_control: a variant's launches are not phase 15's "
              "count", file=sys.stderr)
        rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

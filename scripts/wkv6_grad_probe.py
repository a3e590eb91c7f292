"""Where rwkv6-7b's step-1 gradients part between the kernel path and its
plain twin: the forward kernel, the backward kernel, or the model's own
sensitivity to how its bf16 WKV outputs round.

Run from the repository root on one CUDA device:

    python3 scripts/wkv6_grad_probe.py [--seed N] [--layers L]

rwkv6-7b at full width and ``--layers`` layers (phase 15's depth by
default), weights and batch from seed ``--seed`` (88), takes phase 15's
step-1 gradient pass (B=2 x 4,096 in two microbatches) several times, the
WKV6 op's forward and backward each taken from a version named
``<forward>_fwd/<backward>_bwd``:

  * ``plain_fwd/plain_bwd`` is phase 15's plain twin, and the same weights
    in float32 through the plain versions are the yardstick;
  * ``kernel_fwd/kernel_bwd`` is phase 15's kernel path;
  * ``plain_fwd/kernel_bwd`` keeps the backward kernel and the plain
    forward;
  * ``jitter<e>_fwd/kernel_bwd`` is the plain forward whose float32
    outputs are scaled by 1 +/- 2^-e before they round to bf16 (the sign
    a hash of each value's bits, so the layer's recomputation under remat
    gives the same bits): a forward exact to float32 rounding, whose bf16
    y rounds the other way where it lies near a rounding midpoint, as a
    forward summed in another order does.

Each pass is read against the twin as phase 15 reads it (per-leaf
relative distance, the distance over all leaves, the float32 ratio), and
each forward against the plain forward with the same backward kernel
(``fwd_vs_plain``), per leaf and per layer: the distance and the ratio of
the gradient norms.  If the jittered forwards move the gradients as far as
the forward kernel does, the model amplifies any rounding of y, and no
limit on the distance to the plain twin tells a sound forward kernel from
a broken backward.

During the kernel path every WKV6 call of the first microbatch is checked
on the model's own inputs: each forward call against a float64 evaluation
(y within `ref.f32_error_bound` plus half a bf16 unit in the last place,
the final state within the bound; the share of y that differs from the
plain forward's, and its mean signed difference in units in the last
place), each backward call against ``ref.wkv6_bwd`` (each gradient's
largest |difference| over twice ``ref.f32_bwd_error_bound``; elements whose
bound is 0 must agree exactly).

It prints one line per pass and per checked call and writes everything
to ``chiprun_out/wkv6_grad_probe_seed<N>.json``; it exits non-zero if a
checked call lies outside its bound.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")
#: the exponents e of the jittered forwards' 1 +/- 2^-e
JITTERS = (22, 19, 16)


def bound_fracs(got, want, bound) -> dict:
    """Each gradient's largest |got - want| / (2 bound); where the bound is
    0 a difference reads as inf."""
    import torch

    out = {}
    for name, g, w, b in zip(NAMES, got, want, bound):
        d = (g.double() - w.double()).abs()
        f = torch.where(d == 0, torch.zeros_like(d), d / (2 * b))
        out[name] = float(f.max())
    return out


def wkv6_f64(r, k, v, w, u, state):
    """`ref.wkv6` in float64: (y, final state)."""
    import torch

    rf, kf, vf, wf = (x.double() for x in (r, k, v, w))
    uf = u.double()[None, :, :, None]
    s = state.double()
    ys = torch.empty(rf.shape, dtype=torch.float64, device=rf.device)
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        ys[:, t] = torch.einsum("bhn,bhnm->bhm", rf[:, t], s + uf * kv)
        s = wf[:, t, :, :, None] * s + kv
    return ys, s


def bf16_half_ulp(x):
    """Half a bf16 unit in the last place at |x| (float64)."""
    import torch

    _, e = torch.frexp(x.double())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float64), e - 9)


def jittered(ref, exp: int, flips: list, keep: int):
    """The plain forward with its float32 y scaled by 1 +/- 2^-exp before
    the cast; records the share of y that rounds otherwise for the first
    ``keep`` calls."""
    import torch

    def fwd(r, k, v, w, u, state):
        y32, sT = ref.wkv6(r.float(), k, v, w, u, state)
        bits = y32.view(torch.int32).to(torch.int64)
        sign = (((bits * 2654435761) >> 16) & 1).to(torch.float32) * 2 - 1
        y = (y32 * (1 + sign * 2.0 ** -exp)).to(r.dtype)
        if len(flips) < keep:
            flips.append(float((y != y32.to(r.dtype)).float().mean()))
        return y, sT
    return fwd


def layer_of(name: str) -> str:
    parts = name.split("/")
    return "/".join(parts[:2]) if parts[0] == "layers" else parts[0]


def compare(smoke, names, g, ref_g) -> dict:
    """``g`` against ``ref_g``: per-leaf distances, their largest, the
    distance over all leaves, and per layer the distance and the ratio of
    the gradient norms."""
    import torch

    per, all_d = smoke.grad_distances(g, ref_g)
    worst = max(range(len(per)), key=lambda i: per[i])
    layers: dict = {}
    for n, a, b in zip(names, g, ref_g):
        acc = layers.setdefault(layer_of(n), [0.0, 0.0, 0.0])
        acc[0] += float(torch.linalg.vector_norm(
            (a.float() - b.float()).ravel(), dtype=torch.float64)) ** 2
        acc[1] += float(torch.linalg.vector_norm(
            a.float().ravel(), dtype=torch.float64)) ** 2
        acc[2] += float(torch.linalg.vector_norm(
            b.float().ravel(), dtype=torch.float64)) ** 2
    return dict(grad_rel_err_max=per[worst],
                grad_rel_err_max_leaf=names[worst], grad_rel_err_all=all_d,
                per_layer={k: dict(dist=(d / n2) ** 0.5,
                                   norm_ratio=(n1 / n2) ** 0.5)
                           for k, (d, n1, n2) in layers.items()},
                per_leaf=dict(zip(names, per)))


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("wkv6_grad_probe: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=smoke.SEED)
    ap.add_argument("--layers", type=int, default=smoke.RWKV_TRAIN_LAYERS)
    args = ap.parse_args(argv)
    smoke.SEED = args.seed
    from repro_torch.kernels.rwkv6 import kernel, ops, ref
    from repro_torch.optim import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params, _ = smoke.full_model(smoke.RWKV_ARCH, args.layers)
    batch = smoke.train_batches(cfg)[0]
    names = smoke._leaf_names(params)
    keep = cfg.n_layers
    impl = ops._impl
    fcalls: list = []
    bcalls: list = []

    def checked_fwd(r, k, v, w, u, s):
        """The forward kernel, held against float64 and the plain forward
        on the same inputs for the first microbatch's first calls."""
        y, sT = kernel.wkv6(r, k, v, w, u, s)
        if len(fcalls) < keep:
            y64, s64 = wkv6_f64(r, k, v, w, u, s)
            yb, sb = ref.f32_error_bound(r.float(), k.float(), v.float(),
                                         w, u, s)
            yp, _ = ref.wkv6(r, k, v, w, u, s)
            lim = yb + torch.maximum(bf16_half_ulp(y64),
                                     bf16_half_ulp(y.double()))
            dy_k = (y.double() - y64).abs()
            dy_p = (yp.double() - y64).abs()
            ds = (sT.double() - s64).abs()
            ulp = 2 * bf16_half_ulp(yp.double())
            diff = (y.double() - yp.double()) / ulp
            row = dict(call=len(fcalls),
                       y_frac=float((dy_k / lim).max()),
                       y_frac_plain=float((dy_p / lim).max()),
                       state_frac=float(torch.where(
                           ds == 0, torch.zeros_like(ds), ds / sb).max()),
                       y_differs=float((y != yp).float().mean()),
                       y_diff_mean_ulp=float(diff.mean()),
                       y_diff_signed_by_y_ulp=float(
                           (diff * torch.sign(yp.double())).mean()),
                       y_diff_max_ulp=float(diff.abs().max()))
            del y64, s64, yb, sb, yp, lim, dy_k, dy_p, ds, ulp, diff
            fcalls.append(row)
            print("[probe] fwd " + json.dumps(
                {k: (f"{x:.4g}" if isinstance(x, float) else x)
                 for k, x in row.items()}), flush=True)
        return y, sT

    def checked_bwd(*a):
        """The backward kernel, held against the plain one on the same
        inputs for the first microbatch's calls."""
        got = kernel.wkv6_bwd(*a)
        if len(bcalls) < keep:
            want = ref.wkv6_bwd(*a)
            bound = ref.f32_bwd_error_bound(*a)
            rel = {n: float(torch.linalg.vector_norm((g - x).double())
                            / torch.linalg.vector_norm(x.double()).clamp_min(
                                1e-300))
                   for n, g, x in zip(NAMES, got, want)}
            row = dict(call=len(bcalls), fracs=bound_fracs(got, want, bound),
                       rel=rel, dy_absmax=float(a[6].float().abs().max()))
            del want, bound
            bcalls.append(row)
            print(f"[probe] bwd {row['call']} fracs="
                  + json.dumps({k: f"{x:.3g}" for k, x in row["fracs"].items()})
                  + f" dy_absmax={row['dy_absmax']:.4g}", flush=True)
        return got

    def run(fwd, bwd, p=params, microbatches=smoke.TRAIN_MB):
        ops._impl = lambda r: (fwd, bwd)
        try:
            loss, grads, secs = smoke.grad_pass(cfg, p, batch, plain=False,
                                                microbatches=microbatches)
        finally:
            ops._impl = impl
        return loss, grads, secs

    t0 = time.perf_counter()
    loss_p, g_p, _ = run(ref.wkv6, ref.wkv6_bwd)
    p32 = tree_map(lambda t: t.float(), params)
    loss_f, g_f, _ = run(ref.wkv6, ref.wkv6_bwd, p=p32, microbatches=1)
    del p32
    torch.cuda.empty_cache()
    _, all_p32 = smoke.grad_distances(g_p, g_f)
    loss_pk, g_pk, _ = run(ref.wkv6, kernel.wkv6_bwd)
    flips: dict = {}
    sides = [("kernel", checked_fwd)] + [
        (f"jitter{e}", jittered(ref, e, flips.setdefault(f"jitter{e}", []),
                                keep)) for e in JITTERS]
    passes = {"plain_fwd/kernel_bwd": dict(
        loss=loss_pk, loss_diff=abs(loss_pk - loss_p),
        vs_twin=compare(smoke, names, g_pk, g_p),
        f32_ratio=smoke.grad_distances(g_pk, g_f)[1] / all_p32)}
    for side, fwd in sides:
        bwd = checked_bwd if side == "kernel" else kernel.wkv6_bwd
        loss, g, secs = run(fwd, bwd)
        key = f"{side}_fwd/kernel_bwd"
        _, all_k32 = smoke.grad_distances(g, g_f)
        passes[key] = dict(loss=loss, loss_diff=abs(loss - loss_p),
                           vs_twin=compare(smoke, names, g, g_p),
                           fwd_vs_plain=compare(smoke, names, g, g_pk),
                           f32_ratio=all_k32 / all_p32, grad_pass_s=secs,
                           y_differs=flips.get(side))
        del g
        torch.cuda.empty_cache()
        a, b = passes[key]["vs_twin"], passes[key]["fwd_vs_plain"]
        print(f"[probe] pass {key} loss_diff={abs(loss - loss_p):.4e} "
              f"vs_twin max={a['grad_rel_err_max']:.4e} "
              f"({a['grad_rel_err_max_leaf']}) all={a['grad_rel_err_all']:.4e}"
              f" fwd_vs_plain max={b['grad_rel_err_max']:.4e} "
              f"({b['grad_rel_err_max_leaf']}) all={b['grad_rel_err_all']:.4e}"
              f" f32_ratio={all_k32 / all_p32:.4f}"
              + (f" y_differs_mean={sum(flips[side]) / len(flips[side]):.4g}"
                 if side in flips else ""), flush=True)
    kd = [c["y_differs"] for c in fcalls]
    print(f"[probe] kernel forward y_differs_mean={sum(kd) / len(kd):.4g}",
          flush=True)
    for key, p in passes.items():
        rows = p.get("fwd_vs_plain", p["vs_twin"])["per_layer"]
        print(f"[probe] per_layer {key} " + " ".join(
            f"{k.split('/')[-1]}:{v['dist']:.3g}/{v['norm_ratio']:.3g}"
            for k, v in rows.items()), flush=True)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
               seed=args.seed, layers=cfg.n_layers, twin_loss=loss_p,
               f32_loss=loss_f, twin_f32_dist=all_p32, jitters=JITTERS,
               passes=passes, fwd_calls=fcalls, bwd_calls=bcalls,
               wall_s=time.perf_counter() - t0)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"wkv6_grad_probe_seed{args.seed}.json").write_text(
        json.dumps(out, indent=1))
    bad = [f"bwd {c['call']}" for c in bcalls
           if not all(f <= 1.0 for f in c["fracs"].values())]
    bad += [f"fwd {c['call']}" for c in fcalls
            if not (c["y_frac"] <= 1.0 and c["state_frac"] <= 1.0)]
    if bad:
        print(f"wkv6_grad_probe: kernel calls outside the float32 bound: "
              f"{bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

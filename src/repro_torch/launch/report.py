"""Render the dry-run and roofline tables from the dry run's records (a
port of ``repro.launch.report``, on the port's record keys: ``count_s``,
``aten_ops`` and ``memory.fits_80g``), and the memory read of each
(``--what memory``: peak, where it falls, the largest buffer there).

  PYTHONPATH=src python -m repro_torch.launch.report [--dir artifacts/dryrun]
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load(dir_: str, mesh: str = "single", variant: str = "") -> list[dict]:
    out = []
    suffix = f"_{mesh}{('_' + variant) if variant else ''}.json"
    for f in sorted(glob.glob(os.path.join(dir_, f"*{suffix}"))):
        base = os.path.basename(f)[: -len(suffix)]
        if not variant and any(base.endswith(x)
                               for x in ("_opt", "_v1", "_v2", "_v3")):
            continue
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def fmt_bytes(b) -> str:
    return f"{b / 2**30:.2f}"


def roofline_table(recs: list[dict]) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant | "
           "model TFLOPs | useful | roofline frac | mem GiB | fits |")
    sep = "|" + "---|" * 11
    rows = [hdr, sep]
    for r in recs:
        if "error" in r:
            rows.append(f"| {r['arch']} | {r['shape']} | - | - | - | ERROR "
                        "| - | - | - | - | -- |")
            continue
        rl = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.4f} | "
            f"{rl['memory_s']:.4f} | {rl['collective_s']:.4f} | "
            f"{rl['dominant']} | "
            f"{rl['model_flops'] / 1e12:.0f} | {rl['useful_ratio']:.2f} | "
            f"{rl['roofline_fraction']:.3f} | "
            f"{fmt_bytes(r['memory']['peak_live_bytes'])} | "
            f"{'yes' if r['memory']['fits_80g'] else 'NO'} |")
    return "\n".join(rows)


def dryrun_table(recs: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | count s | aten ops | collectives (count "
           "by kind) | mem GiB | fits 80G |")
    sep = "|" + "---|" * 8
    rows = [hdr, sep]
    for r in recs:
        if "error" in r:
            rows.append(f"| {r['arch']} | {r['shape']} | {r.get('mesh', '?')} "
                        f"| FAIL | - | {r['error'][:60]} | - | - |")
            continue
        cc = r["collectives"]["count_by_kind"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['count_s']} | "
            f"{r['aten_ops']} | {cc} | "
            f"{fmt_bytes(r['memory']['peak_live_bytes'])} | "
            f"{'yes' if r['memory']['fits_80g'] else 'NO'} |")
    return "\n".join(rows)


def _buffer(b: dict) -> str:
    shape = "x".join(map(str, b["shape"]))
    return (f"{b['bytes'] / 1e9:.3f} GB {b['dtype']} ({shape}) "
            f"{b['op']} at {b['site'] or '-'} {b['node'] or ''}").rstrip()


def memory_table(recs: list[dict]) -> str:
    """Each record's memory read: the peak, whether it fits, how its depth
    was reached, where the peak falls and the largest buffer live there."""
    hdr = ("| arch | shape | mesh | peak GB | fits 80G | depth | peak at | "
           "largest buffer |")
    rows = [hdr, "|" + "---|" * 8]
    for r in recs:
        if "error" in r:
            continue
        m = r["memory"]
        at = m["peak_at"] or {}
        where = f"{at.get('phase')} {at.get('op')} {at.get('site') or '-'}"
        top = _buffer(m["largest"][0]) if m["largest"] else "-"
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{m['peak_live_bytes'] / 1e9:.3f} | "
            f"{'yes' if m['fits_80g'] else 'NO'} | {m.get('depth', '-')} | "
            f"{where} | {top} |")
    return "\n".join(rows)


def pick_hillclimb(recs: list[dict]) -> list[str]:
    """Worst roofline fraction / most collective-bound / most
    paper-representative."""
    ok = [r for r in recs if "roofline" in r]
    worst = min(ok, key=lambda r: r["roofline"]["roofline_fraction"])
    coll = max(ok, key=lambda r: r["roofline"]["collective_s"]
               / max(max(r["roofline"]["compute_s"],
                         r["roofline"]["memory_s"]), 1e-12))
    # paper-representative: the technique is a cluster/EP scheduler; the
    # MoE train cell exercises expert-parallel placement hardest
    rep = next((r for r in ok if r["arch"] == "deepseek_moe_16b"
                and r["shape"] == "train_4k"), ok[0])
    return [f"{r['arch']}/{r['shape']}" for r in (worst, coll, rep)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--variant", default="")
    ap.add_argument("--what", default="roofline",
                    choices=["roofline", "dryrun", "memory", "pick"])
    args = ap.parse_args()
    recs = load(args.dir, args.mesh, args.variant)
    if args.what != "pick":
        # DTensor's choice of collectives may move between torch versions
        print("counted on torch", ", ".join(sorted(
            {r["torch"] for r in recs if "torch" in r})) or "?")
    if args.what == "roofline":
        print(roofline_table(recs))
    elif args.what == "dryrun":
        print(dryrun_table(recs))
    elif args.what == "memory":
        print(memory_table(recs))
    else:
        print("\n".join(pick_hillclimb(recs)))


if __name__ == "__main__":
    main()

"""Roofline terms of a dry-run cell: a port of ``repro.launch.roofline``.

Three terms per (arch x shape x mesh), in seconds:

  compute    = FLOPs_per_device / PEAK_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = collective_bytes_per_device / LINK_BW

The dry run (``launch/dryrun.py``) counts FLOPs and bytes per device.
PyTorch has no compiled module whose text lists its collectives; instead
the dry run runs the port's sharded program and reads each collective op
that DTensor issues (`collective_record`, the counterpart of the
reference's ``parse_collectives`` over the compiled HLO) as a record
``(kind, result_bytes, group_size, site)``, and `collective_stats` weights
each with the reference's ring cost for its group of n devices:

  all-gather      (n-1)/n * result
  reduce-scatter  (n-1)   * result   (result is the scattered shard)
  all-reduce      2(n-1)/n * result
  all-to-all      (n-1)/n * result
  collective-permute       result

Hardware model: one NVIDIA H100 SXM5 (NVIDIA's data sheet, dense, 700 W):
989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s HBM3, and 450 GB/s per
direction of NVLink 4 (18 links).  A 16-wide model axis spans two 8-GPU
nodes; the model assumes every hop runs at the NVLink rate and does not
charge the slower link between the nodes (or between pods).
`HBM_PER_DEVICE` is the memory ``torch.cuda.get_device_properties(0)
.total_memory`` reports on an NVIDIA H100 80GB HBM3.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9
#: torch.cuda.get_device_properties(0).total_memory, NVIDIA H100 80GB HBM3
HBM_PER_DEVICE = 85_017_493_504

#: the collective ops DTensor issues, under the reference's HLO kinds
#: (``wait_tensor`` completes one of them and moves nothing of its own)
COLLECTIVE_OPS = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
}


def collective_record(func, args, out) -> tuple[str, int, int] | None:
    """``(kind, result_bytes, group_size)`` of the op ``func`` called on
    ``args`` with result ``out``, if it is one of `COLLECTIVE_OPS`, else
    None.  The result is what one rank receives: the gathered tensor of an
    all-gather, the scattered part of a reduce-scatter, the whole of an
    all-reduce, the exchanged shard of an all-to-all (a coalesced op: its
    results summed).  The group is the op's own (its last argument, a
    group or a group's name)."""
    import torch

    kind = COLLECTIVE_OPS.get(func.name().replace("::", "."))
    if kind is None:
        return None
    outs = out if isinstance(out, (list, tuple)) else (out,)
    nbytes = sum(t.numel() * t.element_size() for t in outs
                 if isinstance(t, torch.Tensor))
    group = args[-1]
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        group = _resolve_process_group(group)
    return kind, nbytes, group.size()


def ring_cost(kind: str, result_bytes: float, n: int) -> float:
    """Bytes one device sends for ``kind`` over a group of ``n``."""
    n = max(int(n), 1)
    if kind == "all-gather":
        return result_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    if kind == "all-reduce":
        return 2 * result_bytes * (n - 1) / n
    if kind == "all-to-all":
        return result_bytes * (n - 1) / n
    if kind == "collective-permute":
        return result_bytes
    raise ValueError(f"unknown collective {kind!r}")


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    total_bytes: float
    count_by_kind: dict
    top: list = dataclasses.field(default_factory=list)   # largest ops

    def to_json(self):
        return {"bytes_by_kind": self.bytes_by_kind,
                "count_by_kind": self.count_by_kind,
                "total_bytes": self.total_bytes,
                "top": self.top}


def collective_stats(records, n_devices: int) -> CollectiveStats:
    """Ring-weighted bytes per device of ``records``, each ``(kind,
    result_bytes, group_size, site)`` (``group_size`` None: all
    ``n_devices``); the twelve costliest listed in ``top``."""
    bytes_by_kind: dict[str, float] = defaultdict(float)
    count_by_kind: dict[str, int] = defaultdict(int)
    tops = []
    for kind, size, group, op in records:
        cost = ring_cost(kind, size, n_devices if group is None else group)
        bytes_by_kind[kind] += cost
        count_by_kind[kind] += 1
        tops.append((cost, kind, op))
    tops.sort(key=lambda t: -t[0])
    return CollectiveStats(dict(bytes_by_kind),
                           float(sum(bytes_by_kind.values())),
                           dict(count_by_kind),
                           [dict(bytes=round(c), kind=k, op=o)
                            for c, k, o in tops[:12]])


@dataclasses.dataclass
class Roofline:
    flops: float                  # per device
    bytes_accessed: float         # per device
    collective_bytes: float       # per device (ring-weighted)
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float            # 6*N*D (or 2*N*B for decode)
    useful_ratio: float           # model_flops / (flops * n_devices)
    n_devices: int = 1

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful model flops-time / bound time (how close to roofline)."""
        if self.bound_s <= 0:
            return 0.0
        ideal = self.model_flops / (PEAK_FLOPS * max(self.n_devices, 1))
        return ideal / self.bound_s

    def to_json(self):
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "collective_bytes_per_device": self.collective_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "n_devices": self.n_devices,
        }


def roofline_terms(cost: dict, collectives: CollectiveStats, n_devices: int,
                   model_flops: float) -> Roofline:
    """``cost``: per-device ``flops`` and ``bytes accessed``."""
    flops = float(cost.get("flops", 0.0) or 0.0)
    byts = float(cost.get("bytes accessed", 0.0) or 0.0)
    cb = collectives.total_bytes
    total_flops = flops * n_devices
    return Roofline(
        flops=flops, bytes_accessed=byts, collective_bytes=cb,
        compute_s=flops / PEAK_FLOPS,
        memory_s=byts / HBM_BW,
        collective_s=cb / LINK_BW,
        model_flops=model_flops,
        useful_ratio=(model_flops / total_flops) if total_flops else 0.0,
        n_devices=n_devices,
    )

"""Explicit pin of the LM kernel ops to their plain versions on the card,
and their route for meta tensors.

With ``REPRO_LM_KERNELS=plain`` the ops ``flash_attention``,
``rglru_scan`` and ``wkv6`` run their plain PyTorch versions (``ref.py``)
on CUDA tensors instead of launching their kernels; that is how a run is
compared with its plain twin on the same card.  Unset (or empty), a CUDA
tensor always launches the kernel.  The pin never moves work to the CPU.

A meta tensor holds no data and computes nothing: the ops take it through
a shape-only route (outputs of the right shapes and dtypes, under autograd
too, and the scratch their kernels allocate), and each call charges the
operations and bytes its kernel would do to the meters that
`meta_charges` opened; the dry run (``launch/dryrun.py``) counts a step
that way.  Inside `shape_route` the ops take that route on tensors of any
device (their outputs uninitialized): a program on real tensors then
allocates what it would on the card, which is how the dry run's memory
read on meta is held against the same program's on CPU tensors.

A DTensor is refused (`refuse_dtensor`): a sharded program reaches the
ops through its kernel regions (``models.sharding.local_region``), which
hand them local shards; nothing gathers a whole tensor for a kernel.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading

PIN_ENV = "REPRO_LM_KERNELS"


def pinned_plain() -> bool:
    """True when ``REPRO_LM_KERNELS`` pins the LM ops to their plain
    versions; any value other than "plain" or empty raises."""
    raw = os.environ.get(PIN_ENV, "").strip()
    if raw not in ("", "plain"):
        raise ValueError(f"{PIN_ENV} must be 'plain' or unset, got {raw!r}")
    return raw == "plain"


def refuse_dtensor(op: str, *ts) -> None:
    """Raise if any of ``ts`` is a DTensor: the ops take plain tensors."""
    dt = sys.modules.get("torch.distributed.tensor")
    if dt is not None and any(isinstance(t, dt.DTensor) for t in ts):
        raise TypeError(f"{op} takes plain tensors, got a DTensor: a sharded "
                        "program calls it on local shards through its kernel "
                        "region (models.sharding.local_region)")


_SHAPE_ROUTE = [0]


@contextlib.contextmanager
def shape_route():
    """The LM ops take their shape-only route on every device inside the
    block (on any thread: autograd may run a backward on its own)."""
    with _METERS_LOCK:
        _SHAPE_ROUTE[0] += 1
    try:
        yield
    finally:
        with _METERS_LOCK:
            _SHAPE_ROUTE[0] -= 1


def shape_only(t) -> bool:
    """True to take the shape-only route on ``t``: a meta tensor, or any
    inside `shape_route`."""
    return t.device.type == "meta" or _SHAPE_ROUTE[0] > 0


def use_kernel(op: str, t) -> bool:
    """True to launch ``op``'s kernel on ``t``: a CUDA tensor, unpinned.  A
    CPU tensor takes the plain version, a meta tensor the ops' shape-only
    route (this returns False for it too); any other device raises."""
    if t.device.type in ("cpu", "meta"):
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{op} runs on cuda or cpu, not {t.device}")
    return not pinned_plain()


_METERS: list[list] = []
_METERS_LOCK = threading.Lock()


@contextlib.contextmanager
def meta_charges():
    """Collect the charges of the meta route's calls made inside the block:
    yields a list that gets one ``(op, flops, bytes)`` per call, from any
    thread (autograd may run a backward on its own)."""
    calls: list = []
    with _METERS_LOCK:
        _METERS.append(calls)
    try:
        yield calls
    finally:
        with _METERS_LOCK:
            _METERS.remove(calls)


def charge(op: str, flops: float, n_bytes: float) -> None:
    """One meta-route call of ``op``: its kernel's operations and the bytes
    it reads and writes (each operand and result once)."""
    with _METERS_LOCK:
        for calls in _METERS:
            calls.append((op, float(flops), float(n_bytes)))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)

"""Placement-engine backend protocol (paper §4.2 placement primitives).

A *backend* answers the virtual-space placement queries that the offline
builder (§4) issues while constructing a schedule.  Every backend must
implement the same placement semantics:

  forward  — earliest (machine, start >= ready) fitting the task's demand
             for its whole duration, ties broken by lowest start then lowest
             machine index;
  backward — latest (machine, start) with start + dur <= deadline, ties by
             highest start then lowest machine index;

plus the per-pass *hint* memoization keyed by (stage, anchor, demand): the
slot of a previously placed identical task is a sound bound because the
space only fills up within a pass.

Backends differ in *how* they search.  The reference backend rescans the
grid per task; the batched backend answers a whole ready-set through one
(n_tasks, m, T)-shaped feasibility scan and walks the precomputed
candidates with cheap live rechecks, the scan itself dispatched to the
device's kernel (core/engine/kernels.py).  Both are tick-identical by
construction (see docs/architecture.md for the monotonicity argument).

Sessions are *per placement pass* (one PlaceTasksF/PlaceTasksB call): the
hint table and any cached feasibility data must not outlive the pass,
because the builder rolls the space back between candidate variants and
cached data is only a sound upper bound while capacity monotonically
decreases.
"""

from __future__ import annotations

import abc
import os
import threading
import typing
from typing import TYPE_CHECKING, Callable, Sequence

import numpy as np

if TYPE_CHECKING:  # avoid a hard cycle: space does not import the engine
    from ..space import Space

FORWARD = "fwd"
BACKWARD = "bwd"

# key of the per-pass hint table: (stage, anchor, demand bytes)
HintKey = tuple


class PeerTask(typing.NamedTuple):
    """A ready-but-not-yet-placed task announced to the session.

    Peers are a *prefetch hint only*: a batched session may scan their
    feasibility alongside the current task to amortize the tensor op, but
    whether peers are announced (and their estimated anchors) can never
    change any placement result.
    """

    tid: int
    anchor: int          # estimated ready tick (fwd) / deadline tick (bwd)
    demand: np.ndarray   # (d,)
    dur_ticks: int


def ceil32(v: np.ndarray) -> np.ndarray:
    """Round float64 demands up to the nearest float32.

    For a float32 grid cell a and float64 demand v, ``a >= v`` iff
    ``a >= ceil32(v)``: comparisons can then run entirely in float32,
    sparing the float64 promotion of every scanned grid slice while
    staying bit-identical to the reference float64 comparison.  This is
    the exactness keystone of every accelerated scan implementation in
    the kernel-dispatch layer (numpy/torch/cuda all compare the same
    float32 pair); a hypothesis property test pins the boundary argument
    (tests/test_placement_kernels.py).
    """
    v = np.asarray(v)
    if v.dtype == np.float32:  # already rounded — passthrough
        return v
    v32 = v.astype(np.float32)
    low = v32.astype(np.float64) < v
    if low.any():
        v32[low] = np.nextafter(v32[low], np.float32(np.inf))
    return v32


class PlacementSession(abc.ABC):
    """One placement pass over a Space in a fixed direction."""

    #: whether the session benefits from PeerTask prefetch announcements
    wants_peers: bool = False

    def __init__(self, space: "Space", direction: str):
        if direction not in (FORWARD, BACKWARD):
            raise ValueError(f"bad direction {direction!r}")
        self.space = space
        self.direction = direction
        self.hint: dict[HintKey, tuple[int, int]] = {}

    #: sessions that compare in float32 may be handed ceil32-rounded demands
    wants_f32: bool = False

    @abc.abstractmethod
    def place(
        self,
        tid: int,
        v: np.ndarray,
        k: int,
        anchor: int,
        key: HintKey,
        peers_fn: Callable[[], Sequence[PeerTask]] | None = None,
        cap: int | None = None,
    ) -> tuple[int, int]:
        """Find the slot for one task; the caller commits it afterwards.

        ``anchor`` is the ready tick (forward) or deadline tick (backward).
        ``peers_fn`` lazily yields PeerTask prefetch hints.  Returns
        (machine, logical start).

        ``cap`` is a prune bound: the caller will discard the whole pass if
        the found start is >= cap (forward) / <= cap (backward).  A session
        MAY therefore stop searching once it has proven every admissible
        slot is past the cap and return the sentinel (-1, cap) instead of
        the exact slot; the reference session ignores it and lets the
        caller prune after the fact — both yield the same pass outcome.
        """


class PlacementBackend(abc.ABC):
    """Factory of placement sessions; stateless and shareable."""

    name: str = "abstract"

    #: whether sessions() actually consumes the per-spec peer hints — lets
    #: callers skip building prefetch hints for backends that ignore them
    wants_prescan: bool = False

    @abc.abstractmethod
    def session(self, space: "Space", direction: str) -> PlacementSession:
        ...

    def sessions(
        self,
        space: "Space",
        specs: Sequence[tuple[str, Sequence[PeerTask]]],
    ) -> list[PlacementSession]:
        """Multi-variant entry point: one session per sibling variant.

        ``specs`` lists the first placement segment of each sibling branch
        off one shared grid state as (direction, initial ready-set peers).
        Backends MAY evaluate all siblings' feasibility scans in one
        stacked (n_variants, n_tasks, m, W) pass and seed each returned
        session with the results; because every sibling starts from
        exactly the scanned grid state and capacity only decreases within
        its pass, a node-level scan is a sound superset for each branch
        (the same monotonicity argument as per-pass prefetch, so results
        are tick-identical with or without the prescan).

        The default is the degenerate stack: independent unseeded
        sessions, one per spec (the reference backend's behavior).
        """
        return [self.session(space, d) for d, _peers in specs]

    @classmethod
    def available(cls) -> bool:
        return True

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        return f"<PlacementBackend {self.name}>"


_REGISTRY: dict[str, Callable[[], PlacementBackend]] = {}
_INSTANCES: dict[str, PlacementBackend] = {}
# backends are stateless-shareable, but the check-then-create below must
# still be atomic so concurrent builds resolve ONE instance per name
_INSTANCES_LOCK = threading.Lock()

#: env var consulted when build_schedule is not given an explicit backend
BACKEND_ENV = "REPRO_PLACEMENT_BACKEND"
DEFAULT_BACKEND = "batched"


def register_backend(name: str, factory: Callable[[], PlacementBackend]) -> None:
    _REGISTRY[name] = factory


def available_backends() -> list[str]:
    return list(_REGISTRY)


def get_backend(which: str | PlacementBackend | None = None) -> PlacementBackend:
    """Resolve a backend instance from a name, instance, or the environment."""
    if isinstance(which, PlacementBackend):
        return which
    name = which or os.environ.get(BACKEND_ENV) or DEFAULT_BACKEND
    if name not in _REGISTRY:
        raise ValueError(f"unknown placement backend {name!r}; "
                         f"have {sorted(_REGISTRY)}")
    with _INSTANCES_LOCK:
        inst = _INSTANCES.get(name)
        if inst is None:
            inst = _INSTANCES[name] = _REGISTRY[name]()
    return inst

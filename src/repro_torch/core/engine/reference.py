"""Reference placement backend: the original per-task numpy grid search.

Each `place` call runs one full cumsum feasibility scan over the remaining
grid (`Space.earliest_fit` / `Space.latest_fit`), seeded by the per-pass
hint table.  This is the semantic oracle the batched backends — and every
implementation in the kernel-dispatch layer (core/engine/kernels.py) —
must match tick-for-tick, and the baseline the construction benchmark
compares against.  It deliberately bypasses the dispatch layer: the
oracle must not share code with what it oracles.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from .base import (FORWARD, HintKey, PeerTask, PlacementBackend,
                   PlacementSession, register_backend)


class ReferenceSession(PlacementSession):
    wants_peers = False

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
        h = self.hint.get(key)
        if self.direction == FORWARD:
            m, t0 = self.space.earliest_fit(v, k, anchor, h)
        else:
            m, t0 = self.space.latest_fit(v, k, anchor, h)
        self.hint[key] = (m, t0)
        return m, t0


class ReferenceBackend(PlacementBackend):
    name = "reference"

    def session(self, space, direction: str) -> ReferenceSession:
        return ReferenceSession(space, direction)


register_backend("reference", ReferenceBackend)

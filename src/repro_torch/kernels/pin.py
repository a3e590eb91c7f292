"""Explicit pin of the LM kernel ops to their plain versions on the card.

With ``REPRO_LM_KERNELS=plain`` the ops ``flash_attention``,
``rglru_scan`` and ``wkv6`` run their plain PyTorch versions (``ref.py``)
on CUDA tensors instead of launching their kernels; that is how a run is
compared with its plain twin on the same card.  Unset (or empty), a CUDA
tensor always launches the kernel.  The pin never moves work to the CPU.
"""

from __future__ import annotations

import os

PIN_ENV = "REPRO_LM_KERNELS"


def pinned_plain() -> bool:
    """True when ``REPRO_LM_KERNELS`` pins the LM ops to their plain
    versions; any value other than "plain" or empty raises."""
    raw = os.environ.get(PIN_ENV, "").strip()
    if raw not in ("", "plain"):
        raise ValueError(f"{PIN_ENV} must be 'plain' or unset, got {raw!r}")
    return raw == "plain"


def use_kernel(op: str, t) -> bool:
    """True to launch ``op``'s kernel on ``t``: a CUDA tensor, unpinned.  A
    CPU tensor takes the plain version; any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{op} runs on cuda or cpu, not {t.device}")
    return not pinned_plain()

"""Architecture configs of the port (``get(arch_id)`` / ``get_smoke``).

Each module defines ``full()`` (the published hyperparameters) and
``smoke()`` (a tiny same-family config), with the reference's values.
``SHAPES`` names the reference's input-shape cells and `cells()`
enumerates its dry-run grid with the long_500k skip rule applied.
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "deepseek_moe_16b",
    "mixtral_8x7b",
    "qwen2_vl_7b",
    "rwkv6_7b",
    "gemma2_2b",
    "codeqwen15_7b",
    "granite3_8b",
    "phi4_mini_3_8b",
    "recurrentgemma_2b",
    "musicgen_large",
]

# the reference's shape cells: (name, seq_len, global_batch, kind)
SHAPES = {
    "train_4k":    dict(seq=4096,    batch=256, kind="train"),
    "prefill_32k": dict(seq=32768,   batch=32,  kind="prefill"),
    "decode_32k":  dict(seq=32768,   batch=128, kind="decode"),
    "long_500k":   dict(seq=524288,  batch=1,   kind="decode"),
}


def _mod(arch_id: str):
    key = arch_id.replace("-", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}; have {ARCH_IDS}")
    return importlib.import_module(f".{key}", __package__)


def get(arch_id: str):
    return _mod(arch_id).full()


def get_smoke(arch_id: str):
    return _mod(arch_id).smoke()


def cells() -> list[tuple[str, str]]:
    """All (arch, shape) dry-run cells, honoring the long_500k skip rule:
    only a sub-quadratic architecture decodes at 500k."""
    out = []
    for a in ARCH_IDS:
        cfg = get(a)
        for s in SHAPES:
            if s == "long_500k" and not cfg.subquadratic:
                continue  # pure full-attention arch
            out.append((a, s))
    return out

"""Architecture configs of the port (``get(arch_id)`` / ``get_smoke``).

Each module defines ``full()`` (the published hyperparameters) and
``smoke()`` (a tiny same-family config), with the reference's values.
Only the architectures whose mixers and ffns the port runs are listed;
asking for another raises.
"""

from __future__ import annotations

import importlib

ARCH_IDS = ["recurrentgemma_2b", "rwkv6_7b"]

#: reference architectures still to come, and the slice that brings each
LATER = {
    "deepseek_moe_16b": "the MoE slice",
    "mixtral_8x7b": "the MoE slice",
    "qwen2_vl_7b": "the M-RoPE / vision slice",
    "musicgen_large": "the audio slice (sinusoidal positions, codebooks)",
    "gemma2_2b": "a dense-model slice",
    "codeqwen15_7b": "a dense-model slice",
    "granite3_8b": "a dense-model slice",
    "phi4_mini_3_8b": "a dense-model slice",
}


def _mod(arch_id: str):
    key = arch_id.replace("-", "_")
    if key not in ARCH_IDS:
        if key in LATER:
            raise NotImplementedError(f"{arch_id} is not ported yet: it "
                                      f"comes with {LATER[key]}")
        raise KeyError(f"unknown architecture {arch_id!r}; have {ARCH_IDS}")
    return importlib.import_module(f".{key}", __package__)


def get(arch_id: str):
    return _mod(arch_id).full()


def get_smoke(arch_id: str):
    return _mod(arch_id).smoke()

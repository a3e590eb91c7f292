"""recurrentgemma-2b [hybrid]: 26L d=2560 10H (kv=1, MQA) d_ff=7680 v=256000.

Griffin: RG-LRU recurrent blocks + local attention (window 2048), pattern
(rec, rec, attn) [arXiv:2402.19427].  26 layers = 8 triples + 2 recurrent
remainder.  O(1) recurrent state + windowed KV.
"""
from ..models.model import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
        d_ff=7680, vocab=256000, rope_theta=1e4,
        block_pattern=("rglru", "rglru", "local"), window=2048,
        rglru_width=2560, conv_width=4,
        norm_plus_one=True, mlp_kind="geglu", embed_scale=True,
        logit_cap=30.0,
        tie_embeddings=True, subquadratic=True,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=256, rope_theta=1e4,
        block_pattern=("rglru", "rglru", "local"), window=16,
        rglru_width=64, conv_width=4,
        norm_plus_one=True, mlp_kind="geglu", embed_scale=True,
        logit_cap=30.0,
        tie_embeddings=True, subquadratic=True,
    )

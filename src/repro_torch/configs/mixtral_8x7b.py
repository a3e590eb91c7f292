"""mixtral-8x7b [moe]: 32L d=4096 32H (kv=8) d_ff=14336 v=32000.

8 experts top-2, sliding-window attention (4096) [arXiv:2401.04088].
SWA bounds the decode KV cache -> long_500k runs.
"""
from ..models.model import ArchConfig
from ..models.layers import MoEConfig

WINDOW = 4096


def full() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=32000, rope_theta=1e6,
        block_pattern=("local",), window=WINDOW,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=14336,
                      router_mode="topk_softmax"),
        tie_embeddings=False, subquadratic=True,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="mixtral-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, rope_theta=1e6,
        block_pattern=("local",), window=16,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=128, capacity_factor=4.0,
                      router_mode="topk_softmax"),
        tie_embeddings=False, subquadratic=True,
    )

"""rwkv6-7b (Finch) [ssm]: 32L d=4096 attn-free d_ff=14336 v=65536.

Data-dependent decay WKV recurrence, head size 64 [arXiv:2404.05892].
O(1) state -> long_500k runs.
"""
from ..models.model import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-7b", family="ssm",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
        d_ff=14336, vocab=65536,
        block_pattern=("rwkv",), rwkv_head_size=64,
        pos_embedding="none", tie_embeddings=False, subquadratic=True,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256,
        block_pattern=("rwkv",), rwkv_head_size=16,
        pos_embedding="none", tie_embeddings=False, subquadratic=True,
    )

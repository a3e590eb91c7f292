"""phi4-mini-3.8b [dense]: 32L d=3072 24H (kv=8) d_ff=8192 v=200064.

RoPE + SwiGLU + GQA [arXiv:2412.08905].  Full attention -> long_500k
skipped.
"""
from ..models.model import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="phi4-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab=200064, rope_theta=1e4,
        tie_embeddings=True, subquadratic=False,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="phi4-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, head_dim=12,
        d_ff=96, vocab=256, rope_theta=1e4,
        tie_embeddings=True, subquadratic=False,
    )

"""granite-3-8b [dense]: 40L d=4096 32H (kv=8) d_ff=12800 v=49155.

GQA llama-style decoder [hf:ibm-granite].  Full attention -> long_500k
skipped.
"""
from ..models.model import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="granite-3-8b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=12800, vocab=49155, rope_theta=1e4,
        tie_embeddings=True, subquadratic=False,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="granite-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, rope_theta=1e4,
        tie_embeddings=True, subquadratic=False,
    )

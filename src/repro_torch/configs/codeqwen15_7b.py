"""codeqwen1.5-7b [dense]: 32L d=4096 32H (kv=32, MHA) d_ff=13440 v=92416.

qwen1.5 architecture: RoPE theta 1e6, attention qkv bias, SwiGLU
[hf:Qwen/CodeQwen1.5-7B].  Full attention -> long_500k skipped.
"""
from ..models.model import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="codeqwen1.5-7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
        d_ff=13440, vocab=92416, rope_theta=1e6, qkv_bias=True,
        tie_embeddings=False, subquadratic=False,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="codeqwen-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, rope_theta=1e6, qkv_bias=True,
        tie_embeddings=False, subquadratic=False,
    )

"""deepseek-moe-16b [moe]: 28L d=2048 16H (kv=16) d_ff=1408/expert v=102400.

2 shared + 64 routed top-6 fine-grained experts [arXiv:2401.06066].
Layer 0 is a dense SwiGLU (d_ff=10944) per the published config.
Full attention -> long_500k skipped.
"""
from ..models.model import ArchConfig
from ..models.layers import MoEConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, vocab=102400, rope_theta=1e4,
        moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                      router_mode="softmax_topk"),
        first_k_dense=1, dense_ff=10944,
        tie_embeddings=False, subquadratic=False,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=96, vocab=256, rope_theta=1e4,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=96, n_shared=1,
                      capacity_factor=4.0, router_mode="softmax_topk"),
        first_k_dense=1, dense_ff=128,
        tie_embeddings=False, subquadratic=False,
    )

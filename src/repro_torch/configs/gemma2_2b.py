"""gemma2-2b [dense]: 26L d=2304 8H (kv=4) d_ff=9216 v=256000.

Alternating local(4096)/global attention, attn softcap 50, final logit
softcap 30, (1+w) RMSNorm with post-norms, tied embeddings scaled by
sqrt(d) [arXiv:2408.00118].  Local layers bound their KV; global layers
decode against the full cache (linear per step) -> long_500k runs, with
the global-layer cache sharded over the sequence axis.
"""
from ..models.model import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="gemma2-2b", family="dense",
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=9216, vocab=256000, rope_theta=1e4,
        block_pattern=("local", "attn"), window=4096,
        attn_cap=50.0, logit_cap=30.0,
        norm_plus_one=True, post_norm=True, mlp_kind="geglu",
        embed_scale=True, tie_embeddings=True, subquadratic=True,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="gemma2-smoke", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, rope_theta=1e4,
        block_pattern=("local", "attn"), window=16,
        attn_cap=50.0, logit_cap=30.0,
        norm_plus_one=True, post_norm=True, mlp_kind="geglu",
        embed_scale=True, tie_embeddings=True, subquadratic=True,
    )

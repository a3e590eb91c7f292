"""musicgen-large [audio]: 48L d=2048 32H (kv=32, MHA) d_ff=8192 v=2048.

Decoder-only over EnCodec tokens, 4 codebooks with summed embeddings and
per-codebook output heads, sinusoidal positions, LayerNorm-free variant
(we use RMSNorm per the shared substrate; GELU MLP) [arXiv:2306.05284].
The EnCodec frontend and text conditioning are stubs per assignment:
input_specs() provides the token grid directly.  Full attention ->
long_500k skipped.
"""
from ..models.model import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="musicgen-large", family="audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab=2048,
        n_codebooks=4, pos_embedding="sinusoidal", mlp_kind="mlp",
        tie_embeddings=False, subquadratic=False,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="musicgen-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=64,
        n_codebooks=4, pos_embedding="sinusoidal", mlp_kind="mlp",
        tie_embeddings=False, subquadratic=False,
    )

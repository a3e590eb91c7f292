"""qwen2-vl-7b [vlm]: 28L d=3584 28H (kv=4) d_ff=18944 v=152064.

M-RoPE (t/h/w sections 16/24/24), dynamic resolution [arXiv:2409.12191].
Modality frontend is a stub per assignment: input_specs() provides
precomputed patch embeddings which the backbone projects and prepends.
Full attention -> long_500k skipped.
"""
from ..models.model import ArchConfig

N_PATCHES = 256   # stub frontend: fixed patch budget prepended to the text


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-7b", family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
        d_ff=18944, vocab=152064, rope_theta=1e6,
        mrope_sections=(16, 24, 24), qkv_bias=True,
        vlm_patches=N_PATCHES,
        tie_embeddings=False, subquadratic=False,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, rope_theta=1e6,
        mrope_sections=(2, 3, 3), qkv_bias=True, vlm_patches=4,
        tie_embeddings=False, subquadratic=False,
    )

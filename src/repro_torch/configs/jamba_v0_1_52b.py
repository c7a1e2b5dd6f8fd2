"""jamba-v0.1-52b [hybrid] — arXiv:2403.19887.

32L d_model=4096; Mamba:attention 7:1 interleave (attention at index 4 of
each 8-layer Jamba block); MoE (16 experts, top-2, expert ff = 14336) every
2nd layer, dense MLP (14336) otherwise. 32H GQA kv=8. No explicit positional
encoding (the SSM provides position information) — attention runs without
RoPE. vocab=65536, mamba d_state=16 d_conv=4 expand=2. Same numbers as
`repro.configs.jamba_v0_1_52b`."""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    activation="silu",
    use_rope=False,
    n_experts=16,
    top_k=2,
    d_ff_expert=14336,
    n_shared_experts=0,
    moe_period=2,
    moe_offset=1,
    attn_period=8,
    attn_offset=4,
    d_state=16,
    d_conv=4,
    mamba_expand=2,
    capacity_factor=1.25,
    tie_embeddings=False,
    scan_period=8,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-smoke",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
        activation="silu", use_rope=False, n_experts=4, top_k=2,
        d_ff_expert=128, moe_period=2, moe_offset=1, attn_period=8,
        attn_offset=4, d_state=8, d_conv=4, mamba_expand=2,
        capacity_factor=2.0, tie_embeddings=False, scan_period=8,
        ssm_chunk=8)

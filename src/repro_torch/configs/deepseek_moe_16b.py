"""deepseek-moe-16b [moe] — arXiv:2401.06066 (DeepSeekMoE).

28L d_model=2048 16H (MHA, head_dim=128); fine-grained experts: 2 shared +
64 routed, top-6, expert d_ff=1408; first layer dense (d_ff=10944);
vocab=102400. Same numbers as `repro.configs.deepseek_moe_16b`."""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,
    vocab=102400,
    activation="silu",
    n_experts=64,
    top_k=6,
    d_ff_expert=1408,
    n_shared_experts=2,
    moe_period=1,
    moe_offset=0,
    prelude_layers=1,
    capacity_factor=1.25,
    tie_embeddings=False,
    rope_theta=10000.0,
    scan_period=1,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=192, vocab=256, activation="silu", n_experts=8, top_k=2,
        d_ff_expert=32, n_shared_experts=2, moe_period=1, moe_offset=0,
        prelude_layers=1, capacity_factor=2.0, tie_embeddings=False,
        scan_period=1)

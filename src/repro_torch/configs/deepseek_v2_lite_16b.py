"""deepseek-v2-lite-16b [moe, MLA] — arXiv:2405.04434.

27L d_model=2048 16H; MLA kv_lora=512, qk_nope=128, qk_rope=64, v_head=128
(no q compression in Lite); MoE: 2 shared + 64 routed experts, top-6,
expert d_ff=1408; first layer dense (d_ff=10944). vocab=102400. Same
numbers as `repro.configs.deepseek_v2_lite_16b`."""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,             # the single dense (first) layer
    vocab=102400,
    activation="silu",
    mla=True,
    q_lora_rank=None,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
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
        name="deepseek-v2-lite-16b-smoke",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=192, vocab=256,
        activation="silu", mla=True, q_lora_rank=None, kv_lora_rank=32,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, n_experts=8, top_k=2,
        d_ff_expert=32, n_shared_experts=2, moe_period=1, moe_offset=0,
        prelude_layers=1, capacity_factor=2.0, tie_embeddings=False,
        scan_period=1)

"""minicpm3-4b [dense, MLA] — hf:openbmb/MiniCPM3-4B.

62L d_model=2560 40H d_ff=6400 vocab=73448; MLA with q_lora=768,
kv_lora=256, qk_nope=64, qk_rope=32, v_head=64; muP-style embedding and
residual scaling (scale_emb=12, scale_depth=1.4). Same numbers as
`repro.configs.minicpm3_4b`."""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    activation="silu",
    mla=True,
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    emb_scale=12.0,
    residual_scale=1.4 / (62 ** 0.5),
    tie_embeddings=True,
    rope_theta=10000.0,
    scan_period=1,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b-smoke",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160, vocab=256,
        activation="silu", mla=True, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        emb_scale=12.0, residual_scale=1.4 / 2.0, scan_period=1)

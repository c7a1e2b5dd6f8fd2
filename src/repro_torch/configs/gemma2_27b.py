"""gemma2-27b [dense] — arXiv:2408.00118, hf:google/gemma-2-27b.

46L d_model=4608 32H (GQA kv=16, head_dim=128) d_ff=36864 vocab=256000;
local(4096)/global alternating attention (local first), attn softcap 50,
final logit softcap 30, sandwich (pre+post) norms, (1+w) RMSNorm, sqrt(d)
embedding scale, query scale 1/sqrt(144). Same numbers as
`repro.configs.gemma2_27b`; scan_period=2 sets the order the layers run in
(`models.transformer.layer_order`), as there."""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    activation="gelu_tanh",
    window=4096,
    local_global_period=2,
    attn_softcap=50.0,
    logit_softcap=30.0,
    sandwich_norm=True,
    rmsnorm_plus_one=True,
    emb_scale=4608 ** 0.5,
    attn_scale=(4608 / 32) ** -0.5,
    tie_embeddings=True,
    rope_theta=10000.0,
    scan_period=2,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b-smoke",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab=256, activation="gelu_tanh", window=8,
        local_global_period=2, attn_softcap=50.0, logit_softcap=30.0,
        sandwich_norm=True, rmsnorm_plus_one=True, emb_scale=8.0,
        attn_scale=0.25, scan_period=2)

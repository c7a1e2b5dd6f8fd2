"""h2o-danube-1.8b [dense] — arXiv:2401.16818.

24L d_model=2560 32H (GQA kv=8, head_dim=80) d_ff=6912 vocab=32000;
llama+mistral mix with sliding-window attention (4096). Same numbers as
`repro.configs.h2o_danube_1_8b`."""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab=32000,
    activation="silu",
    window=4096,
    tie_embeddings=False,
    rope_theta=10000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b-smoke",
        n_layers=4, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=192, vocab=256, activation="silu", window=8,
        tie_embeddings=False)

"""nemotron-4-340b [dense] — arXiv:2402.16819 (Nemotron-4 340B).

96L d_model=18432 96H GQA kv=8 d_ff=73728 vocab=256000; squared-ReLU
(non-gated) MLP, untied embeddings, RoPE. Same numbers as
`repro.configs.nemotron_4_340b`; the port serves it at its smoke size."""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    activation="relu2",
    gated_mlp=False,
    tie_embeddings=False,
    rope_theta=10000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b-smoke",
        n_layers=4, d_model=96, n_heads=6, n_kv_heads=2, d_ff=384, vocab=256,
        activation="relu2", gated_mlp=False, tie_embeddings=False)

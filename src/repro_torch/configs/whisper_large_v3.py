"""whisper-large-v3 [audio enc-dec] — arXiv:2212.04356.

32 encoder + 32 decoder layers, d_model=1280, 20 heads of 64, non-gated
d_ff=5120, vocab=51866 tied, LayerNorm, GELU MLPs and sinusoidal positions
(no RoPE). The conv frontend is a stub: 1500 precomputed frame embeddings
(30 s of audio at 50 frames a second, the port's
`models.frontends.whisper_frames`) feed the encoder, whose output the
decoder's cross-attention reads. Same numbers as
`repro.configs.whisper_large_v3`."""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    n_layers=32,            # decoder
    n_enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    activation="gelu",
    gated_mlp=False,
    norm="layernorm",
    use_rope=False,
    enc_dec=True,
    enc_positions=1500,
    frontend="audio",
    tie_embeddings=True,
    scan_period=1,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3-smoke",
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, activation="gelu", gated_mlp=False,
        norm="layernorm", use_rope=False, enc_dec=True, enc_positions=24,
        frontend="audio", scan_period=1)

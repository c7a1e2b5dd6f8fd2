"""llava-next-mistral-7b [vlm] — hf:llava-hf/llava-v1.6-mistral-7b-hf.

Mistral-7B backbone: 32L d_model=4096 32H (GQA kv=8, head_dim=128)
d_ff=14336 vocab=32000, sliding window 4096. The anyres vision tower is a
stub: 2880 precomputed patch embeddings (anyres tiling: 5 tiles x 576
patches, the port's `models.frontends.llava_patches`) are prepended to the
text stream. Same numbers as `repro.configs.llava_next_mistral_7b`."""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    activation="silu",
    window=4096,
    frontend="vision",
    n_img_tokens=2880,
    tie_embeddings=False,
    rope_theta=10000.0,
    scan_period=1,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b-smoke",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, activation="silu", window=8, frontend="vision",
        n_img_tokens=8, tie_embeddings=False, scan_period=1)

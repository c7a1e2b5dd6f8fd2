"""falcon-mamba-7b [ssm] — arXiv:2410.05355.

64 pure Mamba-1 layers (attention-free), d_model=4096, d_inner=8192
(expand=2), d_state=16, d_conv=4, dt_rank=256, vocab=65024; RMSNorm on the
B/C/dt streams (the falcon-mamba stabilization). Same numbers as
`repro.configs.falcon_mamba_7b`."""

from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    n_layers=64,
    d_model=4096,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=65024,
    is_ssm=True,
    d_state=16,
    d_conv=4,
    mamba_expand=2,
    bcdt_rms=True,
    tie_embeddings=False,
    ssm_chunk=256,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b-smoke",
        n_layers=4, d_model=64, n_heads=1, n_kv_heads=1, d_ff=0, vocab=256,
        is_ssm=True, d_state=8, d_conv=4, mamba_expand=2, bcdt_rms=True,
        tie_embeddings=False, ssm_chunk=8)

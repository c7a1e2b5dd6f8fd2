from repro_torch.optim.adamw import (  # noqa: F401
    OptimizerConfig, adamw_init, adamw_update, global_norm, clip_by_global_norm,
    warmup_cosine, make_optimizer,
)

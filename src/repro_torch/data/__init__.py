from repro_torch.data.pipeline import DataConfig, SyntheticLM, make_pipeline  # noqa: F401

from repro_torch.checkpoint.manager import CheckpointManager, save_pytree, load_pytree  # noqa: F401

from repro_torch.train.loop import (TrainLoopConfig, SimulatedFailure, run_training)

__all__ = ["TrainLoopConfig", "SimulatedFailure", "run_training"]

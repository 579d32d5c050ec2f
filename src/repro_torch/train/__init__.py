from .trainer import TrainConfig, Trainer, TrainMetrics

__all__ = ["TrainConfig", "Trainer", "TrainMetrics"]

from .engine import TrainStep

__all__ = ["TrainStep"]

"""Vision (counterpart of paddle_tpu/vision): the ResNet family so far;
the rest of the model zoo, the datasets and the transforms wait in
ROADMAP.md, queue A.10."""
from . import models

__all__ = ["models"]

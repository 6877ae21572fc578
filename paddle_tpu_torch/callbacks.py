"""The ``callbacks`` namespace (counterpart of paddle_tpu/callbacks.py):
the training callbacks of ``hapi``."""
from .hapi.callbacks import (  # noqa: F401
    Callback,
    EarlyStopping,
    LRScheduler,
    ModelCheckpoint,
    ProgBarLogger,
)

"""``hapi``: the high-level ``Model`` API (counterpart of
paddle_tpu/hapi). ``hub`` is not ported yet (ROADMAP.md A.10)."""
from . import callbacks  # noqa: F401
from .callbacks import (  # noqa: F401
    Callback,
    EarlyStopping,
    LRScheduler,
    ModelCheckpoint,
    ProgBarLogger,
)
from .dynamic_flops import flops  # noqa: F401
from .model import Model, summary  # noqa: F401

"""paddle.regularizer (counterpart of paddle_tpu/regularizer.py): the
decay coefficients the optimizers take (``optimizer/optimizer.py``)."""
from .optimizer.optimizer import L1Decay, L2Decay  # noqa: F401

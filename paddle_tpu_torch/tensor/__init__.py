"""``paddle.tensor`` (counterpart of paddle_tpu/tensor/__init__.py): the
op modules under the reference's module names."""
from ..ops import creation, linalg, manipulation, math, reduction  # noqa: F401
from ..ops import comparison as logic  # noqa: F401
from ..ops.creation import to_tensor  # noqa: F401
from ..ops.linalg import einsum  # noqa: F401
from ..ops.manipulation import (  # noqa: F401
    argsort, searchsorted, sort, topk, where)
from ..ops.reduction import argmax, argmin, mean, median, std, var  # noqa: F401

from . import attribute  # noqa: F401

search = manipulation
stat = reduction
random = creation

from ..optimizer.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                              ClipGradByValue)
from . import functional, initializer, utils
from .decode import BeamSearchDecoder, Decoder, dynamic_decode
from .layers import *  # noqa: F401,F403
from .layers import __all__ as _layers


class ParamAttr:
    """A parameter's options (the reference's ``paddle.ParamAttr``):
    ``name``, ``initializer`` and ``trainable`` are read by
    ``initializer.create_parameter``; the rest are kept and unused, as
    there."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


__all__ = (["functional", "initializer", "utils", "BeamSearchDecoder",
            "Decoder", "dynamic_decode", "ParamAttr", "ClipGradByNorm",
            "ClipGradByGlobalNorm", "ClipGradByValue"] + list(_layers))

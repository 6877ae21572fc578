from .activation import (
    CELU, ELU, GELU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
    LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6, RReLU, SELU,
    Sigmoid, Silu, Softmax, Softmax2D, Softplus, Softshrink, Softsign, Swish,
    Tanh, Tanhshrink, ThresholdedReLU)
from .common import Dropout, Embedding, Linear
from .container import LayerDict, LayerList, ParameterList, Sequential
from .norm import LayerNorm, RMSNorm
from .transformer import (
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer)

__all__ = ["CELU", "Dropout", "ELU", "Embedding", "GELU", "Hardshrink",
           "Hardsigmoid", "Hardswish", "Hardtanh", "LayerDict", "LayerList",
           "LayerNorm", "LeakyReLU", "Linear", "LogSigmoid", "LogSoftmax",
           "Maxout", "Mish", "MultiHeadAttention", "PReLU", "ParameterList",
           "RMSNorm", "RReLU", "ReLU", "ReLU6", "SELU", "Sequential",
           "Sigmoid", "Silu", "Softmax", "Softmax2D", "Softplus",
           "Softshrink", "Softsign", "Swish", "Tanh", "Tanhshrink",
           "ThresholdedReLU", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer"]

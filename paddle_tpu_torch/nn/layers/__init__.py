from .activation import (
    CELU, ELU, GELU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
    LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6, RReLU, SELU,
    Sigmoid, Silu, Softmax, Softmax2D, Softplus, Softshrink, Softsign, Swish,
    Tanh, Tanhshrink, ThresholdedReLU)
from .common import (
    AlphaDropout, Bilinear, ChannelShuffle, CosineSimilarity, Dropout,
    Dropout2D, Dropout3D, Embedding, Flatten, Fold, Identity, Linear, Pad1D,
    Pad2D, Pad3D, PixelShuffle, PixelUnshuffle, Unflatten, Unfold, Upsample,
    UpsamplingBilinear2D, UpsamplingNearest2D, ZeroPad2D)
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .loss import (
    BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss, CrossEntropyLoss,
    CTCLoss, HingeEmbeddingLoss, HSigmoidLoss, KLDivLoss, L1Loss,
    MarginRankingLoss, MSELoss, MultiLabelSoftMarginLoss, MultiMarginLoss,
    NLLLoss, PairwiseDistance, RNNTLoss, SmoothL1Loss, SoftMarginLoss,
    TripletMarginLoss, TripletMarginWithDistanceLoss)
from .norm import (
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
    LocalResponseNorm, RMSNorm, SpectralNorm, SyncBatchNorm)
from .pooling import (
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
    AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D, MaxUnPool1D,
    MaxUnPool2D, MaxUnPool3D)
from .rnn import (
    GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell, RNNCellBase, SimpleRNN,
    SimpleRNNCell)
from .transformer import (
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer)

__all__ = [name for name in dir() if not name.startswith("_")
           and name not in ("activation", "common", "container", "conv",
                            "loss", "norm", "pooling", "rnn",
                            "transformer")]

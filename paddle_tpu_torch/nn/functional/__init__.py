from .activation import (
    celu, elu, elu_, gelu, glu, gumbel_softmax, hardshrink, hardsigmoid,
    hardswish, hardtanh, leaky_relu, log_sigmoid, log_softmax, maxout, mish,
    prelu, relu, relu6, relu_, rrelu, selu, sigmoid, silu, softmax, softmax_,
    softplus, softshrink, softsign, swish, tanh, tanh_, tanhshrink,
    thresholded_relu)
from .attention import (scaled_dot_product_attention, sparse_attention,
                        variable_length_attention)
from .common import (
    affine_grid, alpha_dropout, bilinear, channel_shuffle, cosine_similarity,
    dropout, dropout2d, dropout3d, embedding, fold, grid_sample, interpolate,
    label_smooth, linear, normalize, pixel_shuffle, pixel_unshuffle,
    sequence_mask, temporal_shift, unfold, upsample, zeropad2d)
from .conv import (
    conv1d, conv1d_transpose, conv2d, conv2d_transpose, conv3d,
    conv3d_transpose, deformable_conv)
from .loss import (
    binary_cross_entropy, binary_cross_entropy_with_logits,
    class_center_sample, cosine_embedding_loss, cross_entropy, ctc_loss,
    ctc_loss_dense, dice_loss, hinge_embedding_loss, hsigmoid_loss,
    huber_loss, kl_div, l1_loss, log_loss, margin_cross_entropy,
    margin_ranking_loss, mse_loss, multi_label_soft_margin_loss,
    multi_margin_loss, nll_loss, npair_loss, pairwise_distance, rnnt_loss,
    sigmoid_cross_entropy_with_logits, sigmoid_focal_loss, smooth_l1_loss,
    soft_margin_loss, softmax_with_cross_entropy, square_error_cost,
    triplet_margin_loss, triplet_margin_with_distance_loss, warpctc)
from .norm import (
    batch_norm_infer, batch_norm_train, group_norm, instance_norm,
    layer_norm, local_response_norm, rms_norm)
from .pooling import (
    adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d,
    adaptive_max_pool1d, adaptive_max_pool2d, adaptive_max_pool3d,
    avg_pool1d, avg_pool2d, avg_pool3d, max_pool1d, max_pool2d, max_pool3d,
    max_unpool1d, max_unpool2d, max_unpool3d)
from ...ops.manipulation import diag_embed, one_hot, pad
from ..decode import gather_tree

__all__ = [name for name in dir() if not name.startswith("_")
           and name not in ("activation", "attention", "common", "conv",
                            "loss", "norm", "pooling")]

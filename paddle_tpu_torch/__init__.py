"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for one H100.

The JAX package (``paddle_tpu``) is the reference this port is held
against; the port imports nothing from it and never imports ``jax``. It
keeps the reference's module layout, so each module here names its
counterpart there. Plain tensor work is PyTorch; every Pallas kernel of
the reference becomes a hand-written CUDA kernel for ``sm_90a`` under
``csrc/``, built at first use (``_build.py``).

Entry points run on the card unless the caller passes ``device="cpu"``
(``device.resolve_device``). The reference runs float32 matmuls at
'highest' precision, so TF32 is turned off here for both cuBLAS and
cuDNN: the two packages then compute comparable float32 numbers. Its
bfloat16 and float16 products sum in float32, so cuBLAS is also told not
to sum a bf16 or float16 GEMM's split-K partials in the narrow type, which
PyTorch allows by default (``allow_bf16_reduced_precision_reduction``,
``allow_fp16_reduced_precision_reduction``).

The top level holds what the reference's does for the op layer: the
``paddle.*`` tensor functions (``ops``), dtype names and the default
dtype (``core.dtype``), places (``core.place``), the typed errors
(``core.enforce``), ``Scalar`` / ``IntArray``, ``grad`` / ``no_grad`` /
``enable_grad``, ``seed`` and the RNG state (``framework.random``), and
the in-place spellings ``reshape_``, ``squeeze_``, ``unsqueeze_``,
``tanh_`` and ``scatter_``. The dtype names (``float32`` ...) are the
``torch.dtype`` objects; every dtype argument also takes the reference's
strings. The port's tensor is ``torch.Tensor``: ``Tensor`` names it, and
``ops.METHODS`` holds the reference's tensor methods as functions. The
training front end sits at the top too, as in the reference: ``save`` /
``load`` (``framework.io``), ``Model`` / ``summary`` / ``flops``
(``hapi``), and the ``amp``, ``autograd``, ``io``, ``metric`` and
``callbacks`` modules.
"""

import torch

from .device import resolve_device

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False

from . import amp, autograd, callbacks, hapi, io, metric  # noqa: E402
from . import ops, tensor  # noqa: E402
from .core.autograd import grad  # noqa: E402
from .core.dispatch import enable_grad, no_grad, set_grad_enabled  # noqa: E402,E501
from .core.dtype import get_default_dtype, set_default_dtype  # noqa: E402
from .core.enforce import (  # noqa: E402
    EnforceNotMet, InvalidArgumentError, NotFoundError, OutOfRangeError,
    UnimplementedError, enforce)
from .core.place import (  # noqa: E402
    CPUPlace, CUDAPinnedPlace, CUDAPlace, CustomPlace, NPUPlace, TPUPlace,
    device_count, get_all_custom_device_type, get_device,
    is_compiled_with_cuda, is_compiled_with_custom_device,
    is_compiled_with_tpu, register_custom_device, set_device)
from .core.scalar import IntArray, Scalar  # noqa: E402
from .core.tensor import Parameter  # noqa: E402
from .framework.io import load, save  # noqa: E402
from .framework.random import get_rng_state, seed, set_rng_state  # noqa: E402,E501
from .hapi import Model, flops, summary  # noqa: E402
from .ops import linalg, extras  # noqa: E402,F401
from .ops.creation import (  # noqa: E402
    arange, assign, bernoulli, clone, diag, diagflat, empty, empty_like, eye,
    full, full_like, linspace, logspace, meshgrid, multinomial, normal,
    numel, ones, ones_like, rand, randint, randn, randperm, standard_normal,
    to_tensor, tril, triu, uniform, zeros, zeros_like)
from .ops.math import (  # noqa: E402
    abs, acos, acosh, add, addmm, asin, asinh, atan, atan2, atanh, bmm,
    cast, ceil, clip, clip_by_norm, conj, cos, cosh, cross, cumprod, cumsum,
    deg2rad, diagonal, digamma, dist, divide, dot, erf, erfinv, exp, expm1,
    floor, floor_divide, fmax, fmin, frac, heaviside, hypot, increment,
    inner, isfinite, isinf, isnan, kron, lerp, lgamma, log, log1p, log2,
    log10, logaddexp, logcumsumexp, logit, matmul, maximum, minimum, mm,
    mod, mode, multiply, mv, nan_to_num, nanmedian, neg, outer, pow,
    rad2deg, real, reciprocal, remainder, renorm, round, rsqrt, scale, sign,
    sin, sinh, sqrt, square, squared_l2_norm, stanh, subtract, tan, tanh,
    trace, trunc)
from .ops.reduction import (  # noqa: E402
    all, amax, amin, any, argmax, argmin, count_nonzero, logsumexp, max,
    mean, median, min, nanmean, nansum, prod, quantile, std, sum, var)
from .ops.manipulation import (  # noqa: E402
    argsort, as_strided, broadcast_tensors, broadcast_to, bucketize, chunk,
    concat, diag_embed, diff, expand, expand_as, fill, fill_diagonal,
    fill_diagonal_tensor, flatten, flip, gather, gather_nd, index_add,
    index_put, index_sample, index_select, kthvalue, masked_fill,
    masked_select, moveaxis, multiplex, nonzero, one_hot, pad,
    put_along_axis, repeat_interleave, reshape, reverse, roll, rot90,
    scatter, scatter_nd, scatter_nd_add, searchsorted, sort, split, squeeze,
    stack, strided_slice, swapaxes, t, take_along_axis, tile, topk,
    transpose, unbind, unfold, unique, unique_consecutive, unsqueeze,
    unstack, where)
from .ops.manipulation import slice_ as slice  # noqa: E402,A001
from .ops.comparison import (  # noqa: E402
    allclose, bitwise_and, bitwise_not, bitwise_or, bitwise_xor, equal,
    equal_all, greater_equal, greater_than, is_empty, isclose, less_equal,
    less_than, logical_and, logical_not, logical_or, logical_xor,
    not_equal)
from .ops.extras import (  # noqa: E402
    add_n, angle, as_complex, as_real, broadcast_shape, check_shape,
    complex, crop, disable_signal_handler, floor_mod, frexp, gcd, iinfo,
    imag, is_complex, is_floating_point, is_integer, lcm, nanquantile,
    poisson, randint_like, rank, set_printoptions, sgn, shape, shard_index,
    take, tolist, tril_indices, triu_indices, vsplit)
from .ops.linalg import (  # noqa: E402
    bincount, cholesky, corrcoef, cov, einsum, histogram, multi_dot,
    tensordot)
from .ops.extras import _make_inplace  # noqa: E402

Tensor = torch.Tensor
reshape_ = _make_inplace("reshape_", reshape)
squeeze_ = _make_inplace("squeeze_", squeeze)
unsqueeze_ = _make_inplace("unsqueeze_", unsqueeze)
tanh_ = _make_inplace("tanh_", tanh)
scatter_ = _make_inplace("scatter_", scatter)


def dtype(name):
    """The canonical name of a dtype spec (``paddle.dtype``)."""
    from .core.dtype import canonical_name

    return canonical_name(name)


def is_grad_enabled():
    return torch.is_grad_enabled()


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def get_flags(name=None):
    from .core import flags

    return flags.get_flags(name)


def set_flags(d):
    from .core import flags

    return flags.set_flags(d)


def get_cuda_rng_state():
    return get_rng_state()


def set_cuda_rng_state(state):
    set_rng_state(state)


# dtype names (``paddle.float32`` ...)
bool = torch.bool  # noqa: A001
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

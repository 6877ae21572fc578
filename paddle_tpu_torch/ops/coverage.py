"""The op-coverage list: every op of the reference's inventory
(``paddle_tpu/ops/ops.yaml``, 375 names) that the port has not registered
yet, with the ROADMAP.md item it waits for. A name of the inventory is
ported when the port registers a primitive of that name
(``core.dispatch.WRAPPERS``, after ``load_all()``);
``tests/test_torch_ops.py`` fails on any name that is neither.
"""
from __future__ import annotations

import importlib

# the modules that register the port's primitives
MODULES = (
    "paddle_tpu_torch.ops",
    "paddle_tpu_torch.nn",
    "paddle_tpu_torch.nn.layers.rnn",
    "paddle_tpu_torch.nn.utils",
    "paddle_tpu_torch.models.llama",
    "paddle_tpu_torch.kernels.fused_ce",
)

_A7 = "A.7"    # parallel and distributed
_A10 = "A.10"  # domain APIs

WAITING = {
    **dict.fromkeys(
        ("fft", "fft2", "fftn", "fftshift", "hfft", "ifft", "ifft2",
         "ifftn", "ifftshift", "ihfft", "irfft", "irfft2", "irfftn", "rfft",
         "rfft2", "rfftn"), _A10),
    **dict.fromkeys(
        ("_gather_scatter", "_gather_scatter_ue", "_send_uv", "segment_max",
         "segment_mean", "segment_min", "segment_sum"), _A10),
    **dict.fromkeys(("frame", "istft_op", "overlap_add", "stft_op"), _A10),
    **dict.fromkeys(("box_coder", "prior_box", "roi_align", "roi_pool"),
                    _A10),
    **dict.fromkeys(("fake_quantize_dequantize", "quantize_linear"), _A10),
    **dict.fromkeys(("cond", "while_loop"), "A.6"),
    **dict.fromkeys(("_sharded", "parallel_softmax_cross_entropy",
                     "moe_mlp", "sequence_parallel_attention"), _A7),
}


def load_all():
    """Import every module that registers primitives."""
    for name in MODULES:
        importlib.import_module(name)

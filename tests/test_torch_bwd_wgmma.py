"""The host side of the bf16 flash-attention backward kernels on wgmma.

The kernels themselves run only on the card (chip_smoke.py holds them
against their plain versions there). What surrounds them is Python and
C text that the CPU can check: the TMA alignment rule the wrapper applies
before a launch (an operand TMA cannot read in place is copied and
counted in ``tma_copies``), the ctypes signatures against the C entry
points they bind, and the dispatch of bf16 launches to the wgmma kernels
alone.
"""
import re
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch import _build
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.tools import mma_probe

B, N, H, HKV = 2, 24, 4, 2


def _qkv_views(d, fused):
    """q, k, v [B, N, H(kv), D] bf16: contiguous, or strided views of one
    fused projection output as the fused-QKV Llama hands them over."""
    if not fused:
        return (torch.zeros(B, N, H, d, dtype=torch.bfloat16),
                torch.zeros(B, N, HKV, d, dtype=torch.bfloat16),
                torch.zeros(B, N, HKV, d, dtype=torch.bfloat16))
    qkv = torch.zeros(B, N, (H + 2 * HKV) * d, dtype=torch.bfloat16)
    q, k, v = qkv.split((H * d, HKV * d, HKV * d), dim=-1)
    return (q.view(B, N, H, d), k.view(B, N, HKV, d),
            v.view(B, N, HKV, d))


class TestTmaAlignment:
    @pytest.mark.parametrize("d", fa.HEAD_DIMS)
    @pytest.mark.parametrize("fused", [False, True])
    def test_aligned_views_pass_untouched(self, d, fused):
        xs = _qkv_views(d, fused)
        assert all(fa.tma_aligned(x) for x in xs)
        before = fa.tma_copies
        out = fa._tma_operands(*xs)
        assert fa.tma_copies == before
        assert all(a is b for a, b in zip(out, xs))

    def test_length_one_axes_do_not_count(self):
        # B = 1 and one kv head: the strides of those axes are never used
        x = torch.zeros(1, N, 1, 64, dtype=torch.bfloat16).as_strided(
            (1, N, 1, 64), (3, 64, 5, 1))
        assert fa.tma_aligned(x)

    @pytest.mark.parametrize("how", ["offset", "row_stride", "head_stride"])
    def test_misaligned_views_are_copied_and_counted(self, how):
        d = 64
        if how == "offset":      # address 2 bytes past a 16-byte boundary
            base = torch.arange(B * N * H * d + 1, dtype=torch.bfloat16)
            x = base[1:].view(B, N, H, d)
        elif how == "row_stride":   # a row of H*D + 4 elements
            x = torch.randn(B, N, H * d + 4).bfloat16()[..., :H * d]
            x = x.view(B, N, H, d) if x.is_contiguous() else \
                x.unflatten(-1, (H, d))
        else:                    # heads D + 4 elements apart
            x = torch.randn(B, N, H, d + 4).bfloat16()[..., :d]
        assert not fa.tma_aligned(x)
        before = fa.tma_copies
        (y,) = fa._tma_operands(x)
        assert fa.tma_copies == before + 1
        assert y is not x and fa.tma_aligned(y)
        assert y.is_contiguous() and torch.equal(y, x)

    def test_float32_is_never_copied(self):
        x = torch.randn(B, N, H, 68)[..., :64]
        before = fa.tma_copies
        (y,) = fa._tma_operands(x)
        assert y is x and fa.tma_copies == before

    def test_cpu_backward_takes_the_plain_path_without_copies(self):
        gen = torch.Generator().manual_seed(0)
        q, k, v, dout = (torch.randn(B, N, H, 68, generator=gen)
                         .bfloat16()[..., :64] for _ in range(4))
        out, lse = fa.flash_attention(q, k, v, causal=True)
        before = fa.tma_copies
        got = fa.flash_attention_backward(q, k, v, out, lse, dout, True)
        want = fa.flash_attention_backward_reference(
            q.contiguous(), k.contiguous(), v.contiguous(), out, lse,
            dout.contiguous(), True)
        assert fa.tma_copies == before
        for x, y in zip(got, want):
            assert torch.equal(x, y)


CSRC = Path(_build.CSRC)


def _c_entry_points(source):
    """``{name: parameter count}`` of the ``int pt_*(...)`` functions in
    the ``extern "C"`` block of ``csrc/<source>.cu``."""
    text = (CSRC / (source + ".cu")).read_text()
    block = text[text.index('extern "C" {'):]
    found = {}
    for m in re.finditer(r"\bint\s+(pt_\w+)\s*\(([^)]*)\)", block):
        found[m.group(1)] = len([p for p in m.group(2).split(",")
                                 if p.strip()])
    return found


@pytest.mark.parametrize("source,signatures", [
    ("flash_attention_bwd", fa._BWD_SIGNATURES),
    ("flash_attention", fa._SIGNATURES),
    ("mma_probe", mma_probe._SIGNATURES),
])
def test_ctypes_signatures_match_the_c_entry_points(source, signatures):
    found = _c_entry_points(source)
    assert set(signatures) <= set(found)
    for name, argtypes in signatures.items():
        assert found[name] == len(argtypes), name


def test_bf16_backward_dispatches_only_to_the_wgmma_kernels():
    text = (CSRC / "flash_attention_bwd.cu").read_text()
    entry = text[text.index('extern "C" {'):]
    # every bf16 branch of both entry points launches a tc:: kernel
    bf16 = re.findall(r"dtype == 1 && head_dim == (\d+)\)\s*return (\S+)<",
                      entry)
    assert sorted(bf16) == sorted([
        ("256", "tc::launch_dq256"), ("128", "tc::launch_dq"),
        ("64", "tc::launch_dq"), ("256", "tc::launch_dkv256"),
        ("128", "tc::launch_dkv"), ("64", "tc::launch_dkv")])
    assert "<__nv_bfloat16" not in text.replace(
        "__nv_bfloat162", "")   # no bf16 instantiation of the SIMT kernels
    assert "wgmma_bf16.cuh" in _build.HEADERS["flash_attention_bwd"]
    assert "wgmma_bf16.cuh" in _build.HEADERS["mma_probe"]


def test_probe_lists_every_wgmma_form_with_a_tolerance():
    forms = {code for _, code, _, _ in mma_probe.FORMS}
    assert forms == set(range(8)) and set(mma_probe.TOL) == forms
    gen = torch.Generator().manual_seed(0)
    # each wgmma form computes what its mma.sync counterpart computes, at
    # its twin's tolerance (form 7, tn with A MN-major: the dW product)
    for form, twin in ((4, 0), (5, 1), (6, 3), (7, 2)):
        assert mma_probe.FORMS[form][2:] == mma_probe.FORMS[twin][2:]
        assert mma_probe.TOL[form] == mma_probe.TOL[twin]
        a, b = mma_probe.inputs(form, gen, "cpu")
        want = mma_probe.plain(form, a, b)
        assert want.shape == ((512, 128) if form == 6 else (512, 512))
        assert torch.equal(want, mma_probe.plain(twin, a, b))

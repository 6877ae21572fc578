"""Plant faults in the attention of ``chip_smoke.py`` phase 15(b)/(c), or
in the fused lm_head + CE kernels of phase 16(b), and show that the
phase's limits catch them, on one GPU.

    python3 paddle_tpu_torch/tools/amp_faults.py [--seed N] [--fp16-model]

Runs ``chip_smoke.amp_train`` (llama1b with float32 weights under O1,
three AdamW steps through the flash kernels, then the same steps through
their plain versions) sound in bf16 and in float16, then with each fault
planted on the kernel side only. A fault wraps the kernels' wrappers and
leaves their sources alone:

  bf16_rounding   float16 only: q, k, v and dO rounded to bf16's
                  precision before the float16 kernels (attention
                  computed at bf16's precision)
  causal_flipped  the kernels given the opposite causal flag

With ``--fp16-model`` it runs ``chip_smoke.fp16_train`` instead (the
float16 llama1b with the fused tail, the default GradScaler, three AdamW
steps on the kernels then on every plain version), sound, then with each
fault planted on the fused CE kernels' side only:

  fce_tile_twice     the forward's first 256-column vocab tile summed
                     twice into the log-sum-exp (a split counted twice)
  fce_last_chunk     dW's last vocab chunk left at zero (the ragged last
                     chunk's dW product not written)

and prints, per run, which limit caught it (loss, gradients, or another
check of the phase).

With ``--o2`` it runs ``chip_smoke.o2_train`` (phase 17(b): llama1b
decorated to bf16 or float16 and trained under O2 with the fused tail,
three AdamW steps on the kernels then on every plain version) sound in
both dtypes, then ``causal_flipped`` in both, ``fce_tile_twice`` in bf16
and ``fce_last_chunk`` in float16, against ``O2_LOSS_RTOL`` /
``O2_GRAD_RTOL``.

Each run reads the losses' and the sampled gradients' distance from the
plain versions' (``chip_smoke.AMP_LOSS_RTOL`` / ``AMP_GRAD_RTOL``, or
``FP16_LOSS_RTOL`` / ``FP16_GRAD_RTOL``, lifted for the reading, every
other check of the phase kept) and judges it against the limits. It
prints one JSON line per run and exits 1 if a sound run fails or a faulty
one passes.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def _bf16_rounding(fwd, bwd):
    def rounded(x):
        return x.to(torch.bfloat16).to(x.dtype)

    def fault_fwd(q, k, v, causal=False, scale=None, segment_ids=None):
        return fwd(rounded(q), rounded(k), rounded(v), causal, scale,
                   segment_ids)

    def fault_bwd(q, k, v, out, lse, dout, causal=False, scale=None,
                  segment_ids=None):
        return bwd(rounded(q), rounded(k), rounded(v), out, lse,
                   rounded(dout), causal, scale, segment_ids)
    return fault_fwd, fault_bwd


def _causal_flipped(fwd, bwd):
    def fault_fwd(q, k, v, causal=False, scale=None, segment_ids=None):
        return fwd(q, k, v, not causal, scale, segment_ids)

    def fault_bwd(q, k, v, out, lse, dout, causal=False, scale=None,
                  segment_ids=None):
        return bwd(q, k, v, out, lse, dout, not causal, scale, segment_ids)
    return fault_fwd, fault_bwd


def _fce_tile_twice(fwd, bwd):
    def fault_fwd(h, w, labels):
        return fwd(h, torch.cat([w, w[:, :256]], dim=1).contiguous(), labels)
    return fault_fwd, bwd


def _fce_last_chunk(fwd, bwd):
    from paddle_tpu_torch.kernels import fused_ce as fc

    def fault_bwd(h, w, labels, lse, g_t, events=None):
        dh, dw = bwd(h, w, labels, lse, g_t, events)
        dw[:, fc.chunk_plan(w.shape[1])[-1][0]:] = 0
        return dh, dw
    return fwd, fault_bwd


FAULTS = {"bf16_rounding": _bf16_rounding, "causal_flipped": _causal_flipped,
          "fce_tile_twice": _fce_tile_twice,
          "fce_last_chunk": _fce_last_chunk}
RUNS = (("bfloat16", None), ("float16", None), ("float16", "bf16_rounding"),
        ("float16", "causal_flipped"), ("bfloat16", "causal_flipped"))
FP16_MODEL_RUNS = (None, "fce_tile_twice", "fce_last_chunk")
O2_RUNS = (("bfloat16", None), ("float16", None),
           ("bfloat16", "causal_flipped"), ("float16", "causal_flipped"),
           ("bfloat16", "fce_tile_twice"), ("float16", "fce_last_chunk"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--o2", action="store_true",
                    help="phase 17(b): llama1b under O2, faults in the flash "
                         "and the fused CE kernels")
    ap.add_argument("--fp16-model", action="store_true",
                    help="phase 16(b)'s float16 model, faults in the fused "
                         "CE kernels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("amp_faults: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import flash_attention as fa

    if args.fp16_model:
        sys.exit(fp16_model_faults(cs, args.seed))
    if args.o2:
        sys.exit(o2_faults(cs, args.seed))

    limits = {"loss": dict(cs.AMP_LOSS_RTOL), "grad": dict(cs.AMP_GRAD_RTOL)}
    cs.AMP_LOSS_RTOL = dict.fromkeys(limits["loss"], math.inf)
    cs.AMP_GRAD_RTOL = dict.fromkeys(limits["grad"], math.inf)
    saved = fa.flash_attention, fa.flash_attention_backward
    wrong = 0
    for name, fault in RUNS:
        dtype = getattr(torch, name)
        if fault:
            fa.flash_attention, fa.flash_attention_backward = \
                FAULTS[fault](*saved)
        try:
            res = cs.amp_train(args.seed, dtype)
            loss, grad = res["loss_rel_err"], max(res["grad_rel_err"].values())
            caught = (loss > limits["loss"][dtype]
                      or grad > limits["grad"][dtype])
            row = {"loss_rel_err": loss, "grad_rel_err": res["grad_rel_err"]}
        except AssertionError as e:     # another check of the phase
            caught, row = True, {"failed": str(e)[:2000]}
        finally:
            fa.flash_attention, fa.flash_attention_backward = saved
            torch.cuda.empty_cache()
        wrong += caught != bool(fault)
        print(json.dumps(dict(
            run="%s %s" % (name, fault or "sound"), caught=caught,
            loss_limit=limits["loss"][dtype], grad_limit=limits["grad"][dtype],
            device=torch.cuda.get_device_name(0), **row)), flush=True)
    sys.exit(1 if wrong else 0)


def fp16_model_faults(cs, seed):
    """Phase 16(b) sound and with each of ``FP16_MODEL_RUNS``' faults
    planted on the fused CE wrappers; returns the exit code."""
    from paddle_tpu_torch.kernels import fused_ce as fc

    limits = {"loss": cs.FP16_LOSS_RTOL, "grad": cs.FP16_GRAD_RTOL}
    cs.FP16_LOSS_RTOL = cs.FP16_GRAD_RTOL = math.inf
    saved = fc.fused_lm_head_ce_forward, fc.fused_lm_head_ce_backward
    wrong = 0
    for fault in FP16_MODEL_RUNS:
        if fault:
            fc.fused_lm_head_ce_forward, fc.fused_lm_head_ce_backward = \
                FAULTS[fault](*saved)
        try:
            res = cs.fp16_train(seed)
            loss, grad = res["loss_rel_err"], max(res["grad_rel_err"].values())
            by = [k for k, v in (("loss", loss), ("gradients", grad))
                  if v > limits[k[:4]]]
            caught = bool(by)
            row = {"loss_rel_err": loss, "grad_rel_err": res["grad_rel_err"],
                   "caught_by": by}
        except AssertionError as e:     # another check of the phase
            caught, row = True, {"failed": str(e)[:2000]}
        finally:
            fc.fused_lm_head_ce_forward, fc.fused_lm_head_ce_backward = saved
            torch.cuda.empty_cache()
        wrong += caught != bool(fault)
        print(json.dumps(dict(
            run="float16 model %s" % (fault or "sound"), caught=caught,
            loss_limit=limits["loss"], grad_limit=limits["grad"],
            device=torch.cuda.get_device_name(0), **row)), flush=True)
    return 1 if wrong else 0


def o2_faults(cs, seed):
    """Phase 17(b) sound and with each of ``O2_RUNS``' faults planted on
    the flash or the fused CE wrappers; returns the exit code."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ce as fc

    limits = {"loss": dict(cs.O2_LOSS_RTOL), "grad": dict(cs.O2_GRAD_RTOL)}
    cs.O2_LOSS_RTOL = dict.fromkeys(limits["loss"], math.inf)
    cs.O2_GRAD_RTOL = dict.fromkeys(limits["grad"], math.inf)
    wrong = 0
    for name, fault in O2_RUNS:
        dtype = getattr(torch, name)
        mod, attrs = ((fc, ("fused_lm_head_ce_forward",
                            "fused_lm_head_ce_backward"))
                      if fault and fault.startswith("fce") else
                      (fa, ("flash_attention", "flash_attention_backward")))
        saved = tuple(getattr(mod, a) for a in attrs)
        if fault:
            for a, f in zip(attrs, FAULTS[fault](*saved)):
                setattr(mod, a, f)
        try:
            res = cs.o2_train(seed, dtype)
            loss, grad = res["loss_rel_err"], max(res["grad_rel_err"].values())
            by = [k for k, v in (("loss", loss), ("gradients", grad))
                  if v > limits[k[:4]][dtype]]
            caught = bool(by)
            row = {"loss_rel_err": loss, "grad_rel_err": res["grad_rel_err"],
                   "caught_by": by}
        except AssertionError as e:     # another check of the phase
            caught, row = True, {"failed": str(e)[:2000]}
        finally:
            for a, f in zip(attrs, saved):
                setattr(mod, a, f)
            torch.cuda.empty_cache()
        wrong += caught != bool(fault)
        print(json.dumps(dict(
            run="O2 %s %s" % (name, fault or "sound"), caught=caught,
            loss_limit=limits["loss"][dtype],
            grad_limit=limits["grad"][dtype],
            device=torch.cuda.get_device_name(0), **row)), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    main()

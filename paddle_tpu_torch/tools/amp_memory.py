"""Peak device memory of one llama1b training step under each AMP mode, on
one GPU.

    python3 paddle_tpu_torch/tools/amp_memory.py [--seed N]

Builds ``chip_smoke.py``'s llama1b training row (16 layers, recompute,
8 x 1024, AdamW, ``FLAGS_fused_lm_head_ce``) twice: in bf16 from its
config (phase 6b's model), and in float32 then ``amp.decorate``-d to bf16
(phase 17(b)'s). Each runs one warm-up step, then one step per mode with
the peak counter reset before it: no AMP, ``auto_cast`` O1 and O2. Prints
one JSON line a run: the memory allocated before the step (weights,
optimizer slots) and the step's peak, in GB, beside the card's name.
"""
from __future__ import annotations

import argparse
import json
import sys
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
GB = 1e9


def _step(model, opt, ids, labels, ctx):
    with ctx:
        loss = model(ids, labels)
    loss.backward()
    opt.step()
    opt.clear_grad()
    torch.cuda.synchronize()
    return loss.item()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("amp_memory: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    rng = np.random.default_rng(args.seed)
    ids, labels = (torch.from_numpy(rng.integers(0, 32000, (8, 1024))).cuda()
                   for _ in range(2))
    modes = {"no amp": lambda: nullcontext(),
             "O1": lambda: amp.auto_cast(dtype="bfloat16"),
             "O2": lambda: amp.auto_cast(level="O2", dtype="bfloat16")}
    flags.set_flags({"FLAGS_fused_lm_head_ce": True})
    for build in ("bf16 config", "float32 decorated"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        if build == "bf16 config":
            model = LlamaForCausalLM(LlamaConfig.llama1b_train(),
                                     generator=gen)
        else:
            model = LlamaForCausalLM(
                LlamaConfig.llama1b_train(dtype="float32"), generator=gen)
            amp.decorate(model, level="O2", dtype="bfloat16")
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
        _step(model, opt, ids, labels, nullcontext())
        for name, ctx in modes.items():
            before = torch.cuda.memory_allocated() / GB
            torch.cuda.reset_peak_memory_stats()
            loss = _step(model, opt, ids, labels, ctx())
            print(json.dumps({
                "model": build, "mode": name, "loss": loss,
                "allocated_before_gb": before,
                "step_peak_gb": torch.cuda.max_memory_allocated() / GB,
                "device": torch.cuda.get_device_name(0)}), flush=True)
        del model, opt
    flags.set_flags({"FLAGS_fused_lm_head_ce": False})


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU and
check them.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; no phase swallows an exception):
  1. device     require CUDA, print the card's name and power limit
  2. build      compile every kernel from csrc/ (one nvcc per source, in
                parallel) and print the build seconds and, per kernel,
                ptxas's registers and spill bytes (the fused CE kernels'
                float32 modes and the int8-weight GEMM's bf16 tensor-core
                kernels must spill none)
  3. kernels    hold each kernel against its plain PyTorch version on the
                card at the serving and training paths' shapes, in float32
                and bfloat16, and time the kernel, the plain version and
                (where one exists) the one PyTorch library call computing
                the same function, beside the card's bound for the work;
                the forward is also checked alone with GQA, non-causal,
                N_kv != N both ways, D = 64 and operands that are not
                16-byte aligned (O and the LSE), and timed
                in bf16 at the training shape with 16 and 6 heads; the
                forward and the backward twice on the same inputs must
                give the same bits; the backward is timed at the training
                shape in both dtypes (beside torch SDPA's backward) and
                at the bench row's 6 heads, and also run on operands that
                are not 16-byte aligned, whose dq/dk/dv must equal the
                aligned copies' bit for bit;
                run the bf16 MMA form probe (all eight forms, mma.sync and
                wgmma, must be OK)
                and hold the fused lm_head + CE kernels (forward, dh, dW)
                against their plain versions, bf16 and float32 at the
                training shape, ragged vocabs, a ragged token count and
                float32 at T = 1024 (two launches bit for bit; timed at
                the training shape in both dtypes and at T = 1024 in
                float32),
                beside the port's unfused tail and, as a yardstick,
                torch.matmul of the same products over the same chunks
  3c. tier 2    the mixed paged kernel (fp32/bf16/int8) and the decode
                kernel's int8 and bf16 modes against their plain versions
                (the bf16 one timed at the decode batch, CUDA events and
                profiler device time, beside its bytes bound); with
                phase 3 the history splits: one 2048-token slot beside 15
                idle ones, lengths 255/256/257 at a 256-token split, a
                256-page table of short histories, row tiles whose last
                split is past row 0's horizon, and kernels 7 and 8 twice
                on the same inputs bit for bit in fp32 and int8 (every
                paged row prints the split plan it ran)
  3d. segments  the segment-id (packed sequence) mode of the flash
                forward, dq and dk/dv kernels against their plain
                versions: (a) the training shape, bf16, causal, each row
                packing documents of 64-512 tokens; (b) float32, B = 1,
                N = 2048, non-causal, shuffled ids; all-zero ids must give
                the non-segmented kernels' results bit for bit; timed
                beside torch SDPA with a dense boolean mask
  4. slice      llama1b at full width (random weights from --seed) behind
                serving.Engine: 33 requests run to completion, and both
                serving kernels' launch counters must have grown
  4b. tier 2    llama1b through the prefix cache, chunked prefill and
                int8 KV pages, with exact launch counts
  5. e2e        the check request served alone on the CPU through the
                plain path must produce the card's greedy tokens (or
                diverge only at a reported near-tie); 5b the same for the
                tier-2 engine, fp32 and int8 pages
  6. train      the llama1b training row (bf16, recompute, 8 x 1024) at
                full width and depth through TrainStep + AdamW(1e-4): one
                warm-up and 5 timed steps on one batch, finite and falling
                loss, and per step 16 dq, 16 dk/dv and 32 forward launches
  6b. fused     phase 6 again with FLAGS_fused_lm_head_ce on and
                TrainStep(labels_to_model=True): per step exactly one
                fused-CE forward, dh and dW launch besides the attention
                launches, a first loss within bf16 rounding of phase 6's,
                and a lower peak memory
  6c. bench row the reference's own training row (bench.py, BENCH_FUSE=1:
                hidden 768, 12 layers, 6 heads x 128, FFN 2048, fused QKV
                and gate/up projections, bf16, 8 x 1024, AdamW(1e-4))
                through TrainStep.run_steps: a warm-up window and 2 timed
                windows of K = 10 stacked batches, then the same 10
                batches through 10 calls from the same starting state
                (losses within bf16 rounding of the window's); per step
                exactly 12 forward, dq and dk/dv launches, none segmented
  6d. varlen    F.variable_length_attention at the 3d (a) shape with
                gradients, once by segment ids and once by a 1-D seq_lens
                list with a padded tail: each call launches exactly one
                segmented forward, dq and dk/dv and agrees with the plain
                version
  6e. train32  the llama1b training row at the config's default dtype,
                float32 (LlamaConfig.llama1b_train(dtype="float32"), TF32
                off): phase 6's path, one warm-up and 2 timed steps, finite
                and falling loss, per step exactly 32 forward, 16 dq and 16
                dk/dv launches (the float32 CUDA-core kernels), none
                segmented, no TMA copy; step ms, tokens/s, peak memory
  6f. train32  phase 6e with FLAGS_fused_lm_head_ce on and
      fused     TrainStep(labels_to_model=True): per step exactly one
                fused-CE forward, dh and dW launch (their float32 CUDA-core
                modes) besides 6e's attention launches, a first loss
                within 1e-5 relative of 6e's and a lower peak memory; step
                ms, tokens/s and peak memory beside 6e's
  7. train e2e  the same widths at 2 layers in float32, 2 AdamW steps on
                the card and on a CPU copy (plain path): losses and the
                first step's gradients must agree
  7b. fused e2e phase 7's model with the flag on and the training recipe
                (linear warm-up into cosine decay, global-norm clipping),
                3 steps on the card and on the CPU: the float32 fused-CE
                kernels against the plain path end to end
  7c. variant   phase 7's model with fused QKV and gate/up projections, a
                label-smoothed loss and run_steps (2 windows of K = 2) on
                the card and on the CPU: losses and the first step's
                gradients must agree
  8. quant and  run after phase 5b on the phase-4 llama1b and its CPU copy:
     benchmark  (a) the int8-weight GEMM (csrc/w8_gemm.cu) against its
                plain version at M = 1, 5, 16, 17 (cluster split-K) and 64,
                256 (register-tiled) x (2048->2048, 2048->5504, 5504->2048
                and the fused 2048->6144, 2048->11008) on layer 0's
                weights, and off the vector path (N = 24, K = 36 and 5504),
                two launches bit for bit, timed at M = 16 and 256 (CUDA
                events and profiler device time) beside its bound and
                torch.matmul on the dequantized and on the fp32 weight;
                (b) weight-only int8 decode (FLAGS_serving_quant_weights),
                alone and with prefix cache + chunked prefill + int8 KV:
                greedy tokens equal to the CPU copy's with the same flags
                (or diverging at a near-tie), exactly 7 x 22 int8 GEMM
                launches a decode or mixed step and none in prefill;
                (c) paddle_tpu_torch.tools.serving_benchmark in-process, 32
                requests a row at 4 a second (prompts 128-1536, 64 new
                tokens, 16 slots, 2048 pages): flags off, prefix cache +
                chunked prefill over 4 shared 512-token prefixes (tails
                128-1024), int8 weights, and a resilience row (256 pages, max queue 8,
                deadline 30 s, a prefill and a decode fault); every request
                terminal and, with the admission rejects, all of them;
                goodput within throughput; the resilience row preempted and
                fired both faults, the others shed nothing
  10. bf16 and  run after phase 8 (before the training phases):
      replay    (c) the serving benchmark's --record-out on the phase-4
                llama1b fp32 (8 requests, flags off and prefix cache +
                chunked prefill over shared 512-token prefixes), each
                journal re-driven by tools/ptreplay.py run with the model
                rebuilt from the journal's meta: zero divergences; a
                perturbed weight leaf must diverge (its first diverging
                index printed) and the matrix must name ``weights``;
                (a) the int8-weight GEMM's bf16 mode (tensor cores:
                mma.sync at M <= 32, wgmma above) against its plain
                version (cuBLAS summing its split-K partials in fp32, as
                ``import paddle_tpu_torch`` sets) on a bf16 llama1b's
                layer-0 weights at every tile height (M = 1, 5, 16, 17, 33, 64,
                256; the fused shapes; K = 1000, a ragged last split, on
                and off the vector path; K = 1032, a last stage 8 rows
                deep, with N = 2048 and an odd N = 37), within one bf16 ulp
                of the value, two launches bit for bit, timed at M = 16
                and 256 beside torch.matmul on the bf16-dequantized
                weight; (b) that bf16 llama1b at full width behind
                serving.Engine with flags off, prefix cache + chunked
                prefill, int8 KV and int8 weights, prompts in the 8, 16,
                256 and 1024 buckets and a 240-token prefix hit (the
                quantized runs on the three short prompts): greedy tokens
                equal to a bf16 CPU copy's with the same weights and flags
                (its dense greedy continuation without quantization, its
                engine with it), or diverging first where the CPU copy's
                top-2 gap is under 2^-4 of the row's max |logit|; exact
                launch counts (kernel 1 in bf16, 7, 8 and 10's bf16 mode);
                TTFT and TPOT beside the card's name and power limit
  11. generate  run after phase 5b on the phase-4 llama1b and its CPU copy:
                (a) llama1b fp32 through ``generate``: greedy (B = 4, prompt
                64, 16 new tokens), beam search (B = 2, 4 beams, 8 new
                tokens, an eos, length_penalty 1) and sampling (B = 4,
                top_k 50, top_p 0.9, temperature 0.8) twice with one seed
                (equal tokens) and at top_k 1 (greedy's tokens); greedy and
                beam tokens against the CPU copy's ``generate`` (equal, or
                diverging at a reported near-tie), the prefill's last
                logits within LOGIT_RTOL, greedy against serving.Engine on
                the same prompts; (b) GPT-2 small's geometry (GPTModel()
                at the reference's defaults, fp32, random weights from
                --seed) through greedy ``generate`` (B = 4, prompt 128, 32
                new tokens) against its CPU copy, then the same prompts
                through serving.Engine: tokens equal to ``generate``'s.
                Exact launch counts: 22 (llama1b) or 12 (GPT-2) flash
                forwards a ``generate`` call and no paged launch, 12 paged
                launches a GPT-2 engine decode step. Kernel 1 at the
                rectangular prefills (q_len < kv_len, start-aligned causal)
                and kernel 7 at GPT-2's 12 heads x 64 against their plain
                versions, timed beside their bounds and torch SDPA; each
                run's decode ms a step and tokens/s beside the card
  12. encoders  run after phase 7c, (b)-(e) first (the kernel cases run
                the profiler): (a) kernels 1-3 at ERNIE-3.0-base's
                attention (B = 16, N = 512, 12 heads x 64, non-causal;
                once on strided q/k/v views of a fused [B, N, 3, H, D]
                projection, its TMA copies reported) and at the base
                Transformer's cross-attention (8 x 192 queries over 256
                keys, 8 heads), kernels 4-6 at ERNIE's fused MLM tail
                (T = 8192, H = 768 + 128, V = 40000), float32 and bf16,
                against their plain versions, twice bit for bit, timed by
                CUDA events and profiler device time beside the plain
                versions, torch SDPA's forward and backward or
                torch.matmul of the same products, and the bounds;
                (b) ERNIE-3.0-base (fused QKV, random weights from --seed)
                pretraining through TrainStep(labels_to_model=True) and
                AdamW with PaddleNLP's decay idiom (apply_decay_param_fun;
                fixed rates where a warm-up would start, ERNIE_LR),
                B = 16, S = 512, 15 % masked-LM positions and SOP labels:
                bf16 then float32, each with FLAGS_fused_lm_head_ce off and
                on: falling losses, the fused first loss within 6b's or
                6f's tolerance of the unfused one and a lower peak, per
                step exactly 12 forward, dq and dk/dv launches and with
                the flag 1 fused-CE forward, dh and dW; step ms, tokens/s,
                peak memory; (c) float32 ERNIE on the card against a CPU
                copy (B = 2, S = 128): MLM and SOP logits, then
                ErnieModel with a padding attn_mask (no flash launch),
                within 1e-3 x max|.|; (d) ErnieForSequenceClassification
                (bf16, 2 classes, B = 32, S = 128) fine-tuned 5 steps,
                falling losses; (e) nn.Transformer at the base width
                (float32, B = 8, 256 source and 192 target positions, a
                causal tgt_mask): forward and backward at dropout 0 against
                a CPU copy that replays the card's ReLU decisions (the
                output and every gradient within 1e-3 x max|.|; the
                decisions it would take otherwise counted, within rounding
                of 0), 12 launches of each of kernels 1-3 (the decoder's
                masked self-attention takes SDPA's masked path), then an
                AdamW step at dropout 0.1 with dropout_p reaching SDPA
  13. resnet    run after phase 12; no kernel of the port runs here (every
                launch counter stays 0 across each run): ResNet-50
                (vision.models.resnet50, 1000 classes, random weights from
                --seed) at 224 x 224: (a) float32 logits in train and in
                eval mode at batch 2, and the running statistics the train
                forward leaves, against a CPU copy within 1e-3 x max|.|;
                (b) one Momentum(0.1, 0.9) step through TrainStep at batch
                8 on the card, held to a float64 CPU copy: the loss
                within 1e-4; the gradients of conv1.weight,
                layer4.2.bn3.weight and fc.weight (max|.|) and every
                parameter's update (norm), each within 4 x its own noise
                (+ 1e-5), the larger of a float32 CPU copy's distance and
                a witness's (float64 at inputs moved by 2**-24, which
                counts the ReLU outputs it switches: the step is
                ill-conditioned); bn1's statistics within 1e-3; the same
                check must fail a gradient scaled by 1 % and a tensor
                left out of the optimizer, planted on the card; (c) NHWC
                against NCHW
                logits on the card (same weights, eval) within 1e-4 x
                max|.|; (d) the reference's chip row (batch 64,
                Momentum(0.1, 0.9), cross-entropy) in float32 NCHW and in
                bf16 NCHW and NHWC: 2 warm-up and 10 timed steps, images/s,
                ms a step and peak memory beside the card's name and
                power limit; (e) every loss past nll_loss on the card
                against the same call on the CPU (value and gradients,
                1e-5 x max|.|, 1e-4 for CTC and RNN-T) and
                class_center_sample on card labels
  14. seq2seq  run after phase 13; no kernel of the port runs here (every
                launch counter stays 0 across each run): Luong's attention
                seq2seq at its IWSLT'15 English -> Vietnamese widths
                (vocabularies 17191 / 7709, embedding and hidden 512, a
                2-layer LSTM encoder, a decoder cell of two LSTMCells with
                input feeding and dot attention masked by sequence_mask,
                built from the framework's nn API, every parameter from
                initializer.Uniform(-0.1, 0.1)): (a) float32 logits and
                the masked loss at batch 4 against a CPU copy; (b) one
                Adam(1e-3) step with ClipGradByGlobalNorm(5) through
                TrainStep, held per tensor to the CPU copy's (the loss,
                three gradients, every update where the gradient stands
                above its noise), and two faults planted on the card that
                the check must fail; (c) BeamSearchDecoder (beam 10)
                under dynamic_decode: ids equal to the CPU copy's, or
                differing first at a near-tie of the beams' scores;
                (d) a bidirectional 2-layer GRU, SimpleRNN (relu,
                time-major) and a 2-layer LSTM, output and every
                gradient against the CPU, and a bf16 LSTMCell given no
                states computing in float32; (e) every common functional
                (interpolate in every mode, shrinking and growing) and
                manipulation op against the CPU, value and gradients, the
                dropouts by their law; (f) resnet18 trains a step at
                batch 1 and 32 x 32 (one value a channel in its last
                stage); (g) batch 128 x 50 in float32 and bf16: train step
                ms, target tokens/s, beam decode ms a step, sentences/s,
                peak memory, one profiled step and decode (device ms,
                kernels), and the port's LSTM against torch.nn.LSTM
                (cuDNN's fused _VF.lstm) on the same weights at the
                encoder's shape, beside the card's name and power limit
  15. amp      run after 14: (a) kernels 1-3 in float16 against their plain
                versions at llama1b's training attention (8 x 1024, 16 x
                128, causal) and ERNIE's (16 x 512, 12 x 64, non-causal),
                twice bit for bit, timed by CUDA events and profiler device
                time beside the plain versions, torch SDPA in float16 and
                the bounds, each kernel's ptxas report equal to its bf16
                twin's; (b) llama1b with float32 weights (the training
                row's config at float32) through the reference's eager
                AMP loop under auto_cast O1 bf16 and the default
                GradScaler, 3 AdamW steps: exact bf16 launch counts, the
                dtypes at the cast points (linear bf16, rms_norm float32),
                losses and sampled gradients against the same steps
                through the kernels' plain versions on the card, and one
                profiled step by group; (c) the same in float16: the
                float16 kernels' launch counts, the scaler's (scale, good,
                bad) sequence and skipped steps equal to the plain
                versions', and a step at a loss scale that overflows
                float16 skipped with the parameters untouched; (d) llama1b's
                width at one layer under O1 float16: 2 steps, save (model,
                optimizer with its LR scheduler, scaler), fresh objects,
                load, 2 more: losses and parameters bit for bit those of
                an uninterrupted run (two uninterrupted runs agreeing bit
                for bit; else within their gap); (e) ResNet-50 through
                hapi.Model.fit under O1 bf16 (batch 64, 224^2, Momentum,
                Accuracy top-1/5) over a synthetic ImageNet-shaped dataset
                with 4 forked workers and pinned memory, ModelCheckpoint,
                evaluate, predict, Model.save / load; conv outputs bf16 and
                batch-norm outputs float32, the losses equal to a run with
                no worker, flops(resnet50, [1, 3, 224, 224]) printed
  16. float16   run last: (a) kernels 4-6 in float16 (wgmma .f32.f16.f16)
      model     against their plain versions at llama1b's loss tail (T =
                8192, H = 2048, V = 32000, timed beside torch.matmul of the
                same products and the bound, twice bit for bit) and at
                ERNIE's MLM tail (H = 896, V = 40000), 1/8 of the labels
                ignored, each at an unscaled 1 / T, GradScaler's 2^15 and
                a 2^30 scale that overflows dl at the label: inf and NaN
                of dh and dW (and dW's zeros unscaled) where the plain
                versions put them; kernels 7 and 8 with float16 q and
                pools and with float16 q over int8 pages at their table
                rows' shapes (the decode batch, mixed step (a), suffix
                prefill (b)), timed, twice bit for bit; kernel 10's
                float16 mode at one llama1b layer's 7 projections, M = 16
                and 256, within one float16 ulp, timed beside torch.matmul
                on the float16-dequantized weight; (b) llama1b's training
                row in float16 (16 layers, recompute, 8 x 1024, 1/8 of the
                labels -100) with FLAGS_fused_lm_head_ce, AdamW and the
                default GradScaler: 3 steps on the kernels, then the same
                3 on every plain version, losses and sampled gradients
                within FP16_LOSS_RTOL / FP16_GRAD_RTOL (each limit backed
                by a fault planted in the fused CE kernels,
                paddle_tpu_torch/tools/amp_faults.py --fp16-model), the
                scaler's sequence equal, exact float16 launch counts of
                kernels 1-6, a step at 2^40 skipped with the parameters
                untouched, then 2 steps through TrainStep(labels_to_model=
                True) without a scaler; (c) llama1b in float16 behind
                serving.Engine with the flags off, prefix cache + chunked
                prefill, int8 KV, int8 weights, and prefix cache + chunked
                prefill over int8 pages: greedy tokens equal to
                the same engine's with every kernel swapped for its plain
                version on the card (or diverging first at a near-tie),
                exact launch counts of kernels 1, 7, 8 (22 a decode or
                mixed step) and 10 (154 a step)
  17. ops / O2  run last: (a) every op of paddle_tpu_torch.ops and
                tensor.attribute (295 functions; the in-place forms,
                indexing and _C_ops) on the card against the same call on
                a CPU copy, float32 with TF32 off and bf16 / float16 where
                the op takes them, within a limit by family (OPS_TOLS,
                OPS_HALF_TOLS); decompositions by values and
                reconstructions; the random ops by shape, dtype, range and
                seed-determinism on the card; (b) llama1b's training row
                (16 layers, recompute, 8 x 1024, AdamW,
                FLAGS_fused_lm_head_ce) with float32 weights through
                decorate(level="O2") under auto_cast(level="O2"): 3 steps
                in bf16, 3 in float16 under the default GradScaler and one
                at 2^40 skipped, each against the same steps through every
                plain version (O2_LOSS_RTOL / O2_GRAD_RTOL, backed by
                faults planted with paddle_tpu_torch/tools/amp_faults.py
                --o2), exact launch counts of kernels 1-6 in each dtype
                (the kernels line's "o2 bf16" / "o2 fp16" paths)
  18. head dim  run last: a Llama at Gemma-2B's widths (hidden 2048, 8
      256       query heads and 1 kv head of 256, FFN 16384, 18 layers,
                vocab 256000). (a) kernels 1-3, 7 and 8 at D = 256 in
                float32, bf16 and float16 (and int8 pages) against their
                plain versions at the path's shapes (B = 8, N = 1024,
                H = 8, Hkv = 1 causal; a segment-id case; the decode
                batch; the mixed step and the suffix prefill), twice bit
                for bit, timed by CUDA events and profiler device time
                beside the bound, the plain version and torch SDPA;
                kernels 4-6 at V = 256000 and kernel 10 at the model's
                projections against their plain versions; (b) served at
                18 layers in each dtype, flags off and with prefix cache
                + chunked prefill + int8 KV (float32 also int8 weights):
                greedy tokens against the same engine on the plain
                versions, exact launch counts, and a 2-layer copy's
                logits card against CPU; (c) trained with the fused loss
                tail and AdamW at 8 x 1024 in bf16 and float16 (default
                GradScaler) at 18 layers with recompute and float32 at 2,
                against the plain versions within limits that faults
                planted in kernel 1 cross; (d) the tiny preset (D = 16)
                served and trained one step on the card through the
                plain path the head dim picks: no kernel launch.
                --only-phase-18 runs phases 1, 2 and 18 alone
  9. summary    one JSON line of per-kernel numbers, then the result line

Every exact launch count of phases 4, 4b, 6, 6b, 6c, 6d, 6e, 6f and 11
also holds the bf16 kernels' TMA operand copies (``tma_copies``, forward
and backward) at 0, fused QKV views included.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): device-memory rate,
# float32 outside the tensor cores, bf16 tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
              torch.float16: 989e12}
# Kernel vs plain version on the same inputs: the two sum in a different
# order (tiled online softmax vs one softmax over the whole row), so they
# agree to float32 rounding, not bit for bit. In bfloat16 both round the
# output to 8 mantissa bits and the probabilities before P.V (the plain
# version the normalised ones, the kernel the unnormalised ones, as the
# reference), so the gap is a few bf16 ulps of |out| <~ 4.
# float16 rounds to 11 significant bits where bf16 keeps 8, at the same
# points: a quarter of bf16's tolerance.
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=1e-2),
       torch.float16: dict(atol=5e-3, rtol=2.5e-3)}
# Backward kernels vs plain version: float32 gradients are sums of up to
# N products taken in another order, so atol 1e-4 + rtol 1e-3. bfloat16:
# both round dS and P to bf16 at the same points and the gradients to bf16
# at the end; the forward's bf16 tolerance (atol 2e-2 for |out| <~ 4) is
# scaled to the gradient's size: atol 5e-3 x max|grad|, rtol 1e-2.
BWD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-3),
           torch.bfloat16: dict(atol=5e-3, rtol=1e-2, scaled=True),
           torch.float16: dict(atol=1.25e-3, rtol=2.5e-3, scaled=True)}
NEAR_TIE = 1e-3     # top-2 logit gap below which fp32 order may flip argmax
# card vs CPU logits of llama1b in float32: 22 layers of sums taken in
# another order (cuBLAS vs CPU GEMMs, tiled vs whole-row softmax); a
# wrong kernel or layout moves them by O(1) of the logit range
LOGIT_RTOL = 1e-3
# card vs CPU training of 2 full-width layers in float32: the losses are
# means over 256 tokens of values that agree to ~1e-6 relative; the
# gradients sum over 256 tokens and 2048-wide products in another order
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3


def log(*parts):
    print(*parts, flush=True)


def check_close(name, got, want, tol):
    err = (got.float() - want.float()).abs()
    atol = tol["atol"]
    if tol.get("scaled"):
        atol *= float(want.float().abs().max())
    atol = max(atol, tol.get("floor", 0.0))
    bad = err > atol + tol["rtol"] * want.float().abs()
    max_err = float(err.max())
    if bool(bad.any()):
        raise AssertionError("%s: %d elements off, max abs err %.3g (%s)"
                             % (name, int(bad.sum()), max_err, tol))
    return max_err


def time_ms(fn, iters=10, reps=5):
    """Median over ``reps`` of the mean CUDA-event time of ``iters``
    back-to-back calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound(nbytes, flops, dtype):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak for ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "operations_ms": t_ops}


# -- phase 1 / 2 ------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log("[device] torch %s, CUDA %s, %d device(s)" % (
        torch.__version__, torch.version.cuda, torch.cuda.device_count()))
    log(card)
    return card


def kernel_name(mangled):
    """A ptxas entry name without its mangling: the innermost name and
    its template arguments (``flash_bwd_dq_wgmma_kernel<128, bf16>``)."""
    i = mangled.find("_ZN")
    if i < 0:
        return mangled
    i += 3
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    args = []
    if mangled[i:i + 1] == "I":
        # the template arguments up to their closing E: integer literals,
        # the element types, and float / int8 (signed char)
        types = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "float",
                 "a": "int8"}
        # (S<n>_ repeats a type named before: the last one here)
        pat = re.compile(
            r"L[ib](\d+)E|13__nv_bfloat16|6__half|f|a|S[0-9A-Z]*_|E")
        i += 1
        while True:
            m = pat.match(mangled, i)
            if m is None or m.group(0) == "E":
                break
            tok = m.group(0)
            args.append(m.group(1) or (types[tok] if tok in types else
                                       next((t for t in reversed(args)
                                             if not t.isdigit()), tok)))
            i = m.end()
    return name + ("<%s>" % ", ".join(args) if args else "")


def ptxas_report(text):
    """``[{kernel, registers, stack, spill_stores, spill_loads}]`` from
    ptxas's verbose report (one entry per compiled kernel)."""
    rows, row = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            row = {"kernel": kernel_name(m.group(1))}
            rows.append(row)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and row is not None:
            row.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and row is not None:
            row["registers"] = int(m.group(1))
    return rows


# the fused lm_head + CE kernels' float32 modes and kernel 10's bf16
# tensor-core kernels (name prefixes): phase 2 holds them at 0 spill bytes
FCE_FP32_KERNELS = ("fce_fwd_partial", "fce_fwd_combine", "fce_bwd_dl",
                    "fce_bwd_dh", "fce_bwd_dh64", "fce_bwd_dw")
W8_BF16_KERNELS = ("w8_gemm_mma<", "w8_gemm_wgmma<")


def phase_build():
    """Build every kernel and print ptxas's registers and spills for each
    (the bf16 forward and backward kernels' consumer warpgroups run at 240
    registers after setmaxnreg; ptxas reports the launch-time count)."""
    from paddle_tpu_torch import _build

    t0 = time.perf_counter()
    paths = _build.build()
    log("[build] %d kernels in %.1f s" % (len(paths),
                                          time.perf_counter() - t0))
    report = {}
    for name, path in paths.items():
        rows = ptxas_report(path.with_name(path.name + ".log").read_text())
        for row in rows:
            log("[build] %s: %s: %s registers, %s bytes stack, %s bytes "
                "spill stores, %s bytes spill loads" % (
                    name, row["kernel"], row.get("registers"),
                    row.get("stack"), row.get("spill_stores"),
                    row.get("spill_loads")))
        report[name] = rows
    # the fused CE kernels' float32 modes run at the register cap (8 x 16
    # accumulators a thread), and kernel 10's bf16 tensor-core kernels at
    # 128 (four CTAs an SM) or one CTA an SM: a spill in either is a
    # regression, not a detail
    spilled = [r["kernel"] for name, keep in (
                   ("fused_ce", lambda k: k in FCE_FP32_KERNELS),
                   ("w8_gemm", lambda k: k.startswith(W8_BF16_KERNELS)))
               for r in report.get(name, ()) if keep(r["kernel"])
               and (r.get("spill_stores") or r.get("spill_loads"))]
    if spilled:
        raise AssertionError("kernels spill: %s" % spilled)
    return report


# -- phase 3 ----------------------------------------------------------------

def flash_case(gen, n, heads, head_dim, dtype, timed=False, batch=1,
               kv_heads=None, n_kv=None, causal=True, offset=0,
               profiled=False):
    """The forward kernel against its plain version (O and the LSE); two
    launches on the same inputs must give the same bits (no atomics). With
    ``offset``, q/k/v are views ``offset`` elements into rows of head_dim
    + 4: not 16-byte aligned, so float32 takes the kernel's 4-byte copies
    and bf16 the wrapper's TMA copy (3 a launch). With ``timed``, its time
    beside the plain version's, torch SDPA's and the bound; with
    ``profiled``, its profiler device time too."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    n_kv = n if n_kv is None else n_kv
    kv_heads = heads if kv_heads is None else kv_heads

    def rand(length, h):
        pad = 4 if offset else 0
        x = torch.randn((batch, length, h, head_dim + pad), generator=gen,
                        device="cuda").to(dtype)
        return x[..., offset:offset + head_dim]

    q, k, v = rand(n, heads), rand(n_kv, kv_heads), rand(n_kv, kv_heads)
    copies = fa.tma_copies
    out, lse = fa.flash_attention(q, k, v, causal=causal)
    copies = fa.tma_copies - copies
    if copies != (3 if offset and dtype is not torch.float32 else 0):
        raise AssertionError("forward made %d TMA operand copies" % copies)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    name = "flash B=%d N=%d H=%d D=%d %s" % (batch, n, heads, head_dim,
                                             str(dtype).split(".")[-1])
    if n_kv != n or kv_heads != heads or not causal or offset:
        name += " (Nkv=%d Hkv=%d %s%s)" % (
            n_kv, kv_heads, "causal" if causal else "non-causal",
            ", misaligned" if offset else "")
    err = check_close(name + " out", out, ref_out, TOL[dtype])
    lse_err = check_close(name + " lse", lse, ref_lse, TOL[torch.float32])
    again = fa.flash_attention(q, k, v, causal=causal)
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
        raise AssertionError("%s: two launches differ" % name)
    row = {"case": name, "max_abs_err": err, "lse_max_abs_err": lse_err,
           "deterministic": True}
    if timed:
        esize = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * esize \
            + lse.numel() * 4
        pairs = causal_pairs(batch * heads, n, n_kv) if causal \
            else batch * heads * n * n_kv
        row["ms"] = time_ms(lambda: fa.flash_attention(q, k, v,
                                                       causal=causal))
        if profiled:
            row["device_ms"] = device_ms(
                lambda: fa.flash_attention(q, k, v, causal=causal),
                "flash_fwd")
        row["plain_ms"] = time_ms(
            lambda: fa.flash_attention_reference(q, k, v, causal=causal))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        gqa = {"enable_gqa": True} if kv_heads != heads else {}
        row["library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, **gqa))
        row.update(bound(nbytes, 4 * head_dim * pairs, dtype))
    log("[kernels] " + json.dumps(row))
    return row


def causal_pairs(heads, n, n_kv):
    """(query, key) pairs a start-aligned causal mask keeps, over all
    heads: query i sees min(i + 1, n_kv) keys."""
    keep = min(n, n_kv)
    return heads * (keep * (keep + 1) // 2 + (n - keep) * n_kv)


def flash_bwd_case(gen, n, heads, head_dim, dtype, batch=1, n_kv=None,
                   kv_heads=None, timed=False, offset=0, profiled=False):
    """The dq and dk/dv kernels against their plain version; two launches
    on the same inputs must give the same bits (no atomics). With
    ``offset``, q/k/v/dO are views ``offset`` elements into rows of
    head_dim + 4, not 16-byte aligned (float32 takes the kernels' 4-byte
    copies, bf16 the wrapper's TMA copies): dq, dk and dv must equal the
    aligned copies' bit for bit. With ``timed``, their times beside the
    plain version's, torch SDPA's backward and the bounds."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    n_kv = n if n_kv is None else n_kv
    kv_heads = heads if kv_heads is None else kv_heads

    def rand(length, h):
        pad = 4 if offset else 0
        x = torch.randn((batch, length, h, head_dim + pad), generator=gen,
                        device="cuda").to(dtype)
        return x[..., offset:offset + head_dim]

    q, k, v = rand(n, heads), rand(n_kv, kv_heads), rand(n_kv, kv_heads)
    dout = rand(n, heads)
    out, lse = fa.flash_attention(q, k, v, causal=True)
    got = fa.flash_attention_backward(q, k, v, out, lse, dout, causal=True)
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, dout,
                                                 causal=True)
    torch.cuda.synchronize()
    name = "flash_bwd B=%d N=%d Nkv=%d H=%d Hkv=%d D=%d %s%s" % (
        batch, n, n_kv, heads, kv_heads, head_dim,
        "misaligned " if offset else "", str(dtype).split(".")[-1])
    err = [check_close("%s d%s" % (name, part), x, y, BWD_TOL[dtype])
           for part, x, y in zip("qkv", got, want)]
    row = {"case": name, "max_abs_err": {"dq": err[0],
                                         "dkv": max(err[1], err[2])}}
    # no atomics: the same inputs give the same bits, launch after launch
    again = fa.flash_attention_backward(q, k, v, out, lse, dout, causal=True)
    same = [torch.equal(a, b) for a, b in zip(got, again)]
    if not all(same):
        raise AssertionError("%s: two launches differ (dq, dk, dv equal: "
                             "%s)" % (name, same))
    row["deterministic"] = True
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
        .reshape(batch * heads, n).contiguous()
    args = (q, k, v, dout, lse, delta)
    if offset:
        aligned = [x.contiguous() for x in (q, k, v, dout)] + [lse, delta]
        same = [torch.equal(a, b) for a, b in zip(
            (fa.flash_attention_bwd_dq(*args, causal=True),
             *fa.flash_attention_bwd_dkv(*args, causal=True)),
            (fa.flash_attention_bwd_dq(*aligned, causal=True),
             *fa.flash_attention_bwd_dkv(*aligned, causal=True)))]
        if not all(same):
            raise AssertionError("%s: misaligned operands differ from their "
                                 "aligned copies (dq, dk, dv equal: %s)"
                                 % (name, same))
        row["aligned_bitwise"] = True
    if timed:
        esize = q.element_size()
        row["dq_ms"] = time_ms(
            lambda: fa.flash_attention_bwd_dq(*args, causal=True))
        row["dkv_ms"] = time_ms(
            lambda: fa.flash_attention_bwd_dkv(*args, causal=True))
        if profiled:
            row["dq_device_ms"] = device_ms(
                lambda: fa.flash_attention_bwd_dq(*args, causal=True),
                "flash_bwd_dq")
            row["dkv_device_ms"] = device_ms(
                lambda: fa.flash_attention_bwd_dkv(*args, causal=True),
                "flash_bwd_dkv")
        row["plain_ms"] = time_ms(
            lambda: fa.flash_attention_backward_reference(
                q, k, v, out, lse, dout, causal=True))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True,
            **({"enable_gqa": True} if kv_heads != heads else {}))
        g = dout.transpose(1, 2)
        row["library_ms"] = time_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), g, retain_graph=True))
        row["library"] = ("torch SDPA backward (dq, dk and dv together), "
                          "timed as autograd.grad of one SDPA forward")
        pairs = causal_pairs(batch * heads, n, n_kv)
        reads = ((q.numel() + dout.numel() + k.numel() + v.numel()) * esize
                 + 2 * lse.numel() * 4)
        row["dq"] = bound(reads + q.numel() * esize,
                          3 * 2 * head_dim * pairs, dtype)
        row["dkv"] = bound(reads + (k.numel() + v.numel()) * esize,
                           4 * 2 * head_dim * pairs, dtype)
    log("[kernels] " + json.dumps(row))
    return row


def random_pages(gen, totals, kv_heads, head_dim, dtype, int8,
                 block_size=16, max_blocks=128):
    """Pools holding ``totals[s]`` history tokens per slot on shuffled
    pages (trash page 0 random too: it must never be read), their block
    tables, and, with ``int8``, the int8 pools and scale planes
    quantized from them (``pools`` then maps "fp32" to the originals)."""
    from paddle_tpu_torch.kernels.quant import quantize_int8_page

    pages = [-(-n // block_size) for n in totals]
    num_blocks = sum(pages) + 1
    ids = (torch.randperm(num_blocks - 1, generator=torch.Generator()
                          .manual_seed(sum(totals))) + 1).tolist()
    table = np.zeros((len(totals), max_blocks), np.int32)
    for i, n_pages in enumerate(pages):
        table[i, :n_pages] = [ids.pop() for _ in range(n_pages)]
    shape = (num_blocks, block_size, kv_heads, head_dim)
    k_pool = torch.randn(shape, generator=gen, device="cuda")
    v_pool = torch.randn(shape, generator=gen, device="cuda")
    pools = {"k_pool": k_pool.to(dtype), "v_pool": v_pool.to(dtype)}
    if int8:
        pools = {"fp32": (k_pool, v_pool)}
        pools["k_pool"], pools["k_scale"] = quantize_int8_page(k_pool)
        pools["v_pool"], pools["v_scale"] = quantize_int8_page(v_pool)
    return pools, torch.tensor(table, device="cuda"), pages


def pool_bytes(pools, pages, kv_heads, head_dim, block_size=16):
    """Bytes of the K/V pages (and scales) the slots' histories cover,
    each page read once per (slot, kv head)."""
    per_token = 2 * kv_heads * head_dim * pools["k_pool"].element_size()
    if "k_scale" in pools:
        per_token += 2 * kv_heads * 4
    return sum(pages) * block_size * per_token


def split_of(plan):
    """A split plan as the kernel rows print it."""
    return {"kernel": plan.kernel, "tile_rows": plan.tile_rows,
            "split_pages": plan.split_pages, "splits": plan.splits}


def check_bitwise(name, fn, first):
    """A second launch on the same inputs must give the first's bits (no
    atomics in any sum)."""
    again = fn()
    torch.cuda.synchronize()
    if not torch.equal(again, first):
        raise AssertionError(name + ": two launches differ")


def paged_case(gen, lens, heads, kv_heads, dtype, timed=False,
               head_dim=128, block_size=16, max_blocks=128, int8=False,
               bitwise=False):
    from paddle_tpu_torch.serving.kernels import paged_attention as pa

    s = len(lens)
    pools, bt, pages = random_pages(gen, lens, kv_heads, head_dim, dtype,
                                    int8, block_size, max_blocks)
    kv = {k: v for k, v in pools.items() if k != "fp32"}
    q = torch.randn((s, heads, head_dim), generator=gen,
                    device="cuda").to(dtype)
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = pa.paged_attention(q, block_tables=bt, seq_lens=sl, **kv)
    ref = pa.paged_attention_reference(q, block_tables=bt, seq_lens=sl, **kv)
    torch.cuda.synchronize()
    live = sl > 0
    name = "paged S=%d H=%d Hkv=%d D=%d bs=%d %s%s" % (
        s, heads, kv_heads, head_dim, block_size, str(dtype).split(".")[-1],
        " int8 pages" if int8 else "")
    err = check_close(name, out[live], ref[live], TOL[dtype])
    if not bool((out[~live] == 0).all()):
        raise AssertionError(name + ": idle slots are not exactly zero")
    row = {"case": name, "lens": lens, "max_blocks": max_blocks,
           "split": split_of(pa.split_plan(s, 1, heads, kv_heads, max_blocks,
                                           block_size, decode=True,
                                           head_dim=head_dim)),
           "max_abs_err": err}
    if bitwise:
        check_bitwise(name, lambda: pa.paged_attention(
            q, block_tables=bt, seq_lens=sl, **kv), out)
        row["bitwise"] = True
    if int8:
        # the dequantized pages reconstruct the context: the int8 kernel
        # tracks the plain version on the unquantized pools
        k32, v32 = pools["fp32"]
        fp32 = pa.paged_attention_reference(q, k32.to(dtype), v32.to(dtype),
                                            bt, sl)
        row["vs_unquantized_err"] = check_close(
            name + " vs unquantized", out[live], fp32[live], INT8_VS_FP32_TOL)
    if timed:
        esize = q.element_size()
        tokens = sum(lens)
        nbytes = (2 * q.numel() * esize
                  + pool_bytes(pools, pages, kv_heads, head_dim, block_size)
                  + sum(pages) * 4 + s * 4)
        flops = 4 * tokens * heads * head_dim
        def kernel():
            return pa.paged_attention(q, block_tables=bt, seq_lens=sl, **kv)

        row["ms"] = time_ms(kernel)
        row["device_ms"] = device_ms(
            kernel, "paged_decode", per_call=1 + (row["split"]["splits"] > 1))
        row["plain_ms"] = time_ms(lambda: pa.paged_attention_reference(
            q, block_tables=bt, seq_lens=sl, **kv))
        row["library_ms"] = None
        row["library"] = "none: no single PyTorch call reads paged K/V"
        row.update(bound(nbytes, flops, dtype))
    log("[kernels] " + json.dumps(row))
    return row


def mixed_case(gen, hist, q_lens, chunk, heads, kv_heads, dtype, timed=False,
               head_dim=128, int8=False, block_size=16, max_blocks=128,
               bitwise=False, profiled=False):
    """Kernel 8 against its plain version: valid rows (ci < q_len) within
    the tolerance, every other row exactly zero; with ``profiled`` (and
    ``timed``), its profiler device time too."""
    from paddle_tpu_torch.serving.kernels import paged_attention as pa

    s = len(hist)
    totals = [h + n if n else 0 for h, n in zip(hist, q_lens)]
    pools, bt, pages = random_pages(gen, totals, kv_heads, head_dim, dtype,
                                    int8, block_size, max_blocks)
    kv = {k: v for k, v in pools.items() if k != "fp32"}
    q = torch.randn((s, chunk, heads, head_dim), generator=gen,
                    device="cuda").to(dtype)
    hl = torch.tensor(hist, dtype=torch.int32, device="cuda")
    ql = torch.tensor(q_lens, dtype=torch.int32, device="cuda")
    args = dict(block_tables=bt, hist_lens=hl, q_lens=ql, **kv)
    out = pa.mixed_paged_attention(q, **args)
    ref = pa.mixed_paged_attention_reference(q, **args)
    torch.cuda.synchronize()
    valid = (torch.arange(chunk, device="cuda")[None, :] < ql[:, None])
    name = "mixed S=%d C=%d H=%d Hkv=%d D=%d bs=%d %s%s" % (
        s, chunk, heads, kv_heads, head_dim, block_size,
        str(dtype).split(".")[-1], " int8 pages" if int8 else "")
    err = check_close(name, out[valid], ref[valid], TOL[dtype])
    if not bool((out[~valid] == 0).all()):
        raise AssertionError(name + ": rows past q_len are not exactly zero")
    row = {"case": name, "hist": hist, "q_lens": q_lens,
           "split": split_of(pa.split_plan(s, chunk, heads, kv_heads,
                                           max_blocks, block_size,
                                           head_dim=head_dim)),
           "max_abs_err": err}
    if bitwise:
        check_bitwise(name, lambda: pa.mixed_paged_attention(q, **args), out)
        row["bitwise"] = True
    if int8:
        k32, v32 = pools["fp32"]
        fp32 = pa.mixed_paged_attention_reference(
            q, k32.to(dtype), v32.to(dtype), bt, hl, ql)
        row["vs_unquantized_err"] = check_close(
            name + " vs unquantized", out[valid], fp32[valid],
            INT8_VS_FP32_TOL)
    if timed:
        esize = q.element_size()
        visible = sum(h * n + n * (n + 1) // 2 for h, n in zip(hist, q_lens))
        rows = sum(q_lens)
        nbytes = (2 * rows * heads * head_dim * esize
                  + pool_bytes(pools, pages, kv_heads, head_dim, block_size)
                  + sum(pages) * 4 + 2 * s * 4)
        flops = 4 * heads * head_dim * visible
        row["ms"] = time_ms(lambda: pa.mixed_paged_attention(q, **args))
        if profiled:
            row["device_ms"] = device_ms(
                lambda: pa.mixed_paged_attention(q, **args), "mixed_paged",
                per_call=1 + (row["split"]["splits"] > 1))
        row["plain_ms"] = time_ms(
            lambda: pa.mixed_paged_attention_reference(q, **args))
        row["library_ms"] = None
        row["library"] = "none: no single PyTorch call reads paged K/V"
        row.update(bound(nbytes, flops, dtype))
    log("[kernels] " + json.dumps(row))
    return row


# serving-path shapes: llama1b prefill buckets (B=1, H=16, D=128) and a
# decode batch of 16 slots over ragged histories up to max_model_len 2048
FLASH_NS = (8, 200, 512, 2048)
PAGED_LENS = [0, 1, 15, 16, 17, 100, 257, 512, 777, 1000, 1023, 1500, 1999,
              2047, 2048, 0]
# the paged kernels' split histories (split_plan: 16-page, 256-token
# splits of the decode batch): one 2048-token slot beside 15 idle ones
# (the critical path a single CTA walked alone before the split), lengths
# at the edges of the first splits, and short histories in a 256-page
# table (every split past a length exits at once)
LONE_SLOT = [2048] + [0] * 15
SPLIT_EDGE_LENS = [255, 256, 257, 511, 512, 513, 1, 0, 767, 768, 769, 16, 17,
                   1023, 1024, 1025]
SHORT_LENS = [1, 17, 100, 255, 256, 257, 300, 0, 5, 64, 33, 2, 0, 129, 200,
              16]
# training-path shapes: the llama1b training row's attention (B=8, N=1024,
# H=16, D=128; timed in both dtypes), then a ragged length, D=64, GQA,
# cross-length causal and operands that are not 16-byte aligned, at a
# short N (float32 dq's 64-row tiles) and at the training row (its 128-row
# tiles, the ones every float32 training step launches)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 5
TRAIN_STEPS_FP32 = 2   # phase 6e: a float32 step takes ~1.2 s (SGEMMs)
FLASH_BWD_CASES = (dict(batch=TRAIN_BATCH, n=TRAIN_SEQ, heads=16,
                        head_dim=128),
                   dict(n=200, heads=16, head_dim=128),
                   dict(n=256, heads=16, head_dim=64),
                   dict(n=512, heads=16, kv_heads=4, head_dim=128),
                   dict(n=128, n_kv=256, heads=16, head_dim=128),
                   dict(n=200, heads=16, kv_heads=4, head_dim=128, offset=1),
                   dict(batch=TRAIN_BATCH, n=TRAIN_SEQ, heads=16,
                        head_dim=128, offset=1))
# the bench row's attention (phase 6c: train_benchmark.bench_config(),
# 6 heads x 128)
BENCH_BWD_CASE = dict(batch=TRAIN_BATCH, n=TRAIN_SEQ, heads=6, head_dim=128)
# the forward alone beyond the serving buckets: GQA, non-causal,
# cross-length causal both ways and operands that are not 16-byte aligned
# (ragged N = 200 and D = 64 are in the serving list)
FLASH_FWD_CASES = (dict(n=512, heads=16, kv_heads=4, head_dim=128),
                   dict(n=200, heads=16, kv_heads=4, head_dim=128, offset=1),
                   dict(n=512, heads=16, head_dim=128, causal=False),
                   dict(n=128, n_kv=256, heads=16, head_dim=128),
                   dict(n=256, n_kv=128, heads=16, head_dim=128),
                   dict(n=512, heads=16, kv_heads=4, head_dim=64,
                        causal=False))


def phase_kernels(seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {"flash_attention": [], "flash_attention_bwd": [],
            "paged_attention": []}
    for dtype in (torch.float32, torch.bfloat16):
        for n in FLASH_NS:
            rows["flash_attention"].append(flash_case(
                gen, n, 16, 128, dtype, timed=dtype is torch.float32))
        rows["flash_attention"].append(flash_case(gen, 256, 16, 64, dtype))
        for case in FLASH_FWD_CASES:
            rows["flash_attention"].append(flash_case(gen, dtype=dtype,
                                                      **case))
        for kv_heads in (16, 4):
            rows["paged_attention"].append(paged_case(
                gen, PAGED_LENS, 16, kv_heads, dtype,
                timed=dtype is torch.float32, bitwise=True))
        for i, case in enumerate(FLASH_BWD_CASES):
            rows["flash_attention_bwd"].append(flash_bwd_case(
                gen, dtype=dtype, timed=i == 0, **case))
    # the decode kernel's split cases, float32 (their int8 twins are in 3c)
    rows["paged_attention"] += [
        paged_case(gen, LONE_SLOT, 16, 16, torch.float32, timed=True,
                   bitwise=True),
        paged_case(gen, SPLIT_EDGE_LENS, 16, 16, torch.float32),
        paged_case(gen, SHORT_LENS, 16, 16, torch.float32, max_blocks=256)]
    # the backward at the bench row's attention (phase 6c: 6 heads), timed
    rows["flash_attention_bwd"].append(flash_bwd_case(
        gen, dtype=torch.bfloat16, timed=True, **BENCH_BWD_CASE))
    # the training path's forward, timed in bf16 at the llama1b row's 16
    # heads and the bench row's 6 (the summary's forward entry keeps the
    # fp32 serving shape and shows these beside it)
    for heads in (16, BENCH_BWD_CASE["heads"]):
        rows["flash_attention"].append(flash_case(
            gen, TRAIN_SEQ, heads, 128, torch.bfloat16, timed=True,
            batch=TRAIN_BATCH))
    return rows


# int8 pages against the plain version on the same int8 pages: both take
# the same dequantized values (one fp32 product each), so only the order
# of the sums differs and the float32/bfloat16 TOL above applies. Against
# the unquantized pools (standard normal K/V) the int8 rounding error,
# <= max|vector| / 254 per element, moves the outputs by < 5e-2.
INT8_VS_FP32_TOL = dict(atol=5e-2, rtol=0.0)
# kernel 8's shapes on the tier-2 path, llama1b (H = Hkv = 16, D = 128):
# (a) a mixed step of 16 slots x 16-token chunks: full and partial prompt
# chunks, decode rows (q_len 1), idle rows, histories 0..2000 not aligned
# to the 16-token pages; (b) a prefix-cache suffix prefill: one slot, the
# 1024 bucket, 1000 new tokens after a 512-token cached prefix; (c) GQA
MIXED_STEP = dict(hist=[0, 5, 17, 100, 250, 513, 777, 1000, 1023, 1250,
                        1500, 1777, 1900, 2000, 31, 0],
                  q_lens=[16, 1, 16, 7, 1, 16, 1, 0, 12, 1, 16, 3, 1, 16,
                          0, 1], chunk=16, heads=16, kv_heads=16)
SUFFIX_PREFILL = dict(hist=[512], q_lens=[1000], chunk=1024, heads=16,
                      kv_heads=16)
MIXED_GQA = dict(hist=[0, 37, 700, 1500], q_lens=[16, 1, 9, 16], chunk=16,
                 heads=32, kv_heads=8, head_dim=64)
# row tiles whose last split lies wholly past row 0's horizon: row 0 of
# slot 0 sees keys 0..255 (split 0 of 256 keys), its later rows reach
# into split 1 (and slot 2's row 0 ends split 1, its rows 1-2 reach
# split 2); once in the 16-row rows kernel, once in the 64-row tiles
# kernel
HORIZON_ROWS = dict(hist=[255, 0, 511], q_lens=[16, 0, 3], chunk=16,
                    heads=16, kv_heads=16)
HORIZON_TILES = dict(hist=[255], q_lens=[64], chunk=64, heads=16,
                     kv_heads=16)


def phase_tier2_kernels(seed):
    """Phase 3c: kernel 8 in its three modes, kernel 7's int8 mode, and
    kernel 7's bf16 mode (bf16 q and pools) timed at the decode batch."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = {"mixed_paged_attention": [], "mixed_paged_attention_bf16": [],
            "mixed_paged_attention_int8": [], "paged_attention_int8": [],
            "paged_attention_bf16": [
                paged_case(gen, PAGED_LENS, 16, 16, bf16, timed=True,
                           bitwise=True)]}
    for dtype, key in ((f32, "mixed_paged_attention"),
                       (bf16, "mixed_paged_attention_bf16")):
        rows[key] += [
            mixed_case(gen, dtype=dtype, timed=True, bitwise=True,
                       **MIXED_STEP),
            mixed_case(gen, dtype=dtype, timed=dtype is f32, bitwise=True,
                       **SUFFIX_PREFILL),
            mixed_case(gen, dtype=dtype, **MIXED_GQA)]
    rows["mixed_paged_attention_int8"] += [
        mixed_case(gen, dtype=f32, timed=True, int8=True, bitwise=True,
                   **MIXED_STEP),
        mixed_case(gen, dtype=f32, timed=True, int8=True, bitwise=True,
                   **SUFFIX_PREFILL),
        mixed_case(gen, dtype=bf16, int8=True, **MIXED_STEP),
        mixed_case(gen, dtype=f32, int8=True, **MIXED_GQA)]
    rows["paged_attention_int8"] += [
        paged_case(gen, PAGED_LENS, 16, 16, f32, timed=True, int8=True,
                   bitwise=True),
        paged_case(gen, PAGED_LENS, 16, 4, f32, int8=True),
        paged_case(gen, PAGED_LENS, 16, 16, bf16, int8=True)]
    # the split cases (phase 3 has the decode kernel's float32 ones)
    for case in (HORIZON_ROWS, HORIZON_TILES):
        rows["mixed_paged_attention"].append(mixed_case(gen, dtype=f32,
                                                        **case))
        rows["mixed_paged_attention_int8"].append(mixed_case(
            gen, dtype=f32, int8=True, **case))
    rows["paged_attention_int8"] += [
        paged_case(gen, LONE_SLOT, 16, 16, f32, int8=True, bitwise=True),
        paged_case(gen, SPLIT_EDGE_LENS, 16, 16, f32, int8=True),
        paged_case(gen, SHORT_LENS, 16, 16, f32, int8=True, max_blocks=256)]
    return rows


# -- phase 3d: the segment-id mode of kernels 1-3 -----------------------------

def packed_ids(rng, batch, n, lo=64, hi=512):
    """Each row packs documents of lengths uniform in [lo, hi], the last
    one cut to fit; document i of a row has id i. Returns the ids
    ``[batch, n]`` int32 and each row's lengths."""
    ids = np.zeros((batch, n), np.int32)
    lens = []
    for r in range(batch):
        off, row = 0, []
        while off < n:
            length = min(int(rng.integers(lo, hi + 1)), n - off)
            ids[r, off:off + length] = len(row)
            row.append(length)
            off += length
        lens.append(row)
    return ids, lens


def scattered_ids(rng, batch, n, groups=6):
    """Packed documents (as ``packed_ids``) whose ids are drawn from
    ``groups`` values: not monotonic, and one id may label documents far
    apart, which then see each other."""
    ids, _ = packed_ids(rng, batch, n)
    return rng.integers(0, groups, (batch, int(ids.max()) + 1)).astype(
        np.int32)[np.arange(batch)[:, None], ids]


def shuffled_ids(rng, batch, n, groups=8):
    """Ids in no order: each position draws one of ``groups`` values."""
    return (rng.integers(0, groups, (batch, n)) * 5 - 7).astype(np.int32)


def visible_pairs(ids, heads, causal):
    """(query, key) pairs the segment mask (and the start-aligned causal
    mask) keeps, over all heads: per row and id of count c, c * c pairs,
    or c * (c + 1) / 2 when causal (for any order of the ids)."""
    total = 0
    for row in ids:
        _, counts = np.unique(row, return_counts=True)
        counts = counts.astype(np.int64)
        total += int((counts * (counts + 1) // 2).sum() if causal
                     else (counts * counts).sum())
    return heads * total


def dense_mask(segs, causal):
    """The boolean mask ``[B, 1, N, N]`` (True = attend) that gives torch
    SDPA the same function: equal ids, and key <= query when causal."""
    keep = segs[:, :, None] == segs[:, None, :]
    if causal:
        n = segs.shape[1]
        keep &= torch.ones(n, n, dtype=torch.bool, device=segs.device).tril()
    return keep[:, None]


def segmented_case(gen, ids, heads, head_dim, dtype, causal, tag,
                   timed=True):
    """The segmented forward, dq and dk/dv kernels on one set of ids
    against their plain versions; all-zero ids against the non-segmented
    kernels, bit for bit; with ``timed``, their times beside the plain
    versions', torch SDPA's with a dense mask and the bound of the
    visible pairs."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    batch, n = ids.shape

    def rand():
        return torch.randn((batch, n, heads, head_dim), generator=gen,
                           device="cuda").to(dtype)

    q, k, v, dout = rand(), rand(), rand(), rand()
    segs = torch.from_numpy(ids).cuda()
    out, lse = fa.flash_attention(q, k, v, causal, segment_ids=segs)
    grads = fa.flash_attention_backward(q, k, v, out, lse, dout, causal,
                                        segment_ids=segs)
    want_out, want_lse = fa.flash_attention_reference(q, k, v, causal,
                                                      segment_ids=segs)
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, dout,
                                                 causal, segment_ids=segs)
    torch.cuda.synchronize()
    name = "segmented %s B=%d N=%d H=%d D=%d %s %s" % (
        tag, batch, n, heads, head_dim, str(dtype).split(".")[-1],
        "causal" if causal else "non-causal")
    err = {"fwd": check_close(name + " out", out, want_out, TOL[dtype])}
    check_close(name + " lse", lse, want_lse, TOL[torch.float32])
    errs = [check_close("%s d%s" % (name, part), x, y, BWD_TOL[dtype])
            for part, x, y in zip("qkv", grads, want)]
    err["dq"], err["dkv"] = errs[0], max(errs[1:])

    zeros = torch.zeros_like(segs)
    z_out, z_lse = fa.flash_attention(q, k, v, causal, segment_ids=zeros)
    p_out, p_lse = fa.flash_attention(q, k, v, causal)
    z_grads = fa.flash_attention_backward(q, k, v, p_out, p_lse, dout,
                                          causal, segment_ids=zeros)
    p_grads = fa.flash_attention_backward(q, k, v, p_out, p_lse, dout,
                                          causal)
    same = [torch.equal(a, b) for a, b in zip(
        (z_out, z_lse, *z_grads), (p_out, p_lse, *p_grads))]
    if not all(same):
        raise AssertionError("%s: all-zero ids differ from the "
                             "non-segmented kernels (out, lse, dq, dk, dv "
                             "equal: %s)" % (name, same))
    row = {"case": name, "max_abs_err": err, "zero_ids_bitwise": True}
    if timed:
        esize = q.element_size()
        pairs = visible_pairs(ids, heads, causal)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
            .reshape(batch * heads, n).contiguous()
        args = (q, k, v, dout, lse, delta, causal, None, segs)
        row["ms"] = time_ms(lambda: fa.flash_attention(
            q, k, v, causal, segment_ids=segs))
        row["dq_ms"] = time_ms(lambda: fa.flash_attention_bwd_dq(*args))
        row["dkv_ms"] = time_ms(lambda: fa.flash_attention_bwd_dkv(*args))
        row["plain_ms"] = time_ms(lambda: fa.flash_attention_reference(
            q, k, v, causal, segment_ids=segs))
        row["plain_bwd_ms"] = time_ms(
            lambda: fa.flash_attention_backward_reference(
                q, k, v, out, lse, dout, causal, segment_ids=segs))
        mask = dense_mask(segs, causal)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        g = dout.transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = time_ms(lambda: sdpa(qt, kt, vt,
                                                 attn_mask=mask))
        lib_out = sdpa(qt, kt, vt, attn_mask=mask)
        row["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), g, retain_graph=True))
        row["library_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            sdpa(qt, kt, vt, attn_mask=mask), (qt, kt, vt), g))
        row["library"] = ("torch SDPA with a dense boolean mask [B, 1, N, "
                          "N]: forward; backward (dq, dk, dv together) as "
                          "autograd.grad of one forward; forward + "
                          "backward")
        row["visible_pairs"] = pairs
        row["causal_pairs"] = causal_pairs(batch * heads, n, n) \
            if causal else batch * heads * n * n
        reads = ((q.numel() + dout.numel() + k.numel() + v.numel()) * esize
                 + 2 * lse.numel() * 4 + segs.numel() * 4)
        row["fwd"] = bound(3 * q.numel() * esize + segs.numel() * 4
                           + q.numel() * esize + lse.numel() * 4,
                           4 * head_dim * pairs, dtype)
        row["dq"] = bound(reads + q.numel() * esize,
                          3 * 2 * head_dim * pairs, dtype)
        row["dkv"] = bound(reads + (k.numel() + v.numel()) * esize,
                           4 * 2 * head_dim * pairs, dtype)
    log("[segments] " + json.dumps(row))
    return row


# (a) the training shape, documents of 64-512 tokens; (b) float32, one
# 2048-token row of shuffled ids, non-causal
SEG_HEADS, SEG_HEAD_DIM = 16, 128


def segment_train_ids(seed):
    return packed_ids(np.random.default_rng(seed + 8), TRAIN_BATCH,
                      TRAIN_SEQ)


def phase_segmented_kernels(seed):
    """Phase 3d."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    ids_a, lens = segment_train_ids(seed)
    log("[segments] (a) documents per row %s"
        % [len(row) for row in lens])
    ids_b = shuffled_ids(np.random.default_rng(seed + 9), 1, 2048)
    rows = [segmented_case(gen, ids_a, SEG_HEADS, SEG_HEAD_DIM,
                           torch.bfloat16, True, "(a)"),
            segmented_case(gen, ids_b, SEG_HEADS, SEG_HEAD_DIM,
                           torch.float32, False, "(b)")]
    # the other dtype at each shape, and (c) scattered ids, where the
    # kernels' id-interval tile skip must keep the far-apart documents of
    # one id: checked only
    ids_c = scattered_ids(np.random.default_rng(seed + 10), 2, TRAIN_SEQ)
    for ids, dtype, causal, tag in (
            (ids_a[:2], torch.float32, True, "(a) fp32"),
            (ids_b, torch.bfloat16, False, "(b) bf16"),
            (ids_c, torch.float32, False, "(c)"),
            (ids_c, torch.bfloat16, True, "(c) bf16")):
        rows.append(segmented_case(gen, ids, SEG_HEADS, SEG_HEAD_DIM, dtype,
                                   causal, tag, timed=False))
    return {"segmented": rows}


# fused lm_head + CE vs its plain version. Forward: float32 sums of exact
# products in another order (tiles vs one GEMM), and a sum-exp combined
# across vocab splits; loss and lse ~10, so atol 1e-3 + rtol 1e-4 in both
# dtypes. Backward: float32 gradients sum T or V products in another
# order: atol 1e-4 x max|grad|, rtol 1e-3. bfloat16: dl is rounded to
# bf16 at the same point on both sides, but a p one float32 ulp apart may
# round to the neighbouring bf16, and dh/dW are rounded to bf16: atol
# 1e-2 x max|grad|, rtol 1e-2.
FCE_FWD_TOL = dict(atol=1e-3, rtol=1e-4)
FCE_BWD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-3, scaled=True),
               torch.bfloat16: dict(atol=1e-2, rtol=1e-2, scaled=True),
               # float16 keeps 11 bits where bf16 keeps 8: a quarter of
               # bf16's, and at least one float16 subnormal step (2^-24:
               # at an unscaled 1 / T, dh and dW lie in float16's
               # subnormal range, where a rounding flip moves an element
               # by one step)
               torch.float16: dict(atol=2.5e-3, rtol=2.5e-3, scaled=True,
                                   floor=2.0 ** -24)}
# (T, H, V, dtype, timed): the training shape, ragged vocabs (the bf16
# forward's last 256-column tile 64 and 208 wide), a ragged T (the last
# 128-row tile 104 deep), float32: the float32 training shape (phase 6f's
# loss tail; 128-row dh tiles), T = 1024 (64-row dh tiles), a ragged T
# and vocab (last vocab tile and chunk 80 wide), a ragged vocab (last
# vocab tile 64 wide, last chunk 3136) and a ragged H (dW's last 128-row
# tile and dh's last 128-column one 8 deep)
FCE_CASES = ((TRAIN_BATCH * TRAIN_SEQ, 2048, 32000, torch.bfloat16, True),
             (1024, 2048, 40000, torch.bfloat16, False),
             (512, 2048, 2000, torch.bfloat16, False),
             (1000, 2048, 2000, torch.bfloat16, False),
             (TRAIN_BATCH * TRAIN_SEQ, 2048, 32000, torch.float32, True),
             (1024, 2048, 32000, torch.float32, True),
             (1000, 2048, 2000, torch.float32, False),
             (1024, 2048, 40000, torch.float32, False),
             (512, 2048, 2000, torch.float32, False),
             (1000, 1032, 2000, torch.float32, False))


def fused_ce_case(gen, t_len, hid, vocab, dtype, timed,
                  profiled=False):
    from paddle_tpu_torch.kernels import fused_ce as fc
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.tools import fce_timing

    h = torch.randn((t_len, hid), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((hid, vocab), generator=gen, device="cuda")
         * math.sqrt(2.0 / (hid + vocab))).to(dtype)
    labels = torch.randint(0, vocab, (t_len,), generator=gen, device="cuda")
    labels[::8] = -100                      # 1/8 of the rows ignored
    valid = labels != -100
    safe = torch.where(valid, labels, 0)
    g_t = torch.where(valid, 1.0 / valid.sum(), 0.0).float()
    loss, lse = fc.fused_lm_head_ce_forward(h, w, safe)
    want_loss, want_lse = fc.fused_lm_head_ce_forward_reference(h, w, safe)
    dh, dw = fc.fused_lm_head_ce_backward(h, w, safe, lse, g_t)
    want_dh, want_dw = fc.fused_lm_head_ce_backward_reference(
        h, w, safe, want_lse, g_t)
    torch.cuda.synchronize()
    name = "fused_ce T=%d H=%d V=%d %s" % (t_len, hid, vocab,
                                           str(dtype).split(".")[-1])
    err = {"loss": check_close(name + " loss", loss, want_loss, FCE_FWD_TOL),
           "lse": check_close(name + " lse", lse, want_lse, FCE_FWD_TOL),
           "dh": check_close(name + " dh", dh, want_dh, FCE_BWD_TOL[dtype]),
           "dw": check_close(name + " dw", dw, want_dw, FCE_BWD_TOL[dtype])}
    # one writer per output tile, a fixed order of summation: a second
    # launch gives the same bits
    again = (fc.fused_lm_head_ce_forward(h, w, safe)
             + fc.fused_lm_head_ce_backward(h, w, safe, lse, g_t))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(again, (loss, lse, dh, dw))):
        raise AssertionError(name + ": two launches differ")
    row = {"case": name, "max_abs_err": err,
           "chunk": fc.chunk_columns(vocab),
           "splits": fc.forward_splits(t_len, vocab, dtype)}
    if timed:
        iters, reps = ((10, 5) if dtype in (torch.bfloat16, torch.float16)
                       else (3, 3))
        row["fwd_ms"] = time_ms(lambda: fc.fused_lm_head_ce_forward(
            h, w, safe), iters, reps)
        split = []

        def backward():
            events = {}
            fc.fused_lm_head_ce_backward(h, w, safe, lse, g_t, events)
            split.append(events)
        row["bwd_ms"] = time_ms(backward, iters, reps)
        torch.cuda.synchronize()
        for part in ("dh", "dw"):
            per_call = [sum(ev[part][i].elapsed_time(ev[part][i + 1])
                            for i in range(0, len(ev[part]), 2))
                        for ev in split[1:]]
            row[part + "_ms"] = statistics.median(per_call)
        if profiled:
            # the kernels' own device time a call (fwd: the partials and
            # the combine; dh: every chunk's dl and dh; dw: every chunk's)
            row["device_ms"] = fce_timing.device_ms(
                lambda: (fc.fused_lm_head_ce_forward(h, w, safe),
                         fc.fused_lm_head_ce_backward(h, w, safe, lse, g_t)))
        row["plain_fwd_ms"] = time_ms(
            lambda: fc.fused_lm_head_ce_forward_reference(h, w, safe),
            iters, reps)
        row["plain_bwd_ms"] = time_ms(
            lambda: fc.fused_lm_head_ce_backward_reference(
                h, w, safe, want_lse, g_t), iters, reps)
        # the yardstick: the port's own unfused tail, Linear then
        # cross_entropy, forward and forward + backward
        hg = h.detach().requires_grad_()
        wg = w.detach().requires_grad_()
        row["unfused_fwd_ms"] = time_ms(
            lambda: F.cross_entropy(hg @ wg, labels), iters, reps)
        row["unfused_fwd_bwd_ms"] = time_ms(
            lambda: torch.autograd.grad(F.cross_entropy(hg @ wg, labels),
                                        (hg, wg)), iters, reps)
        # the yardstick: cuBLAS's torch.matmul of each kernel's products
        # over the same vocab chunks (no PyTorch call computes the fused
        # function without the logits)
        row["library_ms"] = {
            part: time_ms(fn, iters, reps) for part, fn in
            fce_timing.library_products(h, w, fc.chunk_plan(vocab)).items()}
        row["library"] = ("torch.matmul of the same products over the same "
                          "vocab chunks (fwd h.W[:, c]; dh h.W[:, c] and "
                          "dl.W[:, c]^T; dw h^T.dl), a yardstick: no single "
                          "PyTorch call computes lm_head + CE without the "
                          "logits")
        esize = h.element_size()
        reads = (h.numel() + w.numel()) * esize + t_len * 4
        product = 2 * t_len * hid * vocab
        # the dh side recomputes the logits for dl (1 product) and takes
        # dl . W^T (1); the dW side takes h^T . dl (1) from the shared dl
        row["fwd"] = bound(reads + 2 * t_len * 4, product, dtype)
        row["dh"] = bound(reads + 2 * t_len * 4 + dh.numel() * esize,
                          2 * product, dtype)
        row["dw"] = bound(reads + 2 * t_len * 4 + dw.numel() * esize,
                          product, dtype)
    log("[kernels] " + json.dumps(row))
    return row


def mma_probe_case(seed):
    from paddle_tpu_torch.tools import mma_probe

    mma_probe.launches = 0
    forms = mma_probe.run(seed)
    launches = {"mma_probe": mma_probe.launches}
    failed = [f["name"] for f in forms if not f["ok"]]
    if failed:
        raise AssertionError("mma probe forms FAIL: %s" % failed)
    if launches["mma_probe"] != len(mma_probe.FORMS):
        raise AssertionError("mma probe launched %s" % launches)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a, b = mma_probe.inputs(1, gen, "cuda")   # the nn form, fused CE's h.W
    row = {"case": "mma_probe nn bf16 512 x 128 x 512", "forms": forms,
           "max_abs_err": max(f["max_abs_err"] for f in forms),
           "ms": time_ms(lambda: mma_probe.probe(1, a, b)),
           "plain_ms": time_ms(lambda: mma_probe.plain(1, a, b)),
           "library_ms": time_ms(lambda: torch.matmul(a, b)),
           "library": "torch.matmul of the bf16 operands (bf16 result)"}
    row.update(bound((a.numel() + b.numel()) * 2 + 512 * 512 * 4,
                     2 * 512 * 512 * 128, torch.bfloat16))
    log("[kernels] " + json.dumps(row))
    return row, launches


def phase_fused_kernels(seed):
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    probe, probe_launches = mma_probe_case(seed)
    cases = [fused_ce_case(gen, *case) for case in FCE_CASES]
    return {"mma_probe": [probe], "fused_ce": cases}, probe_launches


# -- phase 4 / 5 -------------------------------------------------------------

def pct(values, q):
    values = sorted(values)
    return values[min(len(values) - 1, int(math.ceil(q * len(values))) - 1)]


def phase_slice(seed):
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine
    from paddle_tpu_torch.serving.kernels import paged_attention as pa

    cfg = LlamaConfig.llama1b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed))
    engine = Engine(model, max_slots=16, block_size=16, num_blocks=2048,
                    max_model_len=2048)
    torch.cuda.synchronize()
    log("[slice] llama1b fp32 (%d layers, hidden %d) + Engine in %.1f s" % (
        cfg.num_hidden_layers, cfg.hidden_size, time.perf_counter() - t0))
    rng = np.random.default_rng(seed)
    check_prompt = rng.integers(0, cfg.vocab_size, 64).tolist()
    check_id = engine.add_request(check_prompt, max_new_tokens=16)
    expect = {check_id: 16}
    for n in rng.integers(128, 1537, 32):
        rid = engine.add_request(rng.integers(0, cfg.vocab_size, n).tolist(),
                                 max_new_tokens=64)
        expect[rid] = 64

    fa.launches = 0
    pa.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches,
                "paged_attention": pa.launches}

    for rid, n in expect.items():
        if len(outs[rid]) != n:
            raise AssertionError("request %d produced %d tokens, not %d"
                                 % (rid, len(outs[rid]), n))
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError("%s was never launched on the main path"
                                 % name)
    st = engine.stats()
    per = [engine.request_metrics(rid) for rid in expect]
    ttft = [m["ttft_s"] for m in per]
    tpot = [m["tpot_s"] for m in per]
    result = {
        "requests": len(expect), "wall_s": wall,
        "prefill_tokens": st["prefill_tokens"], "prefill_runs":
            st["prefill_runs"], "prefill_tok_s": st["prefill_tokens"]
            / st["prefill_s"],
        "decode_steps": st["decode_steps"], "decode_tok_s":
            st["decode_tokens"] / st["decode_s"],
        "output_tokens": st["output_tokens"], "preemptions":
            st["preemptions"], "slot_occupancy": st["slot_occupancy"],
        "ttft_p50_s": pct(ttft, 0.5), "ttft_p99_s": pct(ttft, 0.99),
        "tpot_p50_s": pct(tpot, 0.5), "tpot_p99_s": pct(tpot, 0.99),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches}
    log("[slice] " + json.dumps(result))
    return model, check_prompt, outs[check_id], launches


def launch_counters():
    """Every attention kernel's launch counter, by summary entry (the
    float32 and bfloat16 modes of the mixed kernel share one counter; the
    float16 modes count apart), the int8-weight GEMM's (every mode, and its
    bf16 and float16 modes), and the bf16 kernels' TMA operand copies."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import quant
    from paddle_tpu_torch.serving.kernels import paged_attention as pa

    return {"flash_attention": fa.launches,
            "flash_attention_bwd_dq": fa.dq_launches,
            "flash_attention_bwd_dkv": fa.dkv_launches,
            "flash_attention_segmented": fa.segmented_fwd_launches,
            "flash_attention_bwd_dq_segmented": fa.segmented_dq_launches,
            "flash_attention_bwd_dkv_segmented": fa.segmented_dkv_launches,
            "flash_attention_fp16": fa.f16_launches,
            "flash_attention_bwd_dq_fp16": fa.f16_dq_launches,
            "flash_attention_bwd_dkv_fp16": fa.f16_dkv_launches,
            "paged_attention": pa.launches,
            "paged_attention_int8": pa.int8_launches,
            "mixed_paged_attention": pa.mixed_launches,
            "mixed_paged_attention_bf16": pa.mixed_launches,
            "mixed_paged_attention_int8": pa.mixed_int8_launches,
            "paged_attention_fp16": pa.f16_launches,
            "paged_attention_int8_fp16": pa.f16_int8_launches,
            "mixed_paged_attention_fp16": pa.f16_mixed_launches,
            "mixed_paged_attention_int8_fp16": pa.f16_mixed_int8_launches,
            "int8_weight_matmul": quant.launches,
            "int8_weight_matmul_bf16": quant.bf16_launches,
            "int8_weight_matmul_fp16": quant.f16_launches,
            # not a kernel: operand copies the bf16 forward and backward
            # made for TMA, which every main path's exact count holds at 0
            "tma_copies": fa.tma_copies}


def reset_launch_counters():
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import quant
    from paddle_tpu_torch.serving.kernels import paged_attention as pa

    fa.launches = fa.dq_launches = fa.dkv_launches = 0
    fa.segmented_fwd_launches = fa.segmented_dq_launches = 0
    fa.segmented_dkv_launches = fa.tma_copies = 0
    fa.f16_launches = fa.f16_dq_launches = fa.f16_dkv_launches = 0
    pa.launches = pa.int8_launches = 0
    pa.mixed_launches = pa.mixed_int8_launches = 0
    pa.f16_launches = pa.f16_int8_launches = 0
    pa.f16_mixed_launches = pa.f16_mixed_int8_launches = 0
    quant.launches = quant.bf16_launches = quant.f16_launches = 0


def tier2_engine(model, prefix, chunked, quant_kv, device=None, **kw):
    """An Engine built with the tier-2 flags set (they are latched at
    construction); the flags are cleared again right after."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.serving import Engine

    names = ("FLAGS_serving_prefix_cache", "FLAGS_serving_chunked_prefill",
             "FLAGS_serving_quant_kv")
    flags.set_flags(dict(zip(names, (prefix, chunked, quant_kv))))
    try:
        return Engine(model, device=device, **kw)
    finally:
        flags.set_flags(dict.fromkeys(names, False))


# phase 4b: the reference's shared-prefix traffic (serving_benchmark.py
# --shared-prefix-tokens 512 --prefix-groups 4) at the phase-4 geometry
TIER2_RUNS = (("prefix", True, False, False),
              ("prefix+chunked", True, True, False),
              ("prefix+int8", True, False, True),
              ("prefix+chunked+int8", True, True, True))
TIER2_GEOMETRY = dict(max_slots=16, block_size=16, max_model_len=2048,
                      prefill_chunk=16)
TIER2_NEW_TOKENS = 64


def tier2_prompts(seed, vocab):
    """32 prompts of one of 4 shared 512-token prefixes plus a random
    16-512-token tail; then a repeat of the first (a hit on all but one
    token) and one sharing 520 tokens, 32.5 pages, with the second, so
    its first write copies the half-shared page."""
    rng = np.random.default_rng(seed + 3)
    prefixes = [rng.integers(0, vocab, 512).tolist() for _ in range(4)]
    prompts = [prefixes[int(rng.integers(4))]
               + rng.integers(0, vocab, int(rng.integers(16, 513))).tolist()
               for _ in range(32)]
    prompts.append(list(prompts[0]))
    prompts.append(prompts[1][:520] + rng.integers(0, vocab, 100).tolist())
    return prompts


def tier2_blocks(cfg, quant_kv, fp32_blocks=2048, block_size=16):
    """The fp32 run's page count, or for int8 pages the count the same
    bytes buy (serving_benchmark.py's equal-byte-budget sizing)."""
    if not quant_kv:
        return fp32_blocks
    d = cfg.hidden_size // cfg.num_attention_heads
    hkv = cfg.num_key_value_heads
    fp32_page = 8 * block_size * hkv * d
    int8_page = 2 * block_size * hkv * (d + 4)
    return fp32_blocks * fp32_page // int8_page


def tier2_run(model, prompts, tag, prefix, chunked, quant_kv):
    cfg = model.config
    layers = cfg.num_hidden_layers
    num_blocks = tier2_blocks(cfg, quant_kv)
    engine = tier2_engine(model, prefix, chunked, quant_kv,
                          num_blocks=num_blocks, **TIER2_GEOMETRY)
    ids = [engine.add_request(p, max_new_tokens=TIER2_NEW_TOKENS)
           for p in prompts]
    reset_launch_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counters()
    st = engine.stats()
    per = [engine.request_metrics(i) for i in ids]
    name = "[tier2 %s]" % tag
    for rid in ids:
        if len(engine.output(rid)) != TIER2_NEW_TOKENS:
            raise AssertionError("%s request %d produced %d tokens"
                                 % (name, rid, len(engine.output(rid))))
    if not (st["prefix_hit_tokens"] > 0 and st["cow_clones"] > 0):
        raise AssertionError("%s no prefix hit or no copy-on-write: %s"
                             % (name, st))
    mode = "_int8" if quant_kv else ""
    want = dict.fromkeys(launches, 0)
    if chunked:
        want["mixed_paged_attention" + mode] = layers * st["mixed_steps"]
    else:
        want["mixed_paged_attention" + mode] = layers * st["prefill_runs"]
        want["paged_attention" + mode] = layers * st["decode_steps"]
    want["mixed_paged_attention_bf16"] = want["mixed_paged_attention"]
    if launches != want:
        raise AssertionError("%s launches %s, expected %s"
                             % (name, launches, want))
    ttft = [m["ttft_s"] for m in per]
    tpot = [m["tpot_s"] for m in per]
    result = {
        "requests": len(ids), "wall_s": wall,
        "output_tok_s": st["output_tokens"] / wall,
        "ttft_p50_s": pct(ttft, 0.5), "ttft_p99_s": pct(ttft, 0.99),
        "tpot_p50_s": pct(tpot, 0.5), "tpot_p99_s": pct(tpot, 0.99),
        "prefill_runs": st["prefill_runs"], "decode_steps":
            st["decode_steps"], "mixed_steps": st["mixed_steps"],
        "tokens_per_mixed_step": (st["mixed_tokens"] / st["mixed_steps"]
                                  if st["mixed_steps"] else None),
        "mixed_tok_s": (st["mixed_tokens"] / st["mixed_s"]
                        if st["mixed_steps"] else None),
        "prefill_tok_s": (st["prefill_tokens"] / st["prefill_s"]
                          if st["prefill_s"] else None),
        "decode_tok_s": (st["decode_tokens"] / st["decode_s"]
                         if st["decode_s"] else None),
        "prefix_hit_rate": st["prefix_hit_tokens"]
            / st["prefix_lookup_tokens"],
        "prefix_hit_tokens": st["prefix_hit_tokens"],
        "cow_clones": st["cow_clones"],
        "prefix_evictions": st["prefix_evictions"],
        "prefill_chunks": st["prefill_chunks"],
        "preemptions": st["preemptions"],
        "kv_pages": num_blocks - 1,
        "kv_token_capacity": (num_blocks - 1) * TIER2_GEOMETRY["block_size"],
        "kv_quant_pages": st["kv_quant_pages"],
        "quant_dequant_bytes": st["quant_dequant_bytes"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches}
    log(name + " " + json.dumps(result))
    del engine
    torch.cuda.empty_cache()
    return result


def phase_tier2_slice(seed, model):
    """Phase 4b: llama1b (the phase-4 model) through the prefix cache,
    chunked prefill and int8 KV pages, four runs of the same traffic."""
    prompts = tier2_prompts(seed, model.config.vocab_size)
    out = {}
    for tag, prefix, chunked, quant_kv in TIER2_RUNS:
        out[tag] = tier2_run(model, prompts, tag, prefix, chunked, quant_kv)
    return out


def diverges_at_near_tie(tag, cpu_model, prompt, want, got, rel=None):
    """True when ``got`` equals ``want``; else the first divergence must
    sit at a top-2 logit gap below NEAR_TIE, or with ``rel`` below ``rel``
    x the row's max |logit| (dense logits on the CPU copy), or this
    raises. Nothing after the first divergence is compared."""
    if got == want:
        return True
    i = next((j for j, (a, b) in enumerate(zip(want, got)) if a != b),
             min(len(want), len(got)))
    with torch.no_grad():
        logits = cpu_model(torch.tensor([prompt + want[:i]]))[0, -1].float()
    top2 = logits.topk(2).values
    gap = float(top2[0] - top2[1])
    limit = NEAR_TIE if rel is None else rel * float(logits.abs().max())
    log("%s first divergence at token %d, top-2 logit gap %.4g (limit "
        "%.4g)" % (tag, i, gap, limit))
    if gap >= limit:
        raise AssertionError("%s diverges at token %d with a top-2 gap of "
                             "%.4g (>= %.4g): not a near-tie" % (
                                 tag, i, gap, limit))
    return False


def phase_tier2_e2e(seed, model, cpu_model):
    """Phase 5b: three full-width requests, two sharing a 48-token
    prefix and one matching 40 tokens of it (half a page: copy-on-write),
    through prefix cache + chunked prefill on the card and on the CPU copy
    (plain path), with and without int8 pages; and the card's fp32 tokens
    against the card's flags-off engine."""
    rng = np.random.default_rng(seed + 5)
    vocab = model.config.vocab_size
    base = rng.integers(0, vocab, 48).tolist()
    prompts = [base + rng.integers(0, vocab, 8).tolist(),
               base + rng.integers(0, vocab, 8).tolist(),
               base[:40] + rng.integers(0, vocab, 10).tolist()]

    def serve(m, device, flags_on, quant_kv):
        t0 = time.perf_counter()
        engine = tier2_engine(m, flags_on, flags_on, quant_kv, device=device,
                              max_slots=3, block_size=16, num_blocks=64,
                              max_model_len=256, prefill_chunk=16)
        ids = [engine.add_request(prompts[0], max_new_tokens=8)]
        engine.run()
        ids += [engine.add_request(p, max_new_tokens=8) for p in prompts[1:]]
        engine.run()
        st = engine.stats()
        tokens = [engine.output(i) for i in ids]
        log("[tier2 e2e] %s %s%s: %s (%.1f s; prefix hit %d tokens, %d "
            "clones)" % ("card" if device is None else "cpu ",
                         "prefix+chunked" if flags_on else "flags off",
                         "+int8" if quant_kv else "", tokens,
                         time.perf_counter() - t0, st["prefix_hit_tokens"],
                         st["cow_clones"]))
        if flags_on and not (st["prefix_hit_tokens"] >= 88
                             and st["cow_clones"] >= 1):
            raise AssertionError("[tier2 e2e] expected 48 + 40 cached tokens "
                                 "and a clone: %s" % st)
        return tokens

    card_off = serve(model, None, False, False)
    for quant_kv in (False, True):
        card = serve(model, None, True, quant_kv)
        cpu = serve(cpu_model, "cpu", True, quant_kv)
        tag = "[tier2 e2e%s]" % (" int8" if quant_kv else "")
        same = [diverges_at_near_tie(tag + " card vs cpu", cpu_model, p, w, g)
                for p, w, g in zip(prompts, cpu, card)]
        if not quant_kv:
            same += [diverges_at_near_tie(tag + " tier 2 vs flags off",
                                          cpu_model, p, w, g)
                     for p, w, g in zip(prompts, card_off, card)]
        log("%s %d of %d token sequences identical" % (tag, sum(same),
                                                       len(same)))


def phase_e2e(model, prompt, card_tokens):
    """Phase 5; returns the model's CPU copy (phase 5b reuses it)."""
    from paddle_tpu_torch.serving import Engine

    t0 = time.perf_counter()
    cpu_model = copy.deepcopy(model).to("cpu")
    engine = Engine(cpu_model, max_slots=1, block_size=16, num_blocks=8,
                    max_model_len=2048, device="cpu")
    rid = engine.add_request(prompt, max_new_tokens=len(card_tokens))
    cpu_tokens = engine.run()[rid]
    log("[e2e] card %s" % card_tokens)
    log("[e2e] cpu  %s (%.1f s)" % (cpu_tokens, time.perf_counter() - t0))
    # random weights can make greedy tokens insensitive (a few ids may
    # dominate), so the full-width logits of the whole sequence are held
    # card (flash kernel) against CPU (plain path) as well
    ids = torch.tensor([prompt + card_tokens])
    with torch.no_grad():
        want = cpu_model(ids)[0]
        got = model(ids.to(model.device))[0].cpu()
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    log("[e2e] logits [%d, %d]: max abs diff %.3g, max |logit| %.3g" % (
        want.shape[0], want.shape[1], diff, scale))
    if not (bool(torch.isfinite(got).all()) and diff <= LOGIT_RTOL * scale):
        raise AssertionError("card logits differ from the CPU plain path "
                             "by %.3g (> %g x %.3g)"
                             % (diff, LOGIT_RTOL, scale))
    if diverges_at_near_tie("[e2e]", cpu_model, prompt, cpu_tokens,
                            card_tokens):
        log("[e2e] greedy tokens identical")
    return cpu_model


# -- phase 11: generate on a static decode cache ------------------------------

# (a) llama1b: greedy, beam and sampling; (b) GPT-2 small's geometry
GEN_GREEDY = dict(batch=4, prompt=64, new=16)
GEN_BEAM = dict(batch=2, num_beams=4, new=8, length_penalty=1.0)
GEN_SAMPLE = dict(top_k=50, top_p=0.9, temperature=0.8)
GEN_GPT2 = dict(batch=4, prompt=128, new=32)
# GPT-2's token table at its own initialisation, N(0, 0.02^2) (Radford et
# al., 2019): at the reference's N(0, 1) the tied logits make greedy decoding
# repeat the last token, and the token checks would hold nothing
GPT2_WTE_STD = 0.02
# beam tokens card vs CPU copy: equal, or both picks scoring within this of
# each other on the CPU copy (a near-tie in summed fp32 log-probabilities,
# whose terms differ by ~1e-5 card against CPU)
BEAM_NEAR_TIE = 1e-3
# kernel 1 at the rectangular prefills of GPT-2 (D = 64) and llama1b
# (D = 128): q_len = prompt, kv_len = prompt + new tokens
GEN_FLASH_CASES = (dict(batch=4, n=128, n_kv=160, heads=12, head_dim=64),
                   dict(batch=4, n=64, n_kv=80, heads=16, head_dim=128))
# kernel 7 at GPT-2's decode batch: 4 slots, 12 heads x 64, histories of the
# engine run's decode steps (128 to 159 tokens), 64 pages a slot (1024)
GEN_PAGED_LENS = [129, 137, 150, 159]


def timed_call(fn):
    """(fn(), seconds), synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def gen_launches(tag, flash, paged=0):
    """The launch counters since the last reset, every one of them exactly
    as the path wants: ``flash`` forwards, ``paged`` decode launches, no
    other kernel and no TMA copy."""
    counts = launch_counters()
    want = dict.fromkeys(counts, 0)
    want.update(flash_attention=flash, paged_attention=paged)
    if counts != want:
        raise AssertionError("%s launches %s, want %s" % (
            tag, {k: v for k, v in counts.items() if v},
            {k: v for k, v in want.items() if v}))
    return counts


def generate_run(tag, model, ids, flash, card, **kw):
    """One ``generate`` call on the card with exact launch counts, timed:
    a prefill-only call (``max_new_tokens=1``) first, outside the counted
    window, gives the prefill's share, and the decode steps share the
    rest. Returns (tokens as lists, launch counts, timing row)."""
    new = kw.pop("max_new_tokens")
    _, prefill_s = timed_call(lambda: model.generate(ids, max_new_tokens=1,
                                                     **kw))
    reset_launch_counters()
    out, wall = timed_call(lambda: model.generate(ids, max_new_tokens=new,
                                                  **kw))
    counts = gen_launches(tag, flash)
    b = ids.shape[0]
    row = {"run": tag, "batch": b, "prompt": ids.shape[1],
           "new_tokens": new, "wall_s": wall, "prefill_s": prefill_s,
           "decode_ms_per_step": (wall - prefill_s) / (new - 1) * 1e3,
           "tokens_per_s": b * new / wall,
           "decode_tokens_per_s": b * (new - 1) / (wall - prefill_s),
           "card": card}
    log("[generate] " + json.dumps(row))
    if out.shape != (b, new):
        raise AssertionError("%s: tokens of shape %s" % (tag, out.shape))
    return out.cpu().tolist(), counts, row


def check_greedy_tokens(tag, cpu_model, prompts, want, got):
    same = [diverges_at_near_tie(tag, cpu_model, p, w, g)
            for p, w, g in zip(prompts, want, got)]
    log("%s %d of %d token sequences identical" % (tag, sum(same),
                                                   len(same)))


def beam_score(cpu_model, prompt, tokens, length_penalty):
    """The CPU copy's summed log-probability of ``tokens`` after
    ``prompt`` over their length ** length_penalty (no eos among them:
    eos-padded tails score 0 in the beam search, and are cut here)."""
    with torch.no_grad():
        logits = cpu_model(torch.tensor([prompt + tokens]))[0].float()
    logp = torch.log_softmax(logits[len(prompt) - 1:-1], dim=-1)
    return float(logp.gather(1, torch.tensor(tokens)[:, None]).sum()
                 / len(tokens) ** length_penalty)


def check_beam_tokens(tag, cpu_model, prompts, want, got, eos,
                      length_penalty):
    """Equal, or both picks within BEAM_NEAR_TIE on the CPU copy."""
    for p, w, g in zip(prompts, want, got):
        if w == g:
            continue
        cut = [t[:t.index(eos) + 1] if eos in t else t for t in (w, g)]
        sw, sg = (beam_score(cpu_model, p, t, length_penalty) for t in cut)
        log("%s beams differ: cpu %s (score %.6g), card %s (score %.6g)"
            % (tag, w, sw, g, sg))
        if abs(sw - sg) >= BEAM_NEAR_TIE:
            raise AssertionError("%s: the card's beam scores %.6g, the CPU "
                                 "copy's %.6g: not a near-tie" % (tag, sg,
                                                                  sw))
    log("%s %d of %d beams identical" % (
        tag, sum(w == g for w, g in zip(want, got)), len(want)))


def check_prefill_logits(tag, model, cpu_model, ids, total):
    """The prefill's last logits, card against CPU copy, within
    LOGIT_RTOL x max |logit|."""
    with torch.no_grad():
        got = model.generate_step(
            ids, model.init_decode_caches(ids.shape[0], total), 0)[:, -1]
        want = cpu_model.generate_step(
            ids.cpu(), cpu_model.init_decode_caches(ids.shape[0], total),
            0)[:, -1]
    got = got.cpu()
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    log("%s prefill logits %s: max abs diff %.3g, max |logit| %.3g" % (
        tag, list(want.shape), diff, scale))
    if not (bool(torch.isfinite(got).all()) and diff <= LOGIT_RTOL * scale):
        raise AssertionError("%s: prefill logits differ by %.3g (> %g x "
                             "%.3g)" % (tag, diff, LOGIT_RTOL, scale))


def generate_kernels(seed):
    """Kernel 1 at the generate prefills' rectangular shapes and kernel 7
    at GPT-2's decode batch against their plain versions, timed (kernel 1
    also by the profiler's device time: at these sizes CUDA events time
    the wrapper's host cost)."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    flash = []
    for case in GEN_FLASH_CASES:
        row = flash_case(gen, dtype=torch.float32, timed=True, **case)
        q = torch.randn((case["batch"], case["n"], case["heads"],
                         case["head_dim"]), generator=gen, device="cuda")
        k, v = (torch.randn((case["batch"], case["n_kv"], case["heads"],
                             case["head_dim"]), generator=gen,
                            device="cuda") for _ in range(2))
        row["device_ms"] = device_ms(
            lambda: fa.flash_attention(q, k, v, causal=True), "flash_fwd")
        log("[kernels] %s device %.4f ms" % (row["case"], row["device_ms"]))
        flash.append(row)
    paged = [paged_case(gen, GEN_PAGED_LENS, 12, 12, torch.float32,
                        timed=True, head_dim=64, max_blocks=64,
                        bitwise=True)]
    return {"flash_attention": flash, "paged_attention": paged}


def phase_generate(seed, model, cpu_model, card):
    """Phase 11: llama1b (the phase-4 model) and GPT-2 small's geometry
    through ``generate`` on the card against their CPU copies and the
    serving engine; exact launch counts; kernels 1 and 7 at this path's
    shapes. Returns (kernel rows, launch counts by path, timing rows)."""
    from paddle_tpu_torch.models import GPTModel
    from paddle_tpu_torch.serving import Engine

    t_phase = time.perf_counter()
    layers = model.config.num_hidden_layers
    rng = np.random.default_rng(seed + 11)
    vocab = model.config.vocab_size
    paths, timing = {}, []

    # (a) llama1b: greedy against the CPU copy and the engine
    g = GEN_GREEDY
    prompts = rng.integers(0, vocab, (g["batch"], g["prompt"])).tolist()
    ids = torch.tensor(prompts, device="cuda")
    total = g["prompt"] + g["new"]
    check_prefill_logits("[generate] llama1b", model, cpu_model, ids, total)
    greedy, paths["generate llama1b greedy"], row = generate_run(
        "llama1b greedy", model, ids, layers, card, max_new_tokens=g["new"])
    timing.append(row)
    t0 = time.perf_counter()
    cpu_greedy = cpu_model.generate(torch.tensor(prompts),
                                    max_new_tokens=g["new"]).tolist()
    log("[generate] llama1b greedy on the CPU copy in %.1f s"
        % (time.perf_counter() - t0))
    check_greedy_tokens("[generate] llama1b greedy card vs cpu", cpu_model,
                        prompts, cpu_greedy, greedy)
    engine = Engine(model, max_slots=g["batch"], block_size=16,
                    num_blocks=64, max_model_len=2 * total)
    rids = [engine.add_request(p, max_new_tokens=g["new"]) for p in prompts]
    outs = engine.run()
    check_greedy_tokens("[generate] llama1b engine vs generate", cpu_model,
                        prompts, greedy, [outs[r] for r in rids])

    # beam search with an eos the beams reach: greedy row 0's third token
    bm = GEN_BEAM
    eos = greedy[0][2]
    beam_prompts = prompts[:bm["batch"]]
    kw = dict(num_beams=bm["num_beams"], eos_token_id=eos,
              length_penalty=bm["length_penalty"])
    beam, paths["generate llama1b beam"], row = generate_run(
        "llama1b beam", model, torch.tensor(beam_prompts, device="cuda"),
        layers, card, max_new_tokens=bm["new"], **kw)
    timing.append(row)
    t0 = time.perf_counter()
    cpu_beam = cpu_model.generate(torch.tensor(beam_prompts),
                                  max_new_tokens=bm["new"], **kw).tolist()
    log("[generate] llama1b beam card %s, cpu %s (%.1f s)"
        % (beam, cpu_beam, time.perf_counter() - t0))
    check_beam_tokens("[generate] llama1b beam card vs cpu", cpu_model,
                      beam_prompts, cpu_beam, beam, eos,
                      bm["length_penalty"])

    # sampling: one seed twice gives one answer; top_k = 1 is greedy
    sampled = []
    for i in range(2):
        toks, paths["generate llama1b sample %d" % i], row = generate_run(
            "llama1b sample", model, ids, layers, card,
            max_new_tokens=g["new"], do_sample=True, seed=seed, **GEN_SAMPLE)
        sampled.append(toks)
    timing.append(row)
    if sampled[0] != sampled[1]:
        raise AssertionError("[generate] one seed sampled %s then %s"
                             % tuple(sampled))
    top1, paths["generate llama1b top_k 1"], _ = generate_run(
        "llama1b top_k=1", model, ids, layers, card,
        max_new_tokens=g["new"], do_sample=True, top_k=1, seed=seed)
    if top1 != greedy:
        raise AssertionError("[generate] top_k=1 sampled %s, greedy gave %s"
                             % (top1, greedy))
    log("[generate] llama1b sampling: %d of %d tokens differ from greedy; "
        "repeatable per seed; top_k=1 is greedy" % (
            sum(a != b for r, q in zip(sampled[0], greedy)
                for a, b in zip(r, q)), g["batch"] * g["new"]))
    del engine
    torch.cuda.empty_cache()

    # (b) GPT-2 small's geometry at the reference's defaults
    g = GEN_GPT2
    gpt = GPTModel(generator=torch.Generator(device="cuda").manual_seed(seed))
    with torch.no_grad():
        gpt.wte.weight.mul_(GPT2_WTE_STD)
    cpu_gpt = copy.deepcopy(gpt).to("cpu")
    n_params = sum(p.numel() for p in gpt.parameters())
    blocks = len(gpt.blocks)
    log("[generate] GPT-2 fp32: %d blocks, hidden %d, %d heads x %d, vocab "
        "%d, %.1fM parameters" % (
            blocks, gpt.wte.embedding_dim, gpt.blocks[0].heads,
            gpt.blocks[0].head_dim, gpt.vocab_size, n_params / 1e6))
    prompts = rng.integers(0, gpt.vocab_size,
                           (g["batch"], g["prompt"])).tolist()
    ids = torch.tensor(prompts, device="cuda")
    total = g["prompt"] + g["new"]
    check_prefill_logits("[generate] gpt2", gpt, cpu_gpt, ids, total)
    greedy, paths["generate gpt2 greedy"], row = generate_run(
        "gpt2 greedy", gpt, ids, blocks, card, max_new_tokens=g["new"])
    timing.append(row)
    t0 = time.perf_counter()
    cpu_greedy = cpu_gpt.generate(torch.tensor(prompts),
                                  max_new_tokens=g["new"]).tolist()
    log("[generate] gpt2 greedy on the CPU copy in %.1f s"
        % (time.perf_counter() - t0))
    check_greedy_tokens("[generate] gpt2 greedy card vs cpu", cpu_gpt,
                        prompts, cpu_greedy, greedy)
    log("[generate] gpt2 greedy: %d distinct tokens in %d" % (
        len({t for r in greedy for t in r}), g["batch"] * g["new"]))

    engine = Engine(gpt, max_slots=g["batch"], block_size=16, num_blocks=64)
    rids = [engine.add_request(p, max_new_tokens=g["new"]) for p in prompts]
    reset_launch_counters()
    outs, wall = timed_call(engine.run)
    st = engine.stats()
    counts = gen_launches("[generate] gpt2 engine",
                          flash=blocks * st["prefill_runs"],
                          paged=blocks * st["decode_steps"])
    paths["serving gpt2"] = counts
    row = {"run": "gpt2 engine", "batch": g["batch"], "prompt": g["prompt"],
           "new_tokens": g["new"], "wall_s": wall,
           "prefill_runs": st["prefill_runs"],
           "decode_steps": st["decode_steps"],
           "decode_ms_per_step": st["decode_s"] / st["decode_steps"] * 1e3,
           "decode_tokens_per_s": st["decode_tokens"] / st["decode_s"],
           "tokens_per_s": st["output_tokens"] / wall, "card": card}
    log("[generate] " + json.dumps(row))
    timing.append(row)
    check_greedy_tokens("[generate] gpt2 engine vs generate", cpu_gpt,
                        prompts, greedy, [outs[r] for r in rids])
    del engine, gpt, cpu_gpt
    torch.cuda.empty_cache()
    rows = generate_kernels(seed)
    log("[generate] phase 11 in %.1f s" % (time.perf_counter() - t_phase))
    return rows, paths, timing


# -- phase 8: weight-only int8 decode and the serving benchmark --------------

# int8-weight GEMM vs its plain version (x @ dequantize_int8_weight in fp32,
# TF32 off): the same dequantized products, summed in another order (a
# K-long fp32 dot split across warps and CTAs) -- 1e-4 x max|y| + rtol 1e-4
W8_TOL = dict(atol=1e-4, rtol=1e-4, scaled=True)
# both sides of the regime threshold (kernels/quant.py W8_SMALL_M = 32):
# the cluster split-K kernel at 1, 5, 16, 17; the register-tiled GEMM at
# 64 and 256
W8_MS = (1, 5, 16, 17, 64, 256)
W8_TIMED_MS = (16, 256)         # the decode batch and the mixed step
# llama1b's projections (K -> N) and their count a layer: q/k/v/o, gate/up,
# down; then the fused variants' qkv_proj and gate_up_proj (count 0: not in
# the unfused layer's sum)
W8_SHAPES = ((2048, 2048, 4, "q_proj"), (2048, 5504, 2, "gate_proj"),
             (5504, 2048, 1, "down_proj"), (2048, 6144, 0, "qkv_proj"),
             (2048, 11008, 0, "gate_up_proj"))
# off the vector path: N not a multiple of 16 (random weights), one with
# the one-scale-per-column block (K = 36) and one split into a cluster of
# more than 8
W8_EDGE_SHAPES = ((36, 24), (5504, 24))
# phase 8(c): the benchmark tool's rows on llama1b (32 requests a row).
# The shared-prefix row's tails are 128-1024 tokens, so its prompts (512 +
# tail) stay within the other rows' 1536 and, with 64 new tokens, within
# max_model_len 2048
BENCH_COMMON = ["--preset", "llama1b", "--device", "cuda", "--max-slots",
                "16", "--num-blocks", "2048", "--rate", "4", "--prompt-len",
                "128", "1536", "--max-new", "64", "64", "--requests", "32"]
BENCH_ROWS = (
    ("flags off", []),
    ("prefix+chunked", ["--prefix-cache", "--chunked-prefill",
                        "--shared-prefix-tokens", "512", "--prefix-groups",
                        "4", "--prompt-len", "128", "1024"]),
    ("quant weights", ["--quant-weights"]),
    ("resilience", ["--num-blocks", "256", "--max-queue", "8",
                    "--deadline-s", "30", "--fault-schedule",
                    "serving.prefill:error@3;serving.decode:error@5"]))


def queued_ms(fn, calls=10, reps=5):
    """Device time per call by CUDA events around ``calls`` launches queued
    behind a sleep kernel: the host enqueues them all while the device
    sleeps, so its own cost is hidden (the gaps between launches stay)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_ms(fn, match, per_call=1, calls=10, tries=5):
    """A wrapper's own device time per call, from the profiler: every CUDA
    kernel whose name holds ``match``, ``per_call`` kernels a call (each
    launched once a call), as the sum of each kernel's mean time. The
    profiler at times drops one event of a window (19 of 20 paged
    launches, in every window of one run); a window missing more than one
    call's worth is measured again. It has also recorded none of a
    kernel's launches in every window of a run (kernel 10's wgmma kernel,
    twice in a dozen runs) and 3 of 10 in every window of another (the
    encoder's flash forward); then the time is ``queued_ms``'s, and a
    line says so. The timing is a diagnostic: what a kernel computes and
    how often the main path launches it are checked elsewhere."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evts = [evt for evt in prof.key_averages()
                if evt.device_type == torch.autograd.DeviceType.CUDA
                and match in evt.key]
        if sum(evt.count for evt in evts) >= (calls - 1) * per_call:
            break
    else:
        ms = queued_ms(fn, calls)
        log("[device_ms] the profiler recorded %d of %d %s launches in the "
            "last of %d windows: %.4f ms by CUDA events behind a sleep "
            "kernel" % (sum(e.count for e in evts), calls * per_call, match,
                        tries, ms))
        return ms
    return sum(evt.self_device_time_total / evt.count for evt in evts) / 1e3


def w8_case(x, q, scales, w, tag, timed):
    from paddle_tpu_torch.kernels import quant

    m, k = x.shape
    n = q.shape[1]
    got = quant.int8_weight_matmul(x, q, scales)
    again = quant.int8_weight_matmul(x, q, scales)
    want = quant.int8_weight_matmul_reference(x, q, scales)
    torch.cuda.synchronize()
    bm, chunk, splits = quant.w8_plan(m, n, k)
    row = {"case": tag, "mkn": [m, k, n],
           "regime": "cluster split-K" if bm == quant.W8_SMALL_BM
           else "register-tiled GEMM",
           "plan": dict(bm=bm, chunk=chunk, splits=splits),
           "max_abs_err": check_close(tag, got, want, W8_TOL),
           "bitwise": bool(torch.equal(got, again))}
    if not row["bitwise"]:
        raise AssertionError("%s: two launches differ" % tag)
    if timed:
        deq = quant.dequantize_int8_weight(q, scales)
        nbytes = (q.numel() + scales.numel() * 4 + x.numel() * 4
                  + m * n * 4)

        def kernel():
            return quant.int8_weight_matmul(x, q, scales)

        row.update(ms=time_ms(kernel), device_ms=device_ms(kernel, "w8_gemm"),
                   plain_ms=time_ms(
                       lambda: quant.int8_weight_matmul_reference(x, q,
                                                                  scales)),
                   library_ms=time_ms(lambda: torch.matmul(x, deq)),
                   library_fp32_weight_ms=time_ms(lambda: torch.matmul(x, w)),
                   **bound(nbytes, 2 * m * n * k, torch.float32))
    log("[w8] " + json.dumps(row))
    return row


def phase_w8_kernel(seed, model):
    """Phase 8(a): the int8-weight GEMM against its plain version on
    llama1b's layer-0 weights at the decode and mixed steps' shapes, on
    both sides of the regime threshold, the fused qkv_proj / gate_up_proj
    shapes and the non-vector path; two launches bit for bit; timed at
    M = 16 and 256 (CUDA events and profiler device time) beside its
    bound, torch.matmul on the dequantized weight and on the fp32 weight."""
    from paddle_tpu_torch.kernels import quant

    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    layer = model.llama.layers[0]
    attn, mlp = layer.self_attn, layer.mlp
    weights = {"q_proj": attn.q_proj.weight,
               "gate_proj": mlp.gate_proj.weight,
               "down_proj": mlp.down_proj.weight,
               "qkv_proj": torch.cat([attn.q_proj.weight, attn.k_proj.weight,
                                      attn.v_proj.weight], dim=1),
               "gate_up_proj": torch.cat([mlp.gate_proj.weight,
                                          mlp.up_proj.weight], dim=1)}
    rows = []
    with torch.no_grad():
        for k, n, _, name in W8_SHAPES:
            w = weights[name].detach().contiguous()
            q, scales = quant.quantize_int8_weight(w)
            for m in W8_MS:
                x = torch.randn(m, k, generator=gen, device="cuda")
                rows.append(w8_case(x, q, scales, w, "%s M=%d K=%d N=%d b=%d"
                                    % (name, m, k, n, quant.weight_block(k)),
                                    timed=m in W8_TIMED_MS))
            del w, q, scales
        for k, n in W8_EDGE_SHAPES:
            w = torch.randn(k, n, generator=gen, device="cuda") * 0.02
            q, scales = quant.quantize_int8_weight(w)
            for m in W8_MS:
                x = torch.randn(m, k, generator=gen, device="cuda")
                rows.append(w8_case(x, q, scales, w, "edge M=%d K=%d N=%d b=%d"
                                    % (m, k, n, quant.weight_block(k)),
                                    timed=False))
    torch.cuda.empty_cache()
    return rows


def w8_layer_numbers(rows, bf16=False, half="bf16"):
    """One layer's seven projections (``W8_SHAPES`` with a count), summed at
    the decode batch (M = 16, the cluster split-K regime) and the mixed
    step (M = 256, the register-tiled GEMM); the error over every case.
    ``bf16``: a 16-bit mode's rows (no fp32-weight yardstick), ``half``
    naming it: "bf16" or "fp16"."""
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
            "bytes_ms", "operations_ms")
    if not bf16:
        keys += ("library_fp32_weight_ms",)

    def layer(m):
        out = dict.fromkeys(keys, 0.0)
        for k, n, count, _ in W8_SHAPES:
            if not count:           # the fused shapes: not one layer's
                continue
            row = next(r for r in rows if r["mkn"] == [m, k, n])
            for key in keys:
                out[key] += count * row[key]
        out["bound_by"] = ("bytes" if out["bytes_ms"] >= out["operations_ms"]
                           else "operations")
        return out

    decode = layer(16)
    mixed = layer(256)
    if bf16:
        ulp = {"bf16": "2^-7", "fp16": "2^-10"}[half]
        log("[w8 %s] one layer's 7 projections: M = 16 (mma.sync, 16-row "
            "CTAs) %.4f ms (device %.4f), bound %.4f, torch.matmul "
            "%s-dequantized weight %.4f; M = 256 (wgmma, 64/128-row "
            "CTAs) %.4f ms (device %.4f), bound %.4f, torch.matmul %.4f" % (
                half, decode["ms"], decode["device_ms"], decode["bound_ms"],
                half,
                decode["library_ms"], mixed["ms"], mixed["device_ms"],
                mixed["bound_ms"], mixed["library_ms"]))
        return dict(ms=decode["ms"], device_ms=decode["device_ms"],
                    plain_ms=decode["plain_ms"], bound_ms=decode["bound_ms"],
                    bound_by=decode["bound_by"],
                    library_ms=decode["library_ms"],
                    library="torch.matmul on the weight dequantized to %s "
                            "(a yardstick: the port never calls it)" % half,
                    max_abs_err=max(r["max_abs_err"] for r in rows),
                    tolerance="one %s ulp of the plain version's value "
                              "(%s |y|) + 2^-16 max|y|" % (half, ulp),
                    timed_case="one %s llama1b layer's 7 projections, "
                               "M = 16 (the decode step; mma.sync, 16-row "
                               "CTAs, cluster split-K)" % half,
                    mixed_step=dict(case="the same, M = 256 (the mixed "
                                         "step; wgmma, 64/128-row CTAs)",
                                    **{k: v for k, v in mixed.items()
                                       if k not in ("bytes_ms",
                                                    "operations_ms")}),
                    timed=[r for r in rows if "ms" in r])
    log("[w8] one layer's 7 projections: M = 16 (cluster split-K) %.4f ms "
        "(device %.4f), bound %.4f, torch.matmul fp32 weight %.4f; M = 256 "
        "(register-tiled) %.4f ms (device %.4f), bound %.4f, torch.matmul "
        "fp32 weight %.4f" % (
            decode["ms"], decode["device_ms"], decode["bound_ms"],
            decode["library_fp32_weight_ms"], mixed["ms"],
            mixed["device_ms"], mixed["bound_ms"],
            mixed["library_fp32_weight_ms"]))
    return dict(ms=decode["ms"], device_ms=decode["device_ms"],
                plain_ms=decode["plain_ms"],
                bound_ms=decode["bound_ms"], bound_by=decode["bound_by"],
                library_ms=decode["library_ms"],
                library="torch.matmul on the dequantized fp32 weight (a "
                        "yardstick: the port never calls it)",
                library_fp32_weight_ms=decode["library_fp32_weight_ms"],
                max_abs_err=max(r["max_abs_err"] for r in rows),
                timed_case="one llama1b layer's 7 projections, M = 16 "
                           "(the decode step, cluster split-K)",
                mixed_step=dict(case="the same, M = 256 (the mixed step, "
                                     "register-tiled GEMM)",
                                **{k: v for k, v in mixed.items()
                                   if k not in ("bytes_ms",
                                                "operations_ms")}),
                timed=[r for r in rows if "ms" in r])


def quant_engine(model, prefix, chunked, quant_kv, device=None, **kw):
    """tier2_engine with FLAGS_serving_quant_weights on (latched at
    construction, cleared again right after)."""
    from paddle_tpu_torch.core import flags

    flags.set_flags({"FLAGS_serving_quant_weights": True})
    try:
        return tier2_engine(model, prefix, chunked, quant_kv, device=device,
                            **kw)
    finally:
        flags.set_flags({"FLAGS_serving_quant_weights": False})


def phase_quant_decode(seed, model, cpu_model):
    """Phase 8(b): weight-only int8 decode on llama1b, alone and with
    prefix cache + chunked prefill + int8 KV, on the card and on the CPU
    copy with the same flags: the same greedy tokens (or a divergence at a
    near-tie), and on the card 7 x 22 int8 GEMM launches a decode or
    mixed step and none in prefill."""
    rng = np.random.default_rng(seed + 8)
    vocab = model.config.vocab_size
    layers = model.config.num_hidden_layers
    base = rng.integers(0, vocab, 48).tolist()
    prompts = [base + rng.integers(0, vocab, 8).tolist(),
               rng.integers(0, vocab, 37).tolist(),
               base[:40] + rng.integers(0, vocab, 10).tolist()]
    paths = {}
    for tag, flags_on in (("quant weights", False),
                          ("quant weights+prefix+chunked+int8", True)):
        runs = {}
        for device, m in ((None, model), ("cpu", cpu_model)):
            t0 = time.perf_counter()
            engine = quant_engine(m, flags_on, flags_on, flags_on,
                                  device=device, max_slots=3, block_size=16,
                                  num_blocks=64, max_model_len=256,
                                  prefill_chunk=16)
            if device is None:
                reset_launch_counters()
            ids = [engine.add_request(p, max_new_tokens=8) for p in prompts]
            engine.run()
            if device is None:
                torch.cuda.synchronize()
                launches = launch_counters()
            st = engine.stats()
            runs[device] = [engine.output(i) for i in ids]
            log("[quant decode] %s %s: %s (%.1f s; %d decode steps, %d "
                "mixed)" % ("card" if device is None else "cpu ", tag,
                            runs[device], time.perf_counter() - t0,
                            st["decode_steps"], st["mixed_steps"]))
            if device is None:
                want = layers * 7 * st["decode_steps"]
                if launches["int8_weight_matmul"] != want:
                    raise AssertionError(
                        "[quant decode] %s: %d int8 GEMM launches, expected "
                        "%d (7 x %d layers x %d steps, none in prefill)"
                        % (tag, launches["int8_weight_matmul"], want, layers,
                           st["decode_steps"]))
                paths["quant decode " + tag] = launches
            del engine
        same = [diverges_at_near_tie("[quant decode] %s card vs cpu" % tag,
                                     cpu_model, p, w, g)
                for p, w, g in zip(prompts, runs["cpu"], runs[None])]
        log("[quant decode] %s: %d of %d token sequences identical, %d int8 "
            "GEMM launches" % (tag, sum(same), len(same),
                               paths["quant decode " + tag][
                                   "int8_weight_matmul"]))
    torch.cuda.empty_cache()
    return paths


def check_bench_row(tag, report):
    """Phase 8(c)'s accounting: every request terminal and, with the
    admission rejects, all of them; goodput within throughput; the
    resilience row preempted and fired both faults; the others shed
    nothing."""
    rows = report["requests_detail"]
    states = [r["status"] for r in rows]
    rejected = sum(report["rejected_at_admission"].values())
    problems = []
    if not all(s in ("finished", "expired", "shed", "failed")
               for s in states):
        problems.append("a request is not terminal: %s" % states)
    if len(rows) + rejected != report["workload"]["requests"]:
        problems.append("%d requests + %d rejects != %d" % (
            len(rows), rejected, report["workload"]["requests"]))
    if not report["goodput_tok_s"] <= report["value"]:
        problems.append("goodput %s > throughput %s" % (
            report["goodput_tok_s"], report["value"]))
    if tag == "resilience":
        fired = report["faults_injected"] or {}
        if report["preemptions"] <= 0:
            problems.append("no preemption")
        if sorted(fired.values()) != [1, 1]:
            problems.append("faults fired: %s" % fired)
        errors = [r.get("error") or "" for r in rows
                  if r["status"] == "failed"]
        if not all("InjectedFault" in e for e in errors):
            problems.append("a request failed of itself: %s" % errors)
    elif report["requests_shed_total"] or rejected \
            or states.count("finished") != len(rows):
        problems.append("shed %s, rejected %s, states %s" % (
            report["shed_by_reason"], rejected, states))
    if problems:
        raise AssertionError("[bench %s] %s" % (tag, "; ".join(problems)))


def phase_serving_bench(seed, model):
    """Phase 8(c): paddle_tpu_torch.tools.serving_benchmark in-process on
    the phase-4 llama1b, four rows, each with its accounting checked and
    its launch counts read around it."""
    from paddle_tpu_torch.tools import serving_benchmark

    reports, paths = {}, {}
    for tag, extra in BENCH_ROWS:
        args = serving_benchmark.parser().parse_args(
            BENCH_COMMON + ["--seed", str(seed)] + extra)
        reset_launch_counters()
        report = serving_benchmark.run(args, model=model)
        torch.cuda.synchronize()
        paths["bench " + tag] = launch_counters()
        log("[bench %s] %s" % (tag, json.dumps(
            {k: v for k, v in report.items() if k != "requests_detail"})))
        check_bench_row(tag, report)
        reports[tag] = report
        torch.cuda.empty_cache()
    if paths["bench quant weights"]["int8_weight_matmul"] <= 0:
        raise AssertionError("[bench quant weights] the int8 GEMM was never "
                             "launched")
    return reports, paths


# -- phase 10: bf16 serving, the int8-weight GEMM's bf16 mode, replay --------

# kernel 10's bf16 mode against its plain version (bf16 x @ the weight
# dequantized to bf16, torch.matmul with fp32 sums, one bf16 rounding): the
# same exact bf16 x bf16 products summed in fp32 in another order, each
# side rounding its sum to bf16 once, so an element may differ by one bf16
# ulp of the value (<= 2^-7 |y|), plus the fp32 sums' own difference where
# a sum cancels to near zero (2^-16 max|y|, far above it)
W8_BF16_ULP = 2.0 ** -7
W8_BF16_FLOOR = 2.0 ** -16
# off the vector path (N = 24), and K = 1000, which no split of the small
# regime's 96-row granule divides (a ragged last split), on both paths;
# K = 1032 (b = 8), whose last 64-row stage is 8 rows deep, on the vector
# path and with an odd N (37) on the plain-load path
W8_BF16_EDGE_SHAPES = ((1000, 24), (1000, 2048), (1032, 2048), (1032, 37))
# both warp rows' tiles: 16, 32 (one warp row), 64, 128 (two); M = 33 is
# past two m16 tiles (a 64-row CTA, 31 rows zero-filled)
W8_BF16_MS = (1, 5, 16, 17, 33, 64, 256)


# phase 16(a): the float16 mode, one float16 ulp (<= 2^-10 |y|) likewise
W8_ULP = {torch.bfloat16: W8_BF16_ULP, torch.float16: 2.0 ** -10}


def check_ulp(name, got, want):
    """Phase 10(a)'s tolerance (``W8_BF16_ULP``, ``W8_BF16_FLOOR``), or
    in float16 one float16 ulp; returns the max abs error."""
    ulp = W8_ULP[got.dtype]
    want = want.float()
    err = (got.float() - want).abs()
    limit = ulp * want.abs() + W8_BF16_FLOOR * float(want.abs().max())
    bad = err > limit
    if bool(bad.any()):
        raise AssertionError("%s: %d elements beyond one ulp (%g), max abs "
                             "err %.3g" % (name, int(bad.sum()), ulp,
                                           float(err.max())))
    return float(err.max())


def w8_bf16_case(x, q, scales, tag, timed):
    from paddle_tpu_torch.kernels import quant

    m, k = x.shape
    n = q.shape[1]
    got = quant.int8_weight_matmul(x, q, scales)
    again = quant.int8_weight_matmul(x, q, scales)
    want = quant.int8_weight_matmul_reference(x, q, scales)
    torch.cuda.synchronize()
    if got.dtype != x.dtype or x.dtype not in W8_ULP:
        raise AssertionError("%s: output dtype %s" % (tag, got.dtype))
    bm, chunk, splits = quant.w8_plan_bf16(m, n, k)
    row = {"case": tag, "mkn": [m, k, n],
           "regime": "mma.sync" if bm <= 32 else "wgmma",
           "plan": dict(bm=bm, chunk=chunk, splits=splits),
           "max_abs_err": check_ulp(tag, got, want),
           "bitwise": bool(torch.equal(got, again))}
    if not row["bitwise"]:
        raise AssertionError("%s: two launches differ" % tag)
    if timed:
        deq = quant.dequantize_int8_weight(q, scales, x.dtype)
        nbytes = q.numel() + scales.numel() * 4 + x.numel() * 2 + m * n * 2

        def kernel():
            return quant.int8_weight_matmul(x, q, scales)

        row.update(ms=time_ms(kernel), device_ms=device_ms(kernel, "w8_gemm"),
                   plain_ms=time_ms(
                       lambda: quant.int8_weight_matmul_reference(x, q,
                                                                  scales)),
                   library_ms=time_ms(lambda: torch.matmul(x, deq)),
                   **bound(nbytes, 2 * m * n * k, x.dtype))
    log("[w8 %s] " % ("bf16" if x.dtype == torch.bfloat16 else "fp16")
        + json.dumps(row))
    return row


def phase_w8_bf16(seed, model):
    """Phase 10(a): the bf16 mode of the int8-weight GEMM against its plain
    version on the bf16 llama1b's layer-0 weights, both regimes, the fused
    shapes, a ragged K and the non-vector path; two launches bit for bit;
    timed at M = 16 and 256 beside its bound and torch.matmul on the
    bf16-dequantized weight."""
    from paddle_tpu_torch.kernels import quant

    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    layer = model.llama.layers[0]
    attn, mlp = layer.self_attn, layer.mlp
    weights = {"q_proj": attn.q_proj.weight,
               "gate_proj": mlp.gate_proj.weight,
               "down_proj": mlp.down_proj.weight,
               "qkv_proj": torch.cat([attn.q_proj.weight, attn.k_proj.weight,
                                      attn.v_proj.weight], dim=1),
               "gate_up_proj": torch.cat([mlp.gate_proj.weight,
                                          mlp.up_proj.weight], dim=1)}
    rows = []
    with torch.no_grad():
        for k, n, count, name in W8_SHAPES:
            q, scales = quant.quantize_int8_weight(
                weights[name].detach().contiguous())
            for m in (W8_BF16_MS if count else W8_TIMED_MS):
                x = torch.randn(m, k, generator=gen, device="cuda").to(
                    torch.bfloat16)
                rows.append(w8_bf16_case(
                    x, q, scales, "%s M=%d K=%d N=%d b=%d bf16" % (
                        name, m, k, n, quant.weight_block(k)),
                    timed=m in W8_TIMED_MS))
        for k, n in W8_BF16_EDGE_SHAPES:
            w = torch.randn(k, n, generator=gen, device="cuda") * 0.02
            q, scales = quant.quantize_int8_weight(w.to(torch.bfloat16))
            for m in W8_BF16_MS:
                x = torch.randn(m, k, generator=gen, device="cuda").to(
                    torch.bfloat16)
                rows.append(w8_bf16_case(
                    x, q, scales, "edge M=%d K=%d N=%d b=%d bf16" % (
                        m, k, n, quant.weight_block(k)), timed=False))
    torch.cuda.empty_cache()
    return rows


# phase 10(b): greedy tokens of the bf16 card engine against a bf16 CPU copy
# with the same weights. Both round every activation to bf16, at other
# places (kernels against plain versions, other sum orders), so a logit may
# move by a few bf16 ulps of the row's largest (2^-7 max|logit| each); a
# divergence counts as a near-tie when the CPU copy's top-2 gap there is
# under BF16_NEAR_TIE x max|logit| of that row (8 ulps). Phase 10(b) also
# prints the card's and the CPU's logits apart over a whole sequence.
BF16_NEAR_TIE = 2.0 ** -4
# (tag, flags, the CPU side's path): with no quantization the CPU copy's
# greedy tokens come from ONE dense forward over the prompt and the card's
# tokens (its argmax at each step, up to the first divergence, is its own
# greedy continuation); int8 KV and int8 weights change the numbers inside
# the steps, so there the CPU copy runs the engine with the same flags, on
# the short prompts (a CPU bf16 step costs ~1000x the card's)
BF16_RUNS = (("flags off", dict(), "dense"),
             ("prefix+chunked", dict(prefix=True, chunked=True), "dense"),
             ("int8 KV", dict(quant_kv=True), "engine"),
             ("int8 weights", dict(quant_weights=True), "engine"))
BF16_NEW_TOKENS = 6
BF16_GEOMETRY = dict(max_slots=4, block_size=16, num_blocks=256,
                     max_model_len=2048, prefill_chunk=16)


def bf16_prompts(seed, vocab, short_only=False):
    """Prompts in the prefill buckets 8, 16, 256 and 1024, then one sharing
    240 tokens (15 full pages) with the 250-token one, added after the
    others finished so that the prefix cache holds them; ``short_only``:
    the first three."""
    rng = np.random.default_rng(seed + 10)
    first = [rng.integers(0, vocab, n).tolist() for n in (5, 13, 250, 600)]
    second = [first[2][:240] + rng.integers(0, vocab, 12).tolist()]
    return (first[:3], []) if short_only else (first, second)


def bf16_dense_check(tag, cpu_model, prompt, got, cache):
    """The card's tokens against the CPU copy's greedy continuation, from
    one dense forward over ``prompt + got``: equal, or first diverging
    where the CPU's top-2 gap is under ``BF16_NEAR_TIE`` x max|logit|
    (else this raises). ``cache`` keeps each sequence's argmax and gaps."""
    key = tuple(prompt + got)
    if key not in cache:
        with torch.no_grad():
            logits = cpu_model(torch.tensor([list(key)]))[0].float()
        rows = logits[len(prompt) - 1:len(prompt) - 1 + len(got)]
        top2 = rows.topk(2, dim=-1).values
        cache[key] = (rows.argmax(-1).tolist(),
                      (top2[:, 0] - top2[:, 1]).tolist(),
                      rows.abs().amax(-1).tolist())
    want, gaps, scales = cache[key]
    i = next((j for j, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if i is None:
        return True
    limit = BF16_NEAR_TIE * scales[i]
    log("%s first divergence at token %d, CPU top-2 gap %.4g (limit %.4g)"
        % (tag, i, gaps[i], limit))
    if gaps[i] >= limit:
        raise AssertionError("%s diverges at token %d with a top-2 gap of "
                             "%.4g (>= %.4g): not a near-tie"
                             % (tag, i, gaps[i], limit))
    return False


def bf16_engine(model, device, prefix=False, chunked=False, quant_kv=False,
                quant_weights=False):
    from paddle_tpu_torch.core import flags

    flags.set_flags({"FLAGS_serving_quant_weights": quant_weights})
    try:
        return tier2_engine(model, prefix, chunked, quant_kv, device=device,
                            **BF16_GEOMETRY)
    finally:
        flags.set_flags({"FLAGS_serving_quant_weights": False})


def bf16_serve(model, device, prompts, opts):
    """Serve the first prompts, then the second (prefix-cache hits); return
    tokens, the engine's stats and per-request metrics."""
    first, second = prompts
    engine = bf16_engine(model, device, **opts)
    ids = [engine.add_request(p, max_new_tokens=BF16_NEW_TOKENS)
           for p in first]
    engine.run()
    ids += [engine.add_request(p, max_new_tokens=BF16_NEW_TOKENS)
            for p in second]
    engine.run()
    out = ([engine.output(i) for i in ids], engine.stats(),
           [engine.request_metrics(i) for i in ids])
    del engine
    return out


def bf16_launch_want(tag, opts, st, layers):
    """The exact launches a bf16 run makes: kernel 1 per prefill and layer
    (none with chunked prefill, whose prompts go through kernel 8), kernel
    7 per decode step and layer, kernel 8 per mixed step and layer, kernel
    10's bf16 mode 7 times per layer and decode or mixed step (int8
    weights); int8 pools take the int8 counters."""
    mode = "_int8" if opts.get("quant_kv") else ""
    want = dict.fromkeys(launch_counters(), 0)
    if opts.get("chunked"):
        want["mixed_paged_attention" + mode] = layers * st["mixed_steps"]
    else:
        want["flash_attention"] = layers * st["prefill_runs"]
        want["paged_attention" + mode] = layers * st["decode_steps"]
    want["mixed_paged_attention_bf16"] = want["mixed_paged_attention"]
    if opts.get("quant_weights"):
        want["int8_weight_matmul"] = 7 * layers * st["decode_steps"]
        want["int8_weight_matmul_bf16"] = want["int8_weight_matmul"]
    return want


def phase_bf16_serving(seed, card):
    """Phase 10(a) and (b): llama1b in bf16 at full width behind
    serving.Engine on the card, flags off, prefix cache + chunked prefill,
    int8 KV and int8 weights; each against a bf16 CPU copy with the same
    weights and flags; exact launch counts; TTFT and TPOT."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama1b(dtype="bfloat16")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed + 10))
    cpu_model = copy.deepcopy(model).to("cpu")
    log("[bf16] llama1b bf16 (%d layers, hidden %d) and its CPU copy in "
        "%.1f s" % (cfg.num_hidden_layers, cfg.hidden_size,
                    time.perf_counter() - t0))
    w8_rows = phase_w8_bf16(seed, model)
    # warm-up: the first bf16 GEMMs and kernels of the process, unmeasured
    bf16_serve(model, None, ([[1, 2, 3]], []), {})
    results, paths, dense = {}, {}, {}
    for tag, opts, cpu_path in BF16_RUNS:
        name = "[bf16 %s]" % tag
        prompts = bf16_prompts(seed, cfg.vocab_size,
                               short_only=cpu_path == "engine")
        flat = prompts[0] + prompts[1]
        reset_launch_counters()
        t0 = time.perf_counter()
        card_tokens, st, per = bf16_serve(model, None, prompts, opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counters()
        want = bf16_launch_want(tag, opts, st, cfg.num_hidden_layers)
        if launches != want:
            raise AssertionError("%s launches %s, expected %s"
                                 % (name, launches, want))
        if opts.get("prefix") and not st["prefix_hit_tokens"] >= 240:
            raise AssertionError("%s expected a 240-token prefix hit: %s"
                                 % (name, st))
        t0 = time.perf_counter()
        if cpu_path == "dense":
            same = [bf16_dense_check(name + " card vs cpu", cpu_model, p, g,
                                     dense)
                    for p, g in zip(flat, card_tokens)]
        else:
            cpu_tokens, _, _ = bf16_serve(cpu_model, "cpu", prompts, opts)
            same = [diverges_at_near_tie(name + " card vs cpu", cpu_model,
                                         p, w, g, rel=BF16_NEAR_TIE)
                    for p, w, g in zip(flat, cpu_tokens, card_tokens)]
        cpu_s = time.perf_counter() - t0
        ttft = [m["ttft_s"] for m in per]
        tpot = [m["tpot_s"] for m in per]
        results[tag] = {
            "card": card, "wall_s": wall, "cpu_s": cpu_s, "cpu": cpu_path,
            "prompt_lens": [len(p) for p in flat],
            "identical": "%d of %d" % (sum(same), len(same)),
            "ttft_p50_s": pct(ttft, 0.5), "ttft_max_s": max(ttft),
            "tpot_p50_s": pct(tpot, 0.5), "tpot_max_s": max(tpot),
            "prefill_runs": st["prefill_runs"],
            "decode_steps": st["decode_steps"],
            "mixed_steps": st["mixed_steps"],
            "prefix_hit_tokens": st["prefix_hit_tokens"],
            "launches": launches}
        log(name + " " + json.dumps(results[tag]))
        paths["bf16 serving " + tag] = launches
    ran = {k: sum(c[k] for c in paths.values())
           for k in ("flash_attention", "paged_attention",
                     "mixed_paged_attention_bf16", "int8_weight_matmul_bf16")}
    if not all(ran.values()):
        raise AssertionError("[bf16] a kernel never ran in bf16: %s" % ran)
    # the card's and the CPU's logits over one whole sequence, the scale of
    # the difference the near-tie limit allows
    ids = torch.tensor([prompts[0][2] + card_tokens[2]])
    with torch.no_grad():
        want = cpu_model(ids)[0].float()
        got = model(ids.to("cuda"))[0].float().cpu()
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    log("[bf16] logits [%d, %d] card vs cpu: max abs diff %.4g, max |logit| "
        "%.4g (ratio %.4g; the near-tie limit is %.4g of a row's max)"
        % (want.shape[0], want.shape[1], diff, scale, diff / scale,
           BF16_NEAR_TIE))
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("[bf16] card logits are not finite")
    del model, cpu_model
    torch.cuda.empty_cache()
    return w8_rows, results, paths


# phase 10(c): the benchmark's --record-out on llama1b fp32, flags off and
# with prefix cache + chunked prefill over shared 512-token prefixes (hits
# at whole pages, so a replay runs each prompt in the recording's chunks)
REPLAY_COMMON = ["--preset", "llama1b", "--device", "cuda", "--max-slots",
                 "8", "--num-blocks", "1024", "--rate", "16", "--requests",
                 "8", "--prompt-len", "16", "256", "--max-new", "8", "16"]
REPLAY_ROWS = (("flags off", []),
               ("prefix+chunked", ["--prefix-cache", "--chunked-prefill",
                                   "--shared-prefix-tokens", "512",
                                   "--prefix-groups", "2"]))


def phase_replay(seed, model):
    """Phase 10(c): record two llama1b fp32 workloads through the port's
    serving benchmark, re-drive each with ``ptreplay run`` (the model
    rebuilt from the journal's meta): zero divergences; a perturbed weight
    leaf must diverge, with its first diverging index, and ``--matrix``
    must name ``weights`` for it."""
    import argparse as _argparse

    from paddle_tpu_torch.serving import replay
    from paddle_tpu_torch.tools import ptreplay, serving_benchmark

    out_dir = os.path.join("chiprun_out", "replay")
    os.makedirs(out_dir, exist_ok=True)
    results = {}
    for tag, extra in REPLAY_ROWS:
        name = "[replay %s]" % tag
        journal = os.path.join(out_dir, tag.replace("+", "_").replace(
            " ", "_") + ".jsonl")
        args = serving_benchmark.parser().parse_args(
            REPLAY_COMMON + ["--seed", str(seed), "--record-out", journal]
            + extra)
        t0 = time.perf_counter()
        report = serving_benchmark.run(args, model=model)
        record_s = time.perf_counter() - t0
        if report["replay_journal"]["entries"] != args.requests:
            raise AssertionError("%s journal %s" % (
                name, report["replay_journal"]))
        t0 = time.perf_counter()
        rc = ptreplay.run_replay(_argparse.Namespace(
            journal=journal, out=journal.replace(".jsonl", "_report.json"),
            full=True, matrix=False, against=None, device="cuda"))
        replay_s = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError("%s ptreplay run: exit code %d" % (name, rc))
        head, entries = replay.load_journal(journal)
        t0 = time.perf_counter()
        perturbed = ptreplay.replay_entries(head, entries, full=True,
                                            perturb=True, device="cuda")
        matrix = ptreplay.matrix_bisect(head, entries, perturb=True,
                                        device="cuda")
        perturb_s = time.perf_counter() - t0
        firsts = [d["first_divergence"] for d in perturbed["divergences"]]
        if not firsts or matrix["bisected_axes"] != ["weights"]:
            raise AssertionError("%s perturbed %s: %d divergences, matrix "
                                 "names %s" % (name,
                                               perturbed["perturbed_leaf"],
                                               len(firsts),
                                               matrix["bisected_axes"]))
        results[tag] = {"record_s": record_s, "replay_s": replay_s,
                        "perturb_and_matrix_s": perturb_s,
                        "replayed": len(entries), "divergences": 0,
                        "perturbed_leaf": perturbed["perturbed_leaf"],
                        "perturbed_divergences": len(firsts),
                        "first_divergence": firsts,
                        "matrix_bisected": matrix["bisected_axes"]}
        log(name + " " + json.dumps(results[tag]))
    torch.cuda.empty_cache()
    return results


# -- phase 6 / 7 -------------------------------------------------------------

def lm_loss(vocab):
    from paddle_tpu_torch.nn import functional as F

    def loss_fn(logits, labels):
        return F.cross_entropy(logits.reshape(-1, vocab), labels.reshape(-1))
    return loss_fn


def phase_train(seed, fused=False, dtype="bfloat16"):
    """Phase 6, or with ``fused`` phase 6b: the same row with
    FLAGS_fused_lm_head_ce on and the loss computed inside the model; with
    ``dtype="float32"`` phase 6e: the row at the config's default dtype,
    2 timed steps, and with both phase 6f."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.kernels import fused_ce as fc
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    tag = "[train%s%s]" % ("" if dtype == "bfloat16" else " " + dtype,
                           " fused" if fused else "")
    steps = TRAIN_STEPS if dtype == "bfloat16" else TRAIN_STEPS_FP32
    cfg = LlamaConfig.llama1b_train(dtype=dtype)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed))
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    if fused:
        step = TrainStep(model, None, opt, labels_to_model=True)
    else:
        step = TrainStep(model, lm_loss(cfg.vocab_size), opt)
    rng = np.random.default_rng(seed)
    ids, labels = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).cuda()
        for _ in range(2))
    flags.set_flags({"FLAGS_fused_lm_head_ce": fused})
    try:
        torch.cuda.reset_peak_memory_stats()
        losses = [step(ids, labels)]   # warm-up: cuBLAS handles, AdamW slots
        torch.cuda.synchronize()
        log("%s llama1b %s (%d layers, hidden %d, FFN %d, recompute) "
            "built and warmed up in %.1f s" % (
                tag, dtype, cfg.num_hidden_layers, cfg.hidden_size,
                cfg.intermediate_size, time.perf_counter() - t0))

        reset_launch_counters()
        fc.fwd_launches = fc.dh_launches = fc.dw_launches = 0
        times = []
        for _ in range(steps):
            t1 = time.perf_counter()
            losses.append(step(ids, labels))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        launches = dict(launch_counters(), fused_ce_fwd=fc.fwd_launches,
                        fused_ce_dh=fc.dh_launches,
                        fused_ce_dw=fc.dw_launches)
    finally:
        flags.set_flags({"FLAGS_fused_lm_head_ce": False})

    losses = [loss.item() for loss in losses]
    layers = cfg.num_hidden_layers
    # recompute runs each layer's forward twice per step; no segmented
    # launch
    want = dict.fromkeys(launches, 0)
    want.update({"flash_attention": 2 * layers * steps,
                 "flash_attention_bwd_dq": layers * steps,
                 "flash_attention_bwd_dkv": layers * steps})
    if fused:
        for name in ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw"):
            want[name] = steps
    if launches != want:
        raise AssertionError("%s launches %s, expected %s"
                             % (tag, launches, want))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite training loss: %s" % losses)
    if not losses[-1] < losses[0]:
        raise AssertionError("training loss did not fall: %s" % losses)
    median = statistics.median(times)
    result = {
        "params": sum(p.numel() for p in model.parameters()),
        "batch": [TRAIN_BATCH, TRAIN_SEQ], "step_ms": median * 1e3,
        "step_ms_each": [t * 1e3 for t in times],
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / median,
        "losses": losses,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "dtype": dtype, "launches": launches,
        "launches_per_step": {k: n / steps for k, n in launches.items()}}
    log(tag + " " + json.dumps(result))
    return result


# phase 6b's first loss against phase 6's: phase 6 rounds the logits to
# bf16 before cross_entropy, the fused kernels keep them float32; the two
# means over 8192 tokens may differ by up to one bf16 ulp (2^-8) of the loss
FUSED_LOSS_RTOL = 2.0 ** -8
# phase 6f's against 6e's: the same float32 hidden states and weights, and
# float32 logits on both sides summed in another order (cuBLAS's SGEMM and
# a whole-row log-softmax vs the kernels' k order and vocab tiles): the
# per-token lse (~10.4) agree to a few float32 ulps, their mean closer
FUSED32_LOSS_RTOL = 1e-5


def check_fused_train(plain, fused, rtol=FUSED_LOSS_RTOL, tag=None):
    got, want = fused["losses"][0], plain["losses"][0]
    if tag is None:
        tag = "[train fused]" if fused["dtype"] == "bfloat16" else \
            "[train %s fused]" % fused["dtype"]
    log("%s first loss %.6f vs unfused %.6f; step %.2f vs %.2f "
        "ms; %.0f vs %.0f tokens/s; peak %.2f vs %.2f GB" % (
            tag, got, want, fused["step_ms"], plain["step_ms"],
            fused["tokens_per_s"], plain["tokens_per_s"],
            fused["peak_mem_gb"], plain["peak_mem_gb"]))
    if abs(got - want) > rtol * abs(want):
        raise AssertionError("fused first loss %.6f differs from the "
                             "unfused %.6f by more than rtol %g"
                             % (got, want, rtol))
    if not fused["peak_mem_gb"] < plain["peak_mem_gb"]:
        raise AssertionError("fused peak memory %.3f GB is not below the "
                             "unfused %.3f GB" % (fused["peak_mem_gb"],
                                                  plain["peak_mem_gb"]))


# -- phase 6c: the reference's bench row, fused, through run_steps ------------

# bench.py:80-86 with BENCH_FUSE=1 (the TPU branch's config), 8 x 1024,
# K = 10 stacked batches per run_steps window (bench.py:132-162), run by
# the port's train benchmark tool (paddle_tpu_torch/tools/train_benchmark)
BENCH_K, BENCH_WINDOWS = 10, 2
# run_steps against 10 calls from the same state: the same kernels on the
# same inputs; the losses are float32 means of bf16 logits, so they may
# differ by at most a bf16 ulp (2^-8) of the loss
WINDOW_LOSS_RTOL = 2.0 ** -8


def phase_bench_fused(seed):
    """Phase 6c: ``train_benchmark.run`` (a warm-up window, the timed
    windows, then the same K batches as K calls from the same state), with
    the attention kernels' exact launch counts over all of its steps."""
    from paddle_tpu_torch.tools import train_benchmark

    tag = "[bench fused]"
    reset_launch_counters()
    t0 = time.perf_counter()
    result = train_benchmark.run(preset="bench", fuse=True, device="cuda",
                                 seed=seed + 6, k=BENCH_K,
                                 windows=BENCH_WINDOWS, batch=TRAIN_BATCH,
                                 seq=TRAIN_SEQ)
    launches = launch_counters()
    cfg = train_benchmark.bench_config()
    log("%s fused llama (%d layers, hidden %d, %d heads x %d, FFN %d), "
        "%d steps in %.1f s" % (
            tag, cfg.num_hidden_layers, cfg.hidden_size,
            cfg.num_attention_heads, cfg.head_dim, cfg.intermediate_size,
            result["steps"], time.perf_counter() - t0))
    want = dict.fromkeys(launches, 0)
    for name in ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        want[name] = cfg.num_hidden_layers * result["steps"]
    if launches != want:
        raise AssertionError("%s launches %s, expected %s"
                             % (tag, launches, want))
    window_losses = result["run_steps"]["window_losses"]
    losses = window_losses + result["calls"]["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("%s non-finite loss: %s" % (tag, losses))
    # each window trains on the same 10 batches again, so its last loss
    # falls from window to window (within a window every batch is new)
    if not all(a > b for a, b in zip(window_losses, window_losses[1:])):
        raise AssertionError("%s loss did not fall from window to window: "
                             "%s" % (tag, window_losses))
    gap = result["window_vs_calls_loss_gap"]
    if gap > WINDOW_LOSS_RTOL * abs(window_losses[0]):
        raise AssertionError(
            "%s the warm-up window's last loss %.6f differs from the 10th "
            "call's %.6f by more than rtol %g" % (
                tag, window_losses[0], result["calls"]["losses"][-1],
                WINDOW_LOSS_RTOL))
    result["launches"] = launches
    log(tag + " " + json.dumps(result))
    return result


# -- phase 6d: variable_length_attention at full width ------------------------

def phase_varlen(seed):
    """Phase 6d: the packed-sequence entry point, forward and backward,
    by segment ids and by seq_lens."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.functional.attention import \
        segment_ids_from_lens

    tag = "[varlen]"
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    ids_a, _ = segment_train_ids(seed)
    rng = np.random.default_rng(seed + 10)
    lens, total = [], 0
    while True:        # documents of 64-512 tokens, a tail of >= 64 left
        length = int(rng.integers(64, 513))
        if total + length > TRAIN_SEQ - 64:
            break
        lens.append(length)
        total += length
    shape = (TRAIN_BATCH, TRAIN_SEQ, SEG_HEADS, SEG_HEAD_DIM)
    calls = (("segment_ids", dict(segment_ids=torch.from_numpy(ids_a)
                                  .cuda()), ids_a),
             ("seq_lens", dict(seq_lens=lens), np.broadcast_to(
                 segment_ids_from_lens(lens, TRAIN_SEQ),
                 (TRAIN_BATCH, TRAIN_SEQ)).copy()))
    reset_launch_counters()
    runs = []
    for how, kw, ids in calls:
        leaves = [torch.randn(shape, generator=gen, device="cuda")
                  .bfloat16().requires_grad_() for _ in range(3)]
        dout = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        before = launch_counters()
        out = F.variable_length_attention(*leaves, **kw)
        out.backward(dout)
        torch.cuda.synchronize()
        after = launch_counters()
        grew = {k: after[k] - before[k] for k in after}
        runs.append((how, leaves, dout, out.detach(), ids, grew))
    launches = launch_counters()

    result = {"shape": list(shape), "dtype": "bfloat16", "causal": True,
              "seq_lens": lens, "tail": TRAIN_SEQ - total, "calls": {}}
    for how, leaves, dout, out, ids, grew in runs:
        want = {k: 0 for k in grew}
        for k in ("flash_attention_segmented",
                  "flash_attention_bwd_dq_segmented",
                  "flash_attention_bwd_dkv_segmented"):
            want[k] = 1
        if grew != want:
            raise AssertionError("%s %s call launched %s, expected %s"
                                 % (tag, how, grew, want))
        q, k, v = (x.detach() for x in leaves)
        segs = torch.from_numpy(ids).cuda()
        want_out, _ = fa.flash_attention_reference(q, k, v, True,
                                                   segment_ids=segs)
        name = "%s %s" % (tag, how)
        err = {"out": check_close(name + " out", out, want_out,
                                  TOL[torch.bfloat16])}
        # the gradients against the plain backward on the kernel's own
        # forward (the plain forward rounds its output elsewhere)
        k_out, k_lse = fa.flash_attention(q, k, v, True, segment_ids=segs)
        want_grads = fa.flash_attention_backward_reference(
            q, k, v, k_out, k_lse, dout, True, segment_ids=segs)
        for part, leaf, w in zip("qkv", leaves, want_grads):
            err["d" + part] = check_close("%s d%s" % (name, part),
                                          leaf.grad, w,
                                          BWD_TOL[torch.bfloat16])
        result["calls"][how] = {"launches": grew, "max_abs_err": err}
    result["launches"] = launches
    log(tag + " " + json.dumps(result))
    return result


TRAIN_GRADS = ("lm_head.weight", "llama.layers.0.self_attn.q_proj.weight")


def recipe_optimizer(params):
    """The training recipe of phase 7b: AdamW under a linear warm-up into
    cosine decay, with global-norm gradient clipping."""
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm, lr

    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, T_max=10),
                            warmup_steps=2, start_lr=0.0, end_lr=1e-3)
    return sched, AdamW(learning_rate=sched, parameters=params,
                        grad_clip=ClipGradByGlobalNorm(RECIPE_CLIP))


RECIPE_CLIP = 0.01   # far below the 2-layer model's gradient norm: engaged


def phase_train_e2e(seed, fused=False):
    """Phase 7, or with ``fused`` phase 7b: the fused loss tail and the
    recipe optimizer, 3 steps (the warm-up's first step has lr 0)."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.kernels import fused_ce as fc
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.parallel import TrainStep

    tag = "[train e2e fused]" if fused else "[train e2e]"
    t0 = time.perf_counter()
    cfg = LlamaConfig.llama1b_train(num_hidden_layers=2, dtype="float32")
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed + 1))
    cpu_model = copy.deepcopy(model).to("cpu")
    rng = np.random.default_rng(seed + 1)
    ids, labels = (rng.integers(0, cfg.vocab_size, (1, 256))
                   for _ in range(2))
    losses, grads, norms = {}, {}, []
    flags.set_flags({"FLAGS_fused_lm_head_ce": fused})
    fc.fwd_launches = 0
    try:
        for where, m, dev in (("card", model, None),
                              ("cpu", cpu_model, "cpu")):
            if fused:
                sched, opt = recipe_optimizer(m.parameters())
                step = TrainStep(m, None, opt, labels_to_model=True,
                                 device=dev)
            else:
                sched, opt = None, AdamW(learning_rate=1e-4,
                                         parameters=m.parameters())
                step = TrainStep(m, lm_loss(cfg.vocab_size), opt, device=dev)
            losses[where] = []
            for i in range(3 if fused else 2):
                losses[where].append(step(ids, labels).item())
                if i == 0:
                    params = dict(m.named_parameters())
                    grads[where] = {n: params[n].grad.float().cpu()
                                    for n in TRAIN_GRADS}
                    norms.append(float(ClipGradByGlobalNorm(1.0).global_norm(
                        [p.grad for p in m.parameters()])))
                if sched is not None:
                    sched.step()
    finally:
        flags.set_flags({"FLAGS_fused_lm_head_ce": False})
    log("%s losses card %s, cpu %s (%.1f s)" % (
        tag, losses["card"], losses["cpu"], time.perf_counter() - t0))
    if fused:
        log("%s fused forward launches on the card %d, gradient norm %.4g "
            "(clip %g)" % (tag, fc.fwd_launches, norms[0], RECIPE_CLIP))
        if fc.fwd_launches != 3 or not norms[0] > RECIPE_CLIP:
            raise AssertionError("%s: %d fused launches (want 3), gradient "
                                 "norm %.4g vs clip %g" % (
                                     tag, fc.fwd_launches, norms[0],
                                     RECIPE_CLIP))
    for got, want in zip(losses["card"], losses["cpu"]):
        if not (math.isfinite(got)
                and abs(got - want) <= TRAIN_LOSS_RTOL * abs(want)):
            raise AssertionError("card losses %s differ from the CPU plain "
                                 "path's %s (rtol %g)" % (
                                     losses["card"], losses["cpu"],
                                     TRAIN_LOSS_RTOL))
    for name in TRAIN_GRADS:
        got, want = grads["card"][name], grads["cpu"][name]
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        log("%s grad %s: max abs diff %.3g, max |grad| %.3g"
            % (tag, name, diff, scale))
        if not (bool(torch.isfinite(got).all())
                and diff <= TRAIN_GRAD_RTOL * scale):
            raise AssertionError("card gradient of %s differs from the CPU "
                                 "plain path's by %.3g (> %g x %.3g)"
                                 % (name, diff, TRAIN_GRAD_RTOL, scale))


VARIANT_GRADS = ("lm_head.weight",
                 "llama.layers.0.self_attn.qkv_proj.weight",
                 "llama.layers.1.mlp.gate_up_proj.weight")
VARIANT_K, VARIANT_WINDOWS = 2, 2


def phase_train_e2e_variant(seed):
    """Phase 7c: phase 7's model with both fused projections, a
    label-smoothed loss and run_steps, on the card and on a CPU copy."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    tag = "[train e2e variant]"
    t0 = time.perf_counter()
    cfg = LlamaConfig.llama1b_train(num_hidden_layers=2, dtype="float32",
                                    fuse_attention_qkv=True, fuse_mlp=True)
    vocab = cfg.vocab_size
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed + 7))
    cpu_model = copy.deepcopy(model).to("cpu")
    rng = np.random.default_rng(seed + 7)
    windows = [tuple(rng.integers(0, vocab, (VARIANT_K, 1, 256))
                     for _ in range(2)) for _ in range(VARIANT_WINDOWS)]

    def loss_fn(logits, labels):
        return F.cross_entropy(logits.reshape(-1, vocab), labels.reshape(-1),
                               label_smoothing=0.1)

    losses, grads = {}, {}
    for where, m, dev in (("card", model, None), ("cpu", cpu_model, "cpu")):
        device = next(m.parameters()).device
        # the first step's gradients: the loss at the starting weights
        ids, labels = (torch.from_numpy(x[0]).to(device)
                       for x in windows[0])
        loss_fn(m(ids), labels).backward()
        params = dict(m.named_parameters())
        grads[where] = {n: params[n].grad.float().cpu()
                        for n in VARIANT_GRADS}
        step = TrainStep(m, loss_fn, AdamW(learning_rate=1e-4,
                                           parameters=m.parameters()),
                         device=dev)
        losses[where] = [step.run_steps(*w).item() for w in windows]
    log("%s last losses of %d windows of K = %d: card %s, cpu %s (%.1f s)"
        % (tag, VARIANT_WINDOWS, VARIANT_K, losses["card"], losses["cpu"],
           time.perf_counter() - t0))
    for got, want in zip(losses["card"], losses["cpu"]):
        if not (math.isfinite(got)
                and abs(got - want) <= TRAIN_LOSS_RTOL * abs(want)):
            raise AssertionError("%s card losses %s differ from the CPU "
                                 "plain path's %s (rtol %g)" % (
                                     tag, losses["card"], losses["cpu"],
                                     TRAIN_LOSS_RTOL))
    for name in VARIANT_GRADS:
        got, want = grads["card"][name], grads["cpu"][name]
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        log("%s grad %s: max abs diff %.3g, max |grad| %.3g"
            % (tag, name, diff, scale))
        if not (bool(torch.isfinite(got).all())
                and diff <= TRAIN_GRAD_RTOL * scale):
            raise AssertionError("%s card gradient of %s differs from the "
                                 "CPU plain path's by %.3g (> %g x %.3g)"
                                 % (tag, name, diff, TRAIN_GRAD_RTOL, scale))


# -- phase 12: the encoder path (ERNIE, nn.Transformer) -----------------------

# ERNIE-3.0-base pretraining (tools/model_benchmark.py:151-168: B = 16,
# S = 512, fused QKV, 12 heads x 64), the classification fine-tuning row
# and the base Transformer (Vaswani et al.: 6 + 6 layers, d_model 512, 8
# heads, FFN 2048; B = 8, 256 source and 192 target positions)
ERNIE_BATCH, ERNIE_SEQ = 16, 512
ERNIE_STEPS, ERNIE_STEPS_FP32 = 4, 2
ERNIE_MASK_P = 0.15         # masked-LM positions, the rest labelled -100
# AdamW's rates, fixed where a warm-up would start. Post-LN ERNIE-base's
# loss jumps at the first update once AdamW's first step (+-lr on every
# weight) is large enough to land: at ERNIE's peak 1e-4 11.39 -> 18.83
# (bf16) and 11.40 -> 19.00 (float32), in float32 from 5e-6 up (11.92),
# in bf16 from 2e-5 up (12.20), where steps below a weight's bf16 spacing
# round away (the card, NVIDIA H100 80GB HBM3 at 700 W; the jump shows on
# the CPU too). At these rates the loss falls from the first step.
ERNIE_LR = {"bfloat16": 1e-5, "float32": 2e-6}
ERNIE_CHECK = dict(batch=2, seq=128)
CLS_BATCH, CLS_SEQ, CLS_STEPS = 32, 128, 5
TF_BATCH, TF_SRC, TF_TGT = 8, 256, 192
# PaddleNLP's decay idiom: no decay on biases and norms (ERNIE's
# LayerNorms are named ln1, ln2, embed_ln, mlm_ln)
NO_DECAY = ("bias", "norm", "ln")
# kernels 1-3 at the encoders' attention, non-causal, D = 64: ERNIE's
# (once on the strided q/k/v views of a fused [B, N, 3, H, D]
# projection) and the Transformer's cross-attention (N != N_kv)
ENCODER_FLASH_CASES = (dict(batch=ERNIE_BATCH, n=ERNIE_SEQ, heads=12),
                       dict(batch=ERNIE_BATCH, n=ERNIE_SEQ, heads=12,
                            qkv=True),
                       dict(batch=TF_BATCH, n=TF_TGT, n_kv=TF_SRC, heads=8))
# kernels 4-6 at ERNIE's fused MLM tail: T = 16 x 512, H = 768 + 128 (the
# bias folded into a pad block), V = 40000 (the last 256-column tile 64
# wide, 10 backward chunks of 4096)
ENCODER_FCE_CASE = (ERNIE_BATCH * ERNIE_SEQ, 768 + 128, 40000)
# card against CPU copy: float32 sums in another order over 12 layers
# (ERNIE) or 12 layers and 2 x 6 attention blocks (the Transformer);
# LOGIT_RTOL's rule, per tensor: 1e-3 x its largest magnitude
ENCODER_RTOL = 1e-3
# a ReLU input the CPU copy decides otherwise than the card must lie within
# this share of the FFN's largest input of 0: rounding, not a fault (one
# such element in 5 of the base Transformer's 12 FFNs, 3.1M inputs each,
# measured on the card)
KINK = 1e-5


def encoder_flash_case(gen, batch, n, heads, dtype, n_kv=None, qkv=False,
                       head_dim=64, causal=False, tag="encoders"):
    """Kernels 1-3 (non-causal, D = 64 unless told otherwise) against their
    plain versions (O, LSE, dq, dk, dv), twice bit for bit, with ``qkv`` on
    strided views of one ``[B, N, 3, H, D]`` projection (the TMA copies
    counted); timed by CUDA events and profiler device time beside the
    plain versions, torch SDPA's forward and backward (same mask) and the
    bounds."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    d = head_dim
    n_kv = n if n_kv is None else n_kv

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    if qkv:
        q, k, v = rand(batch, n, 3, heads, d).unbind(2)
    else:
        q, k, v = rand(batch, n, heads, d), rand(batch, n_kv, heads, d), \
            rand(batch, n_kv, heads, d)
    dout = rand(batch, n, heads, d)
    copies = fa.tma_copies
    out, lse = fa.flash_attention(q, k, v, causal=causal)
    got = fa.flash_attention_backward(q, k, v, out, lse, dout, causal=causal)
    copies = fa.tma_copies - copies
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, dout,
                                                 causal=causal)
    torch.cuda.synchronize()
    name = "%s flash B=%d N=%d Nkv=%d H=%d D=%d %s %s%s" % (
        "encoder" if tag == "encoders" else tag, batch, n, n_kv, heads, d,
        str(dtype).split(".")[-1], "causal" if causal else "non-causal",
        ", strided fused-QKV views" if qkv else "")
    err = {"fwd": check_close(name + " out", out, ref_out, TOL[dtype]),
           "lse": check_close(name + " lse", lse, ref_lse,
                              TOL[torch.float32])}
    for part, x, y in zip(("dq", "dk", "dv"), got, want):
        err[part] = check_close("%s %s" % (name, part), x, y,
                                BWD_TOL[dtype])
    err["dkv"] = max(err.pop("dk"), err.pop("dv"))
    again = fa.flash_attention(q, k, v, causal=causal)
    again_bwd = fa.flash_attention_backward(q, k, v, out, lse, dout,
                                            causal=causal)
    if not (all(torch.equal(a, b) for a, b in zip(again, (out, lse)))
            and all(torch.equal(a, b) for a, b in zip(again_bwd, got))):
        raise AssertionError("%s: two launches differ" % name)
    row = {"case": name, "max_abs_err": err, "tma_copies": copies,
           "deterministic": True}
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
        .reshape(batch * heads, n).contiguous()
    args = (q, k, v, dout, lse, delta)
    parts = {"fwd": lambda: fa.flash_attention(q, k, v, causal=causal),
             "dq": lambda: fa.flash_attention_bwd_dq(*args, causal=causal),
             "dkv": lambda: fa.flash_attention_bwd_dkv(*args,
                                                       causal=causal)}
    for part, fn in parts.items():
        row[part + "_ms"] = time_ms(fn)
    row["device_ms"] = {part: device_ms(fn, match) for (part, fn), match
                        in zip(parts.items(), ("flash_fwd", "bwd_dq",
                                               "bwd_dkv"))}
    row["plain_fwd_ms"] = time_ms(
        lambda: fa.flash_attention_reference(q, k, v, causal=causal), 3, 3)
    row["plain_bwd_ms"] = time_ms(
        lambda: fa.flash_attention_backward_reference(
            q, k, v, out, lse, dout, causal=causal), 3, 3)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    with torch.no_grad():
        row["library_fwd_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal)
    g = dout.transpose(1, 2)
    row["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), g, retain_graph=True))
    row["library"] = ("torch SDPA, %s: the forward alone, and the backward "
                      "(dq, dk, dv together) as autograd.grad of one "
                      "forward" % ("causal" if causal else "not causal"))
    esize = q.element_size()
    pairs = causal_pairs(batch * heads, n, n_kv) if causal \
        else batch * heads * n * n_kv
    qkv_bytes = (q.numel() + k.numel() + v.numel()) * esize
    reads = qkv_bytes + dout.numel() * esize + 2 * lse.numel() * 4
    row["fwd"] = bound(qkv_bytes + out.numel() * esize + lse.numel() * 4,
                       4 * d * pairs, dtype)
    row["dq"] = bound(reads + q.numel() * esize, 3 * 2 * d * pairs, dtype)
    row["dkv"] = bound(reads + (k.numel() + v.numel()) * esize,
                       4 * 2 * d * pairs, dtype)
    log("[%s] %s" % (tag, json.dumps(row)))
    return row


def encoder_kernels(seed):
    """Phase 12(a): kernels 1-3 at the encoders' shapes and kernels 4-6 at
    ERNIE's fused MLM tail, in float32 and bfloat16."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    rows = {"flash": [], "fused_ce": []}
    for dtype in (torch.float32, torch.bfloat16):
        for case in ENCODER_FLASH_CASES:
            rows["flash"].append(encoder_flash_case(gen, dtype=dtype,
                                                    **case))
        rows["fused_ce"].append(fused_ce_case(gen, *ENCODER_FCE_CASE,
                                              dtype, True, profiled=True))
    return rows


def paddlenlp_decay(model):
    """``apply_decay_param_fun`` by PaddleNLP's idiom, unchanged: decay the
    parameters whose path names no bias or norm (by ``p.name``)."""
    decay = [p.name for n, p in model.named_parameters()
             if not any(s in n for s in NO_DECAY)]
    return lambda name: name in decay


def ernie_batch(seed, vocab, batch, seq):
    """Token ids, token types (two segments), masked-LM labels (the token
    at ERNIE_MASK_P of the positions, -100 elsewhere) and SOP labels, on
    the card."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, seq))
    types = np.zeros((batch, seq), np.int64)
    types[:, seq // 2:] = 1
    masked = np.where(rng.random((batch, seq)) < ERNIE_MASK_P, ids, -100)
    sop = rng.integers(0, 2, (batch,))
    return [torch.from_numpy(np.asarray(a, np.int64)).cuda()
            for a in (ids, types, masked, sop)]


def train_steps(tag, step, batch, steps, want_flash, fused=False):
    """A warm-up step and ``steps`` timed ones of ``step(*batch)`` with
    exact launch counts (``want_flash`` forward, dq and dk/dv launches a
    step, and with ``fused`` one fused-CE forward, dh and dW launch; TMA
    copies reported, not held); finite, falling losses."""
    from paddle_tpu_torch.kernels import fused_ce as fc

    torch.cuda.reset_peak_memory_stats()
    losses = [step(*batch)]
    torch.cuda.synchronize()
    reset_launch_counters()
    fc.fwd_launches = fc.dh_launches = fc.dw_launches = 0
    times = []
    for _ in range(steps):
        t1 = time.perf_counter()
        losses.append(step(*batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    launches = dict(launch_counters(), fused_ce_fwd=fc.fwd_launches,
                    fused_ce_dh=fc.dh_launches, fused_ce_dw=fc.dw_launches)
    want = dict.fromkeys(launches, 0)
    want["tma_copies"] = launches["tma_copies"]
    for name in ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        want[name] = want_flash * steps
    if fused:
        for name in ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw"):
            want[name] = steps
    if launches != want:
        raise AssertionError("%s launches %s, expected %s"
                             % (tag, launches, want))
    losses = [loss.item() for loss in losses]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("%s non-finite loss: %s" % (tag, losses))
    if not losses[-1] < losses[0]:
        raise AssertionError("%s loss did not fall: %s" % (tag, losses))
    median = statistics.median(times)
    tokens = int(batch[0].numel())
    return {"step_ms": median * 1e3, "step_ms_each": [t * 1e3 for t in times],
            "tokens_per_s": tokens / median, "losses": losses,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches,
            "launches_per_step": {k: v / steps for k, v in launches.items()
                                  if v}}


def ernie_pretrain(seed, dtype, fused):
    """Phase 12(b): ERNIE-3.0-base (fused QKV) pretraining through
    ``TrainStep(labels_to_model=True)`` and AdamW with PaddleNLP's decay
    idiom, with FLAGS_fused_lm_head_ce off or on."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    tag = "[ernie %s%s]" % (dtype, " fused" if fused else "")
    cfg = ErnieConfig.base(fuse_qkv=True, dtype=dtype)
    t0 = time.perf_counter()
    model = ErnieForPretraining(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed))
    decay = paddlenlp_decay(model)
    opt = AdamW(learning_rate=ERNIE_LR[dtype], weight_decay=0.01,
                parameters=model.parameters(), apply_decay_param_fun=decay)
    step = TrainStep(model, None, opt, labels_to_model=True)
    batch = ernie_batch(seed, cfg.vocab_size, ERNIE_BATCH, ERNIE_SEQ)
    steps = ERNIE_STEPS if dtype == "bfloat16" else ERNIE_STEPS_FP32
    flags.set_flags({"FLAGS_fused_lm_head_ce": fused})
    try:
        result = train_steps(tag, step, batch, steps,
                             cfg.num_hidden_layers, fused)
    finally:
        flags.set_flags({"FLAGS_fused_lm_head_ce": False})
    params = list(model.parameters())
    result.update(
        dtype=dtype, fused=fused, batch=[ERNIE_BATCH, ERNIE_SEQ],
        params=sum(p.numel() for p in params),
        decayed_tensors=sum(bool(decay(p.name)) for p in params),
        tensors=len(params),
        masked_tokens=int((batch[2] != -100).sum()),
        seconds=time.perf_counter() - t0)
    log(tag + " " + json.dumps(result))
    return result


def ernie_e2e(seed):
    """Phase 12(c): ERNIE-3.0-base (fused QKV, float32) on the card against
    a CPU copy on the same weights: the MLM and SOP logits (12 kernel-1
    launches), then ErnieModel with a padding ``attn_mask`` (SDPA's masked
    path: no flash launch)."""
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining

    tag = "[ernie e2e]"
    cfg = ErnieConfig.base(fuse_qkv=True)
    model = ErnieForPretraining(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed + 1))
    cpu_model = ErnieForPretraining(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    model.eval()
    cpu_model.eval()
    ids, types, _, _ = ernie_batch(seed + 1, cfg.vocab_size,
                                   ERNIE_CHECK["batch"], ERNIE_CHECK["seq"])
    keep = torch.ones((ids.shape[0], 1, 1, ids.shape[1]), dtype=torch.bool)
    keep[1, ..., ids.shape[1] * 3 // 4:] = False      # row 1 padded
    rows, launches = {}, {}
    with torch.no_grad():
        for run, fn in (("logits", lambda m, *a: m(*a)),
                        ("padding mask", lambda m, *a: m.ernie(*a))):
            extra = () if run == "logits" else (keep,)
            reset_launch_counters()
            got = fn(model, ids, types, *(x.cuda() for x in extra))
            torch.cuda.synchronize()
            counts = launch_counters()
            want_flash = cfg.num_hidden_layers if run == "logits" else 0
            want = dict.fromkeys(counts, 0)
            want["flash_attention"] = want_flash
            if counts != want:
                raise AssertionError("%s %s launches %s, want %d flash "
                                     "forwards" % (tag, run, counts,
                                                   want_flash))
            launches[run] = counts
            ref = fn(cpu_model, ids.cpu(), types.cpu(), *extra)
            for what, g, w in zip(("mlm", "sop") if run == "logits"
                                  else ("h", "pooled"), got, ref):
                rows["%s %s" % (run, what)] = close_rel(
                    "%s %s %s" % (tag, run, what), g.cpu(), w)
    log(tag + " " + json.dumps(rows))
    return launches["logits"]


def close_rel(name, got, want, rtol=ENCODER_RTOL, scale=None):
    """``got`` within ``rtol`` x max|want| (or x ``scale``) of ``want``;
    returns the numbers."""
    diff = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max()) if scale is None else scale
    if not (bool(torch.isfinite(got).all()) and diff <= rtol * scale):
        raise AssertionError("%s: card and CPU differ by %.3g (> %g x %.3g)"
                             % (name, diff, rtol, scale))
    return {"max_abs_diff": diff, "scale": scale}


def ernie_classify(seed):
    """Phase 12(d): ErnieForSequenceClassification (2 classes, bf16,
    separate q/k/v projections) fine-tuned a few steps on one batch."""
    from paddle_tpu_torch.models import (ErnieConfig,
                                         ErnieForSequenceClassification)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    tag = "[ernie cls]"
    cfg = ErnieConfig.base(dtype="bfloat16")
    model = ErnieForSequenceClassification(
        cfg, num_classes=2,
        generator=torch.Generator(device="cuda").manual_seed(seed + 2))
    opt = AdamW(learning_rate=ERNIE_LR["bfloat16"],
                parameters=model.parameters(),
                apply_decay_param_fun=paddlenlp_decay(model))
    step = TrainStep(model, None, opt, labels_to_model=True)
    ids, types, _, _ = ernie_batch(seed + 2, cfg.vocab_size, CLS_BATCH,
                                   CLS_SEQ)
    labels = torch.from_numpy(np.random.default_rng(seed + 2).integers(
        0, 2, CLS_BATCH)).cuda()
    result = train_steps(tag, step, (ids, types, labels), CLS_STEPS,
                         cfg.num_hidden_layers)
    result.update(batch=[CLS_BATCH, CLS_SEQ], classes=2, dtype="bfloat16")
    log(tag + " " + json.dumps(result))
    return result


def transformer_e2e(seed):
    """Phase 12(e): nn.Transformer at the base width (float32, relu) with a
    causal tgt_mask: one forward and backward at dropout 0 on the card
    against a CPU copy (the output and every gradient), then one AdamW
    step at the default dropout 0.1 with ``dropout_p`` reaching SDPA. Per
    pass 6 + 6 flash launches of each kernel: the encoder's self-attention
    and the decoder's cross-attention; the decoder's masked
    self-attention takes SDPA's masked path.

    ReLU's derivative jumps at 0, so an activation within rounding of 0
    (the two sides sum in other orders) can take the other branch on the
    CPU and move a whole token's term of that FFN's gradients, and through
    them every gradient before it, far past float32 rounding (1.35e-2 of
    max|grad| for one such element, measured). So the CPU copy replays the
    card's ReLU decisions: it multiplies by the card's masks, and the
    elements where its own decision differs are counted and must sit
    within ``KINK`` of 0."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.optimizer import AdamW

    tag = "[transformer]"
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    model = nn.Transformer(dropout=0.0, generator=gen)
    cpu_model = nn.Transformer(dropout=0.0, device="cpu")
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    rng = np.random.default_rng(seed + 3)
    src, tgt = (torch.from_numpy(rng.standard_normal(
        (TF_BATCH, n, model.d_model), np.float32)) for n in (TF_SRC, TF_TGT))
    w = torch.from_numpy(rng.standard_normal(
        (TF_BATCH, TF_TGT, model.d_model), np.float32))
    mask = nn.Transformer.generate_square_subsequent_mask(TF_TGT)
    layers = len(model.encoder.layers) + len(model.decoder.layers)

    def want_counts(counts):
        want = dict.fromkeys(counts, 0)
        for name in ("flash_attention", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"):
            want[name] = layers
        return want

    relu, masks, kinks = F.relu, [], []

    def record(x):
        masks.append(x > 0)
        return relu(x)

    def replay(x):
        keep, xd = masks[len(kinks)].cpu(), x.detach()
        flipped = keep != (xd > 0)
        kinks.append((int(flipped.sum()), float(xd[flipped].abs().max())
                      if flipped.any() else 0.0, float(xd.abs().max())))
        return x * keep
    try:
        F.relu = record
        reset_launch_counters()
        out = model(src.cuda(), tgt.cuda(), None, mask)
        (out * w.cuda()).sum().backward()
        torch.cuda.synchronize()
        launches = launch_counters()
        F.relu = replay
        cpu_out = cpu_model(src, tgt, None, mask.cpu())
        (cpu_out * w).sum().backward()
    finally:
        F.relu = relu
    if launches != want_counts(launches):
        raise AssertionError("%s launches %s" % (tag, launches))
    flips = sum(k[0] for k in kinks)
    if len(kinks) != layers or any(k[1] > KINK * k[2] for k in kinks) \
            or flips > 1e-5 * sum(m.numel() for m in masks):
        raise AssertionError("%s ReLU decisions the CPU takes otherwise "
                             "(count, max |x| there, max |x|): %s"
                             % (tag, kinks))
    pairs = {"out": (out.detach().cpu(), cpu_out.detach(), None)}
    grads = {n: p.grad for n, p in cpu_model.named_parameters()}
    largest = max(float(g.abs().max()) for g in grads.values())
    for name, p in model.named_parameters():
        # a key bias's gradient is 0 in exact arithmetic (the softmax
        # cancels a constant added to a query's scores): both sides hold
        # rounding noise, held against the model's largest gradient
        pairs[name] = (p.grad.cpu(), grads[name],
                       largest if name.endswith("k_proj.bias") else None)
    ratios = {name: float((got - want).abs().max()) / (
        scale or float(want.abs().max())) for name, (got, want, scale)
        in pairs.items()}
    worst = sorted(ratios.items(), key=lambda kv: -kv[1])[:5]
    log("%s card vs CPU, the largest max|diff| / max|.|: %s; ReLU "
        "decisions replayed, %d of them within rounding of 0 on the CPU"
        % (tag, json.dumps(worst), flips))
    checks = {name: close_rel("%s %s" % (tag, name), got, want, scale=scale)
              for name, (got, want, scale) in pairs.items()}
    del model, cpu_model, out, cpu_out, masks
    torch.cuda.empty_cache()

    # one training step at the default dropout, dropout_p seen by SDPA
    model = nn.Transformer(generator=gen)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    seen = []
    sdpa = F.scaled_dot_product_attention

    def spy(*args, **kw):
        seen.append(kw.get("dropout_p"))
        return sdpa(*args, **kw)
    F.scaled_dot_product_attention = spy
    try:
        reset_launch_counters()
        loss = (model(src.cuda(), tgt.cuda(), None, mask)
                * w.cuda()).mean()
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_counts = launch_counters()
    finally:
        F.scaled_dot_product_attention = sdpa
    attention_calls = len(model.encoder.layers) + 2 * len(
        model.decoder.layers)
    if seen != [0.1] * attention_calls or not math.isfinite(loss.item()):
        raise AssertionError("%s dropout step: dropout_p %s, loss %s"
                             % (tag, seen, loss.item()))
    if step_counts != want_counts(step_counts):
        raise AssertionError("%s dropout step launches %s"
                             % (tag, step_counts))
    result = {"batch": TF_BATCH, "src": TF_SRC, "tgt": TF_TGT,
              "params": sum(p.numel() for p in model.parameters()),
              "tensors_checked": len(checks), "worst": worst,
              "out": checks["out"], "relu_kinks": kinks,
              "dropout_step_loss": loss.item(),
              "dropout_p_seen": sorted(set(seen)),
              "sdpa_calls": len(seen), "launches": launches,
              "seconds": time.perf_counter() - t0}
    log(tag + " " + json.dumps(result))
    return launches, step_counts


def phase_encoders(seed):
    """Phase 12: the encoder path. Returns (kernel rows, launch counts by
    path, seconds)."""
    t_phase = time.perf_counter()
    paths, runs = {}, {}
    for dtype in ("bfloat16", "float32"):
        for fused in (False, True):
            run = ernie_pretrain(seed, dtype, fused)
            runs[(dtype, fused)] = run
            paths["ernie %s%s" % (dtype, " fused" if fused else "")] = \
                run["launches"]
            torch.cuda.empty_cache()
        check_fused_train(runs[(dtype, False)], runs[(dtype, True)],
                          FUSED_LOSS_RTOL if dtype == "bfloat16"
                          else FUSED32_LOSS_RTOL,
                          tag="[ernie %s fused]" % dtype)
    paths["ernie forward"] = ernie_e2e(seed)
    torch.cuda.empty_cache()
    paths["ernie classification"] = ernie_classify(seed)["launches"]
    torch.cuda.empty_cache()
    paths["transformer"], paths["transformer dropout"] = \
        transformer_e2e(seed)
    torch.cuda.empty_cache()
    # the kernel cases last: they run the profiler
    rows = encoder_kernels(seed)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log("[encoders] phase 12 in %.1f s" % seconds)
    return rows, paths, seconds


# -- phase 13: ResNet-50 training, the losses (no kernel of the port) ---------

# card vs CPU ResNet-50 in float32 (TF32 off for cuDNN as for cuBLAS): 53
# convolutions and batch norms whose sums run in other orders (cuDNN's
# algorithms against the CPU's); a wrong layout, padding or statistic
# moves the logits by O(1) of their range
RESNET_RTOL = 1e-3
# the same card, NHWC against NCHW: other cuDNN algorithms only
RESNET_LAYOUT_RTOL = 1e-4
# one training step's gradients at initialisation are ill-conditioned:
# ReLU's gradient switches at 0, and a few of the step's ReLU inputs lie
# within float32's rounding of 0. Each switch moves the gradients of every
# layer below it, by up to tens of % of a tensor's max|.| (the batch
# statistics' backward spreads it). The witness is float64 itself at
# inputs moved by 2**-24 of their size: it counts the switches, and it
# sits about as far from float64 as float32 does. So (b) holds each
# tensor to the float64 CPU copy within RESNET_NOISE_FACTOR x its noise
# (the larger of the float32 CPU copy's and the witness's distance) plus
# RESNET_NOISE_FLOOR: the named gradients by max|.| (RESNET_GRADS), every
# parameter's update by its norm (a switch moves a few rows of a tensor,
# a wrong rule all of it). The check must fail each fault planted on the
# card (RESNET_FAULTS).
RESNET_NOISE_FACTOR, RESNET_NOISE_FLOOR = 4.0, 1e-5
RESNET_WITNESS_SHIFT = 2.0 ** -24
RESNET_CHECK_BATCH, RESNET_STEP_BATCH, RESNET_SIZE = 2, 8, 224
RESNET_GRADS = ("conv1.weight", "layer4.2.bn3.weight", "fc.weight")
# (what is held, tensors (None: every one), distance)
RESNET_HELD = (("gradients", RESNET_GRADS, "max"),
               ("updates", None, "norm"))
# planted on the card: one gradient scaled by 1 %, one tensor left out of
# the optimizer
RESNET_FAULTS = (("scale", "fc.weight", 1.01),
                 ("skip", "layer1.0.bn1.bias"))
# the reference's chip row (tools/model_benchmark.py:86-131: batch 64,
# 224 x 224, 2 warm-up steps), 10 timed steps
RESNET_BENCH_ITERS = 10
RESNET_BENCH_ROWS = (("float32", "NCHW"), ("bfloat16", "NCHW"),
                     ("bfloat16", "NHWC"))
# card vs CPU losses in float32 at a few dozen elements: 1e-5 of the
# largest magnitude; the CTC and RNN-T recursions sum over every
# alignment in log space, 1e-4
LOSS_RTOL, LOSS_SCAN_RTOL = 1e-5, 1e-4


def resnet_batch(seed, batch, layout="NCHW"):
    """Images ``U(-1, 1)`` and labels from ``seed``, on the CPU."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.rand(batch, 3, RESNET_SIZE, RESNET_SIZE) * 2
                          - 1).astype(np.float32))
    if layout == "NHWC":
        x = x.permute(0, 2, 3, 1).contiguous()
    return x, torch.from_numpy(rng.randint(0, 1000, batch))


def resnet_pair(seed):
    """ResNet-50 (1000 classes, float32) on the card from ``seed`` and a
    CPU copy holding the same weights and statistics."""
    from paddle_tpu_torch.vision.models import resnet50

    model = resnet50(num_classes=1000,
                     generator=torch.Generator(device="cuda").manual_seed(
                         seed))
    cpu = resnet50(num_classes=1000, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return model, cpu


def no_port_launches(tag, fn):
    """``fn()`` with every launch counter at 0 before and still 0 after:
    this path runs no kernel of the port. Returns (fn's result, counts)."""
    reset_launch_counters()
    out = fn()
    torch.cuda.synchronize()
    counts = launch_counters()
    if any(counts.values()):
        raise AssertionError("%s launched port kernels: %s" % (tag, counts))
    return out, counts


def resnet_forward(seed):
    """Phase 13(a) and (c): logits in train and in eval mode, and the
    running statistics the train forward leaves, against the CPU copy;
    then NHWC against NCHW on the card."""
    from paddle_tpu_torch.vision.models import resnet50

    tag = "[resnet50 forward]"
    model, cpu = resnet_pair(seed)
    x, _ = resnet_batch(seed, RESNET_CHECK_BATCH)
    rows = {}
    with torch.no_grad():
        got, counts = no_port_launches(tag, lambda: model(x.cuda()))
        rows["train logits"] = close_rel(tag + " train logits", got.cpu(),
                                         cpu(x), RESNET_RTOL)
        stats = dict(cpu.named_buffers())
        worst = max((close_rel("%s %s" % (tag, name), buf.cpu(),
                               stats[name], RESNET_RTOL)["max_abs_diff"]
                     / max(float(stats[name].abs().max()), 1e-30), name)
                    for name, buf in model.named_buffers())
        rows["running statistics"] = {"buffers": len(stats),
                                      "worst_rel": worst[0],
                                      "worst": worst[1]}
        model.eval()
        cpu.eval()
        got = model(x.cuda())
        rows["eval logits"] = close_rel(tag + " eval logits", got.cpu(),
                                        cpu(x), RESNET_RTOL)
        nhwc = resnet50(num_classes=1000, data_format="NHWC")
        nhwc.load_state_dict(model.state_dict())
        nhwc.eval()
        xl = x.permute(0, 2, 3, 1).contiguous().cuda()
        rows["nhwc eval logits"] = close_rel(
            tag + " NHWC vs NCHW", nhwc(xl).cpu(), got.cpu(),
            RESNET_LAYOUT_RTOL)
    log(tag + " " + json.dumps(rows))
    return counts


def rel_to(got, want):
    """max |got - want| over max |want|."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max()
                 / max(float(want.abs().max()), 1e-30))


def norm_to(got, want):
    """||got - want|| over ||want||."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def train_once(model, x, y, device, fault=None):
    """One Momentum(0.1, 0.9) step of ``model`` through TrainStep: the
    loss, and the gradients, updates and running statistics in float64
    on the CPU. ``fault`` plants one: ``("scale", name, factor)`` scales
    that tensor's gradient, ``("skip", name)`` leaves it out of the
    optimizer."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.parallel import TrainStep

    params = dict(model.named_parameters())
    before = {n: p.detach().double().cpu().clone()
              for n, p in params.items()}
    kind, name = fault[:2] if fault else (None, None)
    if kind == "scale":
        params[name].register_hook(lambda g: g * fault[2])
    opt = Momentum(learning_rate=0.1, momentum=0.9,
                   parameters=[p for n, p in params.items()
                               if not (kind == "skip" and n == name)])
    loss = TrainStep(model, F.cross_entropy, opt, device=device)(x, y)
    return {"loss": float(loss),
            "gradients": {n: p.grad.double().cpu()
                          for n, p in params.items()},
            "updates": {n: p.detach().double().cpu() - before[n]
                        for n, p in params.items()},
            "statistics": {n: b.double().cpu()
                           for n, b in model.named_buffers()}}


def relu_signs(model):
    """The ``> 0`` masks of every ReLU output of ``model``'s forwards,
    appended as they run."""
    from paddle_tpu_torch.nn import ReLU

    signs = []
    for mod in model.modules():
        if isinstance(mod, ReLU):
            mod.register_forward_hook(
                lambda m, i, out: signs.append(out.detach() > 0))
    return signs


def step_distances(card, refs):
    """{what: {distance: {tensor: [card's, float32 CPU's, witness's]
    distance from float64's]}}}."""
    out = {}
    for what in ("gradients", "updates"):
        want = refs["float64"][what]
        out[what] = {
            kind: {n: [fn(r[what][n], want[n])
                       for r in (card, refs["float32"], refs["witness"])]
                   for n in want}
            for kind, fn in (("max", rel_to), ("norm", norm_to))}
    return out


def check_step(tag, dist):
    """Each tensor of RESNET_HELD within RESNET_NOISE_FACTOR x its noise
    plus RESNET_NOISE_FLOOR; raises on the first that is not."""
    for what, names, kind in RESNET_HELD:
        table = dist[what][kind]
        for n in names or table:
            card, c32, wit = table[n]
            bound = RESNET_NOISE_FACTOR * max(c32, wit) + RESNET_NOISE_FLOOR
            if not card <= bound:
                raise AssertionError(
                    "%s %s of %s: %s distance from float64 %.3g on the "
                    "card, > %.3g (float32 CPU %.3g, witness %.3g)"
                    % (tag, what, n, kind, card, bound, c32, wit))


def resnet_step_refs(seed, state, x, y):
    """The step on float32 and float64 CPU copies holding ``state``, and
    on the witness: float64 at ``x`` moved by RESNET_WITNESS_SHIFT of its
    size (signs from ``seed``), with the number of ReLU outputs whose
    sign it switched against the float64 copy."""
    from paddle_tpu_torch.vision.models import resnet50

    refs, signs = {}, {}
    shift = torch.from_numpy(np.random.RandomState(seed).choice(
        [-1.0, 1.0], x.shape))
    for name, dtype, xin in (
            ("float32", torch.float32, x),
            ("float64", torch.float64, x.double()),
            ("witness", torch.float64,
             x.double() * (1 + RESNET_WITNESS_SHIFT * shift))):
        model = resnet50(num_classes=1000, device="cpu", dtype=dtype)
        model.load_state_dict({k: v.cpu().to(dtype)
                               if v.is_floating_point() else v.cpu()
                               for k, v in state.items()})
        signs[name] = relu_signs(model)
        refs[name] = train_once(model, xin, y, "cpu")
    switched = sum(int((a != b).sum())
                   for a, b in zip(signs["float64"], signs["witness"]))
    return refs, switched, sum(m.numel() for m in signs["float64"])


def resnet_step(seed):
    """Phase 13(b): one Momentum(0.1, 0.9) step through TrainStep on the
    card, held to a float64 CPU copy: the loss, conv1.weight's,
    layer4.2.bn3.weight's and fc.weight's gradients, every parameter's
    update, bn1's statistics; each tensor within RESNET_NOISE_FACTOR x
    its own noise. Then the same check on the card's step with each of
    RESNET_FAULTS planted must fail."""
    from paddle_tpu_torch.vision.models import resnet50

    tag = "[resnet50 step]"

    def card_model():
        return resnet50(num_classes=1000,
                        generator=torch.Generator(device="cuda").manual_seed(
                            seed + 1))

    model = card_model()
    x, y = resnet_batch(seed + 1, RESNET_STEP_BATCH)
    refs, switched, relus = resnet_step_refs(seed + 2, model.state_dict(),
                                             x, y)
    card, counts = no_port_launches(
        tag, lambda: train_once(model, x.cuda(), y.cuda(), None))
    loss64 = refs["float64"]["loss"]
    rows = {"loss": [card["loss"], refs["float32"]["loss"], loss64,
                     refs["witness"]["loss"]],
            "witness relu switches": [switched, relus]}
    if not abs(card["loss"] - loss64) <= TRAIN_LOSS_RTOL * abs(loss64):
        raise AssertionError("%s loss %r on the card, %r in float64"
                             % (tag, card["loss"], loss64))
    dist = step_distances(card, refs)
    check_step(tag, dist)
    for what in ("gradients", "updates"):
        for kind, table in dist[what].items():
            cols = list(zip(*table.values()))
            rows["%s %s max, median [card, f32, witness]" % (what, kind)] = [
                [max(c) for c in cols], [statistics.median(c) for c in cols]]
            noise = {n: c / max(a, b, 1e-30) for n, (c, a, b) in table.items()}
            worst = max(noise, key=noise.get)
            rows["%s %s worst card / noise" % (what, kind)] = [
                worst, noise[worst]]
    rows.update(("grad %s [card, f32, witness]" % n,
                 dist["gradients"]["max"][n]) for n in RESNET_GRADS)
    for name in ("bn1._mean", "bn1._variance"):
        rows[name] = close_rel("%s %s" % (tag, name),
                               card["statistics"][name],
                               refs["float64"]["statistics"][name],
                               RESNET_RTOL)
    caught = {}
    for fault in RESNET_FAULTS:
        faulty = train_once(card_model(), x.cuda(), y.cuda(), None, fault)
        try:
            check_step(tag, step_distances(faulty, refs))
        except AssertionError as e:
            caught[" ".join(map(str, fault))] = str(e)
            continue
        raise AssertionError("%s the check passed a planted fault: %s"
                             % (tag, fault))
    rows["planted faults caught"] = caught
    log(tag + " " + json.dumps(rows))
    return counts


def resnet_bench(card):
    """Phase 13(d): the reference's ResNet-50 train row at batch 64,
    224 x 224: float32 NCHW, and bf16 in NCHW and NHWC."""
    from paddle_tpu_torch.tools.model_benchmark import measure_resnet50

    rows, counts = [], None
    for dtype, layout in RESNET_BENCH_ROWS:
        tag = "[resnet50 bench %s %s]" % (dtype, layout)
        row, counts = no_port_launches(tag, lambda: measure_resnet50(
            layout, dtype, RESNET_BENCH_ITERS, "cuda"))
        row.update(dtype=dtype, layout=layout, card=card,
                   iters=RESNET_BENCH_ITERS)
        log(tag + " " + json.dumps(row))
        rows.append(row)
        torch.cuda.empty_cache()
    return rows, counts


def loss_cases():
    """(name, numpy inputs, indices of the differentiated ones, call,
    tolerance) for every loss of ``nn/functional/loss.py`` past
    ``nll_loss``, at a small size."""
    from paddle_tpu_torch.nn import functional as F

    rng = np.random.RandomState(13)

    def f(*shape, lo=-1.0, hi=1.0):
        return (lo + (hi - lo) * rng.rand(*shape)).astype(np.float32)

    def pm1(*shape):
        return np.where(rng.rand(*shape) < 0.5, -1.0, 1.0).astype(
            np.float32)

    def logp(*shape):
        x = rng.randn(*shape).astype(np.float32)
        return x - np.log(np.exp(x).sum(-1, keepdims=True))

    ctc = [logp(7, 3, 5), np.array([[1, 2, 2], [3, 1, 0], [4, 4, 0]]),
           np.array([7, 6, 5]), np.array([3, 2, 1])]
    rnnt = [rng.randn(2, 4, 3, 5).astype(np.float32),
            np.array([[1, 2], [3, 0]]), np.array([4, 3]), np.array([2, 1])]
    two, three = (0, 1), (0, 1, 2)
    return [
        ("mse_loss", [f(4, 3), f(4, 3)], two, F.mse_loss, LOSS_RTOL),
        ("l1_loss", [f(4, 3), f(4, 3)], two, F.l1_loss, LOSS_RTOL),
        ("smooth_l1_loss", [f(4, 5) * 2, f(4, 5)], two,
         lambda a, b: F.smooth_l1_loss(a, b, delta=0.7), LOSS_RTOL),
        ("huber_loss", [f(4, 5) * 2, f(4, 5)], two,
         lambda a, b: F.huber_loss(a, b, delta=0.6), LOSS_RTOL),
        ("binary_cross_entropy", [f(4, 3, lo=0.02, hi=0.98),
                                  f(4, 3, lo=0, hi=1), f(3, lo=0.5, hi=2)],
         three, F.binary_cross_entropy, LOSS_RTOL),
        ("binary_cross_entropy_with_logits",
         [f(4, 3) * 4, f(4, 3, lo=0, hi=1), f(3, lo=0.5, hi=2)], three,
         lambda a, b, w: F.binary_cross_entropy_with_logits(
             a, b, w, pos_weight=w), LOSS_RTOL),
        ("kl_div", [logp(4, 5), f(4, 5, lo=0, hi=1)], two,
         lambda a, b: F.kl_div(a, b, reduction="batchmean"), LOSS_RTOL),
        ("hinge_embedding_loss", [f(6, 3) * 2, pm1(6, 3)], (0,),
         F.hinge_embedding_loss, LOSS_RTOL),
        ("margin_ranking_loss", [f(8), f(8), pm1(8)], two,
         lambda a, b, y: F.margin_ranking_loss(a, b, y, margin=0.2),
         LOSS_RTOL),
        ("cosine_embedding_loss", [f(6, 4), f(6, 4), pm1(6)], two,
         lambda a, b, y: F.cosine_embedding_loss(a, b, y, margin=0.1),
         LOSS_RTOL),
        ("triplet_margin_loss", [f(5, 4), f(5, 4), f(5, 4)], three,
         lambda a, p, n: F.triplet_margin_loss(a, p, n, p=3.0, swap=True),
         LOSS_RTOL),
        ("log_loss", [f(4, 1, lo=0.05, hi=0.95), f(4, 1, lo=0, hi=1)], two,
         F.log_loss, LOSS_RTOL),
        ("square_error_cost", [f(4, 3), f(4, 3)], two, F.square_error_cost,
         LOSS_RTOL),
        ("ctc_loss_dense", ctc, (0,), F.ctc_loss_dense, LOSS_SCAN_RTOL),
        ("ctc_loss", ctc, (0,), lambda *a: F.ctc_loss(
            *a, norm_by_times=True, reduction="sum"), LOSS_SCAN_RTOL),
        ("warpctc", [rng.randn(7, 3, 5).astype(np.float32)] + ctc[1:], (0,),
         F.warpctc, LOSS_SCAN_RTOL),
        ("sigmoid_focal_loss", [f(4, 3) * 3,
                                (rng.rand(4, 3) < 0.4).astype(np.float32)],
         (0,), lambda a, b: F.sigmoid_focal_loss(a, b, gamma=1.5),
         LOSS_RTOL),
        ("sigmoid_cross_entropy_with_logits",
         [f(4, 3) * 3, np.array([[0, 1, -100], [1, 1, 0], [-100, 0, 1],
                                 [0, 0, 1]], np.float32)], (0,),
         lambda a, b: F.sigmoid_cross_entropy_with_logits(a, b,
                                                          normalize=True),
         LOSS_RTOL),
        ("margin_cross_entropy", [f(4, 6, lo=-0.95, hi=0.95),
                                  np.array([0, 5, 2, 2])], (0,),
         lambda a, b: F.margin_cross_entropy(a, b, margin2=0.3, scale=8.0),
         LOSS_RTOL),
        ("hsigmoid_loss", [f(4, 6), np.array([0, 3, 6, 2]), f(6, 6), f(6)],
         (0, 2, 3), lambda x, y, w, b: F.hsigmoid_loss(x, y, 7, w, b),
         LOSS_RTOL),
        ("soft_margin_loss", [f(4, 3) * 3, pm1(4, 3)], (0,),
         F.soft_margin_loss, LOSS_RTOL),
        ("multi_label_soft_margin_loss",
         [f(4, 5) * 3, (rng.rand(4, 5) < 0.5).astype(np.float32),
          f(5, lo=0.5, hi=2)], (0, 2), F.multi_label_soft_margin_loss,
         LOSS_RTOL),
        ("npair_loss", [f(6, 4), f(6, 4), np.array([0, 1, 0, 2, 1, 3.0],
                                                   np.float32)], two,
         F.npair_loss, LOSS_RTOL),
        ("dice_loss", [f(3, 4, 5, lo=0, hi=1), rng.randint(0, 5, (3, 4, 1))],
         (0,), F.dice_loss, LOSS_RTOL),
        ("multi_margin_loss", [f(5, 4) * 2, np.array([0, 3, 1, 1, 2]),
                               f(4, lo=0.5, hi=2)], (0, 2),
         lambda x, y, w: F.multi_margin_loss(x, y, p=2, weight=w),
         LOSS_RTOL),
        ("pairwise_distance", [f(5, 4), f(5, 4)], two,
         lambda a, b: F.pairwise_distance(a, b, p=1.5), LOSS_RTOL),
        ("triplet_margin_with_distance_loss", [f(5, 4), f(5, 4), f(5, 4)],
         three, lambda a, p, n: F.triplet_margin_with_distance_loss(
             a, p, n, swap=True), LOSS_RTOL),
        ("rnnt_loss", rnnt, (0,), F.rnnt_loss, LOSS_SCAN_RTOL),
    ]


def loss_run(arrays, diff, call, device):
    ts = [torch.tensor(a, device=device, requires_grad=i in diff)
          for i, a in enumerate(arrays)]
    out = call(*ts)
    out.backward(torch.ones_like(out))
    return out.detach().cpu(), [ts[i].grad.cpu() for i in diff]


def phase_losses(seed):
    """Phase 13(e): every new loss on the card against the same call on
    the CPU, the value and each floating input's gradient; then
    ``class_center_sample`` on card labels."""
    from paddle_tpu_torch.nn import functional as F

    tag = "[losses]"
    worst = {}
    for name, arrays, diff, call, rtol in loss_cases():
        (got, got_g), counts = no_port_launches(
            tag, lambda: loss_run(arrays, diff, call, "cuda"))
        want, want_g = loss_run(arrays, diff, call, "cpu")
        errs = [close_rel("%s %s" % (tag, name), got, want, rtol)]
        errs += [close_rel("%s %s grad %d" % (tag, name, i), g, w, rtol)
                 for i, g, w in zip(diff, got_g, want_g)]
        worst[name] = max(e["max_abs_diff"] / max(e["scale"], 1e-30)
                          for e in errs)
    labels = torch.tensor([3, 17, 3, 40, 8, 17], device="cuda")
    remapped, sampled = F.class_center_sample(
        labels, 50, 10, generator=torch.Generator(device="cuda").manual_seed(
            seed))
    extra = sampled[4:].tolist()
    if not (sampled.device == labels.device == remapped.device
            and sampled.numel() == len(set(sampled.tolist())) == 10
            and torch.equal(sampled[remapped], labels)
            and sampled[:4].tolist() == [3, 8, 17, 40]
            and extra == sorted(extra) and not {3, 8, 17, 40} & set(extra)):
        raise AssertionError("%s class_center_sample: %s %s"
                             % (tag, remapped.tolist(), sampled.tolist()))
    log(tag + " %d losses, worst relative difference %.3g (%s)"
        % (len(worst), max(worst.values()), max(worst, key=worst.get)))
    return counts


def phase_resnet(seed, card):
    """Phase 13: ResNet-50 on the card. Returns (bench rows, launch counts
    by path, seconds)."""
    t_phase = time.perf_counter()
    paths = {"resnet50 forward": resnet_forward(seed)}
    torch.cuda.empty_cache()
    paths["resnet50 step"] = resnet_step(seed)
    torch.cuda.empty_cache()
    rows, paths["resnet50 bench"] = resnet_bench(card)
    paths["losses"] = phase_losses(seed)
    seconds = time.perf_counter() - t_phase
    log("[resnet50] phase 13 in %.1f s" % seconds)
    return rows, paths, seconds


# -- phase 14: an attention seq2seq (RNN, beam search; no kernel of the port)

# Luong, Pham & Manning (2015), "Effective Approaches to Attention-based
# Neural Machine Translation", at its IWSLT'15 English -> Vietnamese widths,
# which PaddleNLP's examples/machine_translation/seq2seq trains too:
# vocabularies 17191 / 7709, embedding and hidden 512, 2 LSTM layers a
# side, input feeding, every parameter from U(-0.1, 0.1), Adam(1e-3) with
# the gradients' global norm clipped at 5, beam 10 over at most 50 steps
S2S = dict(src_vocab=17191, tgt_vocab=7709, embed=512, hidden=512, layers=2)
S2S_INIT, S2S_LR, S2S_CLIP = 0.1, 1e-3, 5.0
S2S_BATCH, S2S_LENS, S2S_CHECK_BATCH = 128, (10, 50), 4
S2S_BEAM, S2S_MAX_STEPS, S2S_BOS, S2S_EOS = 10, 50, 1, 2
S2S_TIMED_STEPS, S2S_TIMED_DECODES = 3, 2
# card vs CPU in float32: the encoder's and the decoder's 50 steps each
# sum 512- and 1024-wide products in another order (cuBLAS vs the CPU's
# GEMMs); the logits and the loss agree to ~1e-6 relative, the gradients
# through 50 steps back to ~1e-5. A wrong gate, mask or tie order moves
# them by O(1)
S2S_RTOL, S2S_GRAD_RTOL = 1e-4, 1e-3
# Adam's first update is lr * g / (|g| + eps): +-lr wherever |g| stands
# above its rounding noise, which may flip where it does not. So (b) holds
# the update of every entry whose CPU gradient exceeds S2S_GRAD_RTOL of
# its tensor's max|g| within S2S_UPDATE_RTOL x lr, and the rest within
# 2 x lr (their count is printed)
S2S_UPDATE_RTOL = 1e-3
S2S_GRADS = ("encoder.weight_hh_l1", "decoder.cell.lstm_cells.0.weight_ih",
             "output_layer.weight")
# planted on the card: one gradient scaled by 1 %, one tensor left out of
# the optimizer
S2S_FAULTS = (("scale", "output_layer.weight", 1.01),
              ("skip", "decoder.cell.lstm_cells.1.weight_hh"))
# beam scores (log-probabilities summed over the steps) whose card and CPU
# values lie this close may be taken in either order
S2S_NEAR_TIE = 1e-3
# the recurrent layers and cells on the card against the CPU (float32),
# and a bf16 LSTMCell given no states (float32 states: JAX's promotion)
RNN_RTOL, RNN_BF16_RTOL = 1e-4, 2e-2
COMMON_RTOL = 1e-5


class Seq2SeqCell(torch.nn.Module):
    """The decoder's step, from the framework's public API: the embedded
    token and the last attentional output (input feeding) through
    ``layers`` LSTMCells, then Luong's dot attention over the bound
    memory, ``softmax(h . memory^T)`` with the padding masked by
    ``sequence_mask``, and ``tanh(W_c [context; h])``. The states are one
    flat list, ``[h_0, c_0, h_1, c_1, ..., attentional output]``, as
    ``BeamSearchDecoder`` takes them; the memory is bound beforehand
    (``bind``), since neither ``RNN`` nor the decoder passes it."""

    def __init__(self, embed, hidden, layers, *, generator, device,
                 dtype=torch.float32):
        from paddle_tpu_torch import nn

        super().__init__()
        self.hidden_size = hidden
        self.lstm_cells = nn.LayerList([
            nn.LSTMCell(embed + hidden if i == 0 else hidden, hidden,
                        generator=generator, device=device, dtype=dtype)
            for i in range(layers)])
        self.attention = nn.Linear(2 * hidden, hidden, bias_attr=False,
                                   generator=generator, device=device,
                                   dtype=dtype)
        self.memory = self.memory_bias = None

    def bind(self, memory, lengths):
        from paddle_tpu_torch.nn import functional as F

        mask = F.sequence_mask(lengths, memory.shape[1], dtype=memory.dtype)
        self.memory, self.memory_bias = memory, (mask - 1.0) * 1e9

    def forward(self, step_input, states):
        from paddle_tpu_torch.nn import functional as F

        x = torch.cat([step_input, states[-1]], -1)
        new = []
        for i, cell in enumerate(self.lstm_cells):
            x, (h, c) = cell(x, (states[2 * i], states[2 * i + 1]))
            new += [h, c]
        scores = torch.matmul(x.unsqueeze(1), self.memory.transpose(1, 2))
        attn = F.softmax(scores.squeeze(1) + self.memory_bias, axis=-1)
        context = torch.matmul(attn.unsqueeze(1), self.memory).squeeze(1)
        out = torch.tanh(self.attention(torch.cat([context, x], -1)))
        return out, new + [out]


class Seq2Seq(torch.nn.Module):
    """An attention encoder-decoder from the framework's public API: an
    ``LSTM`` encoder over the embedded source, the ``Seq2SeqCell``
    decoder driven by ``nn.RNN`` (teacher forcing) or by
    ``BeamSearchDecoder`` under ``dynamic_decode``, and an output
    ``Linear`` without bias. Every parameter is drawn again from
    ``initializer.Uniform(-init_scale, init_scale)`` with ``generator``.
    Called with ``labels`` it returns PaddleNLP's loss: the target
    positions' cross-entropy masked by ``sequence_mask``, summed and
    divided by the batch."""

    def __init__(self, src_vocab, tgt_vocab, embed, hidden, layers, *,
                 generator, device, dtype=torch.float32, init_scale=S2S_INIT):
        from paddle_tpu_torch import nn

        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.src_embedder = nn.Embedding(src_vocab, embed, **kw)
        self.encoder = nn.LSTM(embed, hidden, num_layers=layers, **kw)
        self.tgt_embedder = nn.Embedding(tgt_vocab, embed, **kw)
        self.decoder = nn.RNN(Seq2SeqCell(embed, hidden, layers, **kw))
        self.output_layer = nn.Linear(hidden, tgt_vocab, bias_attr=False,
                                      **kw)
        init = nn.initializer.Uniform(-init_scale, init_scale)
        for p in self.parameters():
            init(p, generator=generator)

    def encode(self, src):
        memory, (h, c) = self.encoder(self.src_embedder(src))
        states = [s for i in range(h.shape[0]) for s in (h[i], c[i])]
        return memory, states + [torch.zeros_like(h[0])]

    def forward(self, src, src_len, tgt_in, tgt_len=None, labels=None):
        from paddle_tpu_torch.nn import functional as F

        memory, states = self.encode(src)
        self.decoder.cell.bind(memory, src_len)
        out, _ = self.decoder(self.tgt_embedder(tgt_in), states)
        logits = self.output_layer(out)
        if labels is None:
            return logits
        mask = F.sequence_mask(tgt_len, labels.shape[1], dtype="float32")
        ce = F.cross_entropy(logits.float(), labels, reduction="none")
        return (ce.reshape(labels.shape) * mask).sum() / labels.shape[0]

    def beam_decoder(self, src, src_len, beam_size=S2S_BEAM):
        """The ``BeamSearchDecoder`` over the decoder's cell, its memory
        bound tiled to the beams, and the states to start from."""
        from paddle_tpu_torch import nn

        memory, states = self.encode(src)
        tile = nn.BeamSearchDecoder.tile_beam_merge_with_batch
        self.decoder.cell.bind(tile(memory, beam_size),
                               tile(src_len, beam_size))
        return nn.BeamSearchDecoder(
            self.decoder.cell, S2S_BOS, S2S_EOS, beam_size,
            embedding_fn=self.tgt_embedder,
            output_fn=self.output_layer), states

    def beam_search(self, src, src_len, beam_size=S2S_BEAM,
                    max_step_num=S2S_MAX_STEPS):
        """Beam search ids ``[batch, steps, beam]``, best first."""
        from paddle_tpu_torch import nn

        decoder, states = self.beam_decoder(src, src_len, beam_size)
        return nn.dynamic_decode(decoder, inits=states,
                                 max_step_num=max_step_num)[0]


def s2s_batch(seed, batch, device="cpu"):
    """``(src, src_len, tgt_in, tgt_len, labels)`` from ``seed``: lengths
    in S2S_LENS (row 0 at the longest), ids past the specials, 0 past each
    length; ``labels`` end on S2S_EOS and ``tgt_in`` is them shifted
    right behind S2S_BOS."""
    rng = np.random.RandomState(seed)
    lo, hi = S2S_LENS
    src_len, tgt_len = (rng.randint(lo, hi + 1, batch) for _ in range(2))
    src_len[0] = tgt_len[0] = hi
    pos = np.arange(hi)
    src = rng.randint(3, S2S["src_vocab"], (batch, hi))
    src = np.where(pos < src_len[:, None], src, 0)
    labels = rng.randint(3, S2S["tgt_vocab"], (batch, hi))
    labels[np.arange(batch), tgt_len - 1] = S2S_EOS
    labels = np.where(pos < tgt_len[:, None], labels, 0)
    tgt_in = np.concatenate([np.full((batch, 1), S2S_BOS), labels[:, :-1]],
                            1)
    return tuple(torch.from_numpy(a).long().to(device)
                 for a in (src, src_len, tgt_in, tgt_len, labels))


def on(device, tensors):
    return tuple(t.to(device) for t in tensors)


def s2s_model(seed, device, dtype=torch.float32):
    return Seq2Seq(**S2S, device=device, dtype=dtype,
                   generator=torch.Generator(device=device).manual_seed(seed))


def s2s_pair(seed):
    """The float32 seq2seq on the card from ``seed`` and a CPU copy
    holding the same weights."""
    card = s2s_model(seed, "cuda")
    cpu = Seq2Seq(**S2S, device="cpu", generator=torch.Generator())
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    return card, cpu


def s2s_train_once(model, batch, device, fault=None):
    """One ``Adam`` step with global-norm clipping through ``TrainStep``:
    the loss, every gradient and every update on the CPU. ``fault``
    plants one, as RESNET_FAULTS do."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import TrainStep

    model.zero_grad(set_to_none=True)
    params = dict(model.named_parameters())
    before = {n: p.detach().cpu().clone() for n, p in params.items()}
    kind, name = fault[:2] if fault else (None, None)
    hook = (params[name].register_hook(lambda g: g * fault[2])
            if kind == "scale" else None)
    opt = Adam(learning_rate=S2S_LR,
               parameters=[p for n, p in params.items()
                           if not (kind == "skip" and n == name)],
               grad_clip=nn.ClipGradByGlobalNorm(S2S_CLIP))
    loss = TrainStep(model, None, opt, labels_to_model=True,
                     device=device)(*batch)
    if hook is not None:
        hook.remove()
    return {"loss": float(loss),
            "gradients": {n: p.grad.cpu() for n, p in params.items()},
            "updates": {n: p.detach().cpu() - before[n]
                        for n, p in params.items()}}


def s2s_check_step(tag, card, ref):
    """The loss, S2S_GRADS and every update of the card's step against
    the CPU's; raises on the first out of its limit. Returns the numbers
    and the count of entries whose update noise may flip."""
    rows = {"loss": [card["loss"], ref["loss"]]}
    if not abs(card["loss"] - ref["loss"]) <= S2S_RTOL * abs(ref["loss"]):
        raise AssertionError("%s loss %r on the card, %r on the CPU"
                             % (tag, card["loss"], ref["loss"]))
    for n in S2S_GRADS:
        rows["grad " + n] = close_rel("%s gradient of %s" % (tag, n),
                                      card["gradients"][n],
                                      ref["gradients"][n], S2S_GRAD_RTOL)
    worst, noisy = 0.0, 0
    for n, want in ref["updates"].items():
        g = ref["gradients"][n].abs()
        firm = g > S2S_GRAD_RTOL * float(g.max())
        diff = (card["updates"][n] - want).abs()
        bad = diff[firm] > S2S_UPDATE_RTOL * S2S_LR
        if bool(bad.any()) or float(diff.max()) > 2 * S2S_LR * (1 + 1e-3):
            raise AssertionError(
                "%s update of %s: %d firm entries off by > %g, max %.3g"
                % (tag, n, int(bad.sum()), S2S_UPDATE_RTOL * S2S_LR,
                   float(diff.max())))
        if bool(firm.any()):
            worst = max(worst, float(diff[firm].max()))
        noisy += int((~firm & (diff > S2S_UPDATE_RTOL * S2S_LR)).sum())
    rows["updates"] = {"firm max abs diff": worst,
                       "noisy entries off": noisy,
                       "entries": sum(u.numel()
                                      for u in ref["updates"].values())}
    return rows


def s2s_forward_and_step(seed):
    """Phase 14(a)-(c): float32 logits and the masked loss at batch 4
    against the CPU copy; one Adam step held per tensor, the planted
    faults caught; beam search ids equal to the CPU's."""
    tag = "[seq2seq]"
    card, cpu = s2s_pair(seed)
    start = {k: v.clone() for k, v in card.state_dict().items()}
    batch = s2s_batch(seed + 1, S2S_CHECK_BATCH)
    rows = {}
    with torch.no_grad():
        (logits, loss), counts = no_port_launches(tag, lambda: (
            card(*on("cuda", batch[:3])), card(*on("cuda", batch))))
        rows["logits"] = close_rel(tag + " logits", logits.cpu(),
                                   cpu(*batch[:3]), S2S_RTOL)
        rows["loss"] = close_rel(tag + " loss", loss.cpu(), cpu(*batch),
                                 S2S_RTOL)
    got, step_counts = no_port_launches(
        tag, lambda: s2s_train_once(card, on("cuda", batch), None))
    ref = s2s_train_once(cpu, batch, "cpu")
    rows["step"] = s2s_check_step(tag, got, ref)
    caught = {}
    for fault in S2S_FAULTS:
        card.load_state_dict(start)
        faulty = s2s_train_once(card, on("cuda", batch), None, fault)
        try:
            s2s_check_step(tag, faulty, ref)
        except AssertionError as e:
            caught[" ".join(map(str, fault))] = str(e)
            continue
        raise AssertionError("%s the check passed a planted fault: %s"
                             % (tag, fault))
    rows["planted faults caught"] = caught
    card.load_state_dict(start)
    cpu.load_state_dict({k: v.cpu() for k, v in start.items()})
    with torch.no_grad():
        rows["beam"], beam_counts = no_port_launches(
            tag, lambda: s2s_beam_check(card, cpu, batch))
    log(tag + " " + json.dumps(rows))
    return {"seq2seq forward": counts, "seq2seq step": step_counts,
            "seq2seq beam": beam_counts}


def s2s_beam_check(card, cpu, batch):
    """The card's beam search ids against the CPU copy's; where they
    differ, both decoders are stepped again side by side to the first
    step whose tokens or parents differ, and the beams' scores there must
    agree within S2S_NEAR_TIE (a near-tie taken in the other order)."""
    src, src_len = batch[:2]
    want = cpu.beam_search(src, src_len)
    got = card.beam_search(src.cuda(), src_len.cuda()).cpu()
    row = {"steps": [int(got.shape[1]), int(want.shape[1])]}
    if torch.equal(got, want):
        return dict(row, equal=True)
    dc, sc = card.beam_decoder(src.cuda(), src_len.cuda())
    dp, sp = cpu.beam_decoder(src, src_len)
    (ic, sc, bc), (ip, sp, bp) = dc.initialize(sc), dp.initialize(sp)
    for t in range(S2S_MAX_STEPS):
        (tc, pc), ic, sc, bc = dc.step(t, ic, sc, bc)
        (tp, pp), ip, sp, bp = dp.step(t, ip, sp, bp)
        if not (torch.equal(tc.cpu(), tp) and torch.equal(pc.cpu(), pp)):
            gap = float((bc[0].cpu() - bp[0]).abs().max())
            if gap > S2S_NEAR_TIE:
                raise AssertionError(
                    "[seq2seq] beam step %d: tokens differ and the beams' "
                    "scores differ by %.3g" % (t, gap))
            return dict(row, equal=False, near_tie_step=t, score_gap=gap)
    raise AssertionError("[seq2seq] beam ids differ, every step agrees")


def rnn_pairs(seed):
    """(name, card module, CPU copy, input) for phase 14(d)."""
    from paddle_tpu_torch import nn

    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(8, 20, 64).astype(np.float32))
    makers = (
        ("GRU bidirect 2 layers", lambda **kw: nn.GRU(
            64, 128, num_layers=2, direction="bidirect", **kw), x),
        ("SimpleRNN relu bidirectional 2 layers time-major",
         lambda **kw: nn.SimpleRNN(64, 128, num_layers=2,
                                   direction="bidirectional",
                                   time_major=True, activation="relu",
                                   **kw), x.transpose(0, 1).contiguous()),
        ("LSTM 2 layers", lambda **kw: nn.LSTM(64, 128, num_layers=2, **kw),
         x))
    out = []
    for name, make, inp in makers:
        card = make(device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(seed))
        cpu = make(device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
        out.append((name, card, cpu, inp))
    return out


def rnn_run(model, x, device):
    """The output and the gradients of the input and every parameter of
    ``sum(out * w) + sum(h_n)`` (``w`` fixed from a seed)."""
    xt = x.detach().clone().to(device).requires_grad_()
    out, states = model(xt)
    states = states if isinstance(states, tuple) else (states,)
    w = torch.from_numpy(np.random.RandomState(1).rand(
        *out.shape).astype(np.float32)).to(device)
    ((out * w).sum() + sum(s.sum() for s in states)).backward()
    return [out.detach().cpu(), xt.grad.cpu()] + [
        p.grad.cpu() for p in model.parameters()]


def phase_rnn(seed):
    """Phase 14(d): a bidirectional 2-layer GRU, SimpleRNN (relu,
    time-major) and a 2-layer LSTM on the card against the CPU, output and
    every gradient; a bf16 LSTMCell given no states computes in float32."""
    from paddle_tpu_torch import nn

    tag = "[rnn]"
    rows, counts = {}, None
    for name, card, cpu, x in rnn_pairs(seed):
        got, counts = no_port_launches(tag, lambda: rnn_run(card, x, "cuda"))
        want = rnn_run(cpu, x, "cpu")
        rows[name] = max(close_rel("%s %s %d" % (tag, name, i), g, w,
                                   RNN_RTOL)["max_abs_diff"]
                         / max(float(w.abs().max()), 1e-30)
                         for i, (g, w) in enumerate(zip(got, want)))
    card = nn.LSTMCell(64, 128, device="cuda", dtype=torch.bfloat16,
                       generator=torch.Generator(device="cuda").manual_seed(
                           seed))
    cpu = nn.LSTMCell(64, 128, device="cpu", dtype=torch.bfloat16)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    x = torch.from_numpy(np.random.RandomState(seed).randn(
        8, 64).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        h, (_, c) = card(x.cuda())
        want_h, (_, want_c) = cpu(x)
    if not h.dtype == c.dtype == want_h.dtype == torch.float32:
        raise AssertionError("%s bf16 LSTMCell without states gave %s, %s"
                             % (tag, h.dtype, c.dtype))
    rows["bf16 LSTMCell, float32 states"] = [
        close_rel(tag + " bf16 cell h", h.cpu(), want_h, RNN_BF16_RTOL),
        close_rel(tag + " bf16 cell c", c.cpu(), want_c, RNN_BF16_RTOL)]
    log(tag + " worst relative difference by layer " + json.dumps(rows))
    return counts


def common_cases(rng):
    """(name, call, numpy inputs, indices of the differentiated ones) for
    every functional of ``nn/functional/common.py`` and the manipulation
    ops, at a small size."""
    from paddle_tpu_torch.nn import functional as F

    def f(*shape, lo=-1.0, hi=1.0):
        return (lo + (hi - lo) * rng.rand(*shape)).astype(np.float32)

    img, ids = f(2, 3, 9, 10), rng.randint(0, 7, (3, 5))
    interp = [("interpolate %s %s" % (mode, size), [f(2, 3, 6, 7)], (0,),
               lambda a, mode=mode, size=size: F.interpolate(
                   a, size=size, mode=mode))
              for mode in ("nearest", "bilinear", "bicubic", "area")
              for size in ([11, 13], [3, 4])]
    return interp + [
        ("interpolate linear 1-D shrink", [f(2, 3, 17)], (0,),
         lambda a: F.interpolate(a, size=[6], mode="linear",
                                 data_format="NCL")),
        ("interpolate trilinear", [f(1, 2, 3, 4, 5)], (0,),
         lambda a: F.interpolate(a, size=[5, 2, 7], mode="trilinear",
                                 data_format="NCDHW")),
        ("interpolate bilinear align_corners NHWC", [f(2, 6, 7, 3)], (0,),
         lambda a: F.upsample(a, size=[9, 4], mode="bilinear",
                              align_corners=True, data_format="NHWC")),
        ("linear", [f(2, 3, 4), f(4, 5), f(5)], (0, 1, 2), F.linear),
        ("embedding", [ids, f(7, 4)], (1,),
         lambda i, w: F.embedding(i, w, padding_idx=2)),
        ("normalize", [f(3, 4, 5)], (0,),
         lambda a: F.normalize(a, p=3.0, axis=-1)),
        ("cosine_similarity", [f(3, 4, 5), f(3, 4, 5)], (0, 1),
         F.cosine_similarity),
        ("label_smooth", [f(3, 6, lo=0), f(1, 6, lo=0)], (0, 1),
         lambda a, p: F.label_smooth(a, p, 0.2)),
        ("pixel_shuffle", [f(2, 8, 3, 4)], (0,),
         lambda a: F.pixel_shuffle(a, 2)),
        ("pixel_unshuffle", [f(2, 6, 3, 2)], (0,),
         lambda a: F.pixel_unshuffle(a, 3, "NHWC")),
        ("bilinear", [f(4, 3), f(4, 5), f(6, 3, 5), f(6)], (0, 1, 2, 3),
         F.bilinear),
        ("grid_sample bilinear reflection", [img, f(2, 4, 7, 2) * 1.4],
         (0, 1), lambda a, g: F.grid_sample(
             a, g, padding_mode="reflection", align_corners=False)),
        ("grid_sample nearest border", [img, f(2, 4, 7, 2) * 1.4], (0,),
         lambda a, g: F.grid_sample(a, g, mode="nearest",
                                    padding_mode="border")),
        ("affine_grid", [f(2, 2, 3)], (0,),
         lambda t: F.affine_grid(t, (2, 3, 4, 5))),
        ("unfold", [img], (0,), lambda a: F.unfold(a, [2, 3], 2, [1, 0, 2, 1],
                                                   2)),
        ("fold", [f(2, 18, 16)], (0,),
         lambda a: F.fold(a, [6, 7], [2, 3], strides=2, paddings=1)),
        ("temporal_shift", [f(6, 8, 2, 3)], (0,),
         lambda a: F.temporal_shift(a, 3)),
        ("channel_shuffle", [f(2, 6, 2, 3)], (0,),
         lambda a: F.channel_shuffle(a, 3)),
        ("zeropad2d", [img], (0,), lambda a: F.zeropad2d(a, [1, 0, 2, 3])),
        ("pad reflect NHWC", [f(2, 4, 5, 3)], (0,),
         lambda a: F.pad(a, [2, 1, 3, 0], mode="reflect",
                         data_format="NHWC")),
        ("pad circular", [f(2, 3, 4, 5)], (0,),
         lambda a: F.pad(a, [6, 5, 1, 0], mode="circular")),
        ("diag_embed", [f(2, 3, 4)], (0,),
         lambda a: F.diag_embed(a, 1, 0, 2)),
        ("one_hot", [np.array([[0, 3, -1, 7]])], (), lambda a: F.one_hot(a, 5)),
        ("sequence_mask", [np.array([[3, 0, 5], [1, 4, 2]])], (),
         F.sequence_mask),
    ]


def common_run(arrays, diff, call, device):
    ts = [torch.tensor(a, device=device, requires_grad=i in diff)
          for i, a in enumerate(arrays)]
    out = call(*ts)
    if diff:
        w = torch.from_numpy(np.random.RandomState(2).rand(
            *out.shape).astype(np.float32)).to(device)
        (out * w).sum().backward()
    return out.detach().cpu(), [ts[i].grad.cpu() for i in diff]


def phase_common(seed):
    """Phase 14(e): every common functional and manipulation op on the
    card against the same call on the CPU, the value and each
    differentiated input's gradient; the dropouts by their law."""
    from paddle_tpu_torch.nn import functional as F

    tag = "[common]"
    worst, counts = {}, None
    for name, arrays, diff, call in common_cases(np.random.RandomState(seed)):
        (got, got_g), counts = no_port_launches(
            tag, lambda: common_run(arrays, diff, call, "cuda"))
        want, want_g = common_run(arrays, diff, call, "cpu")
        if not got.is_floating_point():
            if not torch.equal(got, want):
                raise AssertionError("%s %s differs" % (tag, name))
            worst[name] = 0.0
            continue
        errs = [close_rel("%s %s" % (tag, name), got, want, COMMON_RTOL)]
        errs += [close_rel("%s %s grad %d" % (tag, name, i), g, w,
                           COMMON_RTOL)
                 for i, g, w in zip(diff, got_g, want_g)]
        worst[name] = max(e["max_abs_diff"] / max(e["scale"], 1e-30)
                          for e in errs)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ones = torch.ones(64, 256, 2, 2, device="cuda")
    shares = {}
    for name, out in (
            ("dropout2d", F.dropout2d(ones, 0.3, generator=gen)),
            ("dropout3d", F.dropout3d(ones[..., None], 0.3, generator=gen)),
            ("alpha_dropout", F.alpha_dropout(ones, 0.3, generator=gen))):
        dropped = float((out < out.max()).float().mean())
        if abs(dropped - 0.3) > 0.02:
            raise AssertionError("%s %s dropped %.4f, not 0.3"
                                 % (tag, name, dropped))
        shares[name] = dropped
    log(tag + " %d functionals, worst relative difference %.3g (%s); "
        "dropped shares at p = 0.3 %s"
        % (len(worst), max(worst.values()), max(worst, key=worst.get),
           json.dumps(shares)))
    return counts


def resnet_one_value(seed):
    """Phase 14(f): resnet18 trains one Momentum step at batch 1 and
    32 x 32 on the card, its last stage normalising one value a channel:
    the loss and fc.bias's gradient against the CPU copy (every feature
    past that stage is its batch norms' bias, 0, as in the reference),
    and that stage's running variance decays to exactly 0.9 of its old
    value."""
    from paddle_tpu_torch.vision.models import resnet18

    tag = "[resnet18 batch 1]"
    model = resnet18(num_classes=10, generator=torch.Generator(
        device="cuda").manual_seed(seed))
    cpu = resnet18(num_classes=10, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.rand(1, 3, 32, 32).astype(np.float32) * 2 - 1)
    y = torch.tensor([3])
    got, counts = no_port_launches(
        tag, lambda: train_once(model, x.cuda(), y.cuda(), None))
    want = train_once(cpu, x, y, "cpu")
    rows = {"loss": [got["loss"], want["loss"]],
            "fc.bias grad": close_rel(
                tag + " fc.bias grad", got["gradients"]["fc.bias"],
                want["gradients"]["fc.bias"], S2S_GRAD_RTOL)}
    if not abs(got["loss"] - want["loss"]) <= S2S_RTOL * abs(want["loss"]):
        raise AssertionError("%s loss %r, CPU %r" % (tag, got["loss"],
                                                     want["loss"]))
    var = got["statistics"]["layer4.1.bn2._variance"]
    if not bool((var == torch.tensor(0.9, dtype=torch.float32).double())
                .all()):
        raise AssertionError("%s layer4.1.bn2._variance %s, not 0.9"
                             % (tag, var[:4].tolist()))
    log(tag + " " + json.dumps(rows))
    return counts


def device_busy(fn):
    """``fn()`` once under the profiler: the wall ms, the device's kernel
    ms, the kernel launches and the four kernels with the most time
    (name, launches, ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evts = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    return {"wall_ms": wall,
            "device_ms": sum(e.self_device_time_total for e in evts) / 1e3,
            "kernels": sum(e.count for e in evts),
            "top": [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                    for e in evts[:4]]}


def s2s_bench_row(seed, dtype, card):
    """Phase 14(g) for one dtype at batch 128, 50 positions, on a new
    model: beam search first (one warm-up, S2S_TIMED_DECODES timed; a
    trained model soon emits S2S_EOS everywhere and finishes early), then
    the train step (one warm-up, S2S_TIMED_STEPS timed, each ended by a
    synchronize), the peak memory over both, and one profiled decode and
    step."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import TrainStep

    model = s2s_model(seed, "cuda", dtype)
    batch = s2s_batch(seed + 3, S2S_BATCH, "cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        ids = model.beam_search(*batch[:2])
        decodes = []
        for _ in range(S2S_TIMED_DECODES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids = model.beam_search(*batch[:2])
            torch.cuda.synchronize()
            decodes.append(time.perf_counter() - t0)
        profiled_decode = device_busy(lambda: model.beam_search(*batch[:2]))
    decode_s, steps = statistics.median(decodes), int(ids.shape[1])
    opt = Adam(learning_rate=S2S_LR, parameters=model.parameters(),
               grad_clip=nn.ClipGradByGlobalNorm(S2S_CLIP))
    step = TrainStep(model, None, opt, labels_to_model=True)
    losses, walls = [float(step(*batch))], []
    for _ in range(S2S_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(*batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError("[seq2seq bench] losses %s" % losses)
    step_s = statistics.median(walls)
    peak = torch.cuda.max_memory_allocated() / 1e9
    profiled_step = device_busy(lambda: step(*batch))
    return dict(
        dtype=str(dtype).replace("torch.", ""), card=card,
        batch=S2S_BATCH, positions=int(batch[0].shape[1]),
        target_tokens=int(batch[3].sum()), losses=losses,
        train_step_ms=step_s * 1e3, train_step_ms_all=[w * 1e3 for w in walls],
        target_tokens_per_s=int(batch[3].sum()) / step_s,
        decode_steps=steps, decode_ms=decode_s * 1e3,
        decode_ms_all=[d * 1e3 for d in decodes],
        decode_ms_per_step=decode_s * 1e3 / steps,
        sentences_per_s=S2S_BATCH / decode_s, peak_memory_gb=peak,
        profiled_step=profiled_step, profiled_decode=profiled_decode)


def lstm_yardstick(seed):
    """The port's 2-layer LSTM at the encoder's shape (128 x 50 x 512)
    against torch's fused LSTM (``torch.nn.LSTM``: ``_VF.lstm`` on cuDNN,
    TF32 off, its weights in one flattened buffer) holding the same
    weights under the same names: the outputs agree within RNN_RTOL;
    forward, and forward plus backward, timed by CUDA events."""
    from paddle_tpu_torch import nn

    gen = torch.Generator(device="cuda").manual_seed(seed)
    lstm = nn.LSTM(512, 512, num_layers=2, generator=gen, device="cuda")
    fused = torch.nn.LSTM(512, 512, num_layers=2, batch_first=True,
                          device="cuda")
    fused.load_state_dict(lstm.state_dict())
    x = torch.randn(S2S_BATCH, S2S_LENS[1], 512, device="cuda", generator=gen)

    def port():
        return lstm(x)[0]

    def cudnn():
        return fused(x)[0]

    with torch.no_grad():
        row = {"outputs": close_rel("[lstm yardstick] outputs", port(),
                                    cudnn(), RNN_RTOL)}
    for name, fn in (("port", port), ("cudnn", cudnn)):
        with torch.no_grad():
            row[name + "_fwd_ms"] = time_ms(fn, iters=3, reps=3)
        row[name + "_fwd_bwd_ms"] = time_ms(lambda: fn().sum().backward(),
                                            iters=3, reps=3)
    return row


def phase_seq2seq(seed, card):
    """Phase 14: the attention seq2seq and the rest of ``nn`` on the card.
    Returns (bench rows, launch counts by path, seconds)."""
    t_phase = time.perf_counter()
    paths = s2s_forward_and_step(seed)
    torch.cuda.empty_cache()
    paths["rnn"] = phase_rnn(seed)
    paths["common functionals"] = phase_common(seed)
    paths["resnet18 batch 1"] = resnet_one_value(seed)
    torch.cuda.empty_cache()
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        row, paths["seq2seq bench " + str(dtype)] = no_port_launches(
            "[seq2seq bench]", lambda: s2s_bench_row(seed, dtype, card))
        log("[seq2seq bench] " + json.dumps(row))
        rows.append(row)
        torch.cuda.empty_cache()
    yard = lstm_yardstick(seed)
    log("[lstm yardstick] " + json.dumps(yard))
    seconds = time.perf_counter() - t_phase
    log("[seq2seq] phase 14 in %.1f s" % seconds)
    return rows + [yard], paths, seconds


# -- phase 9 ----------------------------------------------------------------

# -- phase 15: mixed precision, checkpoints and the training front end ------

# (a) kernels 1-3 in float16 at llama1b's training attention and ERNIE's
FP16_FLASH_CASES = (dict(batch=8, n=1024, heads=16, head_dim=128, causal=True),
                    dict(batch=16, n=512, heads=12, head_dim=64,
                         causal=False))
# (a): dO ~ this x N(0, 1), clipped to float16's range, pushes dS = P (dP -
# delta) past float16's range in the causal first rows, where a few keys
# share a row's weight: the kernels must put inf and NaN where the plain
# versions do (nothing clamped: the signal GradScaler skips a step on)
FP16_OVERFLOW_DOUT = 1.5e4
AMP_STEPS = 3         # (b), (c): AdamW steps a run
AMP_LR = 1e-4
# (b), (c): the kernels against their plain versions on the card, O1 in
# the same dtype, the same steps, by dtype. The kernels round P and O at
# other points than the plain versions, and that moves through 16 layers.
# Sound readings on an H100 (paddle_tpu_torch/tools/amp_faults.py):
# losses 9.3e-6 / 2.6e-6 relative, sampled gradients 1.2e-2 / 1.4e-3 of
# their norm (bf16 / float16); the loss limits are ~4x those, the bf16
# gradient limit ~4x. At random weights the loss sits near ln(vocab)
# whatever attention returns, so the gradients carry the check: float16
# attention on inputs rounded to bf16's precision reads 4.9e-3 there, so
# float16's gradient limit sits between (2x the sound reading); the
# causal flag flipped reads ~1 in both dtypes.
AMP_LOSS_RTOL = {torch.bfloat16: 4e-5, torch.float16: 1e-5}
AMP_GRAD_RTOL = {torch.bfloat16: 5e-2, torch.float16: 3e-3}
AMP_GRADS = ("lm_head.weight", "llama.layers.0.self_attn.q_proj.weight",
             "llama.layers.15.mlp.down_proj.weight")
# (c): a loss scale that overflows float16 in the backward for certain
# (dlogits alone reach 2^40 / 8192 tokens), for the skipped-step check
OVERFLOW_SCALE = 2.0 ** 40
# (d): llama1b's width at one layer (the checkpoint, model and AdamW
# slots in float32, is ~2.2 GB), k steps, save, m more
CKPT_LAYERS, CKPT_K, CKPT_M = 1, 2, 2
# (e): ResNet-50 at the reference's chip row through Model.fit, O1 bf16
FIT_BATCH, FIT_STEPS, FIT_WORKERS = 64, 8, 4
FIT_LOSS_RTOL = 1e-3   # 4 workers against 0: the same batches; cuDNN's
#                        weight gradients may sum in another order


def imagenet_like(n, seed):
    """A synthetic ImageNet-shaped ``io.Dataset`` of ``n`` items: item i
    is a float32 [3, 224, 224] image and an int64 label in [0, 1000), both
    from ``seed + i``, in numpy only (forked DataLoader workers must not
    touch torch)."""
    from paddle_tpu_torch.io import Dataset

    class ImageNetLike(Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            rng = np.random.default_rng(seed + i)
            image = rng.standard_normal(IMAGE_SHAPE, dtype=np.float32)
            return image, np.int64(rng.integers(0, 1000))

    return ImageNetLike()


IMAGE_SHAPE = (3, 224, 224)


def flash_plain():
    """Swaps the flash kernels' wrappers for their plain versions (on any
    device) while active: the same steps through the plain path on the
    card. Returns the restore function."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    saved = fa.flash_attention, fa.flash_attention_backward
    fa.flash_attention = fa.flash_attention_reference
    fa.flash_attention_backward = fa.flash_attention_backward_reference

    def restore():
        fa.flash_attention, fa.flash_attention_backward = saved
    return restore


def amp_run(model, ids, labels, dtype, steps, scaler=None, probe=None,
            extra_scale=None):
    """The reference's eager AMP loop on ``model``: under
    ``auto_cast(dtype=dtype)`` the loss, then ``scaler.scale(loss)
    .backward()``, ``scaler.step(opt)``, ``opt.clear_grad()``. Returns the
    losses, the first step's sampled gradients (unscaled), the scaler's
    (scale, good, bad) after each step and the step times. ``probe(model)``
    registers dtype hooks for the first step."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate=AMP_LR, parameters=model.parameters())
    scaler = scaler or amp.GradScaler()
    params = dict(model.named_parameters())
    out = {"losses": [], "scaler": [], "skipped": [], "ms": []}
    for i in range(steps):
        handles = probe(model) if (probe and i == 0) else []
        t0 = time.perf_counter()
        with amp.auto_cast(dtype=dtype):
            loss = model(ids, labels)
        for h in handles:
            h.remove()
        scaler.scale(loss).backward()
        before = {n: params[n].detach().clone() for n in AMP_GRADS}
        scaler.step(opt)
        if i == 0:
            out["grads"] = {n: params[n].grad.float().clone()
                            for n in AMP_GRADS}
        if scaler._found_inf and not all(
                torch.equal(before[n], params[n]) for n in AMP_GRADS):
            raise AssertionError("a skipped step moved the parameters")
        opt.clear_grad()
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(loss.item())
        out["skipped"].append(scaler._found_inf)
        sd = scaler.state_dict()
        out["scaler"].append((sd["scale"], sd["good_steps"],
                              sd["bad_steps"]))
    return out


def cast_probe(seen):
    """Forward hooks recording the output dtypes at the cast points of
    llama's layer 0 and of the head."""
    def probe(model):
        layer = model.llama.layers[0]
        spots = {"linear (q_proj)": layer.self_attn.q_proj,
                 "linear (lm_head)": model.lm_head,
                 "rms_norm (input_layernorm)": layer.input_layernorm,
                 "rms_norm (final)": model.llama.norm}
        return [m.register_forward_hook(dtype_hook(seen, tag))
                for tag, m in spots.items()]
    return probe


def dtype_hook(seen, tag):
    """A forward hook noting its module's first output dtype in
    ``seen[tag]`` (returning None: the output stays as it is)."""
    def hook(module, inputs, output):
        seen.setdefault(tag, output.dtype)
    return hook


# kernel-name patterns of the groups a profiled step's device time is
# summed into (the first group a name matches; the rest is "other")
# (lower case; torch's dtype casts run as elementwise copy kernels)
STEP_GROUPS = (("flash", ("flash_",)),
               ("gemm", ("gemm", "gemv", "cutlass", "nvjet", "xmma")),
               ("cast/copy", ("copy",)), ("reduce", ("reduce",)),
               ("elementwise", ("elementwise",)))


def device_breakdown(fn):
    """``fn()`` once under the profiler: the wall ms, the device's kernel
    ms and their share of the wall, the launches, and the device ms by
    ``STEP_GROUPS``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups = dict.fromkeys([g for g, _ in STEP_GROUPS] + ["other"], 0.0)
    launches = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        launches += e.count
        name = e.key.lower()
        group = next((g for g, pats in STEP_GROUPS
                      if any(p in name for p in pats)), "other")
        groups[group] += e.self_device_time_total / 1e3
    device = sum(groups.values())
    return {"wall_ms": wall, "device_ms": device, "busy": device / wall,
            "kernels": launches, "groups_ms": groups}


def rel_norm(got, want):
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def amp_train(seed, dtype):
    """15(b) (bf16) or 15(c) (float16): llama1b in float32 under O1 with
    the default GradScaler, the kernels then their plain versions."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    name = "bfloat16" if dtype == torch.bfloat16 else "float16"
    tag = "[amp O1 %s]" % name
    cfg = LlamaConfig.llama1b_train(dtype="float32")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed + 15))
    plain_model = copy.deepcopy(model)
    rng = np.random.default_rng(seed + 15)
    ids, labels = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).cuda()
        for _ in range(2))
    seen = {}
    reset_launch_counters()
    torch.cuda.reset_peak_memory_stats()
    run = amp_run(model, ids, labels, name, AMP_STEPS,
                  probe=cast_probe(seen))
    launches = launch_counters()
    peak = torch.cuda.max_memory_allocated() / 1e9
    restore = flash_plain()
    try:
        plain = amp_run(plain_model, ids, labels, name, AMP_STEPS)
    finally:
        restore()
    del plain_model
    want_dtypes = {"linear (q_proj)": dtype, "linear (lm_head)": dtype,
                   "rms_norm (input_layernorm)": torch.float32,
                   "rms_norm (final)": torch.float32}
    if seen != want_dtypes:
        raise AssertionError("%s cast points %s, expected %s"
                             % (tag, seen, want_dtypes))
    layers = cfg.num_hidden_layers
    suffix = "" if dtype == torch.bfloat16 else "_fp16"
    want = dict.fromkeys(launches, 0)
    want.update({"flash_attention" + suffix: 2 * layers * AMP_STEPS,
                 "flash_attention_bwd_dq" + suffix: layers * AMP_STEPS,
                 "flash_attention_bwd_dkv" + suffix: layers * AMP_STEPS})
    if launches != want:
        raise AssertionError("%s launches %s, expected %s"
                             % (tag, launches, want))
    if not all(math.isfinite(x) for x in run["losses"]):
        raise AssertionError("%s non-finite loss %s" % (tag, run["losses"]))
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(run["losses"], plain["losses"]))
    # a skipped first step leaves non-finite gradients on both sides
    grad_err = {} if run["skipped"][0] else {
        n: rel_norm(run["grads"][n], plain["grads"][n]) for n in AMP_GRADS}
    if not all(map(math.isfinite, grad_err.values())):
        raise AssertionError("%s non-finite gradients %s" % (tag, grad_err))
    if run["scaler"] != plain["scaler"] or run["skipped"] != plain["skipped"]:
        raise AssertionError("%s scaler sequence %s (skipped %s) differs from "
                             "the plain versions' %s (%s)" % (
                                 tag, run["scaler"], run["skipped"],
                                 plain["scaler"], plain["skipped"]))
    if loss_err > AMP_LOSS_RTOL[dtype] or max(grad_err.values(),
                                              default=0.0) \
            > AMP_GRAD_RTOL[dtype]:
        raise AssertionError("%s kernels vs plain versions: losses %s vs %s "
                             "(rel %.3g > %g?), gradients %s (> %g?)" % (
                                 tag, run["losses"], plain["losses"],
                                 loss_err, AMP_LOSS_RTOL[dtype], grad_err,
                                 AMP_GRAD_RTOL[dtype]))
    result = {"losses": run["losses"], "plain_losses": plain["losses"],
              "loss_rel_err": loss_err, "grad_rel_err": grad_err,
              "scaler": run["scaler"], "skipped": run["skipped"],
              "step_ms": run["ms"], "plain_step_ms": plain["ms"],
              "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
              / statistics.median(run["ms"][1:]) * 1e3,
              "peak_mem_gb": peak, "cast_dtypes": {
                  k: str(v).split(".")[-1] for k, v in seen.items()},
              "launches": launches}
    if dtype == torch.float16:
        # one more step at a loss scale that overflows float16: skipped,
        # parameters untouched (amp_run checks), the scale kept (one bad
        # step of the two that lower it); its launches counted apart
        params = dict(model.named_parameters())
        before = {n: params[n].detach().clone() for n in AMP_GRADS}
        reset_launch_counters()
        over = amp_run(model, ids, labels, name, 1,
                       scaler=amp.GradScaler(init_loss_scaling=OVERFLOW_SCALE))
        over_launches = launch_counters()
        want_over = {k: v // AMP_STEPS for k, v in want.items()}
        if over["skipped"] != [True] or \
                over["scaler"] != [(OVERFLOW_SCALE, 0, 1)] or \
                not all(torch.equal(before[n], params[n]) for n in AMP_GRADS):
            raise AssertionError("%s overflow step %s" % (tag, over))
        if over_launches != want_over:
            raise AssertionError("%s overflow step launches %s, expected %s"
                                 % (tag, over_launches, want_over))
        result["overflow_step"] = {"scale": OVERFLOW_SCALE,
                                   "skipped": True, "scaler": over["scaler"],
                                   "launches": over_launches}
    # where a step's time goes: one more step, profiled
    result["profiled_step"] = device_breakdown(
        lambda: amp_run(model, ids, labels, name, 1))
    log("%s llama1b float32 under O1 (%d layers, %d x %d, AdamW %g, "
        "%.1f s): %s" % (tag, layers, TRAIN_BATCH, TRAIN_SEQ, AMP_LR,
                         time.perf_counter() - t0, json.dumps(result)))
    return result


def ckpt_run(seed, steps, resume_from=None, save_to=None, save_after=None):
    """15(d): a one-layer llama1b-width model under O1 float16 with AdamW
    on a warm-up schedule and a GradScaler, ``steps`` steps; with
    ``save_to``, model, optimizer (its scheduler inside) and scaler are
    saved after ``save_after`` steps; with ``resume_from``, fresh objects
    (other weights) load that state first. Returns the losses and the
    final parameters."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW, lr

    cfg = LlamaConfig.llama1b_train(num_hidden_layers=CKPT_LAYERS,
                                    dtype="float32")
    model = LlamaForCausalLM(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed + (1 if resume_from else 0)))
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, T_max=10),
                            warmup_steps=2, start_lr=1e-5, end_lr=1e-4)
    opt = AdamW(learning_rate=sched, parameters=model.parameters())
    scaler = amp.GradScaler()
    if resume_from:
        state = paddle.load(resume_from)
        model.load_state_dict(state["model"])
        opt.set_state_dict(state["opt"])
        scaler.load_state_dict(state["scaler"])
    rng = np.random.default_rng(seed + 16)
    batches = [tuple(torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).cuda()
        for _ in range(2)) for _ in range(CKPT_K + CKPT_M)]
    first = CKPT_K if resume_from else 0
    losses = []
    for i in range(first, first + steps):
        ids, labels = batches[i]
        with amp.auto_cast(dtype="float16"):
            loss = model(ids, labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        sched.step()
        losses.append(loss.item())
        if save_to and i + 1 == save_after:
            paddle.save({"model": model.state_dict(),
                         "opt": opt.state_dict(),
                         "scaler": scaler.state_dict()}, save_to)
    return losses, {n: p.detach().clone()
                    for n, p in model.named_parameters()}


def ckpt_resume(seed, tmp):
    """15(d): k steps, save, fresh objects, load, m steps, against two
    uninterrupted runs of k + m steps: bit for bit where those two agree
    bit for bit, else within their own gap."""
    tag = "[amp checkpoint]"
    t0 = time.perf_counter()
    path = os.path.join(tmp, "ckpt.pd")
    steps = CKPT_K + CKPT_M
    full_a, params_a = ckpt_run(seed, steps, save_to=path,
                                save_after=CKPT_K)
    size = os.path.getsize(path) / 1e9
    full_b, params_b = ckpt_run(seed, steps)
    resumed, params_r = ckpt_run(seed, CKPT_M, resume_from=path)
    os.remove(path)
    got = full_a[:CKPT_K] + resumed
    bitwise = full_a == full_b and all(
        torch.equal(params_a[n], params_b[n]) for n in params_a)
    if bitwise:
        ok = got == full_a and all(torch.equal(params_r[n], params_a[n])
                                   for n in params_a)
        gap = 0.0
    else:
        gap = max(float((params_a[n] - params_b[n]).abs().max())
                  for n in params_a)
        loss_gap = max(abs(a - b) for a, b in zip(full_a, full_b))
        ok = all(abs(a - b) <= loss_gap for a, b in zip(got, full_a)) and \
            all(float((params_r[n] - params_a[n]).abs().max()) <= gap
                for n in params_a)
    result = {"depth": CKPT_LAYERS, "k": CKPT_K, "m": CKPT_M,
              "checkpoint_gb": size, "uninterrupted": full_a,
              "uninterrupted_again": full_b, "resumed": got,
              "two_runs_bitwise": bitwise, "their_param_gap": gap}
    log("%s llama1b width at %d layer (a depth cut: the checkpoint is "
        "%.2f GB), O1 float16, %.1f s: %s" % (
            tag, CKPT_LAYERS, size, time.perf_counter() - t0,
            json.dumps(result)))
    if not ok:
        raise AssertionError("%s the resumed run differs from the "
                             "uninterrupted one" % tag)
    return result


def resnet_fit_run(seed, workers, tmp, probe=None):
    """15(e): ResNet-50 through Model.fit under O1 bf16 over a DataLoader
    (``workers`` processes, pinned memory) with ModelCheckpoint; returns
    the model, the per-step losses and the wall time."""
    from paddle_tpu_torch import amp, hapi
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    net = resnet50(num_classes=1000, generator=torch.Generator(
        device="cuda").manual_seed(seed + 17))
    model = hapi.Model(net).prepare(
        Momentum(learning_rate=0.1, momentum=0.9,
                 parameters=net.parameters()),
        CrossEntropyLoss(), Accuracy(topk=(1, 5)))
    loader = DataLoader(imagenet_like(FIT_BATCH * FIT_STEPS, seed),
                        batch_size=FIT_BATCH, shuffle=True,
                        num_workers=workers, pin_memory=True)
    losses, stamps = [], []

    class Record(hapi.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])   # read on the host: synced
            stamps.append(time.perf_counter())

    handles = probe(net) if probe else []
    np.random.seed(seed)   # the sampler's shuffle
    t0 = time.perf_counter()
    with amp.auto_cast():
        history = model.fit(loader, epochs=1, verbose=0, callbacks=[
            Record(), hapi.ModelCheckpoint(save_dir=tmp)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for h in handles:
        h.remove()
    # the steps after the first (its warm-up), ModelCheckpoint's saves
    # (each epoch's end and the train's) left out
    step_ms = statistics.median(
        (b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))
    return model, losses, history, wall, step_ms


def resnet_fit(seed, tmp):
    """15(e): ResNet-50 through Model.fit at batch 64, 224^2, NCHW, O1
    bf16, 4 forked workers with pinned memory, ModelCheckpoint, then
    evaluate, predict, Model.save / load and flops."""
    from paddle_tpu_torch import amp, flops, hapi
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    tag = "[amp resnet fit]"
    seen = {}

    def probe(net):
        return [m.register_forward_hook(dtype_hook(seen, t))
                for t, m in (("conv2d (conv1)", net.conv1),
                         ("batch_norm_train (bn1)", net.bn1),
                         ("linear (fc)", net.fc))]

    reset_launch_counters()
    model, losses, history, wall, step_ms = resnet_fit_run(
        seed, FIT_WORKERS, tmp, probe)
    launches = launch_counters()
    _, losses0, _, wall0, step_ms0 = resnet_fit_run(seed, 0, tmp)
    want_dtypes = {"conv2d (conv1)": torch.bfloat16,
                   "batch_norm_train (bn1)": torch.float32,
                   "linear (fc)": torch.bfloat16}
    if seen != want_dtypes:
        raise AssertionError("%s cast points %s, expected %s"
                             % (tag, seen, want_dtypes))
    if any(launches.values()):
        raise AssertionError("%s port kernels launched: %s" % (tag, launches))
    if len(losses) != FIT_STEPS or not all(map(math.isfinite, losses)) or \
            any(
                abs(a - b) > FIT_LOSS_RTOL * abs(b)
                for a, b in zip(losses, losses0)):
        raise AssertionError("%s losses with %d workers %s, with none %s"
                             % (tag, FIT_WORKERS, losses, losses0))
    saved = sorted(os.listdir(tmp))
    if saved != ["0.pdopt", "0.pdparams", "final.pdopt", "final.pdparams"]:
        raise AssertionError("%s ModelCheckpoint wrote %s" % (tag, saved))
    evalset = imagenet_like(2 * FIT_BATCH, seed + 1000)
    with amp.auto_cast():
        logs = model.evaluate(evalset, batch_size=FIT_BATCH, verbose=0)
        preds = model.predict(evalset, batch_size=FIT_BATCH,
                              stack_outputs=True)
    if preds[0].shape != (2 * FIT_BATCH, 1000) or \
            not np.isfinite(preds[0]).all() or \
            not math.isfinite(logs["loss"]):
        raise AssertionError("%s evaluate %s / predict %s" % (
            tag, logs, preds[0].shape))
    path = os.path.join(tmp, "resnet")
    model.save(path)
    net2 = resnet50(num_classes=1000, generator=torch.Generator(
        device="cuda").manual_seed(seed + 18))
    model2 = hapi.Model(net2).prepare(
        Momentum(learning_rate=0.1, momentum=0.9,
                 parameters=net2.parameters()),
        CrossEntropyLoss(), Accuracy(topk=(1, 5)))
    model2.load(path)
    state, state2 = model.network.state_dict(), net2.state_dict()
    if not all(torch.equal(state[k], state2[k]) for k in state):
        raise AssertionError("%s Model.load left other weights" % tag)
    with amp.auto_cast():
        again = model2.predict(evalset, batch_size=FIT_BATCH,
                               stack_outputs=True)
    if not np.array_equal(again[0], preds[0]):
        raise AssertionError("%s the loaded model predicts otherwise" % tag)
    count = flops(model.network, [1, 3, 224, 224])
    result = {"losses": losses, "losses_no_workers": losses0,
              "history": history, "eval": logs, "fit_s": wall,
              "fit_s_no_workers": wall0, "step_ms": step_ms,
              "step_ms_no_workers": step_ms0,
              "images_per_s": FIT_BATCH / step_ms * 1e3,
              "images_per_s_no_workers": FIT_BATCH / step_ms0 * 1e3,
              "checkpoint_files": saved, "flops": count,
              "cast_dtypes": {k: str(v).split(".")[-1]
                              for k, v in seen.items()}}
    log("%s ResNet-50, batch %d, 224^2, NCHW, O1 bf16, Momentum(0.1, 0.9), "
        "%d steps, %d workers, pinned: %s" % (
            tag, FIT_BATCH, FIT_STEPS, FIT_WORKERS, json.dumps(result)))
    log("%s flops(resnet50, [1, 3, 224, 224]) = %d (one multiply-add is "
        "one flop)" % (tag, count))
    return result


def fp16_overflow_case(gen, batch, n, heads, head_dim, causal):
    """15(a): kernels 2-3 in float16 against their plain versions where dS
    passes float16's range (dO scaled by ``FP16_OVERFLOW_DOUT``): inf and
    NaN in the same places of dq, dk and dv, the finite entries within the
    float16 backward tolerance."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    shape = (batch, n, heads, head_dim)
    q, k, v = (rand(*shape).half() for _ in range(3))
    dout = (rand(*shape) * FP16_OVERFLOW_DOUT).clamp(-6e4, 6e4).half()
    out, lse = fa.flash_attention(q, k, v, causal=causal)
    got = fa.flash_attention_backward(q, k, v, out, lse, dout, causal=causal)
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, dout,
                                                 causal=causal)
    name = "fp16 overflow flash B=%d N=%d H=%d D=%d %s, dO ~ %g N(0, 1)" % (
        batch, n, heads, head_dim, "causal" if causal else "non-causal",
        FP16_OVERFLOW_DOUT)
    row = {"case": name, "max_abs_err": {}}
    for part, x, y in zip(("dq", "dk", "dv"), got, want):
        for what, test in (("inf", torch.isinf), ("nan", torch.isnan)):
            mx, my = test(x), test(y)
            if not torch.equal(mx, my):
                raise AssertionError(
                    "%s %s: %s in %d places, the plain version's in %d, %d "
                    "apart" % (name, part, what, int(mx.sum()),
                               int(my.sum()), int((mx != my).sum())))
            row["%s_%s" % (part, what)] = int(my.sum())
        ok = torch.isfinite(y)
        row["max_abs_err"][part] = check_close(
            "%s %s (finite entries)" % (name, part), x[ok], y[ok],
            BWD_TOL[torch.float16])
    if not any(count for key, count in row.items()
               if key.endswith(("_inf", "_nan"))):
        raise AssertionError("%s: nothing overflowed" % name)
    log("[amp] %s: %s" % (name, json.dumps(row)))
    return row


def phase_amp(seed, ptxas):
    """Phase 15: (a) kernels 1-3 in float16 (and where dS overflows), (b)
    llama1b under O1 bf16, (c) under O1 float16 with dynamic loss
    scaling, (d) checkpoint and resume, (e) ResNet-50 through Model.fit.
    Returns the kernel rows, the paths' launch counts and the results."""
    import tempfile

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 15)
    rows = [encoder_flash_case(gen, dtype=torch.float16, tag="fp16", **case)
            for case in FP16_FLASH_CASES]
    overflow = fp16_overflow_case(gen, **FP16_FLASH_CASES[0])
    # the float16 kernels are the bf16 design with other operand types:
    # ptxas must give each the registers, stack and spills of its bf16 twin
    # (forward, dq and dk/dv at D = 64 and 128, and at D = 256 since PR 25)
    report = {r["kernel"]: [r.get(k) for k in ("registers", "stack",
                                               "spill_stores",
                                               "spill_loads")]
              for r in ptxas["flash_attention"] + ptxas["flash_attention_bwd"]}
    f16 = {k: v for k, v in report.items() if k.endswith(("<f16>", ", f16>"))}
    twins = {k: report.get(k[:-len("f16>")] + "bf16>") for k in f16}
    log("[amp] ptxas float16 kernels: %s" % json.dumps(f16))
    if len(f16) != 9 or any(f16[k] != twins[k] for k in f16):
        raise AssertionError("float16 kernels' ptxas %s differ from their "
                             "bf16 twins' %s" % (f16, twins))
    torch.cuda.empty_cache()
    results = {"overflow": overflow, "bf16": amp_train(seed, torch.bfloat16)}
    torch.cuda.empty_cache()
    results["fp16"] = amp_train(seed, torch.float16)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        results["checkpoint"] = ckpt_resume(seed, tmp)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        results["fit"] = resnet_fit(seed, tmp)
    log("[amp] phase 15 in %.1f s" % (time.perf_counter() - t0))
    paths = {"amp_bf16": results["bf16"]["launches"],
             "amp_fp16": results["fp16"]["launches"]}
    return rows, paths, results



# -- phase 16: the float16 model ---------------------------------------------

# (a) kernels 4-6 in float16 at llama1b's loss tail and at ERNIE's fused MLM
# tail (H = 768 + 128, V = 40000: a vocab the 256-column tiles do not
# divide), 1/8 of the labels ignored, each at three scales of the mean's
# 1 / (valid tokens): unscaled (every dl off the label column under half
# float16's smallest subnormal: zero), GradScaler's default 2^15, and 2^30
# (g ~ 1.5e5: dl at the label past 65504, -inf, so dh and dW take inf and
# NaN from it, while every other dl stays near 5 and dW's finite sums far
# below 65504). The kernels must put inf, NaN and (unscaled) dW's zeros
# where the plain versions do; finite entries within FCE_BWD_TOL. (At
# 2^40 every dW sum passes 65504 too, and which of the sums within an
# fp32 rounding of 65520 round to inf depends on the order of summation:
# 690 of 65.5M entries differed in a trial run on an H100.)
FP16_FCE_CASES = ((TRAIN_BATCH * TRAIN_SEQ, 2048, 32000), ENCODER_FCE_CASE)
FP16_FCE_SCALES = (("unscaled", 1.0), ("GradScaler default", 2.0 ** 15),
                   ("overflowing", 2.0 ** 30))
# (b): llama1b's training row in float16 (16 layers, recompute, 8 x 1024,
# AdamW, the default GradScaler, FLAGS_fused_lm_head_ce): the kernels
# against their plain versions on the card, the same 3 steps. Sound
# readings on an H100 (paddle_tpu_torch/tools/amp_faults.py --fp16-model):
# losses 1.4e-6 relative, sampled gradients 1.6e-3 / 2.6e-3 / 3.2e-3 of
# their norm, the rounding of 16 float16 layers (kernels and plain
# versions round P, O and the products at other points). The limits are
# ~7x and ~3x those, each backed by a fault planted in the fused CE
# kernels that it catches: a vocab tile summed twice into the lse (the
# loss), dW's last vocab chunk left unwritten (the gradients)
FP16_TRAIN_STEPS = 3
FP16_LOSS_RTOL = 1e-5
FP16_GRAD_RTOL = 1e-2
FP16_GRADS = ("lm_head.weight", "llama.layers.0.self_attn.q_proj.weight",
              "llama.layers.15.mlp.down_proj.weight")
# (c): llama1b in float16 behind serving.Engine, each run's greedy tokens
# against the same engine with every kernel swapped for its plain version
# on the card: equal, or first diverging where the plain run's top-2 gap
# is under FP16_NEAR_TIE x the row's max |logit| (a few float16 ulps: the
# plain paged versions round the probabilities to float16, the kernels
# keep them in fp32). Over int8 pages the two sides quantize K/V rows that
# already differ by an ulp, and one int8 rounding apart moves an element
# by max|row| / 127: there the limit is phase 10(b)'s 2^-4 (a trial run
# on an H100 diverged at a gap of 0.0127, 0.009 of the row's max, with
# int8 pages under prefix + chunked prefill)
FP16_NEAR_TIE = 2.0 ** -7
FP16_NEAR_TIE_INT8_KV = 2.0 ** -4
FP16_RUNS = (("flags off", dict()),
             ("prefix+chunked", dict(prefix=True, chunked=True)),
             ("int8 KV", dict(quant_kv=True)),
             ("int8 weights", dict(quant_weights=True)),
             # kernel 8 over int8 pages under float16 q
             ("prefix+chunked+int8 KV", dict(prefix=True, chunked=True,
                                             quant_kv=True)))
FP16_NEW_TOKENS = 8


def masks_equal(name, got, want, tests):
    """Each ``(what, test)`` mask of ``got`` must equal ``want``'s; returns
    the counts."""
    counts = {}
    for what, test in tests:
        mx, my = test(got), test(want)
        if not torch.equal(mx, my):
            raise AssertionError(
                "%s: %s in %d places, the plain version's in %d, %d apart"
                % (name, what, int(mx.sum()), int(my.sum()),
                   int((mx != my).sum())))
        counts[what] = int(my.sum())
    return counts


def fp16_fce_scales(gen, t_len, hid, vocab):
    """16(a): kernels 4-6 in float16 against their plain versions at
    ``FP16_FCE_SCALES`` (both sides given the kernels' lse): the loss and
    lse, then per scale the inf and NaN masks of dh and dW, dW's zero mask
    unscaled, and the finite entries."""
    from paddle_tpu_torch.kernels import fused_ce as fc

    h = torch.randn((t_len, hid), generator=gen, device="cuda").half()
    w = (torch.randn((hid, vocab), generator=gen, device="cuda")
         * math.sqrt(2.0 / (hid + vocab))).half()
    labels = torch.randint(0, vocab, (t_len,), generator=gen, device="cuda")
    labels[::8] = -100
    valid = labels != -100
    safe = torch.where(valid, labels, 0)
    loss, lse = fc.fused_lm_head_ce_forward(h, w, safe)
    want_loss, want_lse = fc.fused_lm_head_ce_forward_reference(h, w, safe)
    name = "fp16 fused_ce T=%d H=%d V=%d" % (t_len, hid, vocab)
    row = {"case": name, "scales": {},
           "loss_err": check_close(name + " loss", loss, want_loss,
                                   FCE_FWD_TOL),
           "lse_err": check_close(name + " lse", lse, want_lse, FCE_FWD_TOL)}
    n_valid = int(valid.sum())
    for tag, scale in FP16_FCE_SCALES:
        g_t = torch.where(valid, scale / n_valid, 0.0).float()
        got = fc.fused_lm_head_ce_backward(h, w, safe, lse, g_t)
        want = fc.fused_lm_head_ce_backward_reference(h, w, safe, lse, g_t)
        torch.cuda.synchronize()
        sub = {"g": scale / n_valid}
        for part, x, y in zip(("dh", "dw"), got, want):
            tests = [("inf", torch.isinf), ("nan", torch.isnan),
                     ("zero", lambda z: z == 0)]
            if part == "dh" or scale != 1.0:
                tests = tests[:2]
            case = "%s %s %s" % (name, tag, part)
            sub[part] = masks_equal(case, x, y, tests)
            ok = torch.isfinite(y)
            sub[part]["max_abs_err"] = check_close(
                case + " (finite entries)", x[ok], y[ok],
                FCE_BWD_TOL[torch.float16]) if bool(ok.any()) else 0.0
        if scale == FP16_FCE_SCALES[2][1] and not (sub["dh"]["inf"]
                                                   + sub["dh"]["nan"]):
            raise AssertionError("%s %s: nothing overflowed" % (name, tag))
        if scale == 1.0 and not sub["dw"]["zero"]:
            raise AssertionError("%s %s: nothing underflowed" % (name, tag))
        row["scales"][tag] = sub
        del got, want
    log("[fp16 model] " + json.dumps(row))
    return row


def fp16_kernels(seed):
    """16(a): kernels 4-6, 7, 8 and 10 in float16 against their plain
    versions at their table rows' shapes, twice bit for bit, timed."""
    from paddle_tpu_torch.kernels import quant

    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    f16 = torch.float16
    t0 = time.perf_counter()
    rows = {"fused_ce_fp16": [fused_ce_case(gen, *FP16_FCE_CASES[0], f16,
                                            timed=True, profiled=True)]}
    rows["fused_ce_fp16_scales"] = [fp16_fce_scales(gen, *case)
                                    for case in FP16_FCE_CASES]
    torch.cuda.empty_cache()
    rows["paged_attention_fp16"] = [
        paged_case(gen, PAGED_LENS, 16, 16, f16, timed=True, bitwise=True),
        paged_case(gen, PAGED_LENS, 16, 4, f16)]
    rows["paged_attention_int8_fp16"] = [
        paged_case(gen, PAGED_LENS, 16, 16, f16, timed=True, int8=True,
                   bitwise=True)]
    rows["mixed_paged_attention_fp16"] = [
        mixed_case(gen, dtype=f16, timed=True, bitwise=True, **MIXED_STEP),
        mixed_case(gen, dtype=f16, timed=True, bitwise=True,
                   **SUFFIX_PREFILL),
        mixed_case(gen, dtype=f16, **MIXED_GQA)]
    rows["mixed_paged_attention_int8_fp16"] = [
        mixed_case(gen, dtype=f16, timed=True, int8=True, bitwise=True,
                   **MIXED_STEP),
        mixed_case(gen, dtype=f16, timed=True, int8=True, **SUFFIX_PREFILL)]
    # kernel 10's float16 mode at one llama1b layer's 7 projections
    # (W8_SHAPES; weights of the projections' scale), M = 16 and 256
    w8 = []
    with torch.no_grad():
        for k, n, count, name in W8_SHAPES:
            if not count:
                continue
            w = (torch.randn(k, n, generator=gen, device="cuda")
                 * 0.02).half()
            q, scales = quant.quantize_int8_weight(w)
            for m in W8_TIMED_MS:
                x = torch.randn(m, k, generator=gen, device="cuda").half()
                w8.append(w8_bf16_case(
                    x, q, scales, "%s M=%d K=%d N=%d b=%d fp16" % (
                        name, m, k, n, quant.weight_block(k)), timed=True))
    rows["int8_weight_matmul_fp16"] = w8
    log("[fp16 model] (a) kernels in %.1f s" % (time.perf_counter() - t0))
    torch.cuda.empty_cache()
    return rows


def plain_kernels():
    """Swaps every kernel wrapper of the float16 model's paths (kernels
    1-8 and 10) for its plain version, on any device, while active: the
    same steps or requests through the plain path on the card. Returns the
    restore function."""
    from paddle_tpu_torch.kernels import fused_ce as fc
    from paddle_tpu_torch.nn.layers import common
    from paddle_tpu_torch.serving import kv_cache
    from paddle_tpu_torch.serving.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels import quant

    restore_flash = flash_plain()
    saved = (fc.fused_lm_head_ce_forward, fc.fused_lm_head_ce_backward,
             kv_cache.paged_attention, kv_cache.mixed_paged_attention,
             common.int8_weight_matmul)
    fc.fused_lm_head_ce_forward = fc.fused_lm_head_ce_forward_reference
    fc.fused_lm_head_ce_backward = \
        lambda *a, **kw: fc.fused_lm_head_ce_backward_reference(*a[:5])
    kv_cache.paged_attention = pa.paged_attention_reference
    kv_cache.mixed_paged_attention = pa.mixed_paged_attention_reference
    common.int8_weight_matmul = quant.int8_weight_matmul_reference

    def restore():
        restore_flash()
        (fc.fused_lm_head_ce_forward, fc.fused_lm_head_ce_backward,
         kv_cache.paged_attention, kv_cache.mixed_paged_attention,
         common.int8_weight_matmul) = saved
    return restore


def fp16_counters():
    """The float16 launch counters of kernels 1-8 and 10, by summary
    entry, beside every other counter (``launch_counters``)."""
    from paddle_tpu_torch.kernels import fused_ce as fc

    return dict(launch_counters(), fused_ce_fwd=fc.fwd_launches,
                fused_ce_dh=fc.dh_launches, fused_ce_dw=fc.dw_launches,
                fused_ce_fwd_fp16=fc.f16_fwd_launches,
                fused_ce_dh_fp16=fc.f16_dh_launches,
                fused_ce_dw_fp16=fc.f16_dw_launches)


def reset_fp16_counters():
    from paddle_tpu_torch.kernels import fused_ce as fc

    reset_launch_counters()
    fc.fwd_launches = fc.dh_launches = fc.dw_launches = 0
    fc.f16_fwd_launches = fc.f16_dh_launches = fc.f16_dw_launches = 0


def fp16_train_run(model, ids, labels, steps, scaler=None):
    """The float16 model's eager loop with the fused tail
    (FLAGS_fused_lm_head_ce on, the loss computed inside the model):
    ``scaler.scale(loss).backward()``, ``scaler.step(opt)``,
    ``opt.clear_grad()``. Returns the losses, the first step's sampled
    gradients (unscaled), the scaler's (scale, good, bad) after each step,
    the skipped steps and the step times."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate=AMP_LR, parameters=model.parameters())
    scaler = scaler or amp.GradScaler()
    params = dict(model.named_parameters())
    out = {"losses": [], "scaler": [], "skipped": [], "ms": []}
    flags.set_flags({"FLAGS_fused_lm_head_ce": True})
    try:
        for i in range(steps):
            t0 = time.perf_counter()
            loss = model(ids, labels)
            scaler.scale(loss).backward()
            before = {n: params[n].detach().clone() for n in FP16_GRADS}
            scaler.step(opt)
            if i == 0:
                out["grads"] = {n: params[n].grad.float().clone()
                                for n in FP16_GRADS}
            if scaler._found_inf and not all(
                    torch.equal(before[n], params[n]) for n in FP16_GRADS):
                raise AssertionError("a skipped step moved the parameters")
            opt.clear_grad()
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["losses"].append(loss.item())
            out["skipped"].append(scaler._found_inf)
            sd = scaler.state_dict()
            out["scaler"].append((sd["scale"], sd["good_steps"],
                                  sd["bad_steps"]))
    finally:
        flags.set_flags({"FLAGS_fused_lm_head_ce": False})
    return out


def fp16_train(seed):
    """16(b): llama1b's training row in float16 with the fused tail, the
    default GradScaler and AdamW, 3 steps on the kernels then the same 3 on
    their plain versions; exact float16 launch counts of kernels 1-6; a
    step at OVERFLOW_SCALE skipped with the parameters untouched; then two
    steps through TrainStep(labels_to_model=True) without a scaler (the
    reference's compiled path)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    tag = "[fp16 model train]"
    cfg = LlamaConfig.llama1b_train(dtype="float16")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed + 16))
    plain_model = copy.deepcopy(model)
    rng = np.random.default_rng(seed + 16)
    ids, labels = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).cuda()
        for _ in range(2))
    labels[:, ::8] = -100       # ignored positions, as a padded batch has
    reset_fp16_counters()
    torch.cuda.reset_peak_memory_stats()
    run = fp16_train_run(model, ids, labels, FP16_TRAIN_STEPS)
    launches = fp16_counters()
    peak = torch.cuda.max_memory_allocated() / 1e9
    restore = plain_kernels()
    try:
        plain = fp16_train_run(plain_model, ids, labels, FP16_TRAIN_STEPS)
    finally:
        restore()
    del plain_model
    layers, steps = cfg.num_hidden_layers, FP16_TRAIN_STEPS
    want = dict.fromkeys(launches, 0)
    want.update({"flash_attention_fp16": 2 * layers * steps,
                 "flash_attention_bwd_dq_fp16": layers * steps,
                 "flash_attention_bwd_dkv_fp16": layers * steps,
                 "fused_ce_fwd_fp16": steps, "fused_ce_dh_fp16": steps,
                 "fused_ce_dw_fp16": steps})
    if launches != want:
        raise AssertionError("%s launches %s, expected %s"
                             % (tag, launches, want))
    if not all(math.isfinite(x) for x in run["losses"]):
        raise AssertionError("%s non-finite loss %s" % (tag, run["losses"]))
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(run["losses"], plain["losses"]))
    grad_err = {} if run["skipped"][0] else {
        n: rel_norm(run["grads"][n], plain["grads"][n]) for n in FP16_GRADS}
    if not all(map(math.isfinite, grad_err.values())):
        raise AssertionError("%s non-finite gradients %s" % (tag, grad_err))
    if run["scaler"] != plain["scaler"] or run["skipped"] != plain["skipped"]:
        raise AssertionError("%s scaler sequence %s (skipped %s) differs from "
                             "the plain versions' %s (%s)" % (
                                 tag, run["scaler"], run["skipped"],
                                 plain["scaler"], plain["skipped"]))
    if loss_err > FP16_LOSS_RTOL or max(grad_err.values(), default=0.0) \
            > FP16_GRAD_RTOL:
        raise AssertionError("%s kernels vs plain versions: losses %s vs %s "
                             "(rel %.3g > %g?), gradients %s (> %g?)" % (
                                 tag, run["losses"], plain["losses"],
                                 loss_err, FP16_LOSS_RTOL, grad_err,
                                 FP16_GRAD_RTOL))
    result = {"losses": run["losses"], "plain_losses": plain["losses"],
              "loss_rel_err": loss_err, "grad_rel_err": grad_err,
              "scaler": run["scaler"], "skipped": run["skipped"],
              "step_ms": run["ms"], "plain_step_ms": plain["ms"],
              "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
              / statistics.median(run["ms"][1:]) * 1e3,
              "peak_mem_gb": peak, "launches": launches}
    # a step at a loss scale that overflows float16: skipped, parameters
    # untouched (fp16_train_run checks), the scale kept (one bad step of
    # the two that lower it); its launches counted apart
    params = dict(model.named_parameters())
    before = {n: params[n].detach().clone() for n in FP16_GRADS}
    reset_fp16_counters()
    over = fp16_train_run(model, ids, labels, 1, scaler=amp.GradScaler(
        init_loss_scaling=OVERFLOW_SCALE))
    over_launches = fp16_counters()
    want_over = {k: v // steps for k, v in want.items()}
    if over["skipped"] != [True] or \
            over["scaler"] != [(OVERFLOW_SCALE, 0, 1)] or \
            not all(torch.equal(before[n], params[n]) for n in FP16_GRADS):
        raise AssertionError("%s overflow step %s" % (tag, over))
    if over_launches != want_over:
        raise AssertionError("%s overflow step launches %s, expected %s"
                             % (tag, over_launches, want_over))
    result["overflow_step"] = {"scale": OVERFLOW_SCALE, "skipped": True,
                               "scaler": over["scaler"],
                               "launches": over_launches}
    # the reference's compiled path: TrainStep with the loss inside the
    # model (fused_ce_applies), no scaler
    step = TrainStep(model, None, AdamW(learning_rate=AMP_LR,
                                        parameters=model.parameters()),
                     labels_to_model=True)
    flags.set_flags({"FLAGS_fused_lm_head_ce": True})
    reset_fp16_counters()
    try:
        losses = [step(ids, labels).item() for _ in range(2)]
    finally:
        flags.set_flags({"FLAGS_fused_lm_head_ce": False})
    ts_launches = fp16_counters()
    want_ts = {k: v * 2 // steps for k, v in want.items()}
    if ts_launches != want_ts or not all(map(math.isfinite, losses)):
        raise AssertionError("%s TrainStep: losses %s, launches %s, "
                             "expected %s" % (tag, losses, ts_launches,
                                              want_ts))
    result["train_step"] = {"losses": losses, "launches": ts_launches}
    log("%s llama1b float16 (%d layers, %d x %d, recompute, fused tail, "
        "AdamW %g, %.1f s): %s" % (tag, layers, TRAIN_BATCH, TRAIN_SEQ,
                                   AMP_LR, time.perf_counter() - t0,
                                   json.dumps(result)))
    del model, step
    torch.cuda.empty_cache()
    return result


def fp16_serve(model, prompts, opts):
    """Serve the first prompts, then the second (prefix-cache hits) through
    an Engine on the card with ``opts``' flags; returns the tokens and the
    engine's stats."""
    first, second = prompts
    engine = bf16_engine(model, None, **opts)
    ids = [engine.add_request(p, max_new_tokens=FP16_NEW_TOKENS)
           for p in first]
    engine.run()
    ids += [engine.add_request(p, max_new_tokens=FP16_NEW_TOKENS)
            for p in second]
    engine.run()
    out = [engine.output(i) for i in ids], engine.stats()
    del engine
    return out


def fp16_near_tie(tag, model, prompt, want, got, rel=FP16_NEAR_TIE):
    """True when equal; else the first divergence must sit where the plain
    run's top-2 logit gap (a dense forward on the card through the plain
    versions) is under ``rel`` x the row's max |logit|."""
    if got == want:
        return True
    i = next((j for j, (a, b) in enumerate(zip(want, got)) if a != b),
             min(len(want), len(got)))
    restore = plain_kernels()
    try:
        with torch.no_grad():
            logits = model(torch.tensor([prompt + want[:i]],
                                        device="cuda"))[0, -1].float()
    finally:
        restore()
    top2 = logits.topk(2).values
    gap = float(top2[0] - top2[1])
    limit = rel * float(logits.abs().max())
    log("%s first divergence at token %d, top-2 logit gap %.4g (limit %.4g)"
        % (tag, i, gap, limit))
    if gap >= limit:
        raise AssertionError("%s diverges at token %d with a top-2 gap of "
                             "%.4g (>= %.4g): not a near-tie"
                             % (tag, i, gap, limit))
    return False


def fp16_launch_want(opts, st, layers):
    """The exact float16 launches of a serving run: kernel 1 per prefill
    and layer (none with chunked prefill), kernel 7 per decode step and
    layer, kernel 8 per mixed step and layer, kernel 10's float16 mode 7
    times per layer and decode or mixed step (int8 weights, which count in
    both of its counters); int8 pools take the int8 entries."""
    mode = "_int8" if opts.get("quant_kv") else ""
    want = dict.fromkeys(fp16_counters(), 0)
    if opts.get("chunked"):
        want["mixed_paged_attention%s_fp16" % mode] = \
            layers * st["mixed_steps"]
    else:
        want["flash_attention_fp16"] = layers * st["prefill_runs"]
        want["paged_attention%s_fp16" % mode] = layers * st["decode_steps"]
    if opts.get("quant_weights"):
        want["int8_weight_matmul"] = want["int8_weight_matmul_fp16"] = \
            7 * layers * (st["decode_steps"] + st["mixed_steps"])
    return want


def fp16_serving(seed):
    """16(c): llama1b in float16 behind serving.Engine on the card with the
    flags off, prefix cache + chunked prefill, int8 KV, int8 weights, and
    prefix cache + chunked prefill over int8 pages;
    greedy tokens against the same engine on the plain versions; exact
    launch counts of kernels 1, 7, 8 and 10."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama1b(dtype="float16")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed + 17))
    fp16_serve(model, ([[1, 2, 3]], []), {})   # warm-up, unmeasured
    results, paths = {}, {}
    for tag, opts in FP16_RUNS:
        name = "[fp16 model serve %s]" % tag
        prompts = bf16_prompts(seed, cfg.vocab_size)
        flat = prompts[0] + prompts[1]
        reset_fp16_counters()
        t1 = time.perf_counter()
        tokens, st = fp16_serve(model, prompts, opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = fp16_counters()
        want = fp16_launch_want(opts, st, cfg.num_hidden_layers)
        if launches != want:
            raise AssertionError("%s launches %s, expected %s"
                                 % (name, launches, want))
        if opts.get("prefix") and not st["prefix_hit_tokens"] >= 240:
            raise AssertionError("%s expected a 240-token prefix hit: %s"
                                 % (name, st))
        restore = plain_kernels()
        try:
            plain_tokens, plain_st = fp16_serve(model, prompts, opts)
        finally:
            restore()
        rel = FP16_NEAR_TIE_INT8_KV if opts.get("quant_kv") else FP16_NEAR_TIE
        same = [fp16_near_tie(name + " kernels vs plain", model, p, w, g, rel)
                for p, w, g in zip(flat, plain_tokens, tokens)]
        results[tag] = {
            "wall_s": wall, "prompt_lens": [len(p) for p in flat],
            "identical": "%d of %d" % (sum(same), len(same)),
            "prefill_runs": st["prefill_runs"],
            "decode_steps": st["decode_steps"],
            "mixed_steps": st["mixed_steps"],
            "prefix_hit_tokens": st["prefix_hit_tokens"],
            "launches": launches}
        log(name + " " + json.dumps(results[tag]))
        paths["fp16 serving " + tag] = launches
    log("[fp16 model] (c) serving in %.1f s" % (time.perf_counter() - t0))
    del model
    torch.cuda.empty_cache()
    return results, paths


def phase_fp16_model(seed):
    """Phase 16: (a) kernels 4-8 and 10 in float16, (b) a float16 llama1b
    trained with the fused tail, (c) served with each tier-2 flag. Returns
    the kernel rows, the paths' launch counts and the results."""
    t0 = time.perf_counter()
    rows = fp16_kernels(seed)
    train = fp16_train(seed)
    serving, paths = fp16_serving(seed)
    paths["fp16 train"] = train["launches"]
    paths["fp16 train overflow step"] = train["overflow_step"]["launches"]
    paths["fp16 TrainStep"] = train["train_step"]["launches"]
    ran = {k: sum(c[k] for c in paths.values())
           for k in FP16_MODEL_ENTRIES + ("flash_attention_fp16",
                                          "flash_attention_bwd_dq_fp16",
                                          "flash_attention_bwd_dkv_fp16")}
    if not all(ran.values()):
        raise AssertionError("[fp16 model] a kernel never ran in float16: %s"
                             % ran)
    log("[fp16 model] phase 16 in %.1f s" % (time.perf_counter() - t0))
    return rows, paths, {"train": train, "serving": serving}


# -- phase 17: the op layer and AMP O2 ----------------------------------------

# (a) every op of paddle_tpu_torch.ops (creation, math, reduction,
# comparison, manipulation, linalg, extras), tensor.attribute, the in-place
# forms and indexing, on the card against the same call on a CPU copy.
# Limits (rtol, atol) by family, float32 with TF32 off: sums and products
# in another order 1e-5 / 1e-6; transcendental functions (CUDA's and the
# CPU's libm differ by an ulp or two) 1e-4 / 1e-5; linear algebra
# (cuSOLVER / cuBLAS against LAPACK, well-conditioned inputs) 1e-4 / 1e-4;
# exact ("x") where an op only moves, compares or counts values. bfloat16
# and float16 (card against the CPU in the same dtype): a rounding or two
# of the largest value apart (a scan or a sum may round its partial sums
# in the narrow type on one side and in float32 on the other: a bf16
# cumsum read 0.0234 at partial sums ~6), 1e-2 / 2e-3 relative, and the
# same times max(1, max |CPU|) absolute.
OPS_TOLS = {"f": (1e-5, 1e-6), "t": (1e-4, 1e-5), "l": (1e-4, 1e-4)}
OPS_HALF_TOLS = {torch.bfloat16: (1e-2, 1e-2), torch.float16: (2e-3, 2e-3)}
OPS_HALF = (torch.bfloat16, torch.float16)
OPS_MODULES = ("creation", "math", "reduction", "comparison", "manipulation",
               "linalg", "extras")


def ops_inputs(seed):
    """The sweep's numpy inputs by marker (floats float32)."""
    rng = np.random.default_rng(seed + 17)

    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    m = rng.standard_normal((4, 4)).astype(np.float32)
    spd = m @ m.T + 4 * np.eye(4, dtype=np.float32)
    lu, piv = torch.linalg.lu_factor(torch.from_numpy(m))
    return {
        "LUM": lu.numpy(), "LUP": piv.to(torch.int32).numpy(),
        "X": u(-2, 2, 3, 4), "Y": u(-2, 2, 3, 4), "Z": u(-2, 2, 3, 4),
        "POS": u(0.2, 3, 3, 4), "UNIT": u(-0.9, 0.9, 3, 4),
        "GT1": u(1.1, 3, 3, 4), "P01": u(0.05, 0.95, 3, 4),
        "HALFUP": u(0.5, 2, 3, 4), "X3": u(-2, 2, 2, 3, 4),
        "X3P": u(0.5, 1.5, 2, 3, 4), "M44": u(-2, 2, 4, 4),
        "M34": u(-2, 2, 3, 4), "M43": u(-2, 2, 4, 3), "M45": u(-2, 2, 4, 5),
        "M35": u(-2, 2, 3, 5), "M53": u(-2, 2, 5, 3), "M52": u(-2, 2, 5, 2),
        "M42": u(-2, 2, 4, 2), "M23": u(-2, 2, 2, 3), "M32": u(-2, 2, 3, 2),
        "B234": u(-2, 2, 2, 3, 4), "B242": u(-2, 2, 2, 4, 2),
        "V3": u(-2, 2, 3), "V4": u(-2, 2, 4), "V12": u(-2, 2, 12),
        "V20": u(-2, 2, 20), "C43": u(-2, 2, 4, 3), "IMG": u(-2, 2, 1, 2, 5, 5),
        "SPD": spd, "SPD3": spd[:3, :3].copy(),
        "LOW": np.linalg.cholesky(spd[:3, :3]).astype(np.float32),
        "RANK2": np.outer(np.arange(4.0), np.ones(3)).astype(np.float32),
        "NANS": np.array([np.nan, np.inf, -np.inf, 1.5], np.float32),
        "NANROWS": np.array([[1.0, np.nan, 3.0, 2.0], [np.nan] * 4],
                            np.float32),
        "TIES": np.array([[1.0, 2.0, 2.0, 1.0], [3.0, 3.0, 0.0, 0.0]],
                         np.float32),
        "SEQ": np.array([1.0, 3.0, 5.0, 7.0], np.float32),
        "Q3": np.array([0.1, 0.5, 0.9], np.float32),
        "PROBS": np.array([[0.2, 0.3, 0.5], [0.6, 0.4, 0.0]], np.float32),
        "INT": rng.integers(1, 20, (3, 4)).astype(np.int32),
        "INT2": rng.integers(1, 20, (3, 4)).astype(np.int32),
        "SINT": rng.integers(-9, 9, (3, 4)).astype(np.int32),
        "BIN": rng.integers(0, 2, (3, 4)).astype(np.int32),
        "SMALL": rng.integers(0, 3, (3, 6)).astype(np.int32),
        "BOOL": rng.random((3, 4)) < 0.5, "BOOL2": rng.random((3, 4)) < 0.5,
        "IDX5": rng.integers(0, 4, 5).astype(np.int64),
        "IDX23": rng.integers(0, 3, (2, 3)).astype(np.int64),
        "IDXND": rng.integers(0, 2, (5, 2)).astype(np.int64),
        "IDX32": rng.integers(0, 4, (3, 2)).astype(np.int64),
        "ROWS": np.array([2, 0], np.int64),
        "ROWS2": np.array([[2], [0]], np.int64), "COL1": np.array(
            [[0], [2], [1]], np.int64),
        "ADDIDX": np.array([0, 2, 0], np.int64),
        "REP": np.array([1, 0, 2], np.int64), "IDS": rng.integers(
            0, 5, 12).astype(np.int64),
        "RUNS": np.array([1, 1, 2, 2, 2, 3, 1], np.int64),
        "TAKE": rng.integers(-12, 12, 5).astype(np.int64),
        "WIDE": rng.integers(-30, 30, 5).astype(np.int64),
        "SHARD": rng.integers(0, 20, (6, 1)).astype(np.int64),
        "MUX": np.array([[1], [0], [1]], np.int64),
        "EMPTY": np.zeros((0, 3), np.float32),
    }


def OP(path, *args, fam="x", half=False, **kw):
    """One sweep case: ``path`` (``module.name``) called with ``args``
    (markers of ``ops_inputs`` for arrays, lists of markers for lists of
    tensors, anything else as it is)."""
    return (path, args, kw, fam, half)


def ops_cases():
    cases = [
        # creation
        OP("creation.to_tensor", [[1, 2], [3, 4]]),
        OP("creation.to_tensor", "X"),
        OP("creation.zeros", [2, 3]), OP("creation.ones", [2, 3], "int32"),
        OP("creation.full", [2, 2], 3.5), OP("creation.empty", [2]),
        OP("creation.zeros_like", "X", half=True),
        OP("creation.ones_like", "X", "float16"),
        OP("creation.full_like", "X", 2.0), OP("creation.empty_like", "INT"),
        OP("creation.arange", 5), OP("creation.arange", 1.0, 3.0, 0.5),
        OP("creation.linspace", 0.0, 1.0, 5, fam="f"),
        OP("creation.logspace", 0.0, 2.0, 3, fam="t"),
        OP("creation.eye", 3, 4), OP("creation.diag", "V4"),
        OP("creation.diag", "M44", 1), OP("creation.diag", "V3", 0, 9.0),
        OP("creation.diagflat", "M23", 1),
        OP("creation.tril", "M44", -1, half=True),
        OP("creation.triu", "M44", 1, half=True),
        OP("creation.meshgrid", "V3", "V4"), OP("creation.assign", "X"),
        OP("creation.clone", "X", half=True), OP("creation.numel", "X"),
    ]
    unary = (("abs", "X", "x"), ("neg", "X", "x"), ("exp", "X", "t"),
             ("expm1", "X", "t"), ("log", "POS", "t"), ("log2", "POS", "t"),
             ("log10", "POS", "t"), ("log1p", "POS", "t"),
             ("sqrt", "POS", "t"), ("rsqrt", "POS", "t"),
             ("square", "X", "f"), ("sin", "X", "t"), ("cos", "X", "t"),
             ("tan", "UNIT", "t"), ("asin", "UNIT", "t"),
             ("acos", "UNIT", "t"), ("atan", "X", "t"), ("sinh", "X", "t"),
             ("cosh", "X", "t"), ("tanh", "X", "t"), ("asinh", "X", "t"),
             ("acosh", "GT1", "t"), ("atanh", "UNIT", "t"),
             ("floor", "X", "x"), ("ceil", "X", "x"), ("round", "X", "x"),
             ("round_", "X", "x"), ("trunc", "X", "x"), ("frac", "X", "f"),
             ("sign", "X", "x"), ("reciprocal", "POS", "f"),
             ("erf", "X", "t"), ("erfinv", "UNIT", "t"),
             ("lgamma", "POS", "t"), ("digamma", "POS", "t"),
             ("i0", "X", "t"), ("sigmoid", "X", "t"),
             ("rad2deg", "X", "f"), ("deg2rad", "X", "f"),
             ("angle", "X", "x"), ("conj", "X", "x"), ("real", "X", "x"),
             ("imag", "X", "x"), ("isnan", "NANS", "x"),
             ("isinf", "NANS", "x"), ("isfinite", "NANS", "x"),
             ("squared_l2_norm", "X", "f"))
    half_ok = {"abs", "neg", "exp", "log", "sqrt", "rsqrt", "square", "sin",
               "cos", "tanh", "floor", "ceil", "round", "sign",
               "reciprocal", "erf", "sigmoid", "isnan"}
    cases += [OP("math." + n, a, fam=f, half=n in half_ok)
              for n, a, f in unary]
    binary = (("add", "f"), ("subtract", "f"), ("multiply", "f"),
              ("divide", "f"), ("maximum", "x"), ("minimum", "x"),
              ("fmax", "x"), ("fmin", "x"), ("atan2", "t"),
              ("heaviside", "x"), ("nextafter", "x"), ("hypot", "t"),
              ("copysign", "x"), ("logaddexp", "t"), ("lerp", "f"))
    cases += [OP("math." + n, "X", "Y", *(() if n != "lerp" else (0.3,)),
                 fam=f, half=n in ("add", "subtract", "multiply", "divide",
                                   "maximum", "minimum"))
              for n, f in binary]
    cases += [
        OP("math.add", "X", 2.0, fam="f", half=True),
        OP("math.multiply", "INT", "INT2"), OP("math.divide", "INT", "INT2",
                                               fam="f"),
        OP("math.floor_divide", "X", "HALFUP"),
        OP("math.floor_divide", "SINT", "INT2"),
        OP("math.remainder", "X", "HALFUP", fam="f"),
        OP("math.mod", "SINT", "INT2"), OP("math.floor_mod", "SINT", "INT2"),
        OP("math.pow", "POS", "Y", fam="t"), OP("math.pow_", "X", 2,
                                                fam="f", half=True),
        OP("math.gcd", "INT", "INT2"), OP("math.lcm", "INT", "INT2"),
        OP("math.scale", "X", 2.0, 1.0, fam="f", half=True),
        OP("math.scale", "X", 2.0, 1.0, False, fam="f"),
        OP("math.clip", "X", -0.5, 0.5, half=True),
        OP("math.stanh", "X", fam="t"), OP("math.logit", "P01", fam="t"),
        OP("math.logit", "P01", 0.1, fam="t"),
        OP("math.multiply_add", "X", "Y", "Z", fam="f"),
        OP("math.addmm", "M35", "M34", "M45", 0.5, 2.0, fam="l"),
        OP("math.matmul", "M34", "M45", fam="l", half=True),
        OP("math.matmul", "B234", "B242", False, False, fam="l"),
        OP("math.dot", "M34", "Y", fam="l"), OP("math.mm", "M44", "M43",
                                                 fam="l"),
        OP("math.bmm", "B234", "B242", fam="l"),
        OP("math.mv", "M44", "V4", fam="l"),
        OP("math.inner", "M34", "X", fam="l"),
        OP("math.outer", "V3", "M23", fam="f"),
        OP("math.kron", "M23", "M32", fam="f"),
        OP("math.cross", "C43", "C43"), OP("math.trace", "M44", 1, fam="f"),
        OP("math.diagonal", "X3", 1, 1, 2),
        OP("math.cumsum", "X", fam="f", half=True),
        OP("math.cumsum", "INT", 0), OP("math.cumprod", "HALFUP", 1,
                                       fam="f"),
        OP("math.cummax_values", "X", 1), OP("math.cummin_values", "X", 0),
        OP("math.nan_to_num", "NANS"),
        OP("math.nan_to_num", "NANS", 1.0, 9.0, -9.0),
        OP("math.increment", "X", 2.0, fam="f"),
        OP("math.cast", "X", "int32"), OP("math.cast", "X", "float16"),
        OP("math.astype", "INT", "bool"),
        OP("math.logcumsumexp", "X", 1, fam="t"),
        OP("math.dist", "X", "Y", fam="f"),
        OP("math.dist", "X", "Y", float("inf")),
        OP("math.dist", "X", "Y", 1.5, fam="t"),
        OP("math.renorm", "X", 2.0, 0, 1.0, fam="t"),
        OP("math.mode", "SMALL", 1), OP("math.mode", "TIES", -1, True),
        OP("math.nanmedian", "NANROWS", 1, fam="f"),
        OP("math.clip_by_norm", "X", 1.0, fam="f"),
        OP("math.add_n", ["X", "Y", "Z"], fam="f"),
        OP("math.identity_loss", "X", "mean", fam="f"),
    ]
    for n in ("sum", "mean", "prod", "max", "min", "amax", "amin", "nansum",
              "nanmean", "logsumexp", "sum_", "max_", "min_"):
        fam = "t" if n == "logsumexp" else (
            "x" if n.rstrip("_") in ("max", "min", "amax", "amin") else "f")
        src = "X3P" if n == "prod" else "X3"
        cases += [OP("reduction." + n, src, fam=fam, half=n in ("sum",
                                                                 "mean",
                                                                 "max")),
                  OP("reduction." + n, src, [0, 2], True, fam=fam)]
    cases += [
        OP("reduction.sum", "INT"), OP("reduction.sum", "X", 1, False,
                                       "float16"),
        OP("reduction.all", "BOOL"), OP("reduction.all_", "INT", 1),
        OP("reduction.any", "BOOL", 0, True), OP("reduction.any_", "BIN"),
        OP("reduction.std", "M35", fam="f"),
        OP("reduction.var", "M35", [0, 1], False, fam="f"),
        OP("reduction.median", "M34", 1, fam="f"),
        OP("reduction.quantile", "M35", [0.1, 0.5, 0.9], 1, fam="f"),
        OP("reduction.argmax", "X", half=True),
        OP("reduction.argmax", "X", 1, True),
        OP("reduction.argmin", "X", 0, False, "int32"),
        OP("reduction.count_nonzero", "BIN", 1, True),
    ]
    cases += [OP("comparison." + n, "X", "Y", half=n == "less_than")
              for n in ("equal", "not_equal", "greater_than",
                        "greater_equal", "less_than", "less_equal")]
    cases += [OP("comparison." + n, "BOOL", "BOOL2")
              for n in ("logical_and", "logical_or", "logical_xor")]
    cases += [OP("comparison." + n, "INT", "INT2")
              for n in ("bitwise_and", "bitwise_or", "bitwise_xor")]
    cases += [
        OP("comparison.logical_not", "BOOL"),
        OP("comparison.bitwise_not", "SINT"),
        OP("comparison.isclose", "X", "Y", 1e-5, 2.0),
        OP("comparison.allclose", "X", "X"),
        OP("comparison.equal_all", "INT", "INT"),
        OP("comparison.is_empty", "EMPTY"),
        OP("comparison.in1d", "INT", "IDX5"),
        # manipulation
        OP("manipulation.reshape", "M34", [6, -1], half=True),
        OP("manipulation.transpose", "X3", [2, 0, 1], half=True),
        OP("manipulation.t", "M23"),
        OP("manipulation.concat", ["M23", "M23"], 0, half=True),
        OP("manipulation.stack", ["X", "Y"], 1),
        OP("manipulation.split", "M34", [1, -1, 2], 1),
        OP("manipulation.chunk", "M44", 2),
        OP("manipulation.unbind", "M23", 1),
        OP("manipulation.squeeze", "X3", 0),
        OP("manipulation.unsqueeze", "M23", [0, -1]),
        OP("manipulation.flatten", "X3", 1, 2),
        OP("manipulation.tile", "M23", [2, 1, 2]),
        OP("manipulation.expand", "V4", [3, -1]),
        OP("manipulation.expand_as", "V4", "X"),
        OP("manipulation.broadcast_to", "V4", [3, 4]),
        OP("manipulation.broadcast_tensors", ["V4", "X"]),
        OP("manipulation.flip", "X", [0, 1]),
        OP("manipulation.roll", "X", [1, -1], [0, 1]),
        OP("manipulation.rot90", "X", 1, [0, 1]),
        OP("manipulation.gather", "C43", "IDX5", half=True),
        OP("manipulation.index_select", "C43", "ROWS", 1),
        OP("manipulation.gather_nd", "X3", "IDXND"),
        OP("manipulation.take_along_axis", "X", "IDX32", 1),
        OP("manipulation.put_along_axis", "X", "COL1", 9.0, 1),
        OP("manipulation.put_along_axis", "X", "IDX32", "M32", 1, "add",
           fam="f"),
        OP("manipulation.scatter", "C43", "ROWS", "M23"),
        OP("manipulation.scatter_nd_add", "C43", "ROWS2", "M23", fam="f"),
        OP("manipulation.scatter_nd", "ROWS2", "M23", [5, 3]),
        OP("manipulation.where", "BOOL", "X", "Y", half=True),
        OP("manipulation.masked_fill", "X", "BOOL", -1.0, half=True),
        OP("manipulation.masked_select", "X", "BOOL"),
        OP("manipulation.nonzero", "BIN"),
        OP("manipulation.nonzero", "BIN", True),
        OP("manipulation.unique", "IDS", True, True, True),
        OP("manipulation.sort", "X", 1, half=True),
        OP("manipulation.sort", "X", 0, True),
        OP("manipulation.argsort", "SMALL", 1, True),
        OP("manipulation.topk", "X", 2), OP("manipulation.topk", "X", 2, 0,
                                            False),
        OP("manipulation.kthvalue", "SMALL", 2, 1),
        OP("manipulation.slice_", "X3", [0, 2], [1, -3], [3, 5]),
        OP("manipulation.strided_slice", "M45", [0, 1], [3, 4], [0, 0],
           [-2, -2]),
        OP("manipulation.pad", "M23", [1, 2, 0, 1]),
        OP("manipulation.repeat_interleave", "V3", "REP"),
        OP("manipulation.moveaxis", "X3", 0, 2),
        OP("manipulation.swapaxes", "X3", 0, 2),
        OP("manipulation.searchsorted", "SEQ", "X"),
        OP("manipulation.bucketize", "X", "SEQ", False, True),
        OP("manipulation.one_hot", "IDX5", 4),
        OP("manipulation.index_add", "C43", "ADDIDX", 0, "SPD3", fam="f"),
        OP("manipulation.index_put", "C43", ["ROWS", "ROWS"], 5.0),
        OP("manipulation.as_strided", "V12", [3, 2], [4, 1], 1),
        OP("manipulation.diff", "X", 2, 0, fam="f"),
        OP("manipulation.unfold", "IMG", [2, 3], [1, 2], [1, 0]),
        OP("manipulation.unstack", "M23", 1),
        OP("manipulation.reverse", "X", 0),
        OP("manipulation.fill", "X", 3.0),
        OP("manipulation.fill_diagonal", "M34", 7.0, 1),
        OP("manipulation.diag_embed", "M23", 1),
        OP("manipulation.multiplex", ["M32", "M32"], "MUX"),
        OP("manipulation.index_sample", "M35", "IDX32"),
        OP("manipulation.unique_consecutive", "RUNS", True, True),
        OP("manipulation.fill_diagonal_tensor", "M34", "V3", 1),
        # linalg
        OP("linalg.norm", "X", fam="l"), OP("linalg.norm", "M44", "nuc",
                                            fam="l"),
        OP("linalg.norm", "X", 3, 0, fam="l"),
        OP("linalg.cholesky", "SPD", fam="l"),
        OP("linalg.qr", "M53", fam="l"), OP("linalg.svd", "M53", fam="l"),
        OP("linalg.inv", "SPD", fam="l"), OP("linalg.pinv", "M43", fam="l"),
        OP("linalg.det", "SPD3", fam="l"),
        OP("linalg.slogdet", "SPD", fam="l"),
        OP("linalg.solve", "SPD", "M42", fam="l"),
        OP("linalg.triangular_solve", "SPD", "M42", fam="l"),
        OP("linalg.cholesky_solve", "M32", "LOW", fam="l"),
        OP("linalg.matrix_power", "SPD3", -1, fam="l"),
        OP("linalg.matrix_rank", "RANK2"),
        OP("linalg.eigh", "SPD", fam="l"), OP("linalg.eig", "SPD", fam="l"),
        OP("linalg.eigvalsh", "SPD", fam="l"),
        OP("linalg.eigvals", "SPD", fam="l"),
        OP("linalg.lstsq", "M53", "M52", fam="l"),
        OP("linalg.lu", "SPD", fam="l"),
        OP("linalg.lu_unpack", "LUM", "LUP", fam="l"),
        OP("linalg.multi_dot", ["M23", "M34", "M42"], fam="l"),
        OP("linalg.histogram", "V20", 5),
        OP("linalg.bincount", "IDS"),
        OP("linalg.corrcoef", "M35", fam="l"),
        OP("linalg.cov", "M35", fam="l"),
        OP("linalg.tensordot", "B234", "X", [[1, 2], [0, 1]], fam="l"),
        OP("linalg.einsum", "bij,bjk->bik", "B234", "B242", fam="l",
           half=True),
        # extras and attribute
        OP("extras.as_complex", "M32"), OP("extras.as_real", "X"),
        OP("extras.complex", "X", "Y"), OP("extras.sgn", "X"),
        OP("extras.broadcast_shape", [3, 1], [1, 4]),
        OP("extras.check_shape", [2, -1, 3]),
        OP("extras.floor_mod", "SINT", "INT2"), OP("extras.frexp", "X"),
        OP("extras.nanquantile", "NANROWS", 0.5, 1, fam="f"),
        OP("extras.take", "X", "TAKE"), OP("extras.take", "X", "WIDE",
                                            "wrap"),
        OP("extras.tril_indices", 4, 3, -1),
        OP("extras.triu_indices", 3, None, 1),
        OP("extras.vsplit", "M44", 2),
        OP("extras.shard_index", "SHARD", 20, 2, 1),
        OP("extras.shape", "X"), OP("extras.rank", "X"),
        OP("extras.is_complex", "X"), OP("extras.is_floating_point", "X"),
        OP("extras.is_integer", "INT"), OP("extras.tolist", "INT"),
        OP("extras.iinfo", "int32"), OP("extras.crop", "M45", [2, -1],
                                        [1, 2]),
        OP("extras.set_printoptions", 4),
        OP("extras.disable_signal_handler"),
    ]
    cases += [OP("attribute." + n, "X") for n in (
        "rank", "shape", "is_complex", "is_floating_point", "is_integer",
        "real", "imag")]
    return cases


def _ops_fn(path):
    import paddle_tpu_torch.ops as ops
    import paddle_tpu_torch.tensor.attribute as attribute

    mod, name = path.split(".")
    return getattr(attribute if mod == "attribute" else getattr(ops, mod),
                   name)


def _ops_arg(a, arrays, device, dtype):
    if isinstance(a, str) and a in arrays:
        v = torch.from_numpy(np.array(arrays[a])).to(device)
        return v.to(dtype) if v.is_floating_point() else v
    if isinstance(a, list) and a and all(
            isinstance(i, str) and i in arrays for i in a):
        return [_ops_arg(i, arrays, device, dtype) for i in a]
    return a


def _ops_compare(card, cpu, tol, where):
    """The largest absolute difference of ``card`` from ``cpu`` (0 when
    exact); raises past ``tol`` or on another dtype or shape."""
    if isinstance(cpu, (list, tuple)):
        if not isinstance(card, (list, tuple)) or len(card) != len(cpu):
            raise AssertionError("[ops] %s: %r vs %r" % (where, card, cpu))
        return max([_ops_compare(a, b, tol, where) for a, b in
                    zip(card, cpu)], default=0.0)
    if not isinstance(cpu, torch.Tensor):
        same = card == cpu if not hasattr(cpu, "max") else (
            card.min, card.max, card.bits) == (cpu.min, cpu.max, cpu.bits)
        if not same:
            raise AssertionError("[ops] %s: %r vs %r" % (where, card, cpu))
        return 0.0
    if card.dtype != cpu.dtype \
            or card.shape != cpu.shape:
        raise AssertionError("[ops] %s: card %s %s %s vs CPU %s %s" % (
            where, card.device, card.dtype, tuple(card.shape), cpu.dtype,
            tuple(cpu.shape)))
    got = card.detach().cpu()
    want = cpu.detach()
    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    if tol is None or not (want.is_floating_point()):
        if not torch.equal(got, want) and not (
                want.is_floating_point() and torch.equal(
                    torch.nan_to_num(got, 7.0), torch.nan_to_num(want, 7.0))
                and torch.equal(got.isnan(), want.isnan())):
            raise AssertionError("[ops] %s: card %s vs CPU %s (exact)" % (
                where, got.tolist(), want.tolist()))
        return 0.0
    got, want = got.double(), want.double()
    nan = want.isnan()
    if not torch.equal(nan, got.isnan()):
        raise AssertionError("[ops] %s: NaN masks differ" % where)
    got, want = got[~nan], want[~nan]
    err = float((got - want).abs().max()) if got.numel() else 0.0
    rtol, atol = tol
    if card.dtype in OPS_HALF and want.numel():
        atol *= max(1.0, float(want.abs().max()))
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError("[ops] %s: max |card - CPU| %.3g past rtol %g "
                             "atol %g" % (where, err, rtol, atol))
    return err


def _ops_decomposition(path, card, cpu, where):
    """Decompositions equal up to signs or phases: their values and the
    card's reconstruction, not their vectors."""
    tol = OPS_TOLS["l"]
    if path == "linalg.svd":
        u, s, vh = card
        err = _ops_compare(s, cpu[1], tol, where)
        rec = (u * s.unsqueeze(-2)) @ vh
        return max(err, _ops_compare(rec, (cpu[0] * cpu[1].unsqueeze(-2))
                                     @ cpu[2], tol, where + " U S Vh"))
    if path == "linalg.qr":
        q, r = card
        err = _ops_compare(r.abs(), cpu[1].abs(), tol, where)
        return max(err, _ops_compare(q @ r, cpu[0] @ cpu[1], tol,
                                     where + " QR"))
    if path == "linalg.eigh":
        w, v = card
        err = _ops_compare(w, cpu[0], tol, where)
        return max(err, _ops_compare((v * w) @ v.T, (cpu[1] * cpu[0])
                                     @ cpu[1].T, tol, where + " V W V^T"))
    if path in ("linalg.eig", "linalg.eigvals"):
        w = card[0] if path == "linalg.eig" else card
        want = cpu[0] if path == "linalg.eig" else cpu
        order = torch.argsort(w.real.cpu())
        return _ops_compare(w[order.to(w.device)], want[torch.argsort(
            want.real)], tol, where)
    return None


def ops_sweep(seed, device="cuda"):
    """17(a): every case of ``ops_cases`` on the card and on a CPU copy
    (float32; bf16 and float16 too where ``half``); every public function
    of the op modules must be among them. Returns the op count, the cases
    run and the largest error per family and dtype with its limit."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import _C_ops, ops
    import paddle_tpu_torch.tensor.attribute as attribute
    from paddle_tpu_torch.core import dispatch, place

    arrays = ops_inputs(seed)
    cases = ops_cases()
    errs, runs = {}, 0
    for path, args, kw, fam, half in cases:
        for dtype in (torch.float32,) + (OPS_HALF if half else ()):
            where = "%s%s (%s)" % (path, args, str(dtype)[6:])
            fn = _ops_fn(path)
            try:
                card = fn(*[_ops_arg(a, arrays, device, dtype)
                            for a in args], **kw)
                if device == "cuda":
                    torch.cuda.synchronize()
            except Exception as e:
                raise AssertionError("[ops] %s raised on the card: %r"
                                     % (where, e)) from e
            place.set_device("cpu")
            try:
                cpu = fn(*[_ops_arg(a, arrays, "cpu", dtype)
                           for a in args], **kw)
            finally:
                place._current_place = None
            if path.startswith("creation.") and isinstance(card,
                                                           torch.Tensor):
                if card.device.type != device:
                    raise AssertionError("[ops] %s made on %s, not the "
                                         "card" % (where, card.device))
            err = _ops_decomposition(path, card, cpu, where)
            if err is None:
                tol = (None if fam == "x" else OPS_HALF_TOLS[dtype]
                       if dtype in OPS_HALF else OPS_TOLS[fam])
                err = _ops_compare(card, cpu, tol, where)
            key = "%s %s" % (fam, str(dtype)[6:])
            errs[key] = max(errs.get(key, 0.0), err)
            runs += 1
    ran = {p.split(".")[0] + "." + p.split(".")[1] for p, *_ in cases}
    public = set()
    for mod in OPS_MODULES + ("attribute",):
        m = attribute if mod == "attribute" else getattr(ops, mod)
        public |= {"%s.%s" % (mod, n) for n, v in vars(m).items()
                   if callable(v) and not n.startswith("_")
                   and getattr(v, "__module__", "") == m.__name__}
    missing = sorted(public - ran - {
        "creation." + n for n in RANDOM_OPS} - {
        "extras.poisson", "extras.randint_like"})
    if missing:
        raise AssertionError("[ops] ops not swept on the card: %s" % missing)
    # the random family on the card: shape, dtype, range, seed-determinism
    for name in RANDOM_OPS + ("poisson", "randint_like"):
        paddle.seed(seed)
        first = RANDOM_OPS_CALLS[name](paddle, device)
        paddle.seed(seed)
        again = RANDOM_OPS_CALLS[name](paddle, device)
        shape, dtype, lo, hi = RANDOM_OPS_WANT[name]
        if (first.device.type != device or tuple(first.shape) != shape
                or first.dtype != dtype or not torch.equal(first, again)
                or (lo is not None and not (float(first.min()) >= lo
                                            and float(first.max()) <= hi))):
            raise AssertionError("[ops] random op %s: %s %s %s" % (
                name, first.device, tuple(first.shape), first.dtype))
        runs += 1
    # methods, their in-place forms, indexing and _C_ops
    x = torch.from_numpy(arrays["HALFUP"]).to(device)
    for base in ops.INPLACE_BASES:
        args = {"add": (1.0,), "subtract": (1.0,), "multiply": (2.0,),
                "divide": (2.0,), "clip": (0.7, 1.2), "scale": (3.0,),
                "reshape": ([4, 3],), "squeeze": (), "unsqueeze": (0,),
                "flatten": (), "cast": ("float16",)}.get(base, ())
        card = x.clone()
        cpu = x.cpu().clone()
        ops.method(base + "_")(card, *args)
        ops.method(base + "_")(cpu, *args)
        _ops_compare(card, cpu, OPS_TOLS["t"], base + "_")
        runs += 1
    # every method and operator is a swept op, or one with its operands
    # swapped (the reflected operators)
    swept = {id(_ops_fn(p)) for p, *_ in cases}
    for name, fn in ops.METHODS.items():
        inner = [c.cell_contents for c in (fn.__closure__ or ())]
        if not (id(fn) in swept or name.endswith("_") or name in (
                "__getitem__", "__setitem__", "numel")
                or any(id(f) in swept for f in inner)):
            raise AssertionError("[ops] method %s is not a swept op" % name)
    card, cpu = x.clone(), x.cpu().clone()
    ops.setitem(card, (1, slice(2, None)), 5.0)
    ops.setitem(cpu, (1, slice(2, None)), 5.0)
    _ops_compare(ops.getitem(card, card > 1.0), ops.getitem(cpu, cpu > 1.0),
                 None, "getitem/setitem")
    _ops_compare(_C_ops.add(x, x), _C_ops.add(x.cpu(), x.cpu()), None,
                 "_C_ops.add")
    runs += 2
    limits = {k: (None if k.startswith("x") else OPS_HALF_TOLS[getattr(
        torch, k.split()[1])] if k.split()[1] != "float32"
        else OPS_TOLS[k[0]]) for k in errs}
    out = {"ops": len(public), "cases": runs,
           "registered_primitives": len(dispatch.WRAPPERS),
           "max_abs_err": errs, "limits_rtol_atol": limits}
    log("[ops] %d op functions, %d cases on the card against a CPU copy: %s"
        % (len(public), runs, json.dumps(out)))
    return out


RANDOM_OPS = ("rand", "randn", "standard_normal", "normal", "uniform",
              "randint", "randperm", "multinomial", "bernoulli")
RANDOM_OPS_CALLS = {
    "rand": lambda p, d: p.rand([2, 3]),
    "randn": lambda p, d: p.randn([2, 3]),
    "standard_normal": lambda p, d: p.standard_normal([4]),
    "normal": lambda p, d: p.normal(1.0, 0.5, [3, 2]),
    "uniform": lambda p, d: p.uniform([5], min=-3.0, max=-1.0),
    "randint": lambda p, d: p.randint(2, 7, [4, 3]),
    "randperm": lambda p, d: p.randperm(6),
    "multinomial": lambda p, d: p.multinomial(
        torch.tensor([[0.2, 0.3, 0.5]], device=d), 2),
    "bernoulli": lambda p, d: p.bernoulli(torch.full((8,), 0.5, device=d)),
    "poisson": lambda p, d: p.poisson(torch.full((4,), 3.0, device=d)),
    "randint_like": lambda p, d: p.randint_like(
        torch.zeros(3, device=d), 0, 9),
}
RANDOM_OPS_WANT = {
    "rand": ((2, 3), torch.float32, 0.0, 1.0),
    "randn": ((2, 3), torch.float32, None, None),
    "standard_normal": ((4,), torch.float32, None, None),
    "normal": ((3, 2), torch.float32, None, None),
    "uniform": ((5,), torch.float32, -3.0, -1.0),
    "randint": ((4, 3), torch.int64, 2, 6),
    "randperm": ((6,), torch.int64, 0, 5),
    "multinomial": ((1, 2), torch.int64, 0, 2),
    "bernoulli": ((8,), torch.float32, 0.0, 1.0),
    "poisson": ((4,), torch.float32, 0.0, 1e9),
    "randint_like": ((3,), torch.float32, 0.0, 8.0),
}


# (b) llama1b's training row under O2: float32 weights through
# decorate(level="O2"), FLAGS_fused_lm_head_ce, AdamW, 16 layers with
# recompute, 8 x 1024; 3 steps in bf16, 3 in float16 under the default
# GradScaler (then one at OVERFLOW_SCALE, skipped), each against the same
# steps through every plain version on the card. Sound readings on an H100
# (paddle_tpu_torch/tools/amp_faults.py --o2): losses 1.5e-5 / 3.3e-6
# relative, sampled gradients up to 1.8e-2 / 3.2e-3 of their norm (bf16 /
# float16: 16 layers' rounding at other points). Faults planted on the
# kernel side read: the causal flag flipped 0.066-0.069 on the loss and
# ~1.0 on the gradients; a vocab tile summed twice into the LSE (bf16)
# 8.4e-4 on the loss; dW's last vocab chunk unwritten (float16) 0.31 on
# lm_head's gradient and 2.4e-3 on the loss. The limits sit ~6x over the
# sound loss and ~3x over the sound gradients, each under every fault's
# reading.
O2_STEPS = 3
O2_GRADS = FP16_GRADS
O2_LOSS_RTOL = {torch.bfloat16: 1e-4, torch.float16: 2e-5}
O2_GRAD_RTOL = {torch.bfloat16: 5e-2, torch.float16: 1e-2}


def o2_train_run(model, ids, labels, name, steps, scaler=None):
    """The reference's eager O2 loop: under ``auto_cast(level="O2",
    dtype=name)`` the loss (the fused tail, FLAGS_fused_lm_head_ce on),
    then ``scaler.scale(loss).backward()``, ``scaler.step(opt)``,
    ``opt.clear_grad()``. Returns what ``fp16_train_run`` returns."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate=AMP_LR, parameters=model.parameters())
    scaler = scaler or amp.GradScaler()
    params = dict(model.named_parameters())
    out = {"losses": [], "scaler": [], "skipped": [], "ms": []}
    flags.set_flags({"FLAGS_fused_lm_head_ce": True})
    try:
        for i in range(steps):
            t0 = time.perf_counter()
            with amp.auto_cast(level="O2", dtype=name):
                loss = model(ids, labels)
            scaler.scale(loss).backward()
            before = {n: params[n].detach().clone() for n in O2_GRADS}
            scaler.step(opt)
            if i == 0:
                out["grads"] = {n: params[n].grad.float().clone()
                                for n in O2_GRADS}
            if scaler._found_inf and not all(
                    torch.equal(before[n], params[n]) for n in O2_GRADS):
                raise AssertionError("a skipped step moved the parameters")
            opt.clear_grad()
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["losses"].append(loss.item())
            out["dtype"] = loss.dtype
            out["skipped"].append(scaler._found_inf)
            sd = scaler.state_dict()
            out["scaler"].append((sd["scale"], sd["good_steps"],
                                  sd["bad_steps"]))
    finally:
        flags.set_flags({"FLAGS_fused_lm_head_ce": False})
    return out


def o2_train(seed, dtype):
    """17(b) in ``dtype``: llama1b decorated to it and trained under O2,
    the kernels then every plain version, exact launch counts of kernels
    1-6 in the dtype, the losses and sampled gradients within limits; in
    float16 one more step at OVERFLOW_SCALE, skipped."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    name = "bfloat16" if dtype == torch.bfloat16 else "float16"
    tag = "[amp O2 %s]" % name
    cfg = LlamaConfig.llama1b_train(dtype="float32")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device="cuda").manual_seed(seed + 17))
    amp.decorate(model, level="O2", dtype=name)
    if not all(p.dtype == dtype for p in model.parameters()):
        raise AssertionError("%s decorate left parameters in another dtype"
                             % tag)
    plain_model = copy.deepcopy(model)
    rng = np.random.default_rng(seed + 17)
    ids, labels = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).cuda()
        for _ in range(2))
    labels[:, ::8] = -100
    seen = {}
    handles = [m.register_forward_hook(dtype_hook(seen, tag_))
               for tag_, m in (("decoder layer 0", model.llama.layers[0]),
                               ("rms_norm (final)", model.llama.norm))]
    reset_fp16_counters()
    torch.cuda.reset_peak_memory_stats()
    run = o2_train_run(model, ids, labels, name, O2_STEPS)
    launches = fp16_counters()
    peak = torch.cuda.max_memory_allocated() / 1e9
    for h in handles:
        h.remove()
    restore = plain_kernels()
    try:
        plain = o2_train_run(plain_model, ids, labels, name, O2_STEPS)
    finally:
        restore()
    del plain_model
    want_dtypes = {"decoder layer 0": dtype,
                   "rms_norm (final)": torch.float32}
    if seen != want_dtypes or run["dtype"] != torch.float32:
        raise AssertionError("%s dtypes %s (loss %s), expected %s" % (
            tag, seen, run["dtype"], want_dtypes))
    layers, steps = cfg.num_hidden_layers, O2_STEPS
    sfx = "_fp16" if dtype == torch.float16 else ""
    want = dict.fromkeys(launches, 0)
    want.update({"flash_attention" + sfx: 2 * layers * steps,
                 "flash_attention_bwd_dq" + sfx: layers * steps,
                 "flash_attention_bwd_dkv" + sfx: layers * steps,
                 "fused_ce_fwd" + sfx: steps, "fused_ce_dh" + sfx: steps,
                 "fused_ce_dw" + sfx: steps})
    if launches != want:
        raise AssertionError("%s launches %s, expected %s"
                             % (tag, launches, want))
    if not all(math.isfinite(x) for x in run["losses"]):
        raise AssertionError("%s non-finite loss %s" % (tag, run["losses"]))
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(run["losses"], plain["losses"]))
    grad_err = {} if run["skipped"][0] else {
        n: rel_norm(run["grads"][n], plain["grads"][n]) for n in O2_GRADS}
    if not all(map(math.isfinite, grad_err.values())):
        raise AssertionError("%s non-finite gradients %s" % (tag, grad_err))
    if run["scaler"] != plain["scaler"] or run["skipped"] != plain["skipped"]:
        raise AssertionError("%s scaler sequence %s (skipped %s) differs from "
                             "the plain versions' %s (%s)" % (
                                 tag, run["scaler"], run["skipped"],
                                 plain["scaler"], plain["skipped"]))
    if loss_err > O2_LOSS_RTOL[dtype] or max(grad_err.values(),
                                             default=0.0) \
            > O2_GRAD_RTOL[dtype]:
        raise AssertionError("%s kernels vs plain versions: losses %s vs %s "
                             "(rel %.3g > %g?), gradients %s (> %g?)" % (
                                 tag, run["losses"], plain["losses"],
                                 loss_err, O2_LOSS_RTOL[dtype], grad_err,
                                 O2_GRAD_RTOL[dtype]))
    result = {"losses": run["losses"], "plain_losses": plain["losses"],
              "loss_rel_err": loss_err, "grad_rel_err": grad_err,
              "scaler": run["scaler"], "skipped": run["skipped"],
              "step_ms": run["ms"], "plain_step_ms": plain["ms"],
              "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
              / statistics.median(run["ms"][1:]) * 1e3,
              "peak_mem_gb": peak, "launches": launches,
              "dtypes": {k: str(v)[6:] for k, v in seen.items()}}
    if dtype == torch.float16:
        params = dict(model.named_parameters())
        before = {n: params[n].detach().clone() for n in O2_GRADS}
        reset_fp16_counters()
        over = o2_train_run(model, ids, labels, name, 1,
                            scaler=amp.GradScaler(
                                init_loss_scaling=OVERFLOW_SCALE))
        over_launches = fp16_counters()
        want_over = {k: v // steps for k, v in want.items()}
        if over["skipped"] != [True] or \
                over["scaler"] != [(OVERFLOW_SCALE, 0, 1)] or \
                not all(torch.equal(before[n], params[n]) for n in O2_GRADS):
            raise AssertionError("%s overflow step %s" % (tag, over))
        if over_launches != want_over:
            raise AssertionError("%s overflow step launches %s, expected %s"
                                 % (tag, over_launches, want_over))
        result["overflow_step"] = {"scale": OVERFLOW_SCALE, "skipped": True,
                                   "scaler": over["scaler"],
                                   "launches": over_launches}
    # the host's share: one more step, profiled
    result["profiled_step"] = device_breakdown(
        lambda: o2_train_run(model, ids, labels, name, 1))
    log("%s llama1b float32 weights decorated, under O2 (%d layers, %d x "
        "%d, recompute, fused tail, AdamW %g, %.1f s): %s" % (
            tag, layers, TRAIN_BATCH, TRAIN_SEQ, AMP_LR,
            time.perf_counter() - t0, json.dumps(result)))
    del model
    torch.cuda.empty_cache()
    return result


def phase_ops_o2(seed):
    """Phase 17: (a) the op sweep, (b) llama1b under O2 in bf16 and
    float16. Returns the sweep, the paths' launch counts and the runs."""
    t0 = time.perf_counter()
    sweep = ops_sweep(seed)
    runs = {name: o2_train(seed, dtype) for name, dtype in
            (("bf16", torch.bfloat16), ("fp16", torch.float16))}
    paths = {"o2 bf16": runs["bf16"]["launches"],
             "o2 fp16": runs["fp16"]["launches"],
             "o2 fp16 overflow step": runs["fp16"]["overflow_step"][
                 "launches"]}
    log("[ops/O2] phase 17 in %.1f s" % (time.perf_counter() - t0))
    return sweep, paths, runs


# -- phase 18: head dim 256 ----------------------------------------------------

# A Llama at Gemma-2B's widths (google/gemma-2b, config.json: hidden 2048,
# 8 query heads and 1 kv head of 256, FFN 16384, 18 layers, vocab 256000,
# 8192 positions) through the repo's LlamaForCausalLM: Llama's arithmetic
# (SwiGLU, plain RMSNorm, an untied head), not Gemma's; random weights
# from --seed
GEMMA = dict(hidden_size=2048, intermediate_size=16384, num_hidden_layers=18,
             num_attention_heads=8, num_key_value_heads=1, vocab_size=256000,
             max_position_embeddings=8192)
GEMMA_D = 256
# (a) kernels 1-3 at the training shape (B = 8, N = 1024, H = 8, Hkv = 1,
# causal; timed) and a ragged N (200, the forward non-causal); kernel 7 at
# the decode batch (16 slots, lengths 0..2048); kernel 8 at the mixed step
# (a), the suffix prefill (b) and a mixed step of 4-token chunks (32 rows a
# slot: the rows kernel's 8-row tiles), all at H = 8, Hkv = 1
GEMMA_TRAIN = dict(batch=TRAIN_BATCH, n=TRAIN_SEQ, heads=8, kv_heads=1,
                   head_dim=GEMMA_D)
GEMMA_MIXED = (dict(MIXED_STEP, heads=8, kv_heads=1),
               dict(SUFFIX_PREFILL, heads=8, kv_heads=1),
               dict(hist=MIXED_STEP["hist"],
                    q_lens=[min(n, 4) for n in MIXED_STEP["q_lens"]],
                    chunk=4, heads=8, kv_heads=1))
# kernel 10 at the model's projections (K -> N): q/o, k/v, gate/up, down
GEMMA_W8 = ((2048, 2048, "q_proj"), (2048, 256, "k_proj"),
            (2048, 16384, "gate_proj"), (16384, 2048, "down_proj"))
# (b) served at all 18 layers: (dtype, tag, flags), each run's greedy tokens
# against the same engine on the plain versions on the card: equal, or
# first diverging at a near-tie of the plain run (a top-2 gap under the
# dtype's share of the row's max |logit|: float32 1e-4, a thousand times
# the kernels' float32 rounding; bf16 / float16 phase 10(b)'s and 16(c)'s
# 2^-4 and 2^-7; int8 pages 2^-4, as in 16(c))
GEMMA_SERVE_RUNS = (
    (torch.float32, "flags off", {}),
    (torch.float32, "prefix+chunked+int8 KV+int8 weights",
     dict(prefix=True, chunked=True, quant_kv=True, quant_weights=True)),
    (torch.bfloat16, "flags off", {}),
    (torch.bfloat16, "prefix+chunked+int8 KV",
     dict(prefix=True, chunked=True, quant_kv=True)),
    (torch.float16, "flags off", {}),
    (torch.float16, "prefix+chunked+int8 KV",
     dict(prefix=True, chunked=True, quant_kv=True)))
GEMMA_NEAR_TIE = {torch.float32: 1e-4, torch.bfloat16: BF16_NEAR_TIE,
                  torch.float16: FP16_NEAR_TIE}
# the card against a CPU copy at 2 layers in float32: phase 5's rule
# (LOGIT_RTOL x max |logit|) over a 64-token sequence
GEMMA_CPU_LAYERS, GEMMA_CPU_TOKENS = 2, 64
# (c) trained with FLAGS_fused_lm_head_ce and AdamW at 8 x 1024: bf16 and
# float16 (the default GradScaler) at all 18 layers with recompute, 3
# steps; float32 at 2 layers (depth cut: 18 float32 layers and their AdamW
# slots are 36 GB before activations), 2 steps. Kernels 1-3 against their
# plain versions from the same weights (the fused tail's kernels on both
# sides: its plain backward at V = 256000 holds a 16.8 GB int64 one-hot
# beside two 8.4 GB float32 logit tensors, past the card beside the model;
# (a) holds kernels 4-6 at this shape): the losses and the first step's
# sampled gradients by relative norm, within (loss, gradient) limits by
# dtype: phase 17's O2 limits for a bf16 model, phase 16's for a float16
# one; float32 phase 7's gradient limit and a loss limit of 1e-6: at 2
# layers and random weights the loss sits near ln(vocab) whatever
# attention returns, and in a trial run on an H100 the planted faults
# moved it by 2.6e-6 and 5.3e-6 while the kernels matched the plain
# versions' losses to the bit. Each limit must be crossed by a fault
# planted in kernel 1 on the first step (GEMMA_FAULTS).
GEMMA_TRAIN_STEPS = {torch.bfloat16: 3, torch.float16: 3, torch.float32: 2}
GEMMA_TRAIN32_LAYERS = 2
GEMMA_TRAIN_TOL = {torch.bfloat16: (1e-4, 5e-2),
                   torch.float16: (FP16_LOSS_RTOL, FP16_GRAD_RTOL),
                   torch.float32: (1e-6, TRAIN_GRAD_RTOL)}
GEMMA_FAULTS = ("causal flag flipped", "O's second 128 columns unwritten")
# the summary's entries of the D = 256 instances, each over every dtype
# (and pool mode) the Gemma-width paths ran
D256_ENTRIES = {
    "flash_attention_d256": ("flash_attention", "flash_attention_fp16",
                             "flash_attention_segmented"),
    "flash_attention_bwd_dq_d256": ("flash_attention_bwd_dq",
                                    "flash_attention_bwd_dq_fp16",
                                    "flash_attention_bwd_dq_segmented"),
    "flash_attention_bwd_dkv_d256": ("flash_attention_bwd_dkv",
                                     "flash_attention_bwd_dkv_fp16",
                                     "flash_attention_bwd_dkv_segmented"),
    "paged_attention_d256": ("paged_attention", "paged_attention_int8",
                             "paged_attention_fp16",
                             "paged_attention_int8_fp16"),
    # "mixed_paged_attention_bf16" reads the same counter as the float32
    # entry: counted once
    "mixed_paged_attention_d256": ("mixed_paged_attention",
                                   "mixed_paged_attention_int8",
                                   "mixed_paged_attention_fp16",
                                   "mixed_paged_attention_int8_fp16"),
}
# the other kernels the Gemma-width paths run, under their own entries
GEMMA_OTHER_ENTRIES = ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw",
                       "fused_ce_fwd_fp16", "fused_ce_dh_fp16",
                       "fused_ce_dw_fp16", "int8_weight_matmul",
                       "int8_weight_matmul_bf16", "int8_weight_matmul_fp16")


def gemma_path(counts):
    """A Gemma-width run's launch counts by summary entry: the attention
    kernels' counters summed into their D = 256 entries, the loss tail's
    and kernel 10's under their own."""
    out = {name: sum(counts[c] for c in parts)
           for name, parts in D256_ENTRIES.items()}
    out.update({name: counts[name] for name in GEMMA_OTHER_ENTRIES})
    return out


def gemma_kernels(seed):
    """18(a): kernels 1-3, 7 and 8 at D = 256 in every dtype and pool mode
    against their plain versions at the path's shapes, twice bit for bit,
    timed (CUDA events and profiler device time) beside the bound, the
    plain version and torch SDPA; kernels 4-6 at V = 256000 and kernel 10
    at the model's projections against their plain versions."""
    from paddle_tpu_torch.kernels import quant

    gen = torch.Generator(device="cuda").manual_seed(seed + 18)
    t0 = time.perf_counter()
    rows = {"fwd": [], "bwd": [], "paged": [], "mixed": []}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        rows["fwd"] += [
            flash_case(gen, dtype=dtype, timed=True, profiled=True,
                       **GEMMA_TRAIN),
            flash_case(gen, 200, 8, GEMMA_D, dtype, kv_heads=1,
                       causal=False)]
        rows["bwd"] += [
            flash_bwd_case(gen, dtype=dtype, timed=True, profiled=True,
                           **GEMMA_TRAIN),
            flash_bwd_case(gen, 200, 8, GEMMA_D, dtype, kv_heads=1)]
        for int8 in (False, True):
            rows["paged"].append(paged_case(
                gen, PAGED_LENS, 8, 1, dtype, timed=True, head_dim=GEMMA_D,
                int8=int8, bitwise=True))
            for i, case in enumerate(GEMMA_MIXED):
                rows["mixed"].append(mixed_case(
                    gen, dtype=dtype, timed=i < 2, profiled=i < 2,
                    head_dim=GEMMA_D, int8=int8, bitwise=True, **case))
        torch.cuda.empty_cache()
    ids, _ = packed_ids(np.random.default_rng(seed + 18), TRAIN_BATCH,
                        TRAIN_SEQ)
    rows["segmented"] = [segmented_case(gen, ids, 8, GEMMA_D, torch.bfloat16,
                                        True, "(a) D=256")]
    rows["fused_ce"] = [fused_ce_case(gen, TRAIN_BATCH * TRAIN_SEQ, 2048,
                                      GEMMA["vocab_size"], dtype,
                                      timed=dtype is torch.bfloat16)
                        for dtype in (torch.bfloat16, torch.float16,
                                      torch.float32)]
    torch.cuda.empty_cache()
    w8 = []
    with torch.no_grad():
        for k, n, name in GEMMA_W8:
            w = torch.randn(k, n, generator=gen, device="cuda") * 0.02
            q, scales = quant.quantize_int8_weight(w)
            for m in W8_TIMED_MS:
                x = torch.randn(m, k, generator=gen, device="cuda")
                tag = "%s M=%d K=%d N=%d" % (name, m, k, n)
                w8.append(w8_case(x, q, scales, w, tag, timed=False))
                for half in (torch.bfloat16, torch.float16):
                    hq, hs = quant.quantize_int8_weight(w.to(half))
                    w8.append(w8_bf16_case(x.to(half), hq, hs, "%s %s" % (
                        tag, str(half).split(".")[-1]), timed=False))
    rows["w8"] = w8
    log("[d256] (a) kernels in %.1f s" % (time.perf_counter() - t0))
    return rows


def gemma_model(seed, dtype, layers=None, device=None):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**dict(GEMMA, dtype=str(dtype).split(".")[-1],
                             num_hidden_layers=layers
                             or GEMMA["num_hidden_layers"]))
    if cfg.head_dim != GEMMA_D:
        raise AssertionError("head dim %d" % cfg.head_dim)
    return LlamaForCausalLM(cfg, device=device, generator=torch.Generator(
        device=device or "cuda").manual_seed(seed + 18))


def gemma_launch_want(dtype, opts, st, layers):
    """The exact launches of a serving run: kernel 1 per prefill and layer
    (none with chunked prefill), kernel 7 per decode step and layer, kernel
    8 per mixed step and layer, kernel 10 7 times per layer and step with
    int8 weights (its every-mode counter and its dtype's; with chunked
    prefill every step is a mixed one, which the stats also count as a
    decode step); int8 pools take the int8 entries, float16 its own."""
    f16 = "_fp16" if dtype is torch.float16 else ""
    kv = "_int8" if opts.get("quant_kv") else ""
    want = dict.fromkeys(fp16_counters(), 0)
    if opts.get("chunked"):
        want["mixed_paged_attention%s%s" % (kv, f16)] = \
            layers * st["mixed_steps"]
        if not kv and not f16:   # the float32 / bf16 entries share it
            want["mixed_paged_attention_bf16"] = want["mixed_paged_attention"]
    else:
        want["flash_attention" + f16] = layers * st["prefill_runs"]
        want["paged_attention%s%s" % (kv, f16)] = layers * st["decode_steps"]
    if opts.get("quant_weights"):
        want["int8_weight_matmul"] = 7 * layers * st[
            "mixed_steps" if opts.get("chunked") else "decode_steps"]
        if dtype is not torch.float32:
            want["int8_weight_matmul_" + ("fp16" if f16 else "bf16")] = \
                want["int8_weight_matmul"]
    return want


def gemma_serving(seed):
    """18(b): the model behind serving.Engine at all 18 layers in float32,
    bf16 and float16, flags off and with prefix cache + chunked prefill +
    int8 KV (float32: + int8 weights); greedy tokens against the same
    engine on the plain versions on the card; exact launch counts; then
    a 2-layer float32 copy's logits card against CPU."""
    results, paths = {}, {}
    t0 = time.perf_counter()
    layers = GEMMA["num_hidden_layers"]
    model, model_dtype = None, None
    for dtype, tag, opts in GEMMA_SERVE_RUNS:
        if dtype is not model_dtype:
            del model
            torch.cuda.empty_cache()
            model, model_dtype = gemma_model(seed, dtype), dtype
            fp16_serve(model, ([[1, 2, 3]], []), {})   # warm-up
        name = "[d256 serve %s %s]" % (str(dtype).split(".")[-1], tag)
        prompts = bf16_prompts(seed, GEMMA["vocab_size"])
        flat = prompts[0] + prompts[1]
        reset_fp16_counters()
        t1 = time.perf_counter()
        tokens, st = fp16_serve(model, prompts, opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = fp16_counters()
        want = gemma_launch_want(dtype, opts, st, layers)
        if launches != want:
            raise AssertionError("%s launches %s, expected %s"
                                 % (name, launches, want))
        if opts.get("prefix") and not st["prefix_hit_tokens"] >= 240:
            raise AssertionError("%s expected a 240-token prefix hit: %s"
                                 % (name, st))
        restore = plain_kernels()
        try:
            plain_tokens, _ = fp16_serve(model, prompts, opts)
        finally:
            restore()
        rel = FP16_NEAR_TIE_INT8_KV if opts.get("quant_kv") \
            else GEMMA_NEAR_TIE[dtype]
        same = [fp16_near_tie(name + " kernels vs plain", model, p, w, g, rel)
                for p, w, g in zip(flat, plain_tokens, tokens)]
        results["%s %s" % (str(dtype).split(".")[-1], tag)] = row = {
            "wall_s": wall, "prompt_lens": [len(p) for p in flat],
            "identical": "%d of %d" % (sum(same), len(same)),
            "prefill_runs": st["prefill_runs"],
            "decode_steps": st["decode_steps"],
            "mixed_steps": st["mixed_steps"],
            "prefix_hit_tokens": st["prefix_hit_tokens"],
            "launches": launches}
        log(name + " " + json.dumps(row))
        paths["d256 serving %s %s" % (str(dtype).split(".")[-1], tag)] = \
            gemma_path(launches)
    del model
    torch.cuda.empty_cache()
    # a 2-layer float32 copy: the card (kernels) against the CPU (plain)
    model = gemma_model(seed, torch.float32, layers=GEMMA_CPU_LAYERS)
    cpu_model = copy.deepcopy(model).to("cpu")
    ids = torch.from_numpy(np.random.default_rng(seed + 18).integers(
        0, GEMMA["vocab_size"], (1, GEMMA_CPU_TOKENS)))
    with torch.no_grad():
        want = cpu_model(ids)[0]
        got = model(ids.cuda())[0].cpu()
    diff, scale = float((got - want).abs().max()), float(want.abs().max())
    results["cpu_logits"] = {"layers": GEMMA_CPU_LAYERS,
                             "tokens": GEMMA_CPU_TOKENS, "max_abs_diff": diff,
                             "max_abs_logit": scale}
    log("[d256 serve] card vs CPU logits at %d layers [%d, %d]: max abs diff "
        "%.3g, max |logit| %.3g" % (GEMMA_CPU_LAYERS, *want.shape, diff,
                                    scale))
    if not (bool(torch.isfinite(got).all()) and diff <= LOGIT_RTOL * scale):
        raise AssertionError("[d256 serve] card logits differ from the CPU "
                             "plain path by %.3g (> %g x %.3g)"
                             % (diff, LOGIT_RTOL, scale))
    del model, cpu_model
    torch.cuda.empty_cache()
    log("[d256] (b) serving in %.1f s" % (time.perf_counter() - t0))
    return results, paths


def gemma_grad_names(layers):
    return ("lm_head.weight", "llama.layers.0.self_attn.q_proj.weight",
            "llama.layers.%d.mlp.down_proj.weight" % (layers - 1))


def gemma_train_run(model, ids, labels, steps, scaler=None):
    """The eager loop with the fused tail (FLAGS_fused_lm_head_ce, the
    loss inside the model) and AdamW, through the scaler when given.
    Returns the losses, the first step's sampled gradients (unscaled) and
    the step times."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate=AMP_LR, parameters=model.parameters())
    params = dict(model.named_parameters())
    names = gemma_grad_names(model.config.num_hidden_layers)
    out = {"losses": [], "ms": []}
    flags.set_flags({"FLAGS_fused_lm_head_ce": True})
    try:
        for i in range(steps):
            t0 = time.perf_counter()
            loss = model(ids, labels)
            if scaler is None:
                loss.backward()
                opt.step()
            else:
                scaler.scale(loss).backward()
                scaler.step(opt)
            if i == 0:
                out["grads"] = {n: params[n].grad.float().clone()
                                for n in names}
            opt.clear_grad()
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["losses"].append(loss.item())
    finally:
        flags.set_flags({"FLAGS_fused_lm_head_ce": False})
    return out


def gemma_fault_step(model, ids, labels, fault, scale):
    """The first step's loss and sampled gradients (no update) with a fault
    planted in kernel 1's wrapper: the causal flag flipped, or O's second
    128 columns left as zeros."""
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.kernels import flash_attention as fa

    kernel = fa.flash_attention

    def planted(q, k, v, causal=False, scale=None, segment_ids=None):
        if fault == GEMMA_FAULTS[0]:
            return kernel(q, k, v, not causal, scale, segment_ids)
        out, lse = kernel(q, k, v, causal, scale, segment_ids)
        out = out.clone()
        out[..., 128:] = 0
        return out, lse

    params = dict(model.named_parameters())
    fa.flash_attention = planted
    flags.set_flags({"FLAGS_fused_lm_head_ce": True})
    try:
        loss = model(ids, labels)
        (loss * scale).backward()
        grads = {n: params[n].grad.float() / scale
                 for n in gemma_grad_names(model.config.num_hidden_layers)}
    finally:
        fa.flash_attention = kernel
        flags.set_flags({"FLAGS_fused_lm_head_ce": False})
    for p in model.parameters():
        p.grad = None
    return loss.item(), grads


def gemma_train(seed, dtype):
    """18(c) in one dtype: the planted faults from the initial weights,
    then the steps on the kernels, then on kernels 1-3's plain versions
    from the same weights; exact launch counts; step ms, tokens/s, peak
    memory."""
    from paddle_tpu_torch import amp

    layers = GEMMA_TRAIN32_LAYERS if dtype is torch.float32 \
        else GEMMA["num_hidden_layers"]
    steps = GEMMA_TRAIN_STEPS[dtype]
    tag = "[d256 train %s]" % str(dtype).split(".")[-1]
    t0 = time.perf_counter()
    model = gemma_model(seed, dtype, layers=layers)
    model.config.recompute = dtype is not torch.float32
    plain_model = copy.deepcopy(model)
    rng = np.random.default_rng(seed + 18)
    ids, labels = (torch.from_numpy(rng.integers(
        0, GEMMA["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ))).cuda()
        for _ in range(2))
    labels[:, ::8] = -100
    scaler = amp.GradScaler if dtype is torch.float16 else None
    scale = 2.0 ** 15 if scaler else 1.0
    faults = {f: gemma_fault_step(model, ids, labels, f, scale)
              for f in GEMMA_FAULTS}
    reset_fp16_counters()
    torch.cuda.reset_peak_memory_stats()
    run = gemma_train_run(model, ids, labels, steps, scaler and scaler())
    launches = fp16_counters()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()
    restore = flash_plain()
    try:
        plain = gemma_train_run(plain_model, ids, labels, steps,
                                scaler and scaler())
    finally:
        restore()
    del plain_model
    torch.cuda.empty_cache()
    f16 = "_fp16" if dtype is torch.float16 else ""
    want = dict.fromkeys(launches, 0)
    want.update({"flash_attention" + f16: 2 * layers * steps
                 if dtype is not torch.float32 else layers * steps,
                 "flash_attention_bwd_dq" + f16: layers * steps,
                 "flash_attention_bwd_dkv" + f16: layers * steps,
                 "fused_ce_fwd" + f16: steps, "fused_ce_dh" + f16: steps,
                 "fused_ce_dw" + f16: steps})
    if launches != want:
        raise AssertionError("%s launches %s, expected %s"
                             % (tag, launches, want))
    if not all(map(math.isfinite, run["losses"])):
        raise AssertionError("%s non-finite loss %s" % (tag, run["losses"]))
    loss_tol, grad_tol = GEMMA_TRAIN_TOL[dtype]

    def errors(loss, grads):
        return (abs(loss - plain["losses"][0]) / abs(plain["losses"][0]),
                max(rel_norm(grads[n], plain["grads"][n]) for n in grads))

    grad_err = errors(run["losses"][0], run["grads"])[1]
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(run["losses"], plain["losses"]))
    planted = {f: dict(zip(("loss_rel_err", "grad_rel_err"), errors(*r)))
               for f, r in faults.items()}
    result = {"layers": layers, "steps": steps, "losses": run["losses"],
              "plain_losses": plain["losses"], "loss_rel_err": loss_err,
              "grad_rel_err": grad_err,
              "limits": {"loss": loss_tol, "grad": grad_tol},
              "planted": planted, "step_ms": run["ms"],
              "plain_step_ms": plain["ms"],
              "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
              / statistics.median(run["ms"][1:]) * 1e3,
              "peak_mem_gb": peak, "launches": launches}
    log("%s %d layers, %d x %d%s, fused tail, AdamW %g (%.1f s): %s" % (
        tag, layers, TRAIN_BATCH, TRAIN_SEQ,
        ", recompute" if layers > GEMMA_TRAIN32_LAYERS else "", AMP_LR,
        time.perf_counter() - t0, json.dumps(result)))
    if not (math.isfinite(grad_err) and loss_err <= loss_tol
            and grad_err <= grad_tol):
        raise AssertionError("%s kernels vs plain versions: loss %.3g (> %g?)"
                             ", gradients %.3g (> %g?)" % (
                                 tag, loss_err, loss_tol, grad_err,
                                 grad_tol))
    caught = [(p["loss_rel_err"] > loss_tol, p["grad_rel_err"] > grad_tol)
              for p in planted.values()]
    if not all(a or b for a, b in caught) or not any(a for a, _ in caught) \
            or not any(b for _, b in caught):
        raise AssertionError("%s a limit no planted fault crosses: %s"
                             % (tag, planted))
    return result


def gemma_tiny(seed):
    """18(d): the tiny preset (D = 16) on the card, served and trained one
    step through SDPA's and the paged wrappers' plain path: every kernel
    counter 0, the head-dim dispatch's counter above 0."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    cfg = LlamaConfig.tiny()
    model = LlamaForCausalLM(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed + 18))
    reset_fp16_counters()
    plain = fa.plain_head_dim_calls
    out = {}
    for tag, opts in (("flags off", {}), ("prefix+chunked+int8 KV", dict(
            prefix=True, chunked=True, quant_kv=True))):
        engine = tier2_engine(model, opts.get("prefix", False),
                              opts.get("chunked", False),
                              opts.get("quant_kv", False), max_slots=2,
                              block_size=16, num_blocks=32,
                              max_model_len=cfg.max_position_embeddings)
        rng = np.random.default_rng(seed + 18)
        ids = [engine.add_request(rng.integers(0, cfg.vocab_size, n)
                                  .tolist(), max_new_tokens=6)
               for n in (5, 13, 40)]
        engine.run()
        out[tag] = [engine.output(i) for i in ids]
        del engine
    step = TrainStep(model, lm_loss(cfg.vocab_size), AdamW(
        learning_rate=AMP_LR, parameters=model.parameters()))
    x = torch.randint(0, cfg.vocab_size, (2, 32), device="cuda",
                      generator=torch.Generator(device="cuda")
                      .manual_seed(seed))
    out["loss"] = step(x, x).item()
    counts = fp16_counters()
    out["plain_head_dim_calls"] = fa.plain_head_dim_calls - plain
    log("[d256] (d) tiny preset (D = %d) on the card: %s, kernel launches %s"
        % (cfg.head_dim, json.dumps(out), {k: v for k, v in counts.items()
                                           if v}))
    if any(counts.values()) or not out["plain_head_dim_calls"] \
            or not math.isfinite(out["loss"]):
        raise AssertionError("[d256] (d) kernel launches %s, plain head-dim "
                             "calls %d, loss %s" % (counts,
                                                    out["plain_head_dim_calls"],
                                                    out["loss"]))
    del model, step
    torch.cuda.empty_cache()
    return out


def phase_head_dim_256(seed):
    """Phase 18: (a) kernels 1-3, 7, 8 at D = 256 and 4-6, 10 at the
    model's shapes, (b) a Llama at Gemma-2B's widths served, (c) trained,
    (d) the tiny preset on the plain path. Returns the kernel rows, the
    paths' launch counts and the results."""
    t0 = time.perf_counter()
    rows = gemma_kernels(seed)
    torch.cuda.empty_cache()
    results = {}
    results["serving"], paths = gemma_serving(seed)
    t1 = time.perf_counter()
    results["train"] = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        run = gemma_train(seed, dtype)
        results["train"][str(dtype).split(".")[-1]] = run
        paths["d256 train %s" % str(dtype).split(".")[-1]] = \
            gemma_path(run["launches"])
    log("[d256] (c) training in %.1f s" % (time.perf_counter() - t1))
    results["tiny"] = gemma_tiny(seed)
    ran = {k: sum(c[k] for c in paths.values()) for k in D256_ENTRIES}
    if not all(ran.values()):
        raise AssertionError("[d256] a D = 256 kernel never ran on the "
                             "paths: %s" % ran)
    log("[d256] phase 18 in %.1f s" % (time.perf_counter() - t0))
    return rows, paths, results


def d256_numbers(name, rows, ptxas):
    """A D = 256 entry's numbers: the bf16 timed case (the training shape,
    the decode batch, the mixed step) with every timed mode beside it, the
    largest float32 error, and ptxas's report of the D = 256 instances."""
    d = rows["d256"]
    if name == "flash_attention_d256":
        cases, part, source = d["fwd"], None, "flash_attention"
    elif name.startswith("flash_attention_bwd"):
        cases, part = d["bwd"], name.split("_")[3]
        source = "flash_attention_bwd"
    elif name == "paged_attention_d256":
        cases, part, source = d["paged"], None, "paged_attention"
    else:
        cases, part, source = d["mixed"], None, "paged_attention"

    def brief(r):
        ms = r[part + "_ms"] if part else r["ms"]
        b = r[part] if part else r
        out = dict(case=r["case"], ms=ms, plain_ms=r["plain_ms"],
                   bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                   library_ms=r["library_ms"])
        dev = r.get(part + "_device_ms" if part else "device_ms")
        if dev is not None:
            out["device_ms"] = dev
        return out

    timed = [r for r in cases if ("%s_ms" % part if part else "ms") in r]
    main = next(r for r in timed if "bfloat16" in r["case"])
    errs = [r["max_abs_err"][part] if part else r["max_abs_err"]
            for r in cases if "float32" in r["case"]]
    return dict(brief(main), max_abs_err=max(errs), timed_case=main["case"],
                modes=[brief(r) for r in timed],
                ptxas=[r for r in ptxas.get(source, ())
                       if "256" in r["kernel"]])


BWD_SOURCE = "paddle_tpu_torch/csrc/flash_attention_bwd.cu"
KERNELS = {
    "flash_attention": dict(
        source="paddle_tpu_torch/csrc/flash_attention.cu",
        replaces="paddle_tpu/kernels/flash_attention.py:161"),
    "flash_attention_bwd_dq": dict(
        source=BWD_SOURCE,
        replaces="paddle_tpu/kernels/flash_attention.py:330"),
    "flash_attention_bwd_dkv": dict(
        source=BWD_SOURCE,
        replaces="paddle_tpu/kernels/flash_attention.py:366"),
    "paged_attention": dict(
        source="paddle_tpu_torch/csrc/paged_attention.cu",
        replaces="paddle_tpu/serving/kernels/paged_attention.py:167"),
    "fused_ce_fwd": dict(
        source="paddle_tpu_torch/csrc/fused_ce.cu",
        replaces="paddle_tpu/kernels/fused_ce.py:147"),
    "fused_ce_dh": dict(
        source="paddle_tpu_torch/csrc/fused_ce.cu",
        replaces="paddle_tpu/kernels/fused_ce.py:177"),
    "fused_ce_dw": dict(
        source="paddle_tpu_torch/csrc/fused_ce.cu",
        replaces="paddle_tpu/kernels/fused_ce.py:193"),
    "mma_probe": dict(
        source="paddle_tpu_torch/csrc/mma_probe.cu",
        replaces="tools/mosaic_probe.py:19"),
    "paged_attention_int8": dict(
        source="paddle_tpu_torch/csrc/paged_attention.cu",
        replaces="paddle_tpu/serving/kernels/paged_attention.py:167",
        mode="int8 pages + fp32 scales (quantized=True)"),
    "mixed_paged_attention": dict(
        source="paddle_tpu_torch/csrc/paged_attention.cu",
        replaces="paddle_tpu/serving/kernels/paged_attention.py:345",
        mode="float32"),
    "mixed_paged_attention_bf16": dict(
        source="paddle_tpu_torch/csrc/paged_attention.cu",
        replaces="paddle_tpu/serving/kernels/paged_attention.py:345",
        mode="bfloat16"),
    "mixed_paged_attention_int8": dict(
        source="paddle_tpu_torch/csrc/paged_attention.cu",
        replaces="paddle_tpu/serving/kernels/paged_attention.py:345",
        mode="int8 pages + fp32 scales (quantized=True)"),
    "flash_attention_segmented": dict(
        source="paddle_tpu_torch/csrc/flash_attention.cu",
        replaces="paddle_tpu/kernels/flash_attention.py:161",
        mode="segment ids"),
    "flash_attention_bwd_dq_segmented": dict(
        source=BWD_SOURCE,
        replaces="paddle_tpu/kernels/flash_attention.py:330",
        mode="segment ids"),
    "flash_attention_bwd_dkv_segmented": dict(
        source=BWD_SOURCE,
        replaces="paddle_tpu/kernels/flash_attention.py:366",
        mode="segment ids"),
    "int8_weight_matmul": dict(
        source="paddle_tpu_torch/csrc/w8_gemm.cu",
        replaces="none: the reference's dequantize is fused by XLA "
                 "(paddle_tpu/serving/engine.py:1074, _dequant_state)",
        mode="float32 x, int8 weight, fp32 block scales"),
    "int8_weight_matmul_bf16": dict(
        source="paddle_tpu_torch/csrc/w8_gemm.cu",
        replaces="none: the reference's dequantize is fused by XLA "
                 "(paddle_tpu/serving/engine.py:1074, _dequant_state)",
        mode="bfloat16 x and y, int8 weight, fp32 block scales"),
    "flash_attention_fp16": dict(
        source="paddle_tpu_torch/csrc/flash_attention.cu",
        replaces="paddle_tpu/kernels/flash_attention.py:161",
        mode="float16 (wgmma .f32.f16.f16)"),
    "flash_attention_bwd_dq_fp16": dict(
        source=BWD_SOURCE,
        replaces="paddle_tpu/kernels/flash_attention.py:330",
        mode="float16 (wgmma .f32.f16.f16)"),
    "flash_attention_bwd_dkv_fp16": dict(
        source=BWD_SOURCE,
        replaces="paddle_tpu/kernels/flash_attention.py:366",
        mode="float16 (wgmma .f32.f16.f16)"),
    "fused_ce_fwd_fp16": dict(
        source="paddle_tpu_torch/csrc/fused_ce.cu",
        replaces="paddle_tpu/kernels/fused_ce.py:147",
        mode="float16 h and W (wgmma .f32.f16.f16)"),
    "fused_ce_dh_fp16": dict(
        source="paddle_tpu_torch/csrc/fused_ce.cu",
        replaces="paddle_tpu/kernels/fused_ce.py:177",
        mode="float16 h and W (wgmma .f32.f16.f16)"),
    "fused_ce_dw_fp16": dict(
        source="paddle_tpu_torch/csrc/fused_ce.cu",
        replaces="paddle_tpu/kernels/fused_ce.py:193",
        mode="float16 h and W (wgmma .f32.f16.f16)"),
    "paged_attention_fp16": dict(
        source="paddle_tpu_torch/csrc/paged_attention.cu",
        replaces="paddle_tpu/serving/kernels/paged_attention.py:167",
        mode="float16 q and pools, fp32 math"),
    "paged_attention_int8_fp16": dict(
        source="paddle_tpu_torch/csrc/paged_attention.cu",
        replaces="paddle_tpu/serving/kernels/paged_attention.py:167",
        mode="float16 q, int8 pages + fp32 scales"),
    "mixed_paged_attention_fp16": dict(
        source="paddle_tpu_torch/csrc/paged_attention.cu",
        replaces="paddle_tpu/serving/kernels/paged_attention.py:345",
        mode="float16 q and pools, fp32 math"),
    "mixed_paged_attention_int8_fp16": dict(
        source="paddle_tpu_torch/csrc/paged_attention.cu",
        replaces="paddle_tpu/serving/kernels/paged_attention.py:345",
        mode="float16 q, int8 pages + fp32 scales"),
    "int8_weight_matmul_fp16": dict(
        source="paddle_tpu_torch/csrc/w8_gemm.cu",
        replaces="none: the reference's dequantize is fused by XLA "
                 "(paddle_tpu/serving/engine.py:1074, _dequant_state)",
        mode="float16 x and y, int8 weight, fp32 block scales "
             "(mma.sync / wgmma .f32.f16.f16)"),
    "flash_attention_d256": dict(
        source="paddle_tpu_torch/csrc/flash_attention.cu",
        replaces="paddle_tpu/kernels/flash_attention.py:161",
        mode="head dim 256: float32, bfloat16, float16 (and segment ids)"),
    "flash_attention_bwd_dq_d256": dict(
        source=BWD_SOURCE,
        replaces="paddle_tpu/kernels/flash_attention.py:330",
        mode="head dim 256: float32, bfloat16, float16 (and segment ids)"),
    "flash_attention_bwd_dkv_d256": dict(
        source=BWD_SOURCE,
        replaces="paddle_tpu/kernels/flash_attention.py:366",
        mode="head dim 256: float32, bfloat16, float16 (and segment ids)"),
    "paged_attention_d256": dict(
        source="paddle_tpu_torch/csrc/paged_attention.cu",
        replaces="paddle_tpu/serving/kernels/paged_attention.py:167",
        mode="head dim 256: float32, bfloat16, float16 q over pages of q's "
             "dtype or int8 pages"),
    "mixed_paged_attention_d256": dict(
        source="paddle_tpu_torch/csrc/paged_attention.cu",
        replaces="paddle_tpu/serving/kernels/paged_attention.py:345",
        mode="head dim 256: float32, bfloat16, float16 q over pages of q's "
             "dtype or int8 pages; rows and tiles kernels"),
}
# the entries phase 16 fills (the float16 model's kernels but 1-3)
FP16_MODEL_ENTRIES = ("fused_ce_fwd_fp16", "fused_ce_dh_fp16",
                      "fused_ce_dw_fp16", "paged_attention_fp16",
                      "paged_attention_int8_fp16",
                      "mixed_paged_attention_fp16",
                      "mixed_paged_attention_int8_fp16",
                      "int8_weight_matmul_fp16")
# the float32 and bfloat16 modes of the mixed kernel share one counter;
# each path's launches go to the entry of the dtype it ran (by_mode)
SHARED_COUNTER = {"mixed_paged_attention": "mixed_launches of the float32 "
                  "paths",
                  "mixed_paged_attention_bf16": "mixed_launches of the "
                  "bf16 serving paths (phase 10(b))"}


def by_mode(counts, bf16):
    """A path's launch counts with the shared counters given to the entry
    of the dtype the path ran: the mixed kernel's count to its float32 or
    its bf16 entry, and the int8-weight GEMM's fp32 entry without the bf16
    and float16 modes' launches."""
    counts = dict(counts)
    if "int8_weight_matmul" in counts:
        counts["int8_weight_matmul"] -= (
            counts.get("int8_weight_matmul_bf16", 0)
            + counts.get("int8_weight_matmul_fp16", 0))
    if bf16:
        counts["mixed_paged_attention"] = 0
    elif "mixed_paged_attention_bf16" in counts:
        counts["mixed_paged_attention_bf16"] = 0
    return counts


def tier2_numbers(name, cases):
    """A phase-3c entry's numbers: its first timed case (the mixed-step
    shape, or the decode shape for kernel 7's int8 mode), the suffix
    prefill's time beside it where it was timed, and the largest error
    over the entry's cases."""
    timed = [r for r in cases if "ms" in r]
    # float32 queries' error; the bfloat16 cases' beside it (int8 modes)
    fp32 = [r["max_abs_err"] for r in cases if "float32" in r["case"]]
    bf16 = [r["max_abs_err"] for r in cases if "bfloat16" in r["case"]]
    numbers = dict(ms=timed[0]["ms"], plain_ms=timed[0]["plain_ms"],
                   bound_ms=timed[0]["bound_ms"],
                   bound_by=timed[0]["bound_by"], library_ms=None,
                   library=timed[0]["library"],
                   max_abs_err=max(fp32 or bf16),
                   timed_case=timed[0]["case"], split=timed[0]["split"])
    if fp32 and bf16:
        numbers["max_abs_err_bf16"] = max(bf16)
    if len(timed) > 1:
        numbers["suffix_prefill"] = {
            k: timed[1][k] for k in ("case", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "split")}
    errs = [r["vs_unquantized_err"] for r in cases
            if "vs_unquantized_err" in r]
    if errs:
        numbers["max_abs_err_vs_unquantized"] = max(errs)
    if name in SHARED_COUNTER:
        numbers["launches_counter"] = SHARED_COUNTER[name]
    return numbers


def fused_numbers(name, cases, ptxas):
    """A fused-CE entry's numbers: the bf16 training shape's times and
    errors, with the float32 T = 1024 case's time and bound beside them
    and the float32 training shape's numbers (``train32``), and ptxas's
    report of the entry's bf16 wgmma kernels and float32 kernels."""
    part = name.rsplit("_", 1)[1]
    timed = next(r for r in cases if "fwd_ms" in r
                 and r["case"].endswith("bfloat16"))
    fp32 = next(r for r in cases if "fwd_ms" in r
                and r["case"].startswith("fused_ce T=1024 ")
                and r["case"].endswith("float32"))
    train32 = next(r for r in cases if "fwd_ms" in r
                   and r["case"].startswith("fused_ce T=%d "
                                            % (TRAIN_BATCH * TRAIN_SEQ))
                   and r["case"].endswith("float32"))
    err_key = "loss" if part == "fwd" else part
    plain, unfused = (("plain_fwd_ms", "unfused_fwd_ms") if part == "fwd"
                      else ("plain_bwd_ms", "unfused_fwd_bwd_ms"))
    numbers = dict(ms=timed[part + "_ms"], plain_ms=timed[plain],
                   bound_ms=timed[part]["bound_ms"],
                   bound_by=timed[part]["bound_by"],
                   library_ms=timed["library_ms"][part],
                   library=timed["library"], unfused_ms=timed[unfused],
                   max_abs_err=timed["max_abs_err"][err_key],
                   max_abs_err_fp32=max(
                       r["max_abs_err"][err_key] for r in cases
                       if r["case"].endswith("float32")),
                   ms_fp32=fp32[part + "_ms"],
                   bound_ms_fp32=fp32[part]["bound_ms"],
                   library_ms_fp32=fp32["library_ms"][part],
                   timed_case_fp32=fp32["case"], timed_case=timed["case"],
                   train32=dict(case=train32["case"],
                                ms=train32[part + "_ms"],
                                plain_ms=train32[plain],
                                bound_ms=train32[part]["bound_ms"],
                                bound_by=train32[part]["bound_by"],
                                library_ms=train32["library_ms"][part],
                                unfused_ms=train32[unfused]))
    wgmma = {"fwd": ("fce_fwd_wgmma",),
             "dh": ("fce_bwd_dl_wgmma", "fce_bwd_dh_wgmma"),
             "dw": ("fce_bwd_dw_wgmma",)}   # the bf16 kernels of each part
    simt = {"fwd": ("fce_fwd_partial", "fce_fwd_combine"),
            "dh": ("fce_bwd_dl", "fce_bwd_dh", "fce_bwd_dh64"),
            "dw": ("fce_bwd_dw",)}          # the float32 ones
    numbers["ptxas_bf16"] = [r for r in ptxas if r["kernel"] in wgmma[part]]
    numbers["ptxas_fp32"] = [r for r in ptxas if r["kernel"] in simt[part]]
    return numbers


def segmented_numbers(name, cases):
    """A segment-mode entry's numbers: the training shape (a), bf16, with
    the shuffled float32 shape (b) beside it; errors over every case."""
    part = {"flash_attention_segmented": "fwd",
            "flash_attention_bwd_dq_segmented": "dq",
            "flash_attention_bwd_dkv_segmented": "dkv"}[name]
    ms_key = "ms" if part == "fwd" else part + "_ms"
    plain, library = (("plain_ms", "library_ms") if part == "fwd"
                      else ("plain_bwd_ms", "library_bwd_ms"))
    timed = [r for r in cases if "ms" in r]
    a, b = timed
    return dict(ms=a[ms_key], plain_ms=a[plain],
                bound_ms=a[part]["bound_ms"], bound_by=a[part]["bound_by"],
                library_ms=a[library],
                library_fwd_bwd_ms=a["library_fwd_bwd_ms"],
                library=a["library"],
                max_abs_err=max(r["max_abs_err"][part] for r in cases
                                if "float32" in r["case"]),
                max_abs_err_bf16=max(r["max_abs_err"][part] for r in cases
                                     if "bfloat16" in r["case"]),
                visible_pairs=a["visible_pairs"],
                causal_pairs=a["causal_pairs"], timed_case=a["case"],
                shuffled=dict(case=b["case"], ms=b[ms_key],
                              plain_ms=b[plain], library_ms=b[library],
                              bound_ms=b[part]["bound_ms"],
                              bound_by=b[part]["bound_by"]))


def forward_bf16_numbers(rows):
    """The bf16 forward beside the fp32 serving row: its error over every
    bf16 case, the timed training-shape rows (16 and 6 heads) and ptxas's
    report of both forward kernels."""
    cases = rows["flash_attention"]
    keys = ("case", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    timed = [{k: r[k] for k in keys} for r in cases
             if "ms" in r and "bfloat16" in r["case"]]
    return dict(max_abs_err_bf16=max(r["max_abs_err"] for r in cases
                                     if "bfloat16" in r["case"]),
                lse_max_abs_err=max(r["lse_max_abs_err"] for r in cases),
                train_bf16=timed,
                ptxas=rows["ptxas"]["flash_attention"])


def encoder_numbers(name, rows):
    """Phase 12's cases of a kernel entry (kernels 1-3 at the encoders'
    attention, 4-6 at ERNIE's fused MLM tail), or None."""
    if name.endswith("_fp16"):      # phase 12 runs no float16 case
        return None
    flash = {"flash_attention": "fwd", "flash_attention_bwd_dq": "dq",
             "flash_attention_bwd_dkv": "dkv"}
    if name in flash:
        part, cases = flash[name], rows["flash"]
        plain, library = (("plain_fwd_ms", "library_fwd_ms") if part == "fwd"
                          else ("plain_bwd_ms", "library_bwd_ms"))
        err_key = part
    elif name.startswith("fused_ce"):
        part, cases = name.rsplit("_", 1)[1], rows["fused_ce"]
        plain = "plain_fwd_ms" if part == "fwd" else "plain_bwd_ms"
        library, err_key = None, "loss" if part == "fwd" else part
    else:
        return None
    return [dict(case=r["case"], ms=r[part + "_ms"],
                 device_ms=r["device_ms"][part], plain_ms=r[plain],
                 library_ms=(r[library] if library
                             else r["library_ms"][part]),
                 bound_ms=r[part]["bound_ms"], bound_by=r[part]["bound_by"],
                 max_abs_err=r["max_abs_err"][err_key],
                 **({"tma_copies": r["tma_copies"]} if "tma_copies" in r
                    else {}))
            for r in cases]


def fp16_numbers(name, rows):
    """A float16 entry's numbers: phase 15(a) at llama1b's training
    attention, ERNIE's beside it, and ptxas's report of its kernels."""
    part = {"flash_attention_fp16": "fwd",
            "flash_attention_bwd_dq_fp16": "dq",
            "flash_attention_bwd_dkv_fp16": "dkv"}[name]
    plain, library = (("plain_fwd_ms", "library_fwd_ms") if part == "fwd"
                      else ("plain_bwd_ms", "library_bwd_ms"))
    kernel = {"fwd": "flash_fwd_wgmma", "dq": "flash_bwd_dq_wgmma",
              "dkv": "flash_bwd_dkv_wgmma"}[part]

    def brief(r):
        return dict(case=r["case"], ms=r[part + "_ms"],
                    device_ms=r["device_ms"][part], plain_ms=r[plain],
                    library_ms=r[library], bound_ms=r[part]["bound_ms"],
                    bound_by=r[part]["bound_by"])

    llama, ernie = rows["fp16"]
    source = "flash_attention" if part == "fwd" else "flash_attention_bwd"
    return dict(brief(llama), library=llama["library"],
                max_abs_err=max(r["max_abs_err"][part] for r in rows["fp16"]),
                timed_case=llama["case"], ernie=brief(ernie),
                ptxas=[r for r in rows["ptxas"][source]
                       if r["kernel"].startswith(kernel + "_kernel<")
                       and r["kernel"].endswith(", f16>")])


def fp16_model_numbers(name, rows):
    """A phase-16(a) entry's numbers: kernels 4-6 at llama1b's float16
    tail (timed) with every scale's masks beside, kernels 7-8 at their
    table rows' shapes (the decode batch or mixed step (a) timed, the
    suffix prefill (b) beside), kernel 10 per llama1b layer at M = 16 and
    256; the largest error over the entry's cases; ptxas's report of its
    float16 kernels."""
    got = rows["fp16_model"]
    ptxas = rows["ptxas"]
    if name.startswith("fused_ce"):
        part = name.split("_")[2]
        r = got["fused_ce_fp16"][0]
        err_key = "loss" if part == "fwd" else part
        plain, unfused = (("plain_fwd_ms", "unfused_fwd_ms") if part == "fwd"
                          else ("plain_bwd_ms", "unfused_fwd_bwd_ms"))
        scales = [{"case": c["case"], **{
            tag: {k: v for k, v in sub.items() if k in ("g", "dh", "dw")}
            for tag, sub in c["scales"].items()}}
            for c in got["fused_ce_fp16_scales"]]
        errs = [r["max_abs_err"][err_key]] + [
            c["loss_err"] if part == "fwd" else
            max(sub[part]["max_abs_err"] for sub in c["scales"].values())
            for c in got["fused_ce_fp16_scales"]]
        kernels = {"fwd": ("fce_fwd_wgmma",),
                   "dh": ("fce_bwd_dl_wgmma", "fce_bwd_dh_wgmma"),
                   "dw": ("fce_bwd_dw_wgmma",)}[part]
        return dict(ms=r[part + "_ms"], device_ms=r["device_ms"][part],
                    plain_ms=r[plain], bound_ms=r[part]["bound_ms"],
                    bound_by=r[part]["bound_by"],
                    library_ms=r["library_ms"][part], library=r["library"],
                    unfused_ms=r[unfused], max_abs_err=max(errs),
                    timed_case=r["case"], scales=scales,
                    ptxas=[x for x in ptxas["fused_ce"]
                           if x["kernel"] in ["%s<f16>" % k
                                              for k in kernels]])
    if name.startswith("int8_weight_matmul"):
        numbers = w8_layer_numbers(got[name], bf16=True, half="fp16")
        numbers["ptxas"] = [x for x in ptxas["w8_gemm"]
                            if x["kernel"].startswith(W8_BF16_KERNELS)
                            and x["kernel"].endswith(", f16>")]
        return numbers
    cases = got[name]
    timed = [r for r in cases if "ms" in r]
    keys = ("case", "ms", "plain_ms", "bound_ms", "bound_by", "split")
    numbers = dict(ms=timed[0]["ms"], plain_ms=timed[0]["plain_ms"],
                   bound_ms=timed[0]["bound_ms"],
                   bound_by=timed[0]["bound_by"], library_ms=None,
                   library=timed[0]["library"],
                   max_abs_err=max(r["max_abs_err"] for r in cases),
                   timed_case=timed[0]["case"], split=timed[0]["split"])
    if "device_ms" in timed[0]:
        numbers["device_ms"] = timed[0]["device_ms"]
    if len(timed) > 1:
        numbers["suffix_prefill"] = {k: timed[1][k] for k in keys}
    errs = [r["vs_unquantized_err"] for r in cases
            if "vs_unquantized_err" in r]
    if errs:
        numbers["max_abs_err_vs_unquantized"] = max(errs)
    kind = "paged_decode" if name.startswith("paged") else "mixed_paged"
    pool = "f16, int8" if "int8" in name else "f16, f16"
    numbers["ptxas"] = [x for x in ptxas["paged_attention"]
                        if x["kernel"].startswith(kind)
                        and x["kernel"].split("<")[-1].startswith(pool)]
    return numbers


def summary(rows, paths):
    """``paths``: each main path's launch counts, ``{path: {kernel: N}}``;
    an entry's ``launches`` sums them over the paths."""
    out = []
    for name, meta in KERNELS.items():
        by_path = {path: counts[name] for path, counts in paths.items()
                   if name in counts}
        if name in D256_ENTRIES:
            numbers = d256_numbers(name, rows, rows["ptxas"])
        elif name in FP16_MODEL_ENTRIES:
            numbers = fp16_model_numbers(name, rows)
        elif name.startswith("int8_weight_matmul"):
            bf16 = name.endswith("_bf16")
            numbers = w8_layer_numbers(rows[name], bf16=bf16)
            numbers["ptxas"] = [
                r for r in rows["ptxas"]["w8_gemm"]
                if r["kernel"].startswith(W8_BF16_KERNELS) == bf16
                and not r["kernel"].endswith(", f16>")]
        elif name.endswith("_segmented"):
            numbers = segmented_numbers(name, rows["segmented"])
        elif name.endswith("_fp16"):
            numbers = fp16_numbers(name, rows)
        elif name.startswith("fused_ce"):
            numbers = fused_numbers(name, rows["fused_ce"],
                                    rows["ptxas"]["fused_ce"])
        elif name == "mma_probe":
            timed = rows["mma_probe"][0]
            numbers = dict(ms=timed["ms"], plain_ms=timed["plain_ms"],
                           bound_ms=timed["bound_ms"],
                           bound_by=timed["bound_by"],
                           library_ms=timed["library_ms"],
                           max_abs_err=timed["max_abs_err"],
                           timed_case=timed["case"])
        elif name.endswith("_int8") or name.startswith("mixed"):
            numbers = tier2_numbers(name, rows[name])
        elif name.startswith("flash_attention_bwd"):
            # the bf16 training shape, the float32 one beside it; the plain
            # and library times cover dq, dk and dv together
            part = name.rsplit("_", 1)[1]
            cases = rows["flash_attention_bwd"]
            timed = [r for r in cases if part in r]
            bf16 = next(r for r in timed if " H=16 " in r["case"]
                        and r["case"].endswith("bfloat16"))
            fp32 = next(r for r in timed if r["case"].endswith("float32"))
            bench = next(r for r in timed if " H=6 " in r["case"])

            def brief(r):
                return dict(case=r["case"], ms=r[part + "_ms"],
                            plain_ms=r["plain_ms"],
                            bound_ms=r[part]["bound_ms"],
                            bound_by=r[part]["bound_by"],
                            library_ms=r["library_ms"])

            fp32_err = max(r["max_abs_err"][part] for r in cases
                           if r["case"].endswith("float32"))
            bf16_err = max(r["max_abs_err"][part] for r in cases
                           if r["case"].endswith("bfloat16"))
            ptxas = rows["ptxas"]["flash_attention_bwd"]
            numbers = dict(ms=bf16[part + "_ms"], plain_ms=bf16["plain_ms"],
                           bound_ms=bf16[part]["bound_ms"],
                           bound_by=bf16[part]["bound_by"],
                           library_ms=bf16["library_ms"],
                           max_abs_err=fp32_err, max_abs_err_bf16=bf16_err,
                           timed_case=bf16["case"], fp32_train=brief(fp32),
                           bench_row=brief(bench),
                           ptxas_bf16=[r for r in ptxas if "_%s_wgmma" % part
                                       in r["kernel"]],
                           ptxas_fp32=[r for r in ptxas if "_%s_f32" % part
                                       in r["kernel"]])
        else:
            # the timed fp32 case with the most work: llama1b's largest
            # prefill bucket, and the decode batch without GQA
            timed = max((r for r in rows[name] if "ms" in r
                         and r["case"].endswith("float32")),
                        key=lambda r: r["bound_ms"])
            fp32_err = max(r["max_abs_err"] for r in rows[name]
                           if r["case"].endswith("float32"))
            numbers = dict(ms=timed["ms"], plain_ms=timed["plain_ms"],
                           bound_ms=timed["bound_ms"],
                           bound_by=timed["bound_by"],
                           library_ms=timed["library_ms"],
                           max_abs_err=fp32_err, timed_case=timed["case"])
            if name == "flash_attention":
                numbers.update(forward_bf16_numbers(rows))
            if name in rows["generate"]:
                # phase 11's shapes: the rectangular prefills (kernel 1),
                # GPT-2's decode batch (kernel 7)
                keys = ("case", "ms", "device_ms", "plain_ms", "library_ms",
                        "bound_ms", "bound_by", "max_abs_err")
                numbers["generate"] = [{k: r[k] for k in keys}
                                       for r in rows["generate"][name]]
            if name == "paged_attention":
                # the split plan, the lone 2048-token slot and the bf16
                # mode (bf16 q and pools, phase 3c) beside it, and ptxas's
                # report of every paged kernel (split and combine)
                lone = next(r for r in rows[name] if r["lens"] == LONE_SLOT)
                bf16 = rows["paged_attention_bf16"][0]
                numbers.update(
                    device_ms=timed["device_ms"], split=timed["split"],
                    lone_slot={k: lone[k] for k in ("ms", "plain_ms",
                                                    "bound_ms")},
                    bf16={k: bf16[k] for k in (
                        "case", "ms", "device_ms", "plain_ms", "bound_ms",
                        "bound_by", "max_abs_err", "split")},
                    ptxas=rows["ptxas"]["paged_attention"])
        encoders = encoder_numbers(name, rows["encoders"])
        if encoders:
            numbers["encoders"] = encoders
        out.append(dict(name=name, route="cuda", **meta,
                        launches=sum(by_path.values()),
                        launches_by_path=by_path, **numbers))
    return {"kernels": out}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only-phase-17", action="store_true",
                    help="phases 1, 2 and 17 alone (no summary line)")
    ap.add_argument("--only-phase-18", action="store_true",
                    help="phases 1, 2 and 18 alone (no summary line)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    card = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    ptxas = phase_build()
    if args.only_phase_17:
        phase_ops_o2(args.seed)
        return
    if args.only_phase_18:
        phase_head_dim_256(args.seed)
        return
    rows = phase_kernels(args.seed)
    rows["ptxas"] = ptxas
    fused_rows, probe = phase_fused_kernels(args.seed)
    rows.update(fused_rows)
    rows.update(phase_tier2_kernels(args.seed))
    rows.update(phase_segmented_kernels(args.seed))
    torch.cuda.empty_cache()
    model, prompt, card_tokens, serving = phase_slice(args.seed)
    cpu_model = phase_e2e(model, prompt, card_tokens)
    torch.cuda.empty_cache()
    tier2 = phase_tier2_slice(args.seed, model)
    phase_tier2_e2e(args.seed, model, cpu_model)
    rows["generate"], gen_paths, _ = phase_generate(args.seed, model,
                                                    cpu_model, card)
    rows["int8_weight_matmul"] = phase_w8_kernel(args.seed, model)
    quant_paths = phase_quant_decode(args.seed, model, cpu_model)
    torch.cuda.empty_cache()
    _, bench_paths = phase_serving_bench(args.seed, model)
    del cpu_model
    phase_replay(args.seed, model)
    del model
    torch.cuda.empty_cache()
    w8_bf16_rows, _, bf16_paths = phase_bf16_serving(args.seed, card)
    rows["int8_weight_matmul_bf16"] = w8_bf16_rows
    train = phase_train(args.seed)
    torch.cuda.empty_cache()
    train_fused = phase_train(args.seed, fused=True)
    check_fused_train(train, train_fused)
    torch.cuda.empty_cache()
    bench = phase_bench_fused(args.seed)
    torch.cuda.empty_cache()
    varlen = phase_varlen(args.seed)
    torch.cuda.empty_cache()
    train32 = phase_train(args.seed, dtype="float32")
    torch.cuda.empty_cache()
    train32_fused = phase_train(args.seed, fused=True, dtype="float32")
    check_fused_train(train32, train32_fused, FUSED32_LOSS_RTOL)
    torch.cuda.empty_cache()
    phase_train_e2e(args.seed)
    phase_train_e2e(args.seed, fused=True)
    phase_train_e2e_variant(args.seed)
    torch.cuda.empty_cache()
    rows["encoders"], encoder_paths, _ = phase_encoders(args.seed)
    torch.cuda.empty_cache()
    _, resnet_paths, _ = phase_resnet(args.seed, card)
    torch.cuda.empty_cache()
    _, seq2seq_paths, _ = phase_seq2seq(args.seed, card)
    torch.cuda.empty_cache()
    rows["fp16"], amp_paths, _ = phase_amp(args.seed, ptxas)
    torch.cuda.empty_cache()
    rows["fp16_model"], fp16_paths, _ = phase_fp16_model(args.seed)
    torch.cuda.empty_cache()
    rows["ops"], o2_paths, _ = phase_ops_o2(args.seed)
    torch.cuda.empty_cache()
    rows["d256"], d256_paths, _ = phase_head_dim_256(args.seed)
    paths = {"serving": serving, "train": train["launches"],
             "train_fused": train_fused["launches"], "probe": probe,
             "bench_fused": bench["launches"], "varlen": varlen["launches"],
             "train_fp32": train32["launches"],
             "train_fp32_fused": train32_fused["launches"]}
    paths.update({"tier2 " + tag: run["launches"]
                  for tag, run in tier2.items()})
    paths.update(quant_paths)
    paths.update(gen_paths)
    paths.update(bench_paths)
    paths.update(encoder_paths)
    paths.update(resnet_paths)
    paths.update(seq2seq_paths)
    paths.update(amp_paths)
    paths.update(fp16_paths)
    paths.update(o2_paths)
    paths.update(d256_paths)
    paths = {path: by_mode(counts, bf16=False)
             for path, counts in paths.items()}
    paths.update({path: by_mode(counts, bf16=True)
                  for path, counts in bf16_paths.items()})
    log("[total] chip_smoke.py in %.1f s" % (time.perf_counter() - t_start))
    log(json.dumps(summary(rows, paths)))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

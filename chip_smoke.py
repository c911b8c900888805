#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases (every one must pass; the script exits non-zero otherwise and then
prints no result line):

1. device  — the card's name and power limit (nvidia-smi), capability 9.0;
2. build   — ``nvcc`` builds every kernel from ``src/repro_torch/kernels/csrc``
             (``LATE_BUILDS``, ``ssm_scan.cu``'s minute, in a background
             thread that phase 16's ``build_late`` joins);
3. kernel  — ``packed_sq_norms`` on the card against its plain PyTorch
             version and a float64 reference (ragged sizes, f32 and bf16
             leaves, NaN in the pad, NaN in real data, ||a|| = 0, two
             launches bit-identical); tolerance: relative 1e-5 on each sum;
4. main    — ``ttrace_check`` over one training step of full-width
             ``gpt-paper`` (12 layers, d 512, vocab 50304) at B 8 x S 1024
             with bf16 thresholds must PASS, launching the kernel on the
             estimate and on the compare; then the same step of a reduced
             fp32 ``gpt-paper`` on the card must PASS against the port on
             the CPU under f32 thresholds;
5. control — a candidate whose ``layers.5.mlp.down.w`` is doubled must FAIL
             and be localized to ``layers.5.mlp``;
6. timing  — the compare section's reduction: the kernel, its plain
             version and a library yardstick, beside the bound;
7. fp8_kernel  — ``fp8_matmul`` and ``fp8_matmul_tile128`` (one CUDA
             source: TMA loads, products on the f16 tensor cores from an
             exact e4m3 upcast) on the card against their plain versions
             and a float64 product of the dequantized operands, at the main
             path's shapes (8192 x 512 x 2048 and 8192 x 2048 x 512) and
             the reference tests' shapes (M 8, N 192 and K 64 and 384
             among them); bound on each element:
             |kernel - f64| <= K * 2^-23 * (|xd| @ |wd|); two launches
             bit-identical; shapes outside the reference's contract raise,
             and so do operands within it that break TMA's 16-byte rules
             (K 8, N 8, an unaligned base), before any launch;
8. fp8_main    — the FP8 recipe check of the same full-width model and
             batch: ``make_fp8_runner`` candidates for ``tile128`` and
             ``global`` must PASS under the fp8 epsilon, each launching its
             kernel exactly 36 times (3 MLP matmuls x 12 layers) per
             candidate run;
9. fp8_control — ``fp8_stale_scale`` with tile128 must FAIL and be
             localized to the registry's ``layers.*.mlp``;
10. fp8_timing — each fp8 kernel per launch at the main path's two
             shapes (CUDA events, the card held busy while the launches
             are queued; the wrapper's back-to-back time beside it), its
             plain version and the library calls timed the same way:
             ``torch._scaled_mm`` (global: also with ``use_fast_accum``;
             tile128: with block scales, and
             ``torch.nn.functional.scaled_mm`` with ``BlockWise1x128`` and
             ``BlockWise128x128`` scales where the installed torch has it;
             refusals logged), each with its error against float64 and
             against phase 7's bound, all without deterministic mode's
             fill of new buffers (each kernel and library call also with
             it); beside the bound, the kernel's share
             of it and its executed TFLOP/s; the registers, spills and
             dynamic shared memory of each build;
11. flash_kernel — ``flash_attention`` on the card against its plain
             version and a float64 ``attention_ref``: bf16 (the TMA + wgmma
             kernel) causal at the main path's shape (8 x 1024, 8 heads of
             64), the long path's (2 x 4096), a GQA shape at
             tinyllama-1.1b's heads (2 x 2048, 32 heads, 4 kv), a D 128
             GQA one (1 x 1024, 64 heads, 8 kv), and the D 80 paths of
             25a (1 x 4096, 64 heads, 8 kv, causal) and 25d (2 x 1024, 16
             heads, bidirectional); then the reference tests' sweep, D 80
             and D 112 shapes (the columns past D from TMA's zero fill)
             and four ragged-S shapes (S 100 and 200, rows past S from
             TMA's zero fill) in every mode, in bf16 and in f32 (the FMA
             kernel); f32 within 2e-5 of float64, bf16
             within half a bf16 ulp (plus 2e-5); each case's entry point
             logged and checked against its dtype; two launches
             bit-identical; out-of-contract shapes and operands raise,
             bf16 ones that break TMA's 16-byte rules included;
12. flash_main — the flash-attention candidate (``trace_fn_step`` over
             ``loss(use_kernel=True)``) of the same model and batch must
             PASS under bf16 thresholds, launching the kernel 12 times (one
             per layer) per candidate run;
13. flash_long — the same check at B 2 x S 4096: the reference takes
             ``attention_blockwise`` and the chunked CE, the candidate the
             kernel and the chunked CE (counted); must PASS, 12 launches;
14. flash_control — the flash candidate with
             ``layers.3.self_attention.linear_qkv.w`` doubled must FAIL and
             be localized to ``layers.3.self_attention`` (24 launches);
15. flash_timing — the bf16 kernel per launch at the main and long
             shapes, causal, and at 25a's (causal) and 25d's
             (bidirectional) D 80 shapes (CUDA events, the card held busy
             while the launches
             are queued, so the wrapper's host time does not show; the
             wrapper's back-to-back time beside it), its plain version and
             ``scaled_dot_product_attention`` timed the same way as the
             library yardstick (as the script runs it, in deterministic
             mode, and under each of its backends with that mode off),
             beside the bound (4 D flops per unmasked
             pair), the kernel's share of it and its executed TFLOP/s (6 D
             flops per unmasked pair: p v is taken as p_hi v + p_lo v; at
             D 80, 2 D + 4 x 128: p v runs over whole 64-column boxes); the
             registers, shared memory and spills of each build; the share
             of a consumer warpgroup's SM cycles each phase takes (one
             launch of the profiled build, ``clock64``);
15a. dist_main — the paper's distributed candidate of the same model and
             batch, ``parallel.api.make_candidate_runner`` with dp 2, cp 2,
             tp 2 and sp (8 ranks emulated in one process), checked by
             ``ttrace_check`` against the plain model under bf16
             thresholds, must PASS, launching the rel-err kernel on the
             estimate and on the compare; prints the largest rel-err over
             threshold, each step's seconds and the peak device memory; a
             second candidate run must give a bit-identical trace;
15b. dist_zero1 — the same check of the dp 2, tp 2, ZeRO-1 candidate must
             PASS;
15c. dist_control — ``tp_wrong_embedding_mask`` (dp 2, tp 2) must FAIL and
             be localized to ``embedding*``, and ``sp_stale_wgrad`` (dp 2,
             tp 2, sp), a gradient-only bug, to
             ``layers.*.self_attention*``;
16. ssm_kernel — ``gla_scan`` on the card against its plain version run in
             float64: the reference tests' sweep in f32 within 5e-4
             absolute; rwkv6-7b's time-mix shape (2 x 4096, 64 heads of 64,
             chunk 128, per-channel exclusive) and zamba2-7b's mixer shape
             (112 heads, scalar inclusive), bf16 q/k/v and f32 log_w,
             within 1e-5 normwise, as are a 60-wide shape that takes the
             kernel's scalar staging and the zamba2 check's own operands
             (1 x 4096, q and k broadcast over 112 heads, head stride 0);
             two launches bit-identical; out-of-contract shapes and
             operands raise;
17. ssm_main — ``ttrace_check`` of full-width rwkv6-7b cut to 2 layers at
             B 2 x S 4096 under bf16 thresholds: the reference is the plain
             model, the candidate the same model with ``models.ssm.lin_attn``
             bound to ``kernels.ops.gla_scan`` for its forward; must PASS
             with 2 launches per candidate run and none in the reference;
             prints the peak device memory;
18. ssm_control — that candidate with ``layers.1.time_mix.key.w`` doubled
             must FAIL and be localized to ``layers.1.time_mix`` or a
             module inside it (4 launches): the time mix is invariant to
             the scale of k up to its group norm's epsilon, so at bf16
             thresholds only that weight's gradients and update may flag,
             and the checker then names its linear, ``.key``;
19. ssm_timing — the kernel per launch at the rwkv6 and zamba2 shapes
             and on the zamba2 check's broadcast operands (CUDA events, the card held busy, without deterministic
             mode's fill of new buffers; with it, and back to back,
             beside), its plain version and the bound (no single PyTorch
             call computes it); the kernel's share of the bound, its
             executed TF32 rate and this design's TF32 floor; the
             registers, spills and shared memory of each build; each
             pass's time and the share of a block's SM cycles each phase
             takes (one launch of the profiled build, ``clock64``).

20a. sup_clean (20a-20e run after 15c, before 16, in a temporary work dir
             removed at the end) — the supervised loop
             (``supervise.Supervisor``) over
             ``gpt-paper`` at its published width cut to 4 layers (the
             card machine's disk: see ``SUP_LAYERS``), B 8 x S 1024, seed 0,
             the dp 2 tp 2 ZeRO-1 candidate, 8 steps with a check every
             step, 2 in flight, a checkpoint every 2 steps, a ring window of
             2 and spill on, overlapped: every step must PASS, the rel-err
             kernel launched on the estimate and on every check and no other
             kernel; prints each step's largest rel-err over threshold, its
             reference, candidate and check seconds, the launches, the peak
             device memory against the card's and what the work dir holds;
20b. sup_lockstep — the same run lockstep (spill off): verdicts, every
             rel-err, losses and final states bit-identical to 20a's;
20c. sup_resume — ``python -m repro_torch.launch.supervise`` at 20a's
             config (spill off, a checkpoint every 4 steps) with ``--fault
             crash --fault-step 5`` must die by SIGKILL; ``--resume`` of its
             work dir and an uninterrupted run, through the same CLI code in
             this process, must give the same journaled verdicts and
             rel-errs and bit-identical final states;
20d. sup_late_bug — ``zero_skipped_update`` at ``SUP_LATE_LR``: the
             single-step check at step 0 must PASS, the supervisor (16
             steps, a check every 2, a checkpoint every 4) must flag, and
             bisection must give a first bad step at or before the first
             flagged one;
20e. sup_fp8 — the ``fp8-tile128`` candidate supervised for 4 steps must
             PASS each, launching ``fp8_matmul_tile128`` 3 times a layer per
             candidate step (12 at 4 layers);
21a. pp_staged (21a-21d run after 20e, in its work dir) — the staged
             pipeline candidate of full-width ``gpt-paper``
             (B 8 x S 1024, seed 0, bf16 thresholds) at pp 4 and at pp 5
             (stages of 3 3 2 2 2 layers) must PASS, the rel-err kernel
             launched on the estimate and on the compare and no other;
21b. pp_1f1b — the 1F1B candidate at pp 4 x 4 microbatches (stages
             emulated on the card) must PASS likewise; the engine's
             per-stage op order must be ``stage_op_stream``, its merge
             report clean, no stage's stash deeper than pp - s, a rerun and
             the ordered drive bit-identical to the concurrent one, and the
             plan merge equal to ``merge_microbatch_traces`` of the same
             records bit for bit;
21c. pp_controls — ``pp_wrong_stage_division`` (staged pp 4) and
             ``pp_stale_boundary`` (1F1B) must FAIL at ``layers.3*``, and
             ``pp_microbatch_order`` (1F1B) must FAIL on the gradient
             sections alone, its activations and loss byte-identical to the
             clean engine's;
21d. sup_pp — ``gpt-paper`` at 4 layers, B 8 x S 1024: the ``pp-1f1b``
             recipe at pp 2 x 4 microbatches supervised for 4 steps (spill
             off, one checkpoint) must PASS each, as ``pp1f1b2x4`` with
             kind_scale 2; ``python -m repro_torch.launch.supervise
             --recipe pp --bug pp_wrong_stage_division`` for 4 steps must
             flag with first bad step 0 at a ``layers.*`` module.
22a. moe_main (22a-22d run last, with every earlier model freed) —
             ``mixtral-8x7b`` at its published width (d 4096, 32 heads of
             128, kv 8, 8 experts of d_ff 14336, top 2, capacity factor 2,
             swa window 4096, vocab 32000), cut to 1 layer with tied
             embeddings for memory (``MOE_LAYERS``), B 1 x S 4096, seed 0,
             bf16 thresholds: first the reckoning behind the tied
             embeddings (the untied model's traced reference step and
             clean tp2 check, their peak memory), then one traced
             reference step of the tied model alone (its seconds, peak
             memory and section sizes); then the
             expert-parallel candidates tp2 and tp2 sp must PASS against
             the plain model, the rel-err kernel launched on the estimate
             and on the compare and no other; prints the margin, each
             step's seconds, the peak memory, capacity drops in the
             reference and the candidate, and the tokens whose top-2 (and
             kept) expert set differs between reference and candidate and
             between the estimate's base and perturbed runs; a second tp2
             run must give a bit-identical trace;
22b. moe_control — ``moe_router_not_synced`` at tp2: measured to PASS
             under bf16 thresholds at this width (every threshold is at
             least 12.5% relative; the drift moves the MoE output by about
             1%), so the phase asserts that verdict and that the bug
             expresses (the output differs from the clean tp2
             candidate's); the same control dropless is printed beside;
22c. moe_flash — the flash candidate (``loss(use_kernel=True)``) of the
             same model at B 1 x S 8192, where the window drops keys, must
             PASS against ``attention_blockwise``, one swa launch at window
             4096 per candidate run; then the kernel alone at that shape
             against its plain version (within 2^-6 relative + 4e-5), per
             launch with the card held busy, its plain version and
             ``scaled_dot_product_attention`` with the sliding-window mask,
             beside the bound;
22d. moe_cli — ``python -m repro_torch.launch.supervise --recipe moe
             --reduced --bug moe_router_not_synced`` (spill off) must flag
             at step 0 with first bad step 0 at a ``layers.*.mlp`` module
             (reduced: the CLI checkpoints both full-width states at step
             0, some 44 GB, against the card machine's 45 GiB of writes).
23a. mla_main (23a-23e run after 22d, with every earlier model freed) —
             ``deepseek-v2-236b`` at its published width (d 5120, 128
             heads, MLA with q LoRA 1536, kv LoRA 512, nope 128, rope 64,
             v 128, vocab 102400, untied, bf16) cut to its dense first
             layer (d_ff 12288) for memory, B 1 x S 4096, seed 0: first the
             reckoning (parameters, one traced reference step's seconds,
             peak memory and section sizes), then a clean check (the
             reference runner as candidate) under bf16 thresholds must
             PASS with 5 + 1 rel-err launches and no other kernel, finite
             trace leaves and ``final_norm_out`` of (1, 4096, 5120); prints
             each step's seconds and the peak memory;
23b. mla_control — ``dense_layers.0.self_attention.linear_uq.w`` (the q
             LoRA, a branch only the full config takes) doubled in the
             candidate must FAIL and be localized to layer 0's
             ``self_attention``;
23c. mla_decode — the same model at f32 compute (bf16 parameters) over
             B 4 x T 1024 tokens through ``make_decode_runner``: the naive
             MLA decode (reference) against the absorbed one (candidate),
             ``ttrace_check(estimate=False)`` at f32 eps and margin 64,
             must PASS with every ``decode.final_cache.*`` record
             bit-identical; ``decode_stale_rope_pos`` must FAIL from some
             ``decode.t{t}``, t >= 1, every logit finite; one rel-err
             launch a check; printed beside: the clean pair at bf16
             compute under bf16 eps, each implementation's ms per decode
             step, the cache's 576 values a token against per-head K/V's
             40960, the peak memory;
23d. decode_consistency — full-width ``tinyllama-1.1b`` cut to 11 of its
             22 layers for time (26a trains it at full depth), at f32
             compute, B 2 x 256 tokens: the decode-stepped logits within
             1e-4 normwise of ``forward`` + ``unembed``, and
             ``make_prefill_step``'s of the last decode step's; the values
             at bf16 compute printed beside;
23e. serve_cli — ``python -m repro_torch.launch.serve --batch 4
             --prompt-len 32 --gen 16`` for full-width ``tinyllama-1.1b``
             and ``--reduced`` ``deepseek-v2-236b``, ``mixtral-8x7b`` (the
             sliding-window ring, MoE at decode) and ``rwkv6-7b`` (the
             state continuation) must each exit 0 and print its tokens per
             second.
24a. zamba_main (24a-24d run last, with every earlier model freed) —
             ``zamba2-7b`` at its published width (d 3584, Mamba2 with d_state
             64, heads of 64, expand 2, chunk 128; the shared block's 32
             heads of 112, d_ff 14336; vocab 32000, untied, bf16) cut from
             81 to 12 layers for memory (two groups of 6 Mamba2 layers, the
             shared block used after each: the least depth with two uses),
             B 1 x S 4096, seed 0, bf16 thresholds: first one traced
             reference step alone (its seconds, peak memory and section
             sizes), then the clean check of the plain model against the
             gla_scan candidate (every Mamba2 scan on the kernel's scalar,
             inclusive branch, q and k of head stride 0) must PASS with 12
             launches per candidate run and none in the reference, 5 + 1
             rel-err launches, the shared block's taps once per use and its
             parameters once, all finite; prints each step's seconds, the
             largest rel-err over threshold and the peak memory;
24b. zamba_control_mamba — ``mamba1.0.mixer.out_proj.w`` doubled in the
             candidate must FAIL and be localized to ``layers.6.mixer``;
24c. zamba_control_shared — ``shared_attn.mlp.down.w`` doubled must FAIL
             and be localized to ``shared_attn_0.mlp``, the first use;
24d. zamba_decode, zamba_serve — the 12-layer model's decode path
             (each Mamba2 layer's conv and scan state, each shared use's KV
             cache) stepped over B 2 x 256 tokens at f32 compute within
             1e-4 normwise of ``forward`` + ``unembed`` (bf16 printed
             beside); ``python -m repro_torch.launch.serve --arch zamba2-7b
             --reduced`` must exit 0 and print its tokens per second.
25a. qwen3_main (25a-25e run last, each model freed before the next) —
             ``qwen3-32b`` at its published width (d 5120, 64 heads of 80,
             kv 8, ``qk_norm``, d_ff 25600, vocab 151936, bf16) cut from 64
             layers to 1 with tied embeddings for memory, B 1 x S 4096,
             seed 0, bf16 thresholds: the flash candidate must PASS
             against the plain model (``attention_blockwise``), 1 launch
             per candidate run (bf16, causal, D 80), none in the
             reference, 5 + 1 rel-err launches and no other kernel; then
             (qwen3_control) ``layers.0.self_attention.q_norm`` doubled in
             the candidate must FAIL at ``layers.0.self_attention``;
25b. codeqwen_dist — ``codeqwen1.5-7b`` at its published width (d 4096,
             32 heads of 128, kv 32, ``qkv_bias``, d_ff 13440, vocab 92416,
             untied, bf16) cut from 32 layers to 2, B 1 x S 4096: the tp2
             sp candidate (the bias split with its fused QKV columns) must
             PASS with no kernel but the rel-err one, and a second
             candidate run must be bit-identical; then
             (codeqwen_control) the candidate's
             ``layers.1.self_attention.linear_qkv.b`` shifted by 0.1
             (biases start at zero) must FAIL at
             ``layers.1.self_attention``;
25c. llava_main — ``llava-next-34b`` at its published width (d 7168, 56
             heads of 128, kv 8, d_ff 20480, vocab 64000, vision_dim 1024,
             untied, bf16) cut from 60 layers to 1, B 1 x S 4096: 2880
             patch features (5 anyres tiles x 576) ahead of 1216 text
             tokens, the thresholds from the perturbed ``image_embeds``;
             the flash candidate must PASS with 1 launch per candidate
             run; then (llava_control) ``vision_proj.w`` doubled must
             FAIL at ``embedding``;
25d. hubert_main — ``hubert-xlarge`` at its published width (d 1280, 16
             heads of 80, d_ff 5120 GELU, vocab 504, audio_dim 512, no
             rope, bidirectional, bf16), cut from 48 layers to 24 for time,
             B 2 x S 1024, the thresholds from the perturbed ``features``:
             the flash candidate must PASS with 24 launches per candidate run
             (bf16, bidirectional, D 80); then (hubert_control_mlp)
             ``layers.23.mlp.fc2.w`` doubled must FAIL at
             ``layers.23.mlp`` and (hubert_control_mask) ``mask_embed``
             doubled must FAIL, with ``embedding/output`` under its bf16
             threshold, at the measured ``layers.1.self_attention``
             (``HUBERT_CONTROLS``);
25e. dense_cli — ``python -m repro_torch.launch.serve --reduced`` for
             ``qwen3-32b`` and ``codeqwen1.5-7b`` must exit 0 and print
             their tokens per second, for ``hubert-xlarge`` exit non-zero
             as encoder-only; ``list_configs()`` names the reference's
             eleven configs and ``moonlight-16b-a3b``.
26a. train_main (26a-26c run last) — ``launch.train.main`` in this
             process for ``tinyllama-1.1b`` at its published width and
             depth (22 layers, d 2048, 32 heads, kv 4, d_ff 5632, vocab
             32000, untied, bf16; 1100048384 parameters), 8 steps at
             B 8 x S 128 in 2 microbatches, ``--ttrace-every 4``: the
             step-4 check must PASS with 6 rel-err launches (5 in the
             estimate, 1 in the compare) and no other kernel, over the
             tensors ``check_trace_shapes`` counts; all 8 losses finite;
             no file written; prints each step's synchronized seconds,
             the check's step seconds and the peak device memory;
26b. train_resume — the same width at 2 layers (bf16 parameters):
             ``make_train_step`` at 2 microbatches for 6 steps,
             ``save_checkpoint``, ``load_checkpoint`` and 4 more must be
             bit-identical to 10 uninterrupted steps; then ``python -m
             repro_torch.launch.train --reduced --steps 6 --n-micro 2
             --ttrace-every 3 --save W`` must exit 0 with its check
             PASSing; each checkpoint's size logged, then removed;
26c. rel_err_kernel, rel_err_timing — ``kernels.relerr.sq_norms`` and
             ``ops.rel_err``, the kernel's single-pair layout (one segment
             at 65536 elements a block), at n 1, 65535, 65536, 65537,
             3000017 and 16777259, f32 and bf16 leaves: each sum within
             relative 1e-5 of float64 and of the plain version, a zero
             ``a`` giving ||b||, NaN in real data propagating, exactly one
             launch a call, two launches bit-identical; then the largest
             call per launch (the card held busy) beside the copy to f32
             and the pad, the plain version, two ``vector_norm`` calls and
             the bytes bound.
27a. dryrun_train (27a-27d run last) — ``launch.dryrun.dryrun_config``'s
             meta plan of one train step of full-width, full-depth
             ``tinyllama-1.1b`` at 26a's B 8 x S 128 in 2 microbatches on
             the host mesh, against the same ``make_train_step`` on the
             card, with ``remat`` on (the config's) and off: the planned
             peak (arguments + temp) within 10% of
             ``max_memory_allocated`` (read after
             ``reset_peak_memory_stats``, less the bytes earlier phases
             left allocated), the meta flop count equal to
             ``FlopCounterMode``'s on the card (a second call: the
             counter's module tracker keeps tensors alive), no kernel
             launched, the two losses equal; both peaks and step times
             logged;
27b. dryrun_serve — the same two checks for a ``make_prefill_step`` at
             B 8 x S 2048 and a ``make_serve_step`` at B 32 with 4096
             cached positions of the same model;
27c. dryrun_candidate — ``dryrun_candidate``'s meta plan of
             ``dist_main``'s candidate (full-width ``gpt-paper``,
             dp2·cp2·tp2·sp, B 8 x S 1024, the 8 ranks stacked): its
             collective report (``parallel.mesh.collective_log``) equal to
             one real step's on the card by kind, count and bytes, its
             flops equal, its rank-stacked peak within 10%;
27d. dryrun_cli — ``python -m repro_torch.launch.dryrun`` for
             ``tinyllama-1.1b`` x ``decode_32k`` on the host mesh and
             ``qwen1.5-110b`` x ``decode_32k`` on the single-pod mesh, at
             once, must exit 0; each pair's per-device GiB logged against
             80 GB (the full ``--all`` sweep takes hours of meta ops).

Every kernel's launch count is set to 0 just before each path (phases 4,
8, 12, 13, 14, 15a, 15b, 15c, 17, 18, 20a-20e, 21a-21d, 22a-22c, 23a-23c,
24a-24c, 25a-25d, 26a and 26c) and read just after it.  The ``kernels``
line's ``packed_sq_norms`` launches are phase 4's, 26a's and 26c's, its
``gla_scan`` launches phase 17's and 24a's, its ``flash_attention``
launches phase 12's, 22c's, 25a's, 25c's and 25d's, ``launches_by_path``
beside each.  At the end come the card's name and power
limit, then a ``{"kernels": [...]}`` JSON object, then the last line,
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback

# cuBLAS needs this before its first use for deterministic algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# the rwkv6-7b phases hold several traces of a 0.98 B-parameter model at
# once; growable segments keep the allocator's cache from fragmenting
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_FLOPS = 67e12                  # H100 SXM float32 outside tensor cores
FP8_FLOPS = 1979e12                # H100 SXM fp8 tensor cores, dense
REL_TOL = 1e-5                     # on each sum, against float64
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/relerr.cu"
KERNEL_REPLACES = "src/repro/kernels/relerr.py:101"
FP8_SOURCE = "src/repro_torch/kernels/csrc/fp8_matmul.cu"
FP8_REPLACES = {"fp8_matmul": "src/repro/kernels/fp8_matmul.py:56",
                "fp8_matmul_tile128": "src/repro/kernels/fp8_matmul.py:109"}
# the MLP matmuls of full-width gpt-paper at 8 x 1024 tokens, (M, K, N),
# and how many of each one candidate forward launches
FP8_MAIN_SHAPES = (((8192, 512, 2048), 24), ((8192, 2048, 512), 12))
FP8_LAUNCHES_PER_RUN = 36
BF16_FLOPS = 989e12                # H100 SXM bf16 tensor cores, dense
TF32_FLOPS = 495e12                # H100 SXM tf32 tensor cores, dense
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:110"
FLASH_LAUNCHES_PER_RUN = 12        # one per layer of full-width gpt-paper
FLASH_F32_TOL = 2e-5               # absolute, against float64 (test_kernels)
# (B, S, H, Hkv, D): the main path's attention, the long path's, a GQA
# shape at tinyllama-1.1b's heads and a D 128 GQA one (64 heads, 8 kv)
FLASH_MAIN = (8, 1024, 8, 8, 64)
FLASH_LONG = (2, 4096, 8, 8, 64)
FLASH_BF16_SHAPES = (FLASH_MAIN, FLASH_LONG, (2, 2048, 32, 4, 64),
                     (1, 1024, 64, 8, 128))
# the D 80 paths of phases 25a (qwen3-32b, causal) and 25d (hubert-xlarge,
# bidirectional) at their own shapes, bf16
FLASH_QWEN3 = (1, 4096, 64, 8, 80)
FLASH_HUBERT = (2, 1024, 16, 16, 80)
FLASH_PATHS = ((FLASH_QWEN3, "causal"), (FLASH_HUBERT, "bidirectional"))
# the reference tests' sweep (tests/test_kernels.py), the head dims off a
# multiple of 64 (80 and 112: the columns past D come from TMA's zero fill
# in bf16, the FMA kernel's partial column groups in f32) and four ragged
# S, whose rows past S the bf16 kernel's TMA fills with zeros; every mode,
# both dtypes
FLASH_SWEEP_SHAPES = ((1, 128, 2, 2, 64), (2, 256, 4, 2, 64),
                      (1, 256, 8, 2, 128), (1, 128, 4, 1, 64),
                      (1, 256, 4, 2, 80), (2, 128, 4, 4, 112),
                      (1, 100, 4, 2, 64), (1, 200, 4, 1, 128),
                      (1, 100, 4, 2, 80), (1, 200, 4, 1, 112))
FLASH_MODES = (("causal", 0), ("swa", 64), ("bidirectional", 0))
# the distributed candidates of full-width gpt-paper (8 x 1024): the main
# one on 8 emulated ranks, ZeRO-1, and the controls with the bug each injects
DIST_MAIN = dict(dp=2, cp=2, tp=2, sp=True)
DIST_ZERO1 = dict(dp=2, tp=2, zero1=True)
DIST_CONTROLS = (("tp_wrong_embedding_mask", dict(dp=2, tp=2)),
                 ("sp_stale_wgrad", dict(dp=2, tp=2, sp=True)))
# the supervised loop over full-width gpt-paper (phases 20a-20e): the batch,
# the depth, the dp2 tp2 ZeRO-1 candidate, the clean run's config and the
# late bug's lr.  The depth is cut from 12 to 4 layers for the disk: by the
# tensors' sizes a spilled trace pair of 12 layers takes 4.95 GB and a
# checkpoint of both states 2.44 GB, and a card machine may write 45 GiB in
# all (deleted files count), which phase 20a alone would nearly fill
SUP_BATCH = (8, 1024)
SUP_LAYERS = 4
SUP_PCFG = dict(dp=2, tp=2, zero1=True)
SUP_SCFG = dict(check_every=1, async_window=2, ckpt_every=2, ring_window=2,
                spill=True)
# the late bug's lr: the single-step check is blind and the loop flags
# (development runs in PERF.md, PR 20: at the JAX example's 1e-7 nothing
# flags in 16 steps under bf16 thresholds)
SUP_LATE_LR = 1e-3
# the pipeline candidates of full-width gpt-paper (phases 21a-21d): the
# staged degrees (pp 5 divides 12 layers unevenly, 3 3 2 2 2), the 1F1B
# candidate (pp 4 x 4 microbatches of 2 x 1024), the three pp bugs with the
# candidate each runs under and the module each must be localized to
# (fnmatch; None: the verdict must come from the gradient sections), and
# the supervised 1F1B recipe (pp 2 x 4 microbatches, at SUP_LAYERS)
PP_STAGED = (4, 5)
PP_1F1B = dict(pp=4, pp_schedule="1f1b", microbatches=4)
PP_CONTROLS = (("pp_wrong_stage_division", dict(pp=4), "layers.3*"),
               ("pp_stale_boundary", PP_1F1B, "layers.3*"),
               ("pp_microbatch_order", PP_1F1B, None))
SUP_PP = dict(pp=2, pp_schedule="1f1b", microbatches=4)
SSM_SOURCE = "src/repro_torch/kernels/csrc/ssm_scan.cu"
SSM_REPLACES = "src/repro/kernels/ssm_scan.py:104"
SSM_LAYERS = 2                     # rwkv6-7b at full width, cut to 2 layers
SSM_LAUNCHES_PER_RUN = SSM_LAYERS  # one scan per layer
SSM_SWEEP_TOL = 5e-4               # absolute, against float64 (test_kernels)
SSM_NORM_TOL = 1e-5                # normwise relative, against float64
# (B, S, H, dk, dv, chunk, scalar decay, exclusive): rwkv6-7b's time mix
# (per-channel, exclusive) and zamba2-7b's Mamba2 mixer (scalar, inclusive,
# H = 2 * 3584 / 64)
SSM_RWKV = (2, 4096, 64, 64, 64, 128, False, True)
SSM_ZAMBA = (2, 4096, 112, 64, 64, 128, True, False)
# the zamba2 check's own operands (24a): B 1, q and k broadcast over the
# heads with head stride 0
SSM_ZAMBA_PATH = (1, 4096, 112, 64, 64, 128, True, False)
# rows of 60 bf16 are not whole 16-byte pieces: the kernel's scalar staging
SSM_UNALIGNED = (1, 512, 4, 60, 60, 128, False, True)
# the reference tests' sweep (tests/test_kernels.py), B 2 x S 128, 2 heads
SSM_SWEEP = tuple((2, 128, 2, dk, dv, chunk, scalar, excl)
                  for dk, dv, chunk in ((16, 16, 32), (8, 32, 16), (32, 16, 64))
                  for scalar, excl in ((True, False), (False, False),
                                       (False, True)))
# the Mixture-of-Experts phases (22a-22d): mixtral-8x7b at its published
# width (d 4096, 32 heads of 128, kv 8, 8 experts of d_ff 14336, top 2,
# capacity factor 2, swa window 4096), cut from 32 layers to 1 for memory and
# with the embeddings tied (the reference CLI ties them for every candidate
# recipe); B 1 x S 4096, where the window equals the causal mask, so the
# distributed candidate, whose attention is causal only, is faithful; the
# expert-parallel candidates, the control and the flash candidate's length
# (S 8192, where the window drops keys)
MOE_ARCH = "mixtral-8x7b"
MOE_LAYERS = 1
MOE_TIED = True
MOE_BATCH = (1, 4096)
MOE_CANDIDATES = (("tp2", dict(tp=2)), ("tp2sp", dict(tp=2, sp=True)))
MOE_CONTROL = ("moe_router_not_synced", dict(tp=2))
MOE_FLASH_BATCH = (1, 8192)
MOE_TAPS_PER_LAYER = 6       # attention input/core/output, mlp input/router/output
MOE_PARAMS_PER_LAYER = 8     # 2 norms, qkv, proj, router, 3 expert stacks
# kernel vs plain bf16 attention: each is within half a bf16 ulp of the
# exact value (plus f32 sums), so they differ by at most a bf16 ulp,
# 2^-7 relative, taken here with a factor 2 of slack
MOE_FLASH_REL_TOL = 2.0 ** -6
# the records each MoE check prints beside its verdict
MLA_ARCH = "deepseek-v2-236b"
MLA_LAYERS = 1               # the published dense first layer (memory)
MLA_BATCH = (1, 4096)
MLA_PARAMS_PER_LAYER = 14    # 2 norms, 9 MLA (q LoRA), 3 SwiGLU
MLA_CONTROL = "dense_layers.0.self_attention.linear_uq.w"
MLA_DECODE = (4, 1024)       # B x T decode tokens of phase 23c
DECODE_MARGIN = 64.0         # tests/test_decode_ttrace.py's margin
STALE_ROPE = "decode_stale_rope_pos"
CONSISTENCY = ("tinyllama-1.1b", 2, 256)    # arch, B, T of phase 23d
CONSISTENCY_LAYERS = 11      # of 22, for time: 26a runs the full depth
CONSISTENCY_TOL = 1e-4       # normwise relative, at f32 compute
SERVE_RUNS = (("tinyllama-1.1b", False), ("deepseek-v2-236b", True),
              ("mixtral-8x7b", True), ("rwkv6-7b", True))
ZAMBA_ARCH = "zamba2-7b"
ZAMBA_LAYERS = 12            # two groups of 6 Mamba2 layers, two shared uses
ZAMBA_BATCH = (1, 4096)
ZAMBA_LAUNCHES_PER_RUN = ZAMBA_LAYERS    # one gla_scan per Mamba2 layer
MAMBA_TAPS_PER_LAYER = 2     # mixer input, output
MAMBA_PARAMS_PER_LAYER = 9   # input norm, in/out proj, conv w/b, A_log, D,
                             # dt_bias, gate norm
SHARED_TAPS = 5              # a use of the shared block: attention
                             # input/core/output, mlp input/output
SHARED_PARAMS = 7            # 2 norms, qkv, proj, 3 SwiGLU
ZAMBA_CONTROLS = (("mamba1.0.mixer.out_proj.w", "layers.6.mixer"),
                  ("shared_attn.mlp.down.w", "shared_attn_0.mlp"))
ZAMBA_DECODE = (2, 256)      # B x T of phase 24d, at f32 compute
# the dense options' phases (25a-25e), each config at its published width:
# (arch, depth, tied embeddings), B x S, the parameters of a layer and of
# the frontend (check_trace_shapes) and the controls (parameter, the module
# the check must name).  qwen3-32b: depth 64 -> 1 and tied, as the mixtral
# phases; codeqwen1.5-7b: depth 32 -> 2 (a control on the second layer),
# through the tp2 sp candidate; llava-next-34b: depth 60 -> 1, S 4096 =
# 2880 patch features (5 anyres tiles x 576) + 1216 text tokens;
# hubert-xlarge cut from 48 layers to 24 for the script's time (the
# control on layer 23 stays), B 2 x S 1024 (some 20 s of audio at 50
# frames a second)
QWEN3 = ("qwen3-32b", 1, True)
QWEN3_BATCH = (1, 4096)
QWEN3_CONTROL = ("layers.0.self_attention.q_norm", "layers.0.self_attention")
CODEQWEN = ("codeqwen1.5-7b", 2, False)
CODEQWEN_BATCH = (1, 4096)
CODEQWEN_PCFG = dict(tp=2, sp=True)
# shifted, not doubled: biases start at zero
CODEQWEN_CONTROL = ("layers.1.self_attention.linear_qkv.b",
                    "layers.1.self_attention")
CODEQWEN_SHIFT = 0.1
LLAVA = ("llava-next-34b", 1, False)
LLAVA_BATCH = (1, 4096)
LLAVA_CONTROL = ("vision_proj.w", "embedding")
HUBERT = ("hubert-xlarge", 24, False)
HUBERT_BATCH = (2, 1024)
# the doubled mask_embed moves the embedding output by less than its bf16
# threshold's 12.5% floor (174 of 2048 frames masked), so the check FAILs
# downstream: by propagation at the first flagged activation, measured
# layers.1.self_attention, with no module flagged in isolation; both
# packages name a module past the embedding at bf16 eps on the CPU too
# (tests/test_torch_configs.py; PERF.md section 6)
HUBERT_CONTROLS = (("layers.23.mlp.fc2.w", "layers.23.mlp"),
                   ("mask_embed", "layers.1.self_attention"))
# parameters a layer: 2 norms, qkv, proj, 3 SwiGLU (+ q_norm, k_norm; +
# the qkv bias); hubert's: 2 norms, qkv, proj, fc1 and fc2 with biases
QWEN3_PARAMS_PER_LAYER = 9
CODEQWEN_PARAMS_PER_LAYER = 8
HUBERT_PARAMS_PER_LAYER = 8
LLAVA_PARAMS_PER_LAYER = 7
LLAVA_FRONTEND_PARAMS = 2    # vision_proj w, b
HUBERT_FRONTEND_PARAMS = 3   # audio_proj w, b, mask_embed
DENSE_SERVE = (("qwen3-32b", True), ("codeqwen1.5-7b", True))
MOE_WATCH = ("layers.0.mlp/output", "layers.0.mlp/router_logits",
             "layers.0.mlp.router", "layers.0.mlp.experts.down")


# built behind the phases that do not launch it: ssm_scan.cu (25 kernel
# instances) takes about a minute of nvcc, and phase 16 launches it first
LATE_BUILDS = ("ssm_scan",)


def kernel_wrappers():
    from repro_torch.kernels import ops, ssm_scan
    return {"packed_sq_norms": ops.packed_sq_norms,
            "fp8_matmul": ops.fp8_matmul,
            "fp8_matmul_tile128": ops.fp8_matmul_tile128,
            "flash_attention": ops.flash_attention,
            "gla_scan": ssm_scan.gla_scan}


def reset_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps=20, warmup=3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version and float64
# ---------------------------------------------------------------------------

def _within(got, ref, what):
    """Relative REL_TOL on each finite sum; exact zero where ref is 0."""
    got = got.double()
    err = (got - ref).abs()
    bad = err > REL_TOL * ref.abs()
    if bool(bad.any()):
        i = int(bad.nonzero()[0, 0])
        raise AssertionError(f"{what}: row {i} got {got[i].tolist()} "
                             f"vs float64 {ref[i].tolist()}")
    return float(err.max())


def check_kernel(device, sizes, seed=0):
    """Returns the largest |kernel - plain| seen."""
    import torch
    from repro_torch.core.relerr_engine import pack_device, section_sq_norms
    from repro_torch.kernels.relerr import packed_sq_norms, packed_sq_norms_ref

    gen = torch.Generator(device="cpu").manual_seed(seed)
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        la, lb = [], []
        for n in sizes:
            a = torch.randn(n, generator=gen) * (0.01 + 10 * torch.rand(1, generator=gen))
            b = a + 1e-3 * torch.randn(n, generator=gen)
            la.append(a.to(device=device, dtype=dtype))
            lb.append(b.to(device=device, dtype=dtype))
        la[2] = torch.zeros_like(la[2])               # ||a|| = 0
        ref = torch.from_numpy(section_sq_norms(la, lb, mode="loop")).to(device)
        args = pack_device(la, lb)
        n_seg = len(sizes)
        k1 = packed_sq_norms(*args, n_segments=n_seg)
        k2 = packed_sq_norms(*args, n_segments=n_seg)
        p = packed_sq_norms_ref(*args, n_segments=n_seg)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if not torch.equal(k1, k2):
            raise AssertionError(f"{dtype}: two launches differ")
        _within(k1, ref, f"kernel {dtype}")
        _within(p, ref, f"plain {dtype}")
        if float(k1[2, 1]) != 0.0:
            raise AssertionError("||a|| = 0 pair has a non-zero ||a||^2")
        max_err = max(max_err, float((k1 - p).abs().max()))

        # NaN garbage in the pad must not leak
        a_flat, b_flat, seg_ids, counts = args
        block = a_flat.shape[0] // seg_ids.shape[0]
        lane = torch.arange(block, device=device)[None, :]
        pad = (lane >= counts[:, None]).reshape(-1)
        if bool(pad.any()):
            ga = a_flat.masked_fill(pad, float("nan"))
            gb = b_flat.masked_fill(pad, float("inf"))
            g = packed_sq_norms(ga, gb, seg_ids, counts, n_segments=n_seg)
            if not torch.equal(g, k1):
                raise AssertionError(f"{dtype}: NaN in the pad leaked")
        # a NaN in a real element must propagate to its own pair only
        bad_a = [x.clone() for x in la]
        bad_a[1].view(-1)[0] = float("nan")
        nanned = packed_sq_norms(*pack_device(bad_a, lb), n_segments=n_seg)
        if not bool(torch.isnan(nanned[1]).all()):
            raise AssertionError(f"{dtype}: a NaN in real data did not propagate")
        others = torch.cat([nanned[:1], nanned[2:]])
        if not bool(torch.isfinite(others).all()):
            raise AssertionError(f"{dtype}: a NaN leaked into other pairs")
        log(f"kernel {str(dtype):14s} {n_seg} pairs, "
            f"{a_flat.numel()} packed elements: ok")
    return max_err


# ---------------------------------------------------------------------------
# phases 4-5: the main path
# ---------------------------------------------------------------------------

def timed_runner(run, calls):
    import torch

    def wrapped(batch, rewrites=None):
        t0 = time.perf_counter()
        tr = run(batch, rewrites)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        calls.append(time.perf_counter() - t0)
        return tr
    return wrapped


def packed_elems(leaves, block):
    return sum(max(1, -(-int(x.numel()) // block)) * block for x in leaves)


def main_path(device, cfg, batch_size, seq, eps):
    """``ttrace_check`` of a clean candidate of a new seeded model; returns
    (result, stats, model, batch)."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model

    model = Model(cfg, seed=0, device=device)
    batch = make_batch(cfg, batch_size, seq, seed=0, device=device)
    res, stats = model_check(model, batch, eps)
    return res, stats, model, batch


def model_check(model, batch, eps):
    """``ttrace_check`` (AdamW, lr 1e-3) of ``make_model_runner(model)``
    against itself; every launch count set to 0 just before and read just
    after.  Returns (result, stats)."""
    import torch
    from repro_torch.core.checker import collect_section_pairs
    from repro_torch.core.harness import make_model_runner, ttrace_check
    from repro_torch.kernels.relerr import DEFAULT_BLOCK, packed_sq_norms
    from repro_torch.optim.adamw import AdamW

    dev = model.device
    opt = AdamW(lr=1e-3)
    ref_calls, cand_calls, marks = [], [], {}
    ref = timed_runner(make_model_runner(model, opt, device=dev), ref_calls)
    cand_run = timed_runner(make_model_runner(model, opt, device=dev),
                            cand_calls)

    def cand(batch, rewrites=None):
        marks.setdefault("after_estimate", packed_sq_norms.launches)
        return cand_run(batch, rewrites)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    res = ttrace_check(ref, cand, batch, eps=eps)
    counts = read_counts()
    launches = counts["packed_sq_norms"]
    _, la, _, _ = collect_section_pairs(res.reference, res.candidate)
    seconds = {"1_reference": ref_calls[0],
               "2_thresholds": res.seconds["estimate"] - ref_calls[0],
               "3_candidate": res.seconds["candidate"],
               "4_compare": res.seconds["compare"]}
    if "localize" in res.seconds:
        seconds["5_localize"] = res.seconds["localize"]
    stats = dict(
        launches=launches,
        estimate_launches=marks["after_estimate"],
        compare_launches=launches - marks["after_estimate"],
        other_launches={k: v for k, v in counts.items()
                        if k != "packed_sq_norms" and v},
        tensors=len(res.report.records),
        packed_elems=packed_elems(la, DEFAULT_BLOCK),
        seconds=seconds, loss=res.reference.loss,
        peak_gib=(torch.cuda.max_memory_allocated(dev) / 2**30
                  if dev.type == "cuda" else None))
    return res, stats


def check_trace_shapes(res, cfg, batch_size, seq, taps_per_layer=5,
                       params_per_layer=7, frontend_params=0):
    """Tensors per section, ``final_norm_out``'s shape, every leaf finite.
    A hybrid's shared block counts its taps once per use and its
    parameters once (``*_per_layer`` are then the Mamba2 layers');
    ``frontend_params`` are a VLM's or an audio model's own."""
    from repro_torch.models.model import build_plan
    L, d = cfg.n_layers, cfg.d_model
    uses = sum(seg.shared for seg in build_plan(cfg))
    n_params = (2 + params_per_layer * L + (0 if cfg.tie_embeddings else 1)
                + (SHARED_PARAMS if uses else 0) + frontend_params)
    n_taps = taps_per_layer * L + 2 + SHARED_TAPS * uses
    want = {"activations": n_taps, "act_grads": n_taps,
            "param_grads": n_params, "main_grads": n_params,
            "params_post": n_params}
    for tr in (res.reference, res.candidate):
        for sec, n in want.items():
            got = len(getattr(tr, sec))
            if got != n:
                raise AssertionError(f"{sec}: {got} tensors, expected {n}")
        h = tr.activations.raw("final_norm_out")
        if tuple(h.shape) != (batch_size, seq, d):
            raise AssertionError(f"final_norm_out shape {tuple(h.shape)}")
        for sec in want:
            for name, x in getattr(tr, sec).raw_items():
                if not bool(x.isfinite().all()):
                    raise AssertionError(f"{sec}:{name} is not finite")
        if not math.isfinite(tr.loss) or not math.isfinite(tr.grad_norm):
            raise AssertionError("loss or grad norm is not finite")


def cross_device_check(cfg):
    """One step of a small fp32 model on the card, checked by TTrace against
    the same model on the CPU under f32 thresholds."""
    from repro_torch.core.collector import SECTION_FIELDS, Section
    from repro_torch.core.harness import make_model_runner, ttrace_check
    from repro_torch.core.thresholds import MACHINE_EPS
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW

    small = dataclasses.replace(cfg.reduced(), n_layers=2, vocab=256)
    opt = AdamW(lr=1e-3)
    cpu = make_model_runner(Model(small, seed=0, device="cpu"), opt, device="cpu")
    gpu = make_model_runner(Model(small, seed=0, device="cuda"), opt)

    def gpu_on_cpu(batch, rewrites=None):
        tr = gpu(batch, rewrites)
        for f in SECTION_FIELDS:
            setattr(tr, f, Section({k: v.cpu() for k, v in
                                    getattr(tr, f).raw_items()}))
        return tr

    batch = make_batch(small, 2, 16, seed=0, device="cpu")
    return ttrace_check(cpu, gpu_on_cpu, batch, eps=MACHINE_EPS["float32"],
                        localize=False)


def negative_control(cfg, model, batch, eps):
    from repro_torch.core.harness import make_model_runner, ttrace_check
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW
    import torch

    bad = Model(cfg, seed=0, device=model.device)
    with torch.no_grad():
        bad.layers[5].mlp.down.w.mul_(2.0)
    opt = AdamW(lr=1e-3)
    res = ttrace_check(make_model_runner(model, opt, device=model.device),
                       make_model_runner(bad, opt, device=model.device),
                       batch, eps=eps)
    return res


# ---------------------------------------------------------------------------
# phase 6: timing the compare section's reduction
# ---------------------------------------------------------------------------

def time_reduction(res):
    import torch
    from repro_torch.core.checker import collect_section_pairs
    from repro_torch.core.relerr_engine import pack_device
    from repro_torch.kernels.relerr import packed_sq_norms, packed_sq_norms_ref

    _, la, lb, _ = collect_section_pairs(res.reference, res.candidate)
    args = pack_device(la, lb)
    n = len(la)
    launches = packed_sq_norms.launches
    k = packed_sq_norms(*args, n_segments=n)
    p = packed_sq_norms_ref(*args, n_segments=n)
    torch.cuda.synchronize()
    rel = ((k.double() - p.double()).abs()
           > REL_TOL * p.double().abs()).any()
    if bool(rel):
        raise AssertionError("kernel and plain version disagree on the "
                             "main path's section")
    max_abs = float((k - p).abs().max())
    max_rel = float(((k.double() - p.double()).abs()
                     / p.double().abs().clamp_min(1e-30)).max())

    def library():
        diffs = torch._foreach_sub(la, lb)
        torch._foreach_norm(diffs)
        torch._foreach_norm(la)

    ms = cuda_time_ms(lambda: packed_sq_norms(*args, n_segments=n))
    pack_ms = cuda_time_ms(lambda: pack_device(la, lb), reps=5, warmup=1)
    plain_ms = cuda_time_ms(lambda: packed_sq_norms_ref(*args, n_segments=n),
                            reps=5, warmup=1)
    library_ms = cuda_time_ms(library, reps=5, warmup=1)
    packed_sq_norms.launches = launches      # timing launches are not counted
    a_flat, _, seg_ids, _ = args
    nbytes = 8 * a_flat.numel() + 8 * seg_ids.numel() + 8 * n
    flops = 4 * a_flat.numel()
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_s * 1e3,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS
                else "operations",
                max_abs_err=max_abs, max_rel_err=max_rel, pack_ms=pack_ms,
                packed_elems=a_flat.numel(), pairs=n)


# ---------------------------------------------------------------------------
# phases 7-10: the FP8 recipes and their kernel
# ---------------------------------------------------------------------------

def fp8_operands(M, K, N, recipe, device, seed):
    """Quantized operands of a seeded (M,K) @ (K,N) product and their
    dequantized float64 values as the kernel sees them: for global the
    kernel's product is unscaled, for tile128 it carries the tile scales."""
    import torch
    from repro_torch.precision.fp8 import expand_tile_scale, quantize_e4m3
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=gen).to(device)
    w = (torch.randn(K, N, generator=gen) * 0.05).to(device)
    qx, sx = quantize_e4m3(x, recipe)
    qw, sw = quantize_e4m3(w, recipe)
    xd, wd = qx.double(), qw.double()
    if recipe == "tile128":
        xd = xd * expand_tile_scale(sx, qx.shape).double()
        wd = wd * expand_tile_scale(sw, qw.shape).double()
    return qx, sx, qw, sw, xd, wd


def fp8_call(recipe, plain=False):
    """(qx, sx, qw, sw) -> f32 product through the kernel or its plain
    version."""
    from repro_torch.kernels import fp8_matmul as K
    if recipe == "tile128":
        fn = K.fp8_matmul_tile128_ref if plain else K.fp8_matmul_tile128
        return lambda qx, sx, qw, sw: fn(qx, sx, qw, sw)
    fn = K.fp8_matmul_ref if plain else K.fp8_matmul
    return lambda qx, sx, qw, sw: fn(qx, qw)


def check_fp8_kernels(device):
    """Both kernels against their plain versions and float64; returns the
    largest |kernel - plain| per kernel."""
    import torch
    from repro_torch.kernels import fp8_matmul as K
    shapes = {"global": [s for s, _ in FP8_MAIN_SHAPES]
              + [(128, 128, 128), (64, 256, 192), (256, 64, 64), (8, 64, 64)],
              "tile128": [s for s, _ in FP8_MAIN_SHAPES] + [(256, 384, 128)]}
    max_err = {}
    for recipe, name in (("global", "fp8_matmul"),
                         ("tile128", "fp8_matmul_tile128")):
        kern, plain = fp8_call(recipe), fp8_call(recipe, plain=True)
        worst = 0.0
        for i, (M, Kd, N) in enumerate(shapes[recipe]):
            qx, sx, qw, sw, xd, wd = fp8_operands(M, Kd, N, recipe, device, i)
            k1 = kern(qx, sx, qw, sw)
            k2 = kern(qx, sx, qw, sw)
            p = plain(qx, sx, qw, sw)
            torch.cuda.synchronize(device)
            if not torch.equal(k1, k2):
                raise AssertionError(f"{name} {M}x{Kd}x{N}: two launches differ")
            ref = xd @ wd
            bound = Kd * 2.0 ** -23 * (xd.abs() @ wd.abs())
            for what, got in (("kernel", k1), ("plain", p)):
                over = (got.double() - ref).abs() - bound
                if bool((over > 0).any()):
                    i0 = int(over.argmax())
                    raise AssertionError(
                        f"{name} {what} {M}x{Kd}x{N}: element {i0} is "
                        f"{float(got.reshape(-1)[i0])} vs float64 "
                        f"{float(ref.reshape(-1)[i0])}, over the bound by "
                        f"{float(over.max())}")
            err = float((k1 - p).abs().max())
            worst = max(worst, err)
            log(f"{name} {M}x{Kd}x{N}: ok, max |kernel - plain| {err:.3g}, "
                f"max |kernel - f64| {float((k1.double() - ref).abs().max()):.3g}")
        max_err[name] = worst

    # shapes and layouts outside the reference's contract raise, and so do
    # operands within it that break TMA's 16-byte rules, before any launch
    qx, sx, qw, sw, _, _ = fp8_operands(384, 256, 128, "tile128", device, 9)
    shifted = torch.zeros(256 * 256 + 8, dtype=torch.uint8, device=device)
    shifted = shifted[8:].view(K.F8).view(256, 256)      # base 8 bytes off
    launches = (K.fp8_matmul.launches, K.fp8_matmul_tile128.launches)
    refused = [
        lambda: K.fp8_matmul(qx[:300], qw),                  # 300 % 256
        lambda: K.fp8_matmul(qx.float(), qw),                # not e4m3
        lambda: K.fp8_matmul(qx[:256, ::2], qw[::2]),        # not contiguous
        lambda: K.fp8_matmul_tile128(qx[:100], sx[:1], qw, sw),
        lambda: K.fp8_matmul_tile128(qx, sx[:2], qw, sw),    # sx shape
        lambda: K.fp8_matmul(qx[:64, :8].contiguous(), qw[:8]),  # K 8
        lambda: K.fp8_matmul(qx[:64, :64].contiguous(),
                             qw[:64, :8].contiguous()),      # N 8
        lambda: K.fp8_matmul(shifted, qw[:256]),             # base
    ]
    for i, call in enumerate(refused):
        try:
            call()
        except (ValueError, TypeError) as e:
            log(f"refused as it should be: {e}")
        else:
            raise AssertionError(f"out-of-contract call {i} was accepted")
    if (K.fp8_matmul.launches, K.fp8_matmul_tile128.launches) != launches:
        raise AssertionError("a refused call launched a kernel")
    return max_err


def fp8_check(model, batch, recipe, bugs=frozenset()):
    """One ``ttrace_check`` of an fp8 candidate with every launch count set
    to 0 just before and read just after; also the kernel launches of
    each candidate run."""
    from repro_torch.core.harness import make_model_runner, ttrace_check
    from repro_torch.core.thresholds import MACHINE_EPS
    from repro_torch.optim.adamw import AdamW
    from repro_torch.precision.fp8 import make_fp8_runner

    opt = AdamW(lr=1e-3)
    cand = make_fp8_runner(model, recipe, opt=opt, bugs=bugs)
    per_run = []

    def counted(b, rewrites=None):
        before = read_counts()
        tr = cand(b, rewrites)
        after = read_counts()
        per_run.append({k: after[k] - before[k] for k in after})
        return tr

    reset_counts()
    res = ttrace_check(make_model_runner(model, opt), counted, batch,
                       eps=MACHINE_EPS["float8_e4m3fn"])
    return res, read_counts(), per_run


def fp8_main(model, batch, cfg, B, S):
    out = {}
    for recipe, name in (("tile128", "fp8_matmul_tile128"),
                         ("global", "fp8_matmul")):
        res, counts, per_run = fp8_check(model, batch, recipe)
        log(f"--- fp8-{recipe} ---")
        log(res.summary())
        worst = max(res.report.records, key=lambda r: r.rel_err / r.threshold)
        log(f"fp8-{recipe}: launches {counts}, per candidate run "
            f"{per_run}; step seconds {json.dumps(res.seconds)}; largest "
            f"rel-err / threshold {worst.rel_err / worst.threshold:.4f} "
            f"({worst.kind} {worst.name})")
        if not res.passed:
            raise AssertionError(f"clean fp8-{recipe} check did not PASS")
        other = "fp8_matmul" if recipe == "tile128" else "fp8_matmul_tile128"
        if [r[name] for r in per_run] != [FP8_LAUNCHES_PER_RUN] or any(
                r[other] for r in per_run):
            raise AssertionError(f"fp8-{recipe}: candidate runs launched "
                                 f"{per_run}, expected {FP8_LAUNCHES_PER_RUN} "
                                 f"{name} launches each")
        check_trace_shapes(res, cfg, B, S)
        out[name] = dict(launches=counts[name], seconds=res.seconds,
                         worst=(worst.kind, worst.name,
                                worst.rel_err / worst.threshold))
    return out


def fp8_control(model, batch):
    import fnmatch
    from repro_torch.bugs.registry import bug
    spec = bug("fp8_stale_scale")
    res, counts, _ = fp8_check(model, batch, "tile128",
                               bugs=frozenset({spec.bug_id}))
    log(res.summary())
    log(f"control step seconds: {json.dumps(res.seconds)}; launches {counts}")
    loc = res.localized_module
    if res.passed or not fnmatch.fnmatch(loc or "", spec.expected_module):
        raise AssertionError(f"fp8_stale_scale: passed={res.passed}, "
                             f"localized {loc!r}, expected "
                             f"{spec.expected_module!r}")
    return loc


def fp8_library_calls(qx, sx, qw, sw, recipe):
    """The library yardsticks: each PyTorch call that computes the kernel's
    function (``torch._scaled_mm``; for tile128 also
    ``torch.nn.functional.scaled_mm`` with 1x128 and 128x128 block scales,
    where the installed torch has it), as {name: call}; a call the
    installed torch refuses is logged and left out.  Timed here only; the
    port never calls them."""
    import torch
    import torch.nn.functional as F
    wcm = qw.t().contiguous().t()                 # cuBLAS wants w column-major
    calls = {}
    if recipe == "global":
        one = torch.ones((), dtype=torch.float32, device=qx.device)
        calls["_scaled_mm"] = lambda: torch._scaled_mm(
            qx, wcm, one, one, out_dtype=torch.float32)
        calls["_scaled_mm(use_fast_accum)"] = lambda: torch._scaled_mm(
            qx, wcm, one, one, out_dtype=torch.float32, use_fast_accum=True)
    else:
        # 128x128 tiles of x as 1x128 blocks (each row of a tile shares its
        # scale) and sw as 128x128 blocks, both outer-dim-major
        sa = sx.repeat_interleave(128, 0).t().contiguous().t()
        sb = sw.t().contiguous().t()
        calls["_scaled_mm"] = lambda: torch._scaled_mm(
            qx, wcm, sa, sb, out_dtype=torch.float32)
        if hasattr(F, "scaled_mm"):
            st = F.ScalingType
            calls["scaled_mm"] = lambda: F.scaled_mm(
                qx, wcm, sa, st.BlockWise1x128, sb, st.BlockWise128x128,
                output_dtype=torch.float32)
        else:
            log("torch.nn.functional.scaled_mm: not in this torch")
    for name, call in list(calls.items()):
        try:
            call()
        except (RuntimeError, ValueError, TypeError) as e:
            log(f"{name} ({recipe}) refused: {' '.join(str(e).split())[:400]}")
            del calls[name]
    return calls


def fp8_builds():
    """Registers, stack and spills of each fp8 build (``ptxas -v``), with
    the product's dynamic shared memory."""
    from repro_torch.kernels import build
    smem = build.load("fp8_matmul").repro_fp8_matmul_smem()
    return {name: dict(info, dynamic_smem_bytes=smem if "fp8_mm" in name
                       else 0)
            for name, info in ptxas_summary("fp8_matmul").items()}


@contextlib.contextmanager
def uninitialized_fill(on):
    """Deterministic mode's NaN fill of every new ``torch.empty`` buffer
    turned on or off while the block runs."""
    import torch
    det = torch.utils.deterministic
    was = det.fill_uninitialized_memory
    det.fill_uninitialized_memory = on
    try:
        yield
    finally:
        det.fill_uninitialized_memory = was


def fp8_timing(device):
    """Per kernel: ms per launch (``device_time_ms``, the card held busy
    while launches queue; the wrapper's back-to-back ``cuda_time_ms``
    beside it), plain ms and library ms timed the same way, and the
    bound, each the main path's launch-weighted mean over its two shapes;
    per shape also executed TFLOP/s, the share of the bound, and each
    library call's error against float64 and against phase 7's bound.
    Every contender allocates its output, so all are timed without
    deterministic mode's fill of new buffers; the kernel and each library
    call are timed with it too (``filled_ms``), as the main path runs."""
    with uninitialized_fill(False):
        return _fp8_timing(device)


def _fp8_timing(device):
    import torch
    from repro_torch.kernels import fp8_matmul as K
    rows = {}
    total = sum(n for _, n in FP8_MAIN_SHAPES)
    launches = (K.fp8_matmul.launches, K.fp8_matmul_tile128.launches)
    for recipe, name in (("global", "fp8_matmul"),
                         ("tile128", "fp8_matmul_tile128")):
        kern, plain = fp8_call(recipe), fp8_call(recipe, plain=True)
        acc = dict(ms=0.0, wrapper_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                   bytes_ms=0.0, ops_ms=0.0)
        library_ms = {}
        shapes = []
        for (M, Kd, N), n in FP8_MAIN_SHAPES:
            qx, sx, qw, sw, xd, wd = fp8_operands(M, Kd, N, recipe, device, 0)
            args = (qx, sx, qw, sw)
            ms = device_time_ms(lambda: kern(*args))
            with uninitialized_fill(True):
                filled_ms = device_time_ms(lambda: kern(*args))
            wrapper_ms = cuda_time_ms(lambda: kern(*args))
            plain_ms = device_time_ms(lambda: plain(*args), reps=10)
            ref = xd @ wd
            bound = Kd * 2.0 ** -23 * (xd.abs() @ wd.abs())
            lib = {}
            for lname, call in fp8_library_calls(*args, recipe).items():
                err = (call().double() - ref).abs()
                rel = float(err.max() / ref.abs().max())
                row = dict(max_abs_err=float(err.max()), rel_err=rel,
                           over_phase7_bound=float((err / bound).max()))
                if rel > 1e-2:
                    log(f"{lname} {recipe} {M}x{Kd}x{N} disagrees (relative "
                        f"{rel:.3g}); not a yardstick")
                else:
                    row["ms"] = device_time_ms(call)
                    with uninitialized_fill(True):
                        row["filled_ms"] = device_time_ms(call)
                lib[lname] = row
            del ref, bound
            nbytes = M * Kd + Kd * N + 4 * M * N
            if recipe == "tile128":
                nbytes += 4 * (sx.numel() + sw.numel())
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = 2 * M * Kd * N / FP8_FLOPS * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            shapes.append(dict(
                shape=(M, Kd, N), launches_per_run=n, ms=ms,
                filled_ms=filled_ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, library=lib,
                bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_share=bound_ms / ms,
                executed_tflops=2 * M * Kd * N / ms * 1e-9))
            for k, v in (("ms", ms), ("wrapper_ms", wrapper_ms),
                         ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                         ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                acc[k] += v * n / total
            for lname, row in lib.items():
                if "ms" in row:
                    library_ms.setdefault(lname, []).append(row["ms"] * n)
            log(f"{name} {M}x{Kd}x{N}: " + json.dumps(shapes[-1]))
        # the yardstick: the first call that ran and agreed at both shapes
        # (_scaled_mm without fast accumulation, the kernel's f32 sums)
        library = [(lname, sum(v) / total) for lname, v in library_ms.items()
                   if len(v) == len(FP8_MAIN_SHAPES)]
        rows[name] = dict(
            ms=acc["ms"], wrapper_ms=acc["wrapper_ms"],
            plain_ms=acc["plain_ms"],
            library_ms=library[0][1] if library else None,
            library=library[0][0] if library else None,
            bound_ms=acc["bound_ms"],
            bound_by="bytes" if acc["bytes_ms"] >= acc["ops_ms"]
            else "operations", shapes=shapes)
    # timing launches are not counted
    K.fp8_matmul.launches, K.fp8_matmul_tile128.launches = launches
    return rows, fp8_builds()


# ---------------------------------------------------------------------------
# phases 11-15: the flash-attention candidate and its kernel
# ---------------------------------------------------------------------------

def flash_inputs(B, S, H, Hkv, D, dtype, device, seed):
    import torch
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(device=device, dtype=dtype)
            for shape in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]


def check_flash_kernel(device):
    """The kernel against its plain version and a float64 ``attention_ref``
    on the same inputs.  f32: within FLASH_F32_TOL of float64 (f32
    summation order, as ``test_kernels.py``).  bf16: within half a bf16 ulp
    of the float64 value (the output's one rounding, 2^-8 relative) plus
    FLASH_F32_TOL for the f32 sums before it.  Each case must take its
    dtype's entry point; two launches must give identical bits.  Returns
    the largest |kernel - plain|."""
    import torch
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models.attention import attention_ref

    cases = [(shape, torch.bfloat16, "causal", 0)
             for shape in FLASH_BF16_SHAPES]
    cases += [(shape, torch.bfloat16, mode, 0) for shape, mode in FLASH_PATHS]
    cases += [(shape, dtype, mode, window)
              for dtype in (torch.bfloat16, torch.float32)
              for shape in FLASH_SWEEP_SHAPES for mode, window in FLASH_MODES]
    entries = []
    real_lib = TF._lib

    def logged_lib(source, symbol, *args):
        entries.append(symbol)
        return real_lib(source, symbol, *args)
    TF._lib = logged_lib
    worst = 0.0
    try:
        for i, (shape, dtype, mode, window) in enumerate(cases):
            q, k, v = flash_inputs(*shape, dtype, device, seed=100 + i)
            entries.clear()
            k1 = ops.flash_attention(q, k, v, mode=mode, window=window)
            k2 = ops.flash_attention(q, k, v, mode=mode, window=window)
            p = flash_attention_ref(q, k, v, mode=mode, window=window)
            ref = attention_ref(q.double(), k.double(), v.double(), mode=mode,
                                window=window)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            what = f"flash {tuple(shape)} {str(dtype)[6:]} {mode}"
            if entries != [TF.ENTRY_POINTS[dtype][1]] * 2:
                raise AssertionError(f"{what}: launched {entries}")
            if k1.dtype != dtype or tuple(k1.shape) != tuple(q.shape):
                raise AssertionError(f"{what}: got {k1.dtype} "
                                     f"{tuple(k1.shape)}")
            if not torch.equal(k1, k2):
                raise AssertionError(f"{what}: two launches differ")
            rel = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
            for name, got in (("kernel", k1), ("plain", p)):
                over = (got.double() - ref).abs() - (rel * ref.abs()
                                                     + FLASH_F32_TOL)
                if bool((over > 0).any()) or not bool(got.isfinite().all()):
                    j = int(over.reshape(-1).argmax())
                    raise AssertionError(
                        f"{what} {name}: element {j} is "
                        f"{float(got.reshape(-1)[j])} vs float64 "
                        f"{float(ref.reshape(-1)[j])}, over the bound by "
                        f"{float(over.max())}")
            err = float((k1.double() - p.double()).abs().max())
            worst = max(worst, err)
            log(f"{what} via {entries[0]}: ok, max |kernel - plain| "
                f"{err:.3g}, max |kernel - f64| "
                f"{float((k1.double() - ref).abs().max()):.3g}")
            del q, k, v, k1, k2, p, ref
    finally:
        TF._lib = real_lib

    # shapes and operands outside the contract raise
    bf = torch.bfloat16
    q, k, v = flash_inputs(1, 768, 2, 2, 64, bf, device, 9)
    gqa = flash_inputs(1, 64, 6, 4, 64, bf, device, 9)
    d96 = flash_inputs(1, 64, 2, 2, 96, bf, device, 9)
    wide = torch.zeros((1, 64, 2, 64, 2), dtype=bf, device=device)[..., 0]
    s = slice(0, 64)
    # bf16 for TMA: a base 8 bytes past a 16-byte boundary, and rows 136
    # bytes apart (4-element rows, enough for f32 but not for TMA)
    flat = torch.zeros(1 * 64 * 2 * 64 + 8, dtype=bf, device=device)
    shifted = flat[4:4 + 64 * 2 * 64].view(1, 64, 2, 64)
    rows68 = torch.zeros((1, 64, 2, 68), dtype=bf, device=device)[..., :64]
    refused = [
        lambda: ops.flash_attention(q, k, v),                 # 768 % 512
        lambda: ops.flash_attention(*gqa),                    # 6 % 4
        lambda: ops.flash_attention(*d96),                    # D 96
        lambda: ops.flash_attention(wide, k[:, s], v[:, s]),  # D stride 2
        lambda: ops.flash_attention(q[:, s], k[:, s].cpu(), v[:, s]),
        lambda: ops.flash_attention(q[:, s], k[:, s].float(), v[:, s]),
        lambda: ops.flash_attention(shifted, k[:, s], v[:, s]),
        lambda: ops.flash_attention(q[:, s], rows68, v[:, s]),
    ]
    launches = ops.flash_attention.launches
    for i, call in enumerate(refused):
        try:
            call()
        except (ValueError, TypeError) as e:
            log(f"refused as it should be: {e}")
        else:
            raise AssertionError(f"out-of-contract flash call {i} was "
                                 f"accepted")
    if ops.flash_attention.launches != launches:
        raise AssertionError("a refused flash call launched a kernel")
    return worst


def flash_runner(model, opt):
    """The flash-attention candidate as a user builds it: the generic
    collector over ``loss(use_kernel=True)``, as ``make_fp8_runner``."""
    from repro_torch.core.collector import named_params, trace_fn_step
    from repro_torch.core.harness import inputs_on
    params = named_params(model)

    def loss_call(batch, ctx):
        return model.loss(batch, ctx=ctx, use_kernel=True)[0]

    def run(batch, rewrites=None):
        b, rw = inputs_on(model.device, batch, rewrites)
        tr, _, _ = trace_fn_step(loss_call, params, b, opt=opt, rewrites=rw)
        return tr

    return run


def counted_runner(run, per_run, extra=None):
    """``run`` recording each call's launches (and ``extra`` counters)."""
    def wrapped(batch, rewrites=None):
        before = dict(read_counts(), **(extra or {}))
        tr = run(batch, rewrites)
        after = dict(read_counts(), **(extra or {}))
        per_run.append({k: after[k] - before[k] for k in after})
        return tr
    return wrapped


def flash_check(model, batch, cand_model=None, extra=None):
    """One ``ttrace_check`` of the flash candidate over ``cand_model``
    (default ``model``) against the plain ``model``, with every launch
    count set to 0 just before and read just after.  Returns (result,
    counts, per reference run, per candidate run)."""
    from repro_torch.core.harness import make_model_runner, ttrace_check
    from repro_torch.core.thresholds import MACHINE_EPS
    from repro_torch.optim.adamw import AdamW

    opt = AdamW(lr=1e-3)
    ref_runs, cand_runs = [], []
    ref = counted_runner(make_model_runner(model, opt, device=model.device),
                         ref_runs, extra)
    cand = counted_runner(flash_runner(cand_model or model, opt), cand_runs,
                          extra)
    reset_counts()
    res = ttrace_check(ref, cand, batch, eps=MACHINE_EPS["bfloat16"])
    return res, read_counts(), ref_runs, cand_runs


def worst_record(res):
    w = max(res.report.records, key=lambda r: r.rel_err / r.threshold)
    return w.rel_err / w.threshold, f"{w.kind} {w.name}"


def flash_verdict(name, res, counts, ref_runs, cand_runs, cfg, B, S):
    ratio, where = worst_record(res)
    log(res.summary())
    log(f"{name}: launches {counts}; per reference run {ref_runs}; per "
        f"candidate run {cand_runs}; step seconds {json.dumps(res.seconds)}; "
        f"largest rel-err / threshold {ratio:.4f} ({where})")
    if not res.passed:
        raise AssertionError(f"clean {name} check did not PASS")
    if [r["flash_attention"] for r in cand_runs] != [FLASH_LAUNCHES_PER_RUN]:
        raise AssertionError(f"{name}: candidate runs launched {cand_runs}, "
                             f"expected {FLASH_LAUNCHES_PER_RUN} "
                             f"flash_attention launches")
    if any(r["flash_attention"] for r in ref_runs):
        raise AssertionError(f"{name}: the reference launched the kernel")
    check_trace_shapes(res, cfg, B, S)
    return dict(launches=counts["flash_attention"], seconds=res.seconds,
                worst=(where, ratio))


def flash_long(model, cfg, B, S):
    """The flash check at S 4096: the reference must take
    ``attention_blockwise`` and the chunked CE, the candidate the kernel and
    the chunked CE.  Both are counted by wrapping the two functions where
    the model calls them, for this phase only."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models import attention as A
    from repro_torch.models import model as M

    if not (S * cfg.vocab > M._CHUNKED_CE_ELEMS and S % 1024 == 0):
        raise AssertionError(f"S {S} x vocab {cfg.vocab} does not take the "
                             f"chunked CE in 1024-wide chunks")
    calls = {"attention_blockwise": 0, "chunked_cross_entropy": 0}
    saved = [(mod, name, getattr(mod, name)) for mod, name in
             ((A, "attention_blockwise"), (M, "chunked_cross_entropy"))]

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped
    for mod, name, fn in saved:
        setattr(mod, name, counting(name, fn))
    try:
        batch = make_batch(cfg, B, S, seed=0, device=model.device)
        res, counts, ref_runs, cand_runs = flash_check(model, batch,
                                                       extra=calls)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    L = cfg.n_layers
    # the candidate's forward runs on the kernel; its backward recomputes
    # the reference's attention, which is blockwise at this length
    for kind, runs in (("reference", ref_runs), ("candidate", cand_runs)):
        for r in runs:
            if (r["attention_blockwise"] != L
                    or r["chunked_cross_entropy"] != 1):
                raise AssertionError(f"a {kind} run called {r}: expected {L}"
                                     f" attention_blockwise, 1 chunked CE")
    return flash_verdict("flash_long", res, counts, ref_runs, cand_runs, cfg,
                         B, S)


def flash_control(cfg, model, batch):
    import torch
    from repro_torch.models.model import Model
    bad = Model(cfg, seed=0, device=model.device)
    with torch.no_grad():
        bad.layers[3].self_attention.linear_qkv.w.mul_(2.0)
    res, counts, _, cand_runs = flash_check(model, batch, cand_model=bad)
    log(res.summary())
    log(f"flash control step seconds: {json.dumps(res.seconds)}; launches "
        f"{counts}; per candidate run {cand_runs}")
    loc = res.localized_module
    if res.passed or loc != "layers.3.self_attention":
        raise AssertionError(f"doubled layers.3.self_attention.linear_qkv.w: "
                             f"passed={res.passed}, localized {loc!r}")
    if counts["flash_attention"] != 2 * FLASH_LAUNCHES_PER_RUN:
        raise AssertionError(f"flash control launched "
                             f"{counts['flash_attention']}, expected "
                             f"{2 * FLASH_LAUNCHES_PER_RUN}")
    return loc


def flash_bound(B, S, H, Hkv, D, elem_bytes=2, mode="causal"):
    """(bound ms, bound_by, bytes, flops) of causal (or bidirectional)
    attention: q, k, v and out read or written once; 4 D flops per unmasked
    (q, k) pair on the bf16 tensor cores, D the true head dim."""
    nbytes = elem_bytes * B * S * D * (2 * H + 2 * Hkv)
    pairs = S * S if mode == "bidirectional" else S * (S + 1) // 2
    flops = 4 * D * B * H * pairs
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes, flops)


def device_time_ms(fn, reps=20, warmup=3) -> float:
    """Per call (CUDA events), with the card held busy while the calls are
    queued, so the host's time to launch them does not show."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)          # some 10 ms of the card's cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_summary(source):
    """Registers, stack and spills of each kernel in ``source``'s build log
    (``nvcc -Xptxas -v``), by mangled name."""
    import re
    from repro_torch.kernels import build
    out, fn = {}, None
    for line in build.lib_path(source).with_suffix(".log").read_text() \
            .splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn is not None:
            fn.update(stack=int(m[1]), spill_stores=int(m[2]),
                      spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            fn["registers"] = int(m[1])
    return out


def sdpa_backends_ms(q, k, v, want, causal=True):
    """``scaled_dot_product_attention`` on (B,H,S,D) views, causal (or
    bidirectional), under each of its CUDA backends, with deterministic
    algorithms off while it
    runs (the script's deterministic mode narrows SDPA's choice): ms per
    call (``device_time_ms``), or None for a backend that refuses or
    disagrees with ``want`` (bf16, (B,S,H,D)) by more than 0.05."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    gqa = q.shape[2] != k.shape[2]
    out = {}
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                     "CUDNN_ATTENTION"):
            backend = getattr(SDPBackend, name, None)

            def call(backend=backend):
                with sdpa_kernel(backend):
                    return F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), is_causal=causal, enable_gqa=gqa)
            out[name.lower()] = None
            try:
                err = float((call().transpose(1, 2).double()
                             - want.double()).abs().max())
            except (RuntimeError, TypeError) as e:
                log(f"SDPA {name} refused: {str(e).splitlines()[0][:160]}")
                continue
            if err > 0.05:
                log(f"SDPA {name} disagrees by {err:.3g}; not timed")
                continue
            out[name.lower()] = device_time_ms(call)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    return out


def flash_timing(device):
    """Per launch, bf16: the kernel, its plain version and
    ``scaled_dot_product_attention`` on (B,H,S,D) views as the library
    yardstick (timed here only; the port never calls it), causal at the
    main and long shapes and at 25a's, bidirectional at 25d's; the kernel's
    builds and one profiled launch a shape.  Executed TFLOP/s count the
    kernel's own work: q k^T at the true D, p v as p_hi v + p_lo v at D
    rounded up to whole 64-column boxes."""
    import re
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as TF
    from repro_torch.kernels.flash_attention import flash_attention_ref

    launches = ops.flash_attention.launches
    smem = build.load("flash_attention_wgmma").repro_flash_attention_wgmma_smem
    builds = {name: dict(info, dynamic_smem_bytes=smem(
        int(re.search(r"ILi(\d+)E", name)[1])))
        for name, info in ptxas_summary("flash_attention_wgmma").items()}
    for name, info in builds.items():
        log(f"flash_attention_wgmma build {name}: {json.dumps(info)}")
    rows = []
    for shape, mode in ((FLASH_MAIN, "causal"), (FLASH_LONG, "causal"),
                        *FLASH_PATHS):
        causal = mode == "causal"
        q, k, v = flash_inputs(*shape, torch.bfloat16, device, seed=0)
        ms = device_time_ms(lambda: ops.flash_attention(q, k, v, mode=mode))
        wrapper_ms = cuda_time_ms(lambda: ops.flash_attention(q, k, v,
                                                              mode=mode))
        plain_ms = cuda_time_ms(lambda: flash_attention_ref(q, k, v,
                                                            mode=mode),
                                reps=5, warmup=1)
        got = ops.flash_attention(q, k, v, mode=mode)

        def library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True).transpose(1, 2)
        lib_ms = None
        try:
            lib_err = float((library().double() - got.double()).abs().max())
        except (RuntimeError, TypeError) as e:
            log(f"scaled_dot_product_attention refused: "
                f"{str(e).splitlines()[0][:200]}")
        else:
            if lib_err > 0.05:
                log(f"scaled_dot_product_attention disagrees by {lib_err:.3g}"
                    f"; no yardstick")
            else:
                lib_ms = device_time_ms(library)
        backends = sdpa_backends_ms(q, k, v, got, causal=causal)
        bound_ms, bound_by, nbytes, flops = flash_bound(*shape, mode=mode)
        D = shape[4]
        executed = flops * (2 * D + 4 * (-(-D // 64) * 64)) / (4 * D)
        prof = TF.profile(q, k, v, mode=mode).double()
        cycles = prof.mean(0).tolist()
        rows.append(dict(shape=shape, mode=mode, ms=ms,
                         wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, library_backends_ms=backends,
                         bound_ms=bound_ms, bound_by=bound_by,
                         bound_share=bound_ms / ms, bytes=nbytes,
                         flops=flops, executed_tflops=executed / ms * 1e-9,
                         warpgroup_cycles=cycles[-1],
                         phase_share={n: c / cycles[-1] for n, c in
                                      zip(TF.PHASES[:-1], cycles)}))
        log(f"flash_attention {shape} {mode}: " + json.dumps(rows[-1]))
        del q, k, v, got
    ops.flash_attention.launches = launches   # timing launches are not counted
    return rows, builds


# ---------------------------------------------------------------------------
# phases 15a-15c: the distributed candidate (dp/cp/tp/sp/zero1 on emulated
# ranks) of the same model and batch
# ---------------------------------------------------------------------------

def dist_check(cfg, model, batch, kw, bugs=(), routing=None,
               cand_params=None):
    """``ttrace_check`` of ``parallel.api.make_candidate_runner`` (over
    ``cand_params``, default ``model``'s parameters) against the plain
    ``model`` under bf16 thresholds, every launch count set to 0 just
    before and read just after.  With ``routing`` (a dict), each
    reference and candidate run's MoE routing is appended to
    ``routing["reference"]`` and ``routing["candidate"]``
    (``moe_routing``).  Returns (result, stats, the candidate runner)."""
    import torch
    from repro_torch.core.harness import make_model_runner, ttrace_check
    from repro_torch.core.thresholds import MACHINE_EPS
    from repro_torch.kernels.relerr import packed_sq_norms
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel.api import ParallelConfig, make_candidate_runner

    opt = AdamW(lr=1e-3)
    pcfg = ParallelConfig(bugs=frozenset(bugs), **kw)
    dev = model.device
    ref_calls, cand_calls, marks = [], [], {}
    ref = timed_runner(make_model_runner(model, opt, device=dev), ref_calls)
    cand_run = timed_runner(make_candidate_runner(
        cfg, pcfg, model if cand_params is None else cand_params, opt,
        device=dev), cand_calls)
    if routing is not None:
        ref = routing_runner(ref, cfg, routing.setdefault("reference", []))
        cand_run = routing_runner(cand_run, cfg,
                                  routing.setdefault("candidate", []))

    def cand(b, rewrites=None):
        marks.setdefault("after_estimate", packed_sq_norms.launches)
        return cand_run(b, rewrites)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    res = ttrace_check(ref, cand, batch, eps=MACHINE_EPS["bfloat16"])
    counts = read_counts()
    seconds = {"1_reference": ref_calls[0],
               "2_thresholds": res.seconds["estimate"] - ref_calls[0],
               "3_candidate": res.seconds["candidate"],
               "4_compare": res.seconds["compare"]}
    if "localize" in res.seconds:
        seconds["5_localize"] = res.seconds["localize"]
    ratio, where = worst_record(res)
    launches = counts["packed_sq_norms"]
    stats = dict(
        pcfg=kw, launches=launches,
        estimate_launches=marks["after_estimate"],
        compare_launches=launches - marks["after_estimate"],
        other_launches={k: v for k, v in counts.items()
                        if k != "packed_sq_norms" and v},
        seconds=seconds, worst=ratio, worst_at=where,
        peak_gib=(torch.cuda.max_memory_allocated(dev) / 2**30
                  if dev.type == "cuda" else None))
    log(res.summary())
    log(f"dist {kw} bugs {sorted(bugs)}: largest rel-err / threshold "
        f"{ratio:.4f} ({where}); packed_sq_norms launches: estimate "
        f"{stats['estimate_launches']}, compare {stats['compare_launches']}"
        f" (all {launches}), other kernels {stats['other_launches']}; step "
        f"seconds {json.dumps(seconds)}; peak device memory "
        f"{stats['peak_gib']} GiB")
    return res, stats, cand_run


def dist_verdict(name, res, stats, cfg, B, S, **shape_counts):
    if not res.passed:
        raise AssertionError(f"clean {name} check did not PASS")
    if stats["estimate_launches"] < 1 or stats["compare_launches"] < 1:
        raise AssertionError(f"{name}: packed_sq_norms did not run on both "
                             f"the estimate and the compare")
    if stats["other_launches"]:
        raise AssertionError(f"{name}: kernels off its path launched "
                             f"{stats['other_launches']}")
    check_trace_shapes(res, cfg, B, S, **shape_counts)


def bit_identical(t1, t2) -> list[str]:
    """Every (section, name) where two traces differ in any bit."""
    from repro_torch.core.collector import SECTION_FIELDS
    import torch
    out = []
    for sec in SECTION_FIELDS:
        s1, s2 = getattr(t1, sec), getattr(t2, sec)
        if list(s1) != list(s2):
            out.append(f"{sec}: names differ")
            continue
        out += [f"{sec}:{n}" for n in s1
                if not torch.equal(s1.raw(n), s2.raw(n))]
    if not all(_same_scalar(a, b) for a, b in ((t1.loss, t2.loss),
                                               (t1.grad_norm, t2.grad_norm))):
        out.append("loss or grad norm")
    return out


def _same_scalar(a, b) -> bool:
    """Two losses or grad norms equal: f32 device scalars or host floats,
    read back exactly (NaN where a trace has none)."""
    a, b = float(a), float(b)
    return a == b or (math.isnan(a) and math.isnan(b))


def dist_main(cfg, model, batch, B, S):
    """The dp2 cp2 tp2 sp candidate (8 emulated ranks) must PASS; a second
    candidate run must give a bit-identical trace."""
    res, stats, cand_run = dist_check(cfg, model, batch, DIST_MAIN)
    dist_verdict("dist_main", res, stats, cfg, B, S)
    diffs = bit_identical(res.candidate, cand_run(batch))
    if diffs:
        raise AssertionError(f"two candidate runs differ in {len(diffs)} "
                             f"tensors, first {diffs[:5]}")
    log("dist_main: a second candidate run is bit-identical in every section")
    return stats


def dist_zero1(cfg, model, batch, B, S):
    res, stats, _ = dist_check(cfg, model, batch, DIST_ZERO1)
    dist_verdict("dist_zero1", res, stats, cfg, B, S)
    return stats


def dist_control(cfg, model, batch):
    """Each control bug must FAIL and be localized to its registry module."""
    import fnmatch
    from repro_torch.bugs.registry import BUGS
    out = {}
    for bug, kw in DIST_CONTROLS:
        res, stats, _ = dist_check(cfg, model, batch, kw, bugs=(bug,))
        loc = res.localized_module
        want = BUGS[bug].expected_module
        if res.passed or loc is None or not fnmatch.fnmatchcase(loc, want):
            raise AssertionError(f"{bug} under {kw}: passed={res.passed}, "
                                 f"localized {loc!r}, expected {want!r}")
        log(f"dist_control {bug}: FAIL, localized {loc!r} ({want!r})")
        out[bug] = dict(stats, localized=loc)
    return out


# ---------------------------------------------------------------------------
# phases 20a-20e: the supervised loop (step builders, async checker,
# checkpoints, journal, bisection, resume) over full-width gpt-paper
# ---------------------------------------------------------------------------

def sup_model(cfg, device, seed=0):
    from repro_torch.models.model import Model
    return Model(cfg, seed=seed, device=device)


def dir_gb(root) -> float:
    """GB of the files under ``root`` (what a phase left on the disk)."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(root) for f in fs) / 1e9


def sup_run(cfg, device, work_dir, pcfg_kw, steps, lr=1e-3, bugs=(),
            **scfg_kw):
    """One ``Supervisor`` run of full-width gpt-paper at B 8 x S 1024 on
    ``device``, every launch count set to 0 just before and read just
    after.  Each check launches the rel-err kernel once, so on a run that
    neither bisects nor localizes the threshold estimate's launches are
    the rest.  Returns (supervisor, result, stats)."""
    import torch
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel.api import ParallelConfig
    from repro_torch.supervise import SuperviseConfig, Supervisor

    B, S = SUP_BATCH
    pcfg = ParallelConfig(bugs=frozenset(bugs), **pcfg_kw)
    scfg = SuperviseConfig(steps=steps, work_dir=work_dir, seed=0, **scfg_kw)
    sup = Supervisor(sup_model(cfg, device), cfg, pcfg, AdamW(lr=lr),
                     scfg=scfg, batch_size=B, seq_len=S, device=device,
                     log_fn=log)
    base_gib = None
    if device.type == "cuda":
        # a finished supervisor's objects form reference cycles: collect
        # the earlier phases' before this run's memory is read
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base_gib = torch.cuda.memory_allocated(device) / 2**30
    reset_counts()
    t0 = time.perf_counter()
    res = sup.run()
    counts = read_counts()
    seconds = time.perf_counter() - t0
    worst = {k: (max(r.rel_err / r.threshold for r in rep.records)
                 if rep is not None and rep.records else None)
             for k, rep in sorted(res.checks.items())}
    stats = dict(
        counts=counts, checks=len(res.checks), worst=worst, seconds=seconds,
        estimate_launches=(None if res.flagged else
                           counts["packed_sq_norms"] - len(res.checks)),
        steps=res.timings.get("steps", []),
        timings={k: v for k, v in res.timings.items() if k != "steps"},
        peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                  if device.type == "cuda" else None),
        base_gib=base_gib,
        card_gib=(torch.cuda.get_device_properties(device).total_memory
                  / 2**30 if device.type == "cuda" else None))
    log(res.summary())
    log(f"supervised {pcfg_kw} bugs {sorted(bugs)} lr {lr} "
        f"{json.dumps(scfg_kw)}: {res.steps_run} steps in {seconds:.2f} s; "
        f"packed_sq_norms launches {counts['packed_sq_norms']}: one a "
        f"check over {stats['checks']} checked steps, the estimate "
        f"{stats['estimate_launches']}; all launches {json.dumps(counts)}; "
        f"peak device memory {stats['peak_gib']} GiB of "
        f"{stats['card_gib']} GiB ({base_gib} GiB held before the run)")
    log("worst rel-err / threshold by step: " + json.dumps(worst))
    log("seconds by step (reference and candidate between events on the "
        "stream, check and wall on the host): " + json.dumps(stats["steps"]))
    log("timings: " + json.dumps(stats["timings"]))
    log(f"work dir holds {dir_gb(work_dir):.3f} GB")
    return sup, res, stats


def _check_records(res) -> dict:
    from repro_torch.supervise.journal import report_to_payload
    return {k: report_to_payload(v) for k, v in res.checks.items()}


def _states_equal(s1, s2) -> list[str]:
    """Every leaf where two ((ref_p, ref_opt), (cand_p, cand_opt)) states
    differ in any bit."""
    from repro_torch.checkpoint.store import flatten_named
    import torch
    a, b = flatten_named(s1), flatten_named(s2)
    if list(a) != list(b):
        return ["names differ"]
    return [n for n in a if not (
        torch.equal(a[n], b[n]) if isinstance(a[n], torch.Tensor)
        else a[n] == b[n])]


def sup_clean(cfg, device, root):
    """20a: clean dp2·tp2·zero1 candidate, overlapped, spill on."""
    sup, res, stats = sup_run(cfg, device, os.path.join(root, "a"),
                              SUP_PCFG, steps=8, **SUP_SCFG)
    if not res.passed or len(res.checks) != 8:
        raise AssertionError(f"clean supervised run: passed={res.passed}, "
                             f"{len(res.checks)} checks of 8")
    if stats["estimate_launches"] != 5:
        raise AssertionError(f"packed_sq_norms: {stats['counts']} launches "
                             f"for 8 checks, want one a check and 5 (one a "
                             f"trace kind) in the estimate")
    off_path = {k: v for k, v in stats["counts"].items()
                if k != "packed_sq_norms" and v}
    if off_path:
        raise AssertionError(f"kernels off the path launched {off_path}")
    if stats["peak_gib"] is not None and stats["peak_gib"] >= stats["card_gib"]:
        raise AssertionError(f"peak {stats['peak_gib']} GiB")
    log(f"ring: {sup.ring.in_memory} in memory, {sup.ring.on_disk} "
        f"spilled; checkpoints {sup.keeper.steps}")
    return sup.state, res, stats


def sup_lockstep(cfg, device, root, clean):
    """20b: the same run lockstep: verdicts, rel-errs and final states
    bit-identical to 20a.  Spill is off (it enters no verdict; its writes
    would take the machine's disk past its limit)."""
    state_a, res_a, stats_a = clean
    sup, res, stats = sup_run(cfg, device, os.path.join(root, "b"),
                              SUP_PCFG, steps=8,
                              **dict(SUP_SCFG, overlap=False, spill=False))
    if _check_records(res) != _check_records(res_a):
        raise AssertionError("lockstep verdicts or rel-errs differ from "
                             "the overlapped run's")
    if res.losses != res_a.losses or res.cand_losses != res_a.cand_losses:
        raise AssertionError("lockstep losses differ")
    diffs = _states_equal(sup.state, state_a)
    if diffs:
        raise AssertionError(f"final states differ in {diffs[:5]}")
    log(f"lockstep == overlapped: {len(res.checks)} verdicts, every "
        f"rel-err, every loss and final state bit-identical; loop "
        f"{stats['timings']['loop_s']:.3f} s lockstep vs "
        f"{stats_a['timings']['loop_s']:.3f} s overlapped")
    return stats


def sup_resume(cfg, root):
    """20c: crash and resume through the CLI: ``python -m
    repro_torch.launch.supervise --fault crash --fault-step 5`` is
    SIGKILLed at the top of step 5; ``--resume`` of its work dir, and an
    uninterrupted run, go through the same CLI code (``launch.supervise.
    run``) in this process.  The resumed run's journaled verdicts,
    rel-errs and final states equal the uninterrupted run's.  20a's
    config, with spill off and a checkpoint every 4 steps for the disk."""
    from repro_torch.launch import supervise as cli
    from repro_torch.supervise.journal import (Journal, JournalState,
                                               journal_path,
                                               report_to_payload)
    B, S = SUP_BATCH
    argv = ["--arch", cfg.name, "--layers", str(cfg.n_layers), "--steps",
            "8", "--batch", str(B), "--seq", str(S), "--zero1",
            "--check-every", "1", "--async-window", "2", "--ckpt-every", "4",
            "--ring-window", "2", "--no-spill"]
    crashed = os.path.join(root, "c_crash")
    whole = os.path.join(root, "c_whole")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    seconds = {}
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.supervise", *argv,
         "--work-dir", crashed, "--fault", "crash", "--fault-step", "5"],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    seconds["crash"] = time.perf_counter() - t0
    log(f"--- cli crash: rc {out.returncode} in {seconds['crash']:.2f} s\n"
        + "\n".join(out.stdout.strip().splitlines()[-3:]))
    if out.returncode != -9:
        raise AssertionError(f"cli crash: rc {out.returncode}, want -9 "
                             f"(SIGKILL)\n{out.stdout}\n{out.stderr}")
    runs = {}
    for name, extra in (("resume", ["--work-dir", crashed, "--resume"]),
                        ("whole", ["--work-dir", whole])):
        t0 = time.perf_counter()
        runs[name] = cli.run(cli.parse_args(argv + extra))
        seconds[name] = time.perf_counter() - t0
    (sup_r, res_r), (sup_w, res_w) = runs["resume"], runs["whole"]
    if res_r.resumed_from is None or res_r.flagged or res_w.flagged:
        raise AssertionError("the resumed or the uninterrupted run flagged, "
                             "or the resume did not resume")
    v_res, v_whole = ({k: report_to_payload(v) for k, v in JournalState(
        Journal.read(journal_path(d))).verdicts.items()}
        for d in (crashed, whole))
    if v_res != v_whole or len(v_whole) != 8:
        raise AssertionError(f"journaled verdicts differ: resumed steps "
                             f"{sorted(v_res)}, uninterrupted "
                             f"{sorted(v_whole)}")
    diffs = _states_equal(sup_r.state, sup_w.state)
    if diffs:
        raise AssertionError(f"final states differ in {diffs[:5]}")
    log(f"resume: from step {res_r.resumed_from}; 8 journaled verdicts and "
        f"every final state leaf bit-identical to the uninterrupted run's; "
        f"seconds {json.dumps(seconds)}")
    return dict(seconds=seconds, resumed_from=res_r.resumed_from)


def sup_late_bug(cfg, device, root):
    """20d: zero_skipped_update at a fine-tuning lr: the single-step check
    at step 0 PASSes, the supervisor flags at a later step and bisects to
    a first bad step at or before it."""
    from repro_torch.core.harness import make_model_runner, ttrace_check
    from repro_torch.core.thresholds import MACHINE_EPS
    from repro_torch.data.synthetic import make_batch
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel.api import ParallelConfig, make_candidate_runner

    bug = "zero_skipped_update"
    B, S = SUP_BATCH
    model = sup_model(cfg, device)
    opt = AdamW(lr=SUP_LATE_LR)
    pcfg = ParallelConfig(bugs=frozenset([bug]), **SUP_PCFG)
    reset_counts()
    # the supervisor's own epsilon (CandidateStep.build): bf16 here
    eps = max(MACHINE_EPS["float32"], MACHINE_EPS[cfg.compute_dtype])
    one = ttrace_check(make_model_runner(model, opt, device=device),
                       make_candidate_runner(cfg, pcfg, model, opt,
                                             device=device),
                       make_batch(cfg, B, S, seed=0, device=device),
                       eps=eps, localize=False)
    worst = max(r.rel_err / r.threshold for r in one.report.records)
    log(f"single-step check at step 0, lr {SUP_LATE_LR}: "
        f"{'PASS' if one.passed else 'FAIL'} (largest rel-err / threshold "
        f"{worst:.4f}); launches {json.dumps(read_counts())}")
    del model, one
    sup, res, stats = sup_run(cfg, device, os.path.join(root, "d"),
                              SUP_PCFG, steps=16, lr=SUP_LATE_LR,
                              bugs=(bug,), check_every=2, ckpt_every=4,
                              spill=False)
    log(f"late bug: flagged at step {res.first_flagged_step}, first bad "
        f"step {res.first_bad_step}, localized {res.localized_module!r}")
    if worst >= 1.0:
        raise AssertionError("the single-step check is not blind at this lr")
    if not res.flagged or not res.first_flagged_step or (
            res.first_bad_step is None
            or res.first_bad_step > res.first_flagged_step):
        raise AssertionError(f"supervisor: flagged={res.flagged}, first "
                             f"flagged {res.first_flagged_step}, first bad "
                             f"{res.first_bad_step}")
    return dict(stats, first_flagged=res.first_flagged_step,
                first_bad=res.first_bad_step, module=res.localized_module,
                single_step_worst=worst)


def sup_fp8(cfg, device, root):
    """20e: the fp8-tile128 candidate under supervision, 4 clean steps."""
    sup, res, stats = sup_run(cfg, device, os.path.join(root, "e"),
                              {"fp8": "tile128"}, steps=4, spill=False)
    per_step = stats["counts"]["fp8_matmul_tile128"] / 4
    want = FP8_LAUNCHES_PER_RUN * cfg.n_layers // 12
    log(f"fp8-tile128 supervised: fp8_matmul_tile128 launches "
        f"{stats['counts']['fp8_matmul_tile128']} ({per_step:g} per "
        f"candidate step, 3 MLP matmuls x {cfg.n_layers} layers)")
    if not res.passed or len(res.checks) != 4:
        raise AssertionError(f"fp8 supervised run: passed={res.passed}")
    if per_step != want or stats["counts"]["fp8_matmul"]:
        raise AssertionError(f"fp8 launches {stats['counts']}")
    return stats


def sup_phases(cfg, phase):
    """Phases 20a-20e, then the pipeline phases 21a-21d, in a temporary
    work dir, removed at the end."""
    import shutil
    import tempfile
    import torch
    dev = torch.device("cuda")
    full = cfg
    cfg = dataclasses.replace(cfg, n_layers=SUP_LAYERS)
    root = tempfile.mkdtemp(prefix="chip_smoke_supervise_")
    out = {}
    try:
        clean = phase("sup_clean", lambda: sup_clean(cfg, dev, root))
        if clean is not None:
            out["clean"] = clean[2]
            out["lockstep"] = phase("sup_lockstep", lambda: sup_lockstep(
                cfg, dev, root, clean))
        clean = None
        shutil.rmtree(os.path.join(root, "a"), ignore_errors=True)
        out["resume"] = phase("sup_resume", lambda: sup_resume(cfg, root))
        out["late_bug"] = phase("sup_late_bug",
                                lambda: sup_late_bug(cfg, dev, root))
        out["fp8"] = phase("sup_fp8", lambda: sup_fp8(cfg, dev, root))
        out["pp"] = pp_phases(full, cfg, dev, root, phase)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 21a-21d: the pipeline candidates (staged and 1F1B, stages emulated
# on the one card) of full-width gpt-paper, their bugs, and the Supervisor
# ---------------------------------------------------------------------------

def pp_model(cfg, device):
    """Phase 4's full-width model and batch, made anew (seed 0)."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model
    B, S = SUP_BATCH
    return (Model(cfg, seed=0, device=device),
            make_batch(cfg, B, S, seed=0, device=device))


def pp_check(cfg, model, batch, kw, bugs=()):
    """``dist_check`` of a pipeline candidate, with the card's memory."""
    import torch
    res, stats, run = dist_check(cfg, model, batch, kw, bugs)
    stats["card_gib"] = (torch.cuda.get_device_properties(model.device)
                         .total_memory / 2**30
                         if model.device.type == "cuda" else None)
    log(f"pp {kw} bugs {sorted(bugs)}: {'PASS' if res.passed else 'FAIL'}, "
        f"largest rel-err / threshold {stats['worst']:.4f}, peak "
        f"{stats['peak_gib']} GiB of {stats['card_gib']} GiB")
    return res, stats, run


def pp_staged(cfg, device):
    """21a: the staged candidate at pp 4 and pp 5 must PASS."""
    from repro_torch.parallel.pp import stage_division
    model, batch = pp_model(cfg, device)
    B, S = SUP_BATCH
    out = {}
    for pp in PP_STAGED:
        log(f"pp {pp} stages {stage_division(cfg.n_layers, pp)}")
        res, stats, _ = pp_check(cfg, model, batch, dict(pp=pp))
        dist_verdict(f"pp{pp}", res, stats, cfg, B, S)
        out[pp] = stats
    return out


def pp_engine_runs(cfg, model, batch, bugs=()):
    """The 1F1B engine's own runs over ``model``'s parameters: the
    concurrent and the ordered drive and a rerun, timed; returns the
    engine and its traces."""
    import torch
    from repro_torch.core.collector import named_params
    from repro_torch.parallel.pp1f1b import PP1F1BEngine
    params = {k: p.detach() for k, p in named_params(model).items()}
    out = {}
    for name, dispatch in (("concurrent", "concurrent"),
                           ("ordered", "ordered"),
                           ("rerun", "concurrent")):
        if name != "rerun":
            eng = PP1F1BEngine(model, PP_1F1B["pp"], PP_1F1B["microbatches"],
                               bugs=frozenset(bugs), dispatch=dispatch,
                               device=model.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr, grads, rep = eng.collect(params, batch)
        torch.cuda.synchronize()
        out[name] = dict(trace=tr, grads=grads, report=rep,
                         seconds=time.perf_counter() - t0,
                         order=list(eng.last_order),
                         max_stash=list(eng.max_stash))
    return eng, params, out


def pp_1f1b(cfg, device):
    """21b: the 1F1B candidate at pp 4 x M 4 must PASS through the user's
    entry point; the engine's per-stage op order is ``stage_op_stream``,
    its merge report is clean, its stash bounded, a rerun and the ordered
    drive are bit-identical, and the plan merge equals
    ``merge_microbatch_traces`` of the same records bit for bit."""
    import torch
    from repro_torch.core.merger import MergePlan, merge_microbatch_traces
    from repro_torch.parallel.pp1f1b import stage_op_stream
    model, batch = pp_model(cfg, device)
    B, S = SUP_BATCH
    res, stats, _ = pp_check(cfg, model, batch, PP_1F1B)
    dist_verdict("pp_1f1b", res, stats, cfg, B, S)
    del res
    pp, M = PP_1F1B["pp"], PP_1F1B["microbatches"]
    eng, params, runs = pp_engine_runs(cfg, model, batch)
    for name, r in runs.items():
        if not r["report"].ok:
            raise AssertionError(f"{name}: merge report "
                                 f"{r['report'].problems()}")
        for s in range(pp):
            ops = [op for op in r["order"] if op[1] == s]
            if ops != stage_op_stream(pp, s, M):
                raise AssertionError(f"{name}: stage {s} ran {ops}")
            if r["max_stash"][s] > pp - s:
                raise AssertionError(f"{name}: stage {s} stashed "
                                     f"{r['max_stash'][s]} inputs")
    for name in ("ordered", "rerun"):
        diffs = bit_identical(runs["concurrent"]["trace"], runs[name]["trace"])
        if diffs or not all(torch.equal(runs["concurrent"]["grads"][n],
                                        runs[name]["grads"][n])
                            for n in runs[name]["grads"]):
            raise AssertionError(f"{name} differs from the concurrent drive "
                                 f"in {diffs[:5]} or its grads")
    recs, _ = eng.run_schedule(params, batch)
    full, _ = merge_microbatch_traces(recs, eng.tables, M)
    planned, _ = MergePlan.build(recs, eng.tables, M).execute(recs)
    # the merges carry no loss: the engine's trace is held section by section
    diffs = bit_identical(full, planned) + [
        d for d in bit_identical(full, runs["concurrent"]["trace"])
        if d != "loss or grad norm"]
    if diffs:
        raise AssertionError(f"plan merge differs from the full merge in "
                             f"{diffs[:5]}")
    seconds = {k: r["seconds"] for k, r in runs.items()}
    log(f"pp_1f1b engine: per-stage order == stage_op_stream, stash "
        f"{runs['concurrent']['max_stash']}, merge report ok; ordered drive,"
        f" rerun and the full merge bit-identical; engine collect seconds "
        f"{json.dumps(seconds)}")
    return dict(stats, engine_seconds=seconds,
                max_stash=runs["concurrent"]["max_stash"])


def pp_controls(cfg, device):
    """21c: each pp bug must FAIL where it should; the microbatch-order
    bug leaves the forward and the loss byte-identical to the clean
    engine's and is caught in the gradient sections only."""
    import fnmatch
    import torch
    model, batch = pp_model(cfg, device)
    out = {}
    for bug, kw, want in PP_CONTROLS:
        res, stats, _ = pp_check(cfg, model, batch, kw, bugs=(bug,))
        loc = res.localized_module
        flagged = sorted({r.kind for r in res.report.records if r.flagged})
        log(f"pp_control {bug}: {'PASS' if res.passed else 'FAIL'}, "
            f"localized {loc!r}, flagged kinds {flagged}")
        if res.passed:
            raise AssertionError(f"{bug} under {kw} passed")
        if want is not None and not (loc and fnmatch.fnmatchcase(loc, want)):
            raise AssertionError(f"{bug}: localized {loc!r}, want {want!r}")
        if want is None and "activation" in flagged:
            raise AssertionError(f"{bug}: an activation flagged")
        out[bug] = dict(stats, localized=loc, flagged_kinds=flagged)
        del res
    # pp_microbatch_order: the forward and the loss byte-identical
    _, _, clean = pp_engine_runs(cfg, model, batch)
    _, _, bad = pp_engine_runs(cfg, model, batch,
                               bugs=("pp_microbatch_order",))
    tc, tb = clean["concurrent"]["trace"], bad["concurrent"]["trace"]
    same = (list(tc.activations) == list(tb.activations)
            and all(torch.equal(tc.activations.raw(n), tb.activations.raw(n))
                    for n in tc.activations)
            and torch.equal(tc.loss, tb.loss))
    if not same:
        raise AssertionError("pp_microbatch_order changed the forward")
    log("pp_microbatch_order: activations and loss byte-identical to the "
        "clean engine's")
    return out


def sup_pp(cfg, device, root):
    """21d: the pp-1f1b recipe supervised for 4 steps PASSes each; the CLI's
    staged pp recipe under pp_wrong_stage_division flags at step 0."""
    sup, res, stats = sup_run(cfg, device, os.path.join(root, "pp"), SUP_PP,
                              steps=4, spill=False, ckpt_every=4)
    log(f"pp-1f1b supervised: candidate {sup.candidate.name}, kind_scale "
        f"{sup.pipe.kind_scale}, checkpoints {sup.keeper.steps}")
    if not res.passed or len(res.checks) != 4:
        raise AssertionError(f"pp-1f1b supervised run: passed={res.passed}")
    if sup.candidate.name != "pp1f1b2x4" or sup.pipe.kind_scale != 2.0:
        raise AssertionError("candidate name or kind_scale")
    if stats["estimate_launches"] != 5 or sup.keeper.steps != [0]:
        raise AssertionError(f"launches {stats['counts']}, checkpoints "
                             f"{sup.keeper.steps}")
    del sup, res
    B, S = SUP_BATCH
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    argv = ["--arch", cfg.name, "--layers", str(cfg.n_layers), "--steps",
            "4", "--batch", str(B), "--seq", str(S), "--recipe", "pp",
            "--bug", "pp_wrong_stage_division", "--no-spill",
            "--device", device.type, "--work-dir", os.path.join(root, "pp_cli")]
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.supervise", *argv],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    cli_s = time.perf_counter() - t0
    lines = cli.stdout.strip().splitlines()
    log(f"--- cli {' '.join(argv[:-4])}: rc {cli.returncode} in "
        f"{cli_s:.2f} s\n" + "\n".join(lines[-12:]))
    bad = [ln for ln in lines if "FIRST BAD STEP:" in ln]
    loc = [ln for ln in lines if "localized:" in ln and "expected" in ln]
    if (cli.returncode != 0 or not bad or bad[-1].split(":")[-1].strip()
            != "0" or not loc or "-> localized: layers." not in
            " ".join(loc[-1].split())):
        raise AssertionError(f"cli pp run: rc {cli.returncode}\n"
                             f"{cli.stdout[-3000:]}\n{cli.stderr[-3000:]}")
    log(f"work dir holds {dir_gb(root):.3f} GB after the pp phases, "
        f"{dir_gb(os.path.join(root, 'pp')):.3f} GB of them the supervised "
        f"pp-1f1b run's and {dir_gb(os.path.join(root, 'pp_cli')):.3f} GB "
        f"the CLI run's")
    return dict(stats, cli_seconds=cli_s)


def pp_phases(full, cfg, device, root, phase):
    """Phases 21a-21c at full width, 21d at ``SUP_LAYERS``."""
    import torch
    out = {}
    for name, fn in (("pp_staged", lambda: pp_staged(full, device)),
                     ("pp_1f1b", lambda: pp_1f1b(full, device)),
                     ("pp_controls", lambda: pp_controls(full, device)),
                     ("sup_pp", lambda: sup_pp(cfg, device, root))):
        out[name] = phase(name, fn)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 16-19: the rwkv6-7b check whose time mix runs on the gla_scan kernel
# ---------------------------------------------------------------------------

def ssm_inputs(shape, dtype, device, seed, broadcast=False):
    """q, k, v in ``dtype`` and f32 log_w for one ``gla_scan`` shape.  The
    sweep draws its decays as ``test_kernels.py`` does; rwkv6-7b's come
    from the model's own formula, -exp(w0 + tanh(x A) B) with its init
    (w0 = -6, A and B at 0.02); zamba2's are -softplus(normal), the
    reference test's scalar draw.  ``broadcast``: q and k are one head's
    values expanded over the heads (head stride 0), as the Mamba2 mixer
    hands them over."""
    import torch
    import torch.nn.functional as F
    B, S, H, dk, dv, _, scalar, _ = shape
    gen = torch.Generator().manual_seed(seed)

    def randn(*size):
        return torch.randn(size, generator=gen).to(device)
    Hqk = 1 if broadcast else H
    q, k, v = (randn(B, S, h, d).to(dtype).expand(B, S, H, d)
               for h, d in ((Hqk, dk), (Hqk, dk), (H, dv)))
    if scalar:
        lw = -F.softplus(randn(B, S, H, 1))
    elif shape == SSM_RWKV:
        d = H * dk
        x = randn(B * S, d)
        lora = torch.tanh(x @ (0.02 * randn(d, 64))) @ (0.02 * randn(64, d))
        lw = -torch.exp(-6.0 + lora).reshape(B, S, H, dk)
    else:
        lw = -0.02 * torch.sigmoid(randn(B, S, H, dk))
    return q, k, v, lw.float().contiguous()


def normwise(got, ref):
    return float((got.double() - ref).norm() / ref.norm().clamp_min(1e-300))


def check_ssm_kernel(device):
    """``gla_scan`` against its plain version in float64 on the same inputs:
    the reference tests' sweep in f32 within SSM_SWEEP_TOL absolute, the
    rwkv6 and zamba2 full-width shapes, SSM_UNALIGNED and the zamba2
    check's own operands (SSM_ZAMBA_PATH, q and k of head stride 0) (bf16
    q, k, v) within SSM_NORM_TOL normwise; two launches bit-identical;
    out-of-contract shapes and operands raise.  Returns the largest
    |kernel - plain (f32)|."""
    import torch
    from repro_torch.kernels import ssm_scan as K

    worst = 0.0
    cases = ([(shape, torch.float32, False) for shape in SSM_SWEEP]
             + [(SSM_RWKV, torch.bfloat16, False),
                (SSM_ZAMBA, torch.bfloat16, False),
                (SSM_UNALIGNED, torch.bfloat16, False),
                (SSM_ZAMBA_PATH, torch.bfloat16, True)])
    for i, (shape, dtype, bcast) in enumerate(cases):
        chunk, excl = shape[5], shape[7]
        q, k, v, lw = ssm_inputs(shape, dtype, device, seed=200 + i,
                                 broadcast=bcast)
        if bcast and not (q.stride(2) == k.stride(2) == 0
                          and K.staging_vec(q, k, v, lw)):
            raise AssertionError(f"broadcast operands: strides {q.stride()}")
        y1, s1 = K.gla_scan(q, k, v, lw, chunk=chunk, exclusive=excl)
        y2, s2 = K.gla_scan(q, k, v, lw, chunk=chunk, exclusive=excl)
        yp, sp = K.gla_scan_ref(q, k, v, lw, chunk=chunk, exclusive=excl)
        y64, s64 = K.gla_scan_ref(q.double(), k.double(), v.double(),
                                  lw.double(), chunk=chunk, exclusive=excl)
        torch.cuda.synchronize(device)
        what = (f"gla_scan {shape[:6]} {'scalar' if shape[6] else 'channel'}"
                f"{' exclusive' if excl else ''} {str(dtype)[6:]}"
                f"{' q/k head stride 0' if bcast else ''}")
        if y1.dtype != torch.float32 or tuple(y1.shape) != tuple(yp.shape) \
                or tuple(s1.shape) != tuple(sp.shape):
            raise AssertionError(f"{what}: got {y1.dtype} {tuple(y1.shape)} "
                                 f"{tuple(s1.shape)}")
        if not (torch.equal(y1, y2) and torch.equal(s1, s2)):
            raise AssertionError(f"{what}: two launches differ")
        errs = {}
        for name, (y, st) in (("kernel", (y1, s1)), ("plain", (yp, sp))):
            if not (bool(y.isfinite().all()) and bool(st.isfinite().all())):
                raise AssertionError(f"{what} {name}: not finite")
            if dtype == torch.float32:
                e = max(float((y.double() - y64).abs().max()),
                        float((st.double() - s64).abs().max()))
                ok = e <= SSM_SWEEP_TOL
            else:
                e = max(normwise(y, y64), normwise(st, s64))
                ok = e <= SSM_NORM_TOL
            errs[name] = e
            if not ok:
                raise AssertionError(f"{what} {name}: error {e:.3g} against "
                                     f"float64")
        err = max(float((y1 - yp).abs().max()), float((s1 - sp).abs().max()))
        worst = max(worst, err)
        log(f"{what}: ok, max |kernel - plain| {err:.3g}, against float64: "
            f"kernel {errs['kernel']:.3g}, plain {errs['plain']:.3g} "
            f"({'absolute' if dtype == torch.float32 else 'normwise'})")
        del q, k, v, lw, y1, s1, y2, s2, yp, sp, y64, s64

    # shapes and operands outside the contract raise
    small = (1, 256, 2, 64, 64, 128, False, True)
    q, k, v, lw = ssm_inputs(small, torch.bfloat16, device, 9)
    wide = torch.zeros((1, 256, 2, 192), dtype=torch.bfloat16, device=device)
    strided = torch.zeros((1, 256, 2, 64, 2), dtype=torch.bfloat16,
                          device=device)[..., 0]
    refused = [
        lambda: K.gla_scan(q[:, :200], k[:, :200], v[:, :200], lw[:, :200]),
        lambda: K.gla_scan(q, k, v, lw[..., :3]),             # log_w dim 3
        lambda: K.gla_scan(wide, wide, v, lw[..., :1]),       # dk 192
        lambda: K.gla_scan(q, k, v, lw, chunk=256),           # chunk 256
        lambda: K.gla_scan(q, k, v, lw.bfloat16()),           # bf16 log_w
        lambda: K.gla_scan(q.float(), k, v, lw),              # mixed dtypes
        lambda: K.gla_scan(q, k.cpu(), v, lw),                # a CPU k
        lambda: K.gla_scan(strided, k, v, lw),                # q stride 2
    ]
    for i, call in enumerate(refused):
        try:
            call()
        except (ValueError, TypeError) as e:
            log(f"refused as it should be: {e}")
        else:
            raise AssertionError(f"out-of-contract gla_scan call {i} was "
                                 f"accepted")
    return worst


def gla_lin_attn(q, k, v, log_w, chunk=128, u=None, s0=None, chunked=True):
    """``models.ssm.lin_attn`` on ``kernels.ops.gla_scan``: ``u`` given is
    rwkv6's per-channel exclusive scan with its bonus, ``u=None`` Mamba2's
    scalar inclusive one.  The kernel starts from a zero state, so a call
    with ``s0`` (a decode) or the recurrent form raises."""
    from repro_torch.kernels import ops
    if s0 is not None or not chunked:
        raise ValueError("the gla_scan candidate runs the chunked scan from "
                         "a zero state")
    return ops.gla_scan(q, k, v, log_w, chunk=chunk, exclusive=u is not None,
                        u=u)


def gla_runner(model, opt):
    """The gla_scan candidate as a user builds it: the reference model with
    its chunked scan replaced by the kernel.  ``models.ssm.lin_attn`` is
    bound to ``gla_lin_attn`` for the length of the candidate's own
    forward and restored after it; the generic collector traces the step."""
    from repro_torch.core.collector import named_params, trace_fn_step
    from repro_torch.core.harness import inputs_on
    from repro_torch.models import ssm
    params = named_params(model)

    def loss_call(batch, ctx):
        plain = ssm.lin_attn
        ssm.lin_attn = gla_lin_attn
        try:
            return model.loss(batch, ctx=ctx)[0]
        finally:
            ssm.lin_attn = plain

    def run(batch, rewrites=None):
        b, rw = inputs_on(model.device, batch, rewrites)
        tr, _, _ = trace_fn_step(loss_call, params, b, opt=opt, rewrites=rw)
        return tr

    return run


def ssm_check(model, batch, cand_model=None):
    """One ``ttrace_check`` of the gla_scan candidate over ``cand_model``
    (default ``model``) against the plain ``model``, with every launch count
    set to 0 just before and read just after."""
    from repro_torch.core.harness import make_model_runner, ttrace_check
    from repro_torch.core.thresholds import MACHINE_EPS
    from repro_torch.optim.adamw import AdamW

    opt = AdamW(lr=1e-3)
    ref_runs, cand_runs = [], []
    ref = counted_runner(make_model_runner(model, opt, device=model.device),
                         ref_runs)
    cand = counted_runner(gla_runner(cand_model or model, opt), cand_runs)
    reset_counts()
    res = ttrace_check(ref, cand, batch, eps=MACHINE_EPS["bfloat16"])
    return res, read_counts(), ref_runs, cand_runs


def ssm_main(device, B, S):
    """The clean check of full-width rwkv6-7b cut to SSM_LAYERS layers;
    returns the verdict's numbers, the model and the batch."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config("rwkv6-7b"), n_layers=SSM_LAYERS)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    model = Model(cfg, seed=0, device=device)
    batch = make_batch(cfg, B, S, seed=0, device=device)
    log(f"rwkv6-7b, {SSM_LAYERS} layers: "
        f"{sum(p.numel() for p in model.parameters())} parameters, built in "
        f"{time.perf_counter() - t0:.2f} s")
    res, counts, ref_runs, cand_runs = ssm_check(model, batch)
    peak = torch.cuda.max_memory_allocated(device)
    ratio, where = worst_record(res)
    log(res.summary())
    log(f"ssm_main: launches {counts}; per reference run {ref_runs}; per "
        f"candidate run {cand_runs}; step seconds {json.dumps(res.seconds)}; "
        f"largest rel-err / threshold {ratio:.4f} ({where}); peak memory "
        f"{peak} bytes ({peak / 2**30:.2f} GiB)")
    if not res.passed:
        raise AssertionError("clean rwkv6-7b gla_scan check did not PASS")
    if [r["gla_scan"] for r in cand_runs] != [SSM_LAUNCHES_PER_RUN]:
        raise AssertionError(f"ssm_main: candidate runs launched {cand_runs},"
                             f" expected {SSM_LAUNCHES_PER_RUN} gla_scan "
                             f"launches")
    if any(r["gla_scan"] for r in ref_runs):
        raise AssertionError("ssm_main: the reference launched the kernel")
    check_trace_shapes(res, cfg, B, S, taps_per_layer=4, params_per_layer=21)
    out = dict(launches=counts["gla_scan"], seconds=res.seconds,
               worst=(where, ratio), peak_bytes=peak)
    del res
    return out, cfg, model, batch


def ssm_control(model, batch):
    """The candidate with ``layers.1.time_mix.key.w`` doubled must FAIL and
    be localized to ``layers.1.time_mix`` or a module inside it.  Every term
    of the time mix's y is linear in k and the per-head group norm divides
    the scale out, so the forward barely moves: where only that weight's
    gradients and update flag, the checker's own rule names the linear that
    owns it, ``layers.1.time_mix.key``."""
    import copy
    import torch
    torch.cuda.reset_peak_memory_stats()
    bad = copy.deepcopy(model)
    with torch.no_grad():
        bad.layers[1].time_mix.key.w.mul_(2.0)
    res, counts, _, cand_runs = ssm_check(model, batch, cand_model=bad)
    peak = torch.cuda.max_memory_allocated()
    log(res.summary())
    ratio, where = worst_record(res)
    log(f"ssm control step seconds: {json.dumps(res.seconds)}; launches "
        f"{counts}; per candidate run {cand_runs}; largest rel-err / "
        f"threshold {ratio:.4f} ({where}); localized {res.localized_module!r}"
        f" ({res.report.localization_mode}); peak memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")
    loc = res.localized_module or ""
    if res.passed or not (loc == "layers.1.time_mix"
                          or loc.startswith("layers.1.time_mix.")):
        raise AssertionError(f"doubled layers.1.time_mix.key.w: passed="
                             f"{res.passed}, localized {loc!r}")
    if counts["gla_scan"] != 2 * SSM_LAUNCHES_PER_RUN:
        raise AssertionError(f"ssm control launched {counts['gla_scan']}, "
                             f"expected {2 * SSM_LAUNCHES_PER_RUN}")
    return loc


def ssm_bound(shape, elem_bytes=2, broadcast=False):
    """(bound ms, bound_by, bytes, flops) of one scan: q, k, v and log_w
    (f32) read once (``broadcast`` q and k: one head's values), y and the
    state (f32) written once; the four products of each chunk counted
    whole (A, A v, q_t S and the state update), on the bf16 tensor
    cores."""
    B, S, H, dk, dv, C, scalar, _ = shape
    dw = 1 if scalar else dk
    Hqk = 1 if broadcast else H
    nbytes = (elem_bytes * B * S * (2 * Hqk * dk + H * dv)
              + 4 * B * S * H * dw + 4 * B * S * H * dv + 4 * B * H * dk * dv)
    flops = B * H * (S // C) * 2 * (C * C * dk + C * C * dv + 2 * C * dk * dv)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes, flops)


def ssm_work(shape, elem_bytes=2):
    """(TF32 flops, bytes) this kernel's design executes and moves for one
    scan: each product at its padded tile sizes (64-row tiles, k8 steps,
    dv to 64 or 128), an f32 operand split in two and a product of two
    split operands taken three times, one with an exact operand (v; q and
    k in the scalar branch) twice, the all-masked s-tile skipped; the
    state pass reads k, v and log_w and writes the scratch, the fold
    reads and writes it, the out pass reads q, k, v, log_w and the scratch
    and writes y."""
    B, S, H, dk, dv, C, scalar, _ = shape
    n, nt = S // C, -(-C // 64)
    dvp, dkp, cp = (64 if dv <= 64 else 128), -(-dk // 8) * 8, -(-C // 8) * 8
    exact_qk = scalar and elem_bytes == 2
    v_passes = 2 if elem_bytes == 2 else 3
    tiles = nt * (nt + 1) // 2
    per_chunk = (2 * 64 * -(-dk // 64) * cp * dvp * v_passes        # state
                 + tiles * 2 * 64 * 64 * dkp * (1 if exact_qk else 3)  # A
                 + 2 * 64 * nt * dkp * dvp * (2 if exact_qk else 3)   # q S
                 + tiles * 2 * 64 * 64 * dvp * v_passes)              # A v
    dw = 1 if scalar else dk
    rows = B * S * H
    k, v, q = (elem_bytes * rows * d for d in (dk, dv, dk))
    lw, y = 4 * rows * dw, 4 * rows * dv
    scratch = 4 * B * H * n * (dk * -(-dv // 4) * 4 + dw)
    nbytes = (k + v + lw + scratch) + 2 * scratch \
        + (q + k + v + lw + scratch + y) + 4 * B * H * dk * dv
    return B * H * n * per_chunk, nbytes


def ssm_builds():
    """Registers, stack and spills of each build of ``ssm_scan.cu``
    (``ptxas -v``), with the dynamic shared memory of the state and out
    passes' blocks at the main path's operands (bf16, chunk 128, dv 64)."""
    import re
    import torch
    from repro_torch.kernels import ssm_scan as K
    builds = ptxas_summary("ssm_scan")
    for name, info in builds.items():
        # gla_state<T, SCALAR, DVP>, gla_out<T, SCALAR, DVP, WIDE>
        m = re.search(r"gla_(state|out)I(13__nv_bfloat16|f)Lb([01])ELi(\d+)E",
                      name)
        if m is None:                     # the fold
            info["dynamic_smem_bytes"] = 0
            continue
        dtype = torch.bfloat16 if m[2] != "f" else torch.float32
        info["dynamic_smem_bytes"] = K.shared_memory(
            dtype, m[3] == "1", int(m[4]), 128)[m[1]]
    return builds


def ssm_timing(device):
    """Per launch at the rwkv6 and zamba2 full-width shapes and on the
    zamba2 check's own operands (B 1, q and k of head stride 0): the kernel
    with the card held busy (``device_time_ms``) without deterministic
    mode's fill of new buffers and with it (as the main path runs), and
    back to back (``cuda_time_ms``); its plain version (f32); beside the
    bound, the kernel's share of it, its executed TF32 rate and this
    design's TF32 floor; each pass's time (CUDA events) and
    the share of a block's SM cycles each phase takes, from one launch of
    the profiled build.  No single PyTorch call computes this function, so
    there is no library yardstick."""
    import torch
    from repro_torch.kernels import ssm_scan as K

    launches = K.gla_scan.launches
    rows = []
    for shape, bcast in ((SSM_RWKV, False), (SSM_ZAMBA, False),
                         (SSM_ZAMBA_PATH, True)):
        q, k, v, lw = ssm_inputs(shape, torch.bfloat16, device, seed=0,
                                 broadcast=bcast)
        chunk, excl = shape[5], shape[7]

        def call():
            return K.gla_scan(q, k, v, lw, chunk=chunk, exclusive=excl)
        with uninitialized_fill(False):
            ms = device_time_ms(call)
        with uninitialized_fill(True):
            filled_ms = device_time_ms(call)
            wrapper_ms = cuda_time_ms(call)
        plain_ms = cuda_time_ms(lambda: K.gla_scan_ref(
            q, k, v, lw, chunk=chunk, exclusive=excl), reps=5, warmup=1)
        bound_ms, bound_by, nbytes, flops = ssm_bound(shape, broadcast=bcast)
        tf32_flops, design_bytes = ssm_work(shape)
        _, _, cycles, pass_ms = K.profile(q, k, v, lw, chunk, excl)
        phases = {}
        for name, c in cycles.items():
            mean = c.double().mean(0).tolist()
            names = K.PHASES[name]
            total = mean[names.index("total")]
            phases[name] = dict(blocks=c.shape[0], block_cycles=total,
                                share={n: m / total for n, m in
                                       zip(names, mean) if n != "total"})
        passes = sum(pass_ms.values())
        rows.append(dict(shape=shape[:6], decay="scalar" if shape[6]
                         else "per-channel", exclusive=excl,
                         qk_head_stride_0=bcast, ms=ms,
                         filled_ms=filled_ms, wrapper_ms=wrapper_ms,
                         plain_ms=plain_ms, library_ms=None,
                         bound_ms=bound_ms, bound_by=bound_by,
                         bound_share=bound_ms / ms, bytes=nbytes,
                         flops=flops, tf32_flops=tf32_flops,
                         executed_tflops=tf32_flops / ms * 1e-9,
                         tf32_floor_ms=tf32_flops / TF32_FLOPS * 1e3,
                         design_bytes=design_bytes,
                         design_bytes_ms=design_bytes / HBM_BYTES_PER_S * 1e3,
                         gbytes_per_s=nbytes / ms * 1e-6,
                         pass_ms=pass_ms,
                         pass_share={n: t / passes for n, t in
                                     pass_ms.items()},
                         phases=phases))
        log(f"gla_scan {shape[:6]}{' q/k head stride 0' if bcast else ''}: "
            + json.dumps(rows[-1]))
        del q, k, v, lw
    K.gla_scan.launches = launches        # timing launches are not counted
    return rows, ssm_builds()


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phases 22a-22d: Mixture-of-Experts — full-width mixtral-8x7b's MoE layer
# against its expert-parallel candidate, with paper bug 6
# ---------------------------------------------------------------------------

def moe_config():
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS,
                               tie_embeddings=MOE_TIED)


def moe_routing(trace, cfg) -> list[dict]:
    """Each MoE layer's routing in ``trace``, from its tapped router logits
    (the reference's ``router_topk`` and capacity rule): every token's
    sorted top-k experts and its sorted kept experts (a dropped one as
    ``n_experts``), the capacity, the assignments (token-expert pairs) and
    tokens that capacity drops, and the layer's tapped output."""
    import torch
    from repro_torch.models.moe import (dispatch_maps, expert_capacity,
                                        router_topk)
    m = cfg.moe
    out = []
    for li in range(cfg.n_layers):
        logits = trace.activations.raw(f"layers.{li}.mlp/router_logits")
        logits = logits.reshape(-1, logits.shape[-1])
        T = logits.shape[0]
        _, top_e = router_topk(logits, m.top_k)
        cap = expert_capacity(T, m)
        slot, _, dropped = dispatch_maps(top_e[None], m.n_experts, cap)
        lost = slot.reshape(T, m.top_k) == m.n_experts * cap
        out.append(dict(
            top=torch.sort(top_e, dim=-1).values,
            kept=torch.sort(torch.where(lost, m.n_experts, top_e),
                            dim=-1).values,
            cap=cap, dropped=int(dropped[0]),
            tokens_dropped=int(lost.any(-1).sum()),
            output=trace.activations.raw(f"layers.{li}.mlp/output")))
    return out


def routing_runner(run, cfg, out):
    """``run`` appending each call's ``moe_routing`` to ``out``."""
    def wrapped(batch, rewrites=None):
        tr = run(batch, rewrites)
        out.append(moe_routing(tr, cfg))
        return tr
    return wrapped


def switched(a, b, key="top") -> int:
    """Tokens whose top-k expert set (or kept set) differs between two
    routings."""
    return int((a[key] != b[key]).any(-1).sum())


def routing_stats(routing) -> list[dict]:
    """Per MoE layer: capacity drops in the reference's first run and the
    candidate's, tokens whose top-k set and whose kept set differ between
    the reference and the candidate and between the estimate's base and
    perturbed runs, and the estimate's rel-err of the layer's output
    (||base - perturbed|| / ||base||) over all tokens and over the tokens
    whose kept set the perturbation did not change."""
    import torch
    base, pert = routing["reference"][:2]
    out = []
    for b, p, c in zip(base, pert, routing["candidate"][0]):
        same = (b["kept"] == p["kept"]).all(-1)
        x = b["output"].reshape(same.shape[0], -1).float()
        dx = x - p["output"].reshape(x.shape).float()

        def rel(rows):
            return float(torch.linalg.vector_norm(dx[rows])
                         / torch.linalg.vector_norm(x[rows]))
        out.append(dict(
            capacity=b["cap"], dropped_reference=b["dropped"],
            tokens_dropped_reference=b["tokens_dropped"],
            dropped_candidate=c["dropped"],
            tokens_dropped_candidate=c["tokens_dropped"],
            switched_candidate=switched(b, c),
            kept_switched_candidate=switched(b, c, "kept"),
            switched_perturbed=switched(b, p),
            kept_switched_perturbed=switched(b, p, "kept"),
            estimate_rel_err_all=rel(torch.ones_like(same)),
            estimate_rel_err_kept_unchanged=rel(same)))
    return out


def records_of(res, names) -> dict:
    """``{kind name: (rel_err, threshold)}`` of the report's records whose
    name is in ``names``."""
    return {f"{r.kind} {r.name}": (r.rel_err, r.threshold)
            for r in res.report.records if r.name in names}


def reference_step(cfg, model, batch):
    """One traced reference step alone (AdamW, lr 1e-3): its seconds, its
    peak device memory and the GB each trace section holds — the
    reckoning that sizes phases 22a-22c and 23a-23b."""
    import torch
    from repro_torch.core.collector import SECTION_FIELDS
    from repro_torch.core.harness import make_model_runner
    from repro_torch.optim.adamw import AdamW
    dev = model.device
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    tr = make_model_runner(model, AdamW(lr=1e-3), device=dev)(batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    sections = {sec: sum(x.numel() * x.element_size() for _, x in
                         getattr(tr, sec).raw_items()) / 1e9
                for sec in SECTION_FIELDS}
    out = dict(params=n_params, seconds=secs,
               held_before_gib=held / 2**30,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
               section_gb=sections)
    del tr
    shapes = {k: tuple(v.shape) for k, v in batch.items()}
    log(f"reference step ({cfg.name}, {cfg.n_layers} layer(s), tied "
        f"{cfg.tie_embeddings}, {n_params} parameters, batch {shapes}): "
        + json.dumps(out))
    return out


def moe_untied(cfg, device, B, S):
    """The reckoning behind ``MOE_TIED``: the same model with its own LM
    head (the published config's), one traced reference step and the
    clean tp2 check's peak memory; the model is freed at the end."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model
    untied = dataclasses.replace(cfg, tie_embeddings=False)
    model = Model(untied, seed=0, device=device)
    batch = make_batch(untied, B, S, seed=0, device=device)
    step = reference_step(untied, model, batch)
    res, stats, _ = dist_check(untied, model, batch, dict(tp=2))
    log(f"moe untied: reference step peak {step['peak_gib']} GiB, clean "
        f"tp2 check peak {stats['peak_gib']} GiB (passed {res.passed})")
    return dict(reference_step=step, check_peak_gib=stats["peak_gib"],
                passed=res.passed)


def moe_main(cfg, model, batch, B, S):
    """22a: each expert-parallel candidate (tp2, tp2 sp) of the 1-layer
    model must PASS; prints the margin, step seconds, peak memory, rel-err
    launches, capacity drops in the reference and the candidate, and the
    tokens whose top-2 set differs between reference and candidate and
    between the estimate's base and perturbed runs; a second tp2 run must
    give a bit-identical trace.  Returns (stats by candidate, the clean
    tp2 candidate's MoE outputs by layer)."""
    import torch
    out = {}
    for name, kw in MOE_CANDIDATES:
        routing = {}
        res, stats, cand_run = dist_check(cfg, model, batch, kw,
                                          routing=routing)
        stats["routing"] = routing_stats(routing)
        stats["mlp_records"] = records_of(res, MOE_WATCH)
        if name == "tp2":
            clean = [r["output"] for r in routing["candidate"][0]]
        log(f"moe_main {name}: routing by layer "
            f"{json.dumps(stats['routing'])}; records "
            f"{json.dumps(stats['mlp_records'])}")
        dist_verdict(f"moe_main {name}", res, stats, cfg, B, S,
                     taps_per_layer=MOE_TAPS_PER_LAYER,
                     params_per_layer=MOE_PARAMS_PER_LAYER)
        if name == "tp2":
            first = res.candidate
            del res
            diffs = bit_identical(first, cand_run(batch))
            if diffs:
                raise AssertionError(f"two tp2 candidate runs differ in "
                                     f"{len(diffs)} tensors, first "
                                     f"{diffs[:5]}")
            stats["rerun_peak_gib"] = (torch.cuda.max_memory_allocated()
                                       / 2**30)
            log(f"moe_main tp2: a second candidate run is bit-identical in "
                f"every section; peak device memory through the rerun "
                f"{stats['rerun_peak_gib']} GiB")
            del first
        out[name] = stats
        del cand_run, routing
        gc.collect()
        torch.cuda.empty_cache()
    return out, clean


@contextlib.contextmanager
def moe_capacity(cfg, model, factor):
    """``model`` (and the config it yields) with every MoE layer at
    capacity factor ``factor``, for the span of the block: the same
    parameters, another dispatch."""
    cfg2 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))
    mods = [model] + [blk.mlp for blk in model.layers
                      if getattr(blk, "moe", False)]
    saved = [mod.cfg for mod in mods]
    for mod in mods:
        mod.cfg = cfg2
    try:
        yield cfg2
    finally:
        for mod, c in zip(mods, saved):
            mod.cfg = c


def moe_control(cfg, model, batch, clean):
    """22b: ``moe_router_not_synced`` at tp2.  The registry localizes it to
    ``layers.*.mlp``; at this width under bf16-eps thresholds the check
    PASSes it (measured, PERF.md §6): each tensor's threshold is at
    least 8 x 4 x 2^-8 = 0.125 relative, and the drift moves the layer's
    output by about 1% (printed: its rel-err against ``clean``, the clean
    tp2 candidate's per-layer outputs).  The phase asserts that verdict
    and that the bug expresses (the output differs from the clean
    candidate's).  Printed beside: the routing diagnosis of ``moe_main``
    and the same control with the capacity off (dropless)."""
    import torch
    bug, kw = MOE_CONTROL
    out = {}
    for label, factor in (("capacity", cfg.moe.capacity_factor),
                          ("dropless", 0.0)):
        with moe_capacity(cfg, model, factor) as c:
            routing = {}
            res, stats, _ = dist_check(c, model, batch, kw, bugs=(bug,),
                                       routing=routing)
        stats["routing"] = routing_stats(routing)
        stats["mlp_records"] = records_of(res, MOE_WATCH)
        stats["passed"] = res.passed
        stats["localized"] = res.localized_module
        if label == "capacity":
            stats["bug_effect"] = [
                float(torch.linalg.vector_norm(
                    (r["output"].float() - x.float()))
                    / torch.linalg.vector_norm(x.float()))
                for r, x in zip(routing["candidate"][0], clean)]
        log(f"moe_control {bug} ({label}, capacity factor {factor}): "
            f"passed={res.passed}, localized {res.localized_module!r}; "
            f"bug effect on each layer's output (rel-err against the clean "
            f"tp2 candidate's) {stats.get('bug_effect')}; routing by layer "
            f"{json.dumps(stats['routing'])}; records "
            f"{json.dumps(stats['mlp_records'])}")
        out[label] = stats
        del res, routing
        gc.collect()
        torch.cuda.empty_cache()
    got = out["capacity"]
    if not got["passed"] or not min(got["bug_effect"]) > 0:
        raise AssertionError(f"{bug} under {kw}: passed={got['passed']} "
                             f"(measured: PASS under bf16-eps thresholds), "
                             f"bug effect {got['bug_effect']} (must be > 0)")
    log(f"moe_control {bug}: PASS as measured, the bug expressed "
        f"(output rel-err {got['bug_effect']} against the clean candidate)")
    return out


@contextlib.contextmanager
def kernel_attention_calls():
    """The (mode, window, D, dtype) of each attention the models send to
    the flash kernel (``use_kernel``) while the context is open."""
    from repro_torch.models import attention as A
    calls, saved = [], A.attention

    def attention(q, k, v, mode="causal", window=0, **kw):
        if kw.get("use_kernel"):
            calls.append((mode, window, q.shape[-1],
                          str(q.dtype).split(".")[-1]))
        return saved(q, k, v, mode=mode, window=window, **kw)
    A.attention = attention
    try:
        yield calls
    finally:
        A.attention = saved


def moe_flash(cfg, model, B, S):
    """22c: the flash candidate (``loss(use_kernel=True)``) at S 8192,
    where the swa window of 4096 drops keys, must PASS against the plain
    model (``attention_blockwise`` and the chunked CE); every kernel call
    must be swa at the config's window, one launch a layer a candidate
    run and none in the reference."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models import attention as A
    calls = {"attention_blockwise": 0}
    saved_blockwise = A.attention_blockwise

    def blockwise(*args, **kwargs):
        calls["attention_blockwise"] += 1
        return saved_blockwise(*args, **kwargs)
    A.attention_blockwise = blockwise
    try:
        batch = make_batch(cfg, B, S, seed=0, device=model.device)
        with kernel_attention_calls() as kernel_calls:
            res, counts, ref_runs, cand_runs = flash_check(model, batch,
                                                           extra=calls)
    finally:
        A.attention_blockwise = saved_blockwise
    modes = [(mode, window) for mode, window, _, _ in kernel_calls]
    ratio, where = worst_record(res)
    log(res.summary())
    log(f"moe_flash: launches {counts}; per reference run {ref_runs}; per "
        f"candidate run {cand_runs}; kernel modes {sorted(set(modes))}; "
        f"step seconds {json.dumps(res.seconds)}; largest rel-err / "
        f"threshold {ratio:.4f} ({where})")
    L = cfg.n_layers
    if not res.passed:
        raise AssertionError("clean moe_flash check did not PASS")
    if [r["flash_attention"] for r in cand_runs] != [L]:
        raise AssertionError(f"candidate runs launched {cand_runs}, expected "
                             f"{L} flash_attention launches")
    if any(r["flash_attention"] for r in ref_runs):
        raise AssertionError("the reference launched the kernel")
    if not modes or set(modes) != {("swa", cfg.window)}:
        raise AssertionError(f"kernel modes {sorted(set(modes))}, expected "
                             f"swa at window {cfg.window}")
    if any(r["attention_blockwise"] != L for r in ref_runs):
        raise AssertionError(f"reference runs {ref_runs}: expected {L} "
                             f"attention_blockwise calls each")
    check_trace_shapes(res, cfg, B, S, taps_per_layer=MOE_TAPS_PER_LAYER,
                       params_per_layer=MOE_PARAMS_PER_LAYER)
    return dict(launches=counts["flash_attention"], seconds=res.seconds,
                worst=(where, ratio), per_candidate_run=cand_runs)


def swa_flash_bound(B, S, H, Hkv, D, window, elem_bytes=2):
    """``flash_bound`` for a sliding window: 4 D flops for each of the
    sum over q of min(q + 1, window) unmasked pairs."""
    nbytes = elem_bytes * B * S * D * (2 * H + 2 * Hkv)
    w = min(window, S)
    pairs = w * (w + 1) // 2 + (S - w) * w
    flops = 4 * D * B * H * pairs
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes, flops)


def moe_flash_timing(cfg, device, B, S):
    """22c's kernel alone at Mixtral's attention (bf16, swa at the config's
    window): against its plain version (MOE_FLASH_REL_TOL), per launch
    with the card held busy, the plain version, and
    ``scaled_dot_product_attention`` given the sliding-window mask as the
    library call, beside the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_ref
    shape = (B, S, cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
    W = cfg.window
    launches = ops.flash_attention.launches
    q, k, v = flash_inputs(*shape, torch.bfloat16, device, seed=0)
    got = ops.flash_attention(q, k, v, mode="swa", window=W)
    plain = flash_attention_ref(q, k, v, mode="swa", window=W)
    err = (got.float() - plain.float()).abs()
    tol = MOE_FLASH_REL_TOL * plain.float().abs() + 2 * FLASH_F32_TOL
    if not bool((err <= tol).all()):
        raise AssertionError(f"kernel vs plain at {shape} swa {W}: max "
                             f"{float(err.max()):.3g}, over tolerance")
    max_abs_err = float(err.max())
    del plain, err, tol
    ms = device_time_ms(lambda: ops.flash_attention(q, k, v, mode="swa",
                                                    window=W))
    plain_ms = cuda_time_ms(lambda: flash_attention_ref(
        q, k, v, mode="swa", window=W), reps=3, warmup=1)
    pos = torch.arange(S, device=device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True).transpose(1, 2)
    lib_ms = None
    try:
        lib_err = float((library().double() - got.double()).abs().max())
    except (RuntimeError, TypeError) as e:
        log(f"scaled_dot_product_attention (swa mask) refused: "
            f"{str(e).splitlines()[0][:200]}")
    else:
        if lib_err > 0.05:
            log(f"scaled_dot_product_attention (swa mask) disagrees by "
                f"{lib_err:.3g}; no library time")
        else:
            lib_ms = device_time_ms(library)
    bound_ms, bound_by, nbytes, flops = swa_flash_bound(*shape, W)
    ops.flash_attention.launches = launches  # timing launches are not counted
    row = dict(shape=shape, window=W, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
               bound_share=bound_ms / ms, bytes=nbytes, flops=flops,
               max_abs_err=max_abs_err)
    log(f"flash_attention at {cfg.name}'s attention {shape} swa {W}: "
        + json.dumps(row))
    return row


def moe_cli(root):
    """22d: ``python -m repro_torch.launch.supervise --recipe moe --bug
    moe_router_not_synced`` at ``--reduced`` (the CLI writes a checkpoint
    of both states at step 0: 1.582 B parameters x 14 B x 2 sides would
    near the card machine's 45 GiB of writes) must flag at step 0, with
    first bad step 0, at a ``layers.*.mlp`` module."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    argv = ["--recipe", "moe", "--reduced", "--steps", "4",
            "--bug", "moe_router_not_synced", "--no-spill",
            "--device", "cuda", "--work-dir", os.path.join(root, "moe_cli")]
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.supervise", *argv],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    cli_s = time.perf_counter() - t0
    lines = cli.stdout.strip().splitlines()
    log(f"--- cli {' '.join(argv[:-2])}: rc {cli.returncode} in "
        f"{cli_s:.2f} s\n" + "\n".join(lines[-14:]))

    def last(tag):
        hit = [ln.split(tag, 1)[1].strip() for ln in lines if tag in ln]
        return hit[-1] if hit else None
    loc = [ln for ln in lines if "localized:" in ln and "expected" in ln]
    if (cli.returncode != 0 or last("first flagged (online): step") != "0"
            or last("FIRST BAD STEP:") != "0" or not loc
            or "[MATCH]" not in loc[-1]):
        raise AssertionError(f"cli moe run: rc {cli.returncode}\n"
                             f"{cli.stdout[-3000:]}\n{cli.stderr[-3000:]}")
    return dict(seconds=cli_s, localized=loc[-1].strip(),
                work_dir_gb=dir_gb(os.path.join(root, "moe_cli")))


def moe_phases(device, phase):
    """Phases 22a-22d (the model and every trace freed at the end)."""
    import tempfile
    import torch
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model
    cfg = moe_config()
    B, S = MOE_BATCH
    out = {"moe_untied": phase("moe_untied",
                               lambda: moe_untied(cfg, device, B, S))}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = Model(cfg, seed=0, device=device)
    log(f"moe model {cfg.name}: {MOE_LAYERS} layer(s), tied "
        f"{cfg.tie_embeddings}, built in {time.perf_counter() - t0:.2f} s")
    batch = make_batch(cfg, B, S, seed=0, device=device)
    out["moe_reference_step"] = phase(
        "moe_reference_step", lambda: reference_step(cfg, model, batch))
    main = phase("moe_main", lambda: moe_main(cfg, model, batch, B, S))
    if main is not None:
        out["moe_main"], clean = main
        out["moe_control"] = phase(
            "moe_control", lambda: moe_control(cfg, model, batch, clean))
        del main, clean
    gc.collect()
    torch.cuda.empty_cache()
    out["moe_flash"] = phase(
        "moe_flash", lambda: moe_flash(cfg, model, *MOE_FLASH_BATCH))
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    out["moe_flash_timing"] = phase(
        "moe_flash_timing", lambda: moe_flash_timing(cfg, device,
                                                     *MOE_FLASH_BATCH))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as root:
        out["moe_cli"] = phase("moe_cli", lambda: moe_cli(root))
    return out


# ---------------------------------------------------------------------------
# phases 23a-23e: Multi-head Latent Attention and the decode path —
# full-width deepseek-v2-236b's first layer, full-depth tinyllama-1.1b
# ---------------------------------------------------------------------------

def mla_config():
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_LAYERS)


def mla_main(cfg, model, batch, B, S):
    """23a: a clean check of the 1-layer model (the reference runner as
    candidate) must PASS under bf16 thresholds with 5 + 1 rel-err
    launches, finite trace leaves and ``final_norm_out`` of (B, S, d)."""
    from repro_torch.core.thresholds import MACHINE_EPS
    res, stats = model_check(model, batch, MACHINE_EPS["bfloat16"])
    ratio, where = worst_record(res)
    log(res.summary())
    log(f"mla_main: largest rel-err / threshold {ratio:.4f} ({where}); "
        f"packed_sq_norms launches: estimate {stats['estimate_launches']}, "
        f"compare {stats['compare_launches']}; other kernels "
        f"{stats['other_launches']}; step seconds "
        f"{json.dumps(stats['seconds'])}; peak device memory "
        f"{stats['peak_gib']} GiB")
    if not res.passed:
        raise AssertionError("clean mla_main check did not PASS")
    got = (stats["estimate_launches"], stats["compare_launches"])
    if got != (5, 1) or stats["other_launches"]:
        raise AssertionError(f"mla_main: packed_sq_norms launches {got}, "
                             f"expected (5, 1); other kernels "
                             f"{stats['other_launches']}")
    check_trace_shapes(res, cfg, B, S, params_per_layer=MLA_PARAMS_PER_LAYER)
    return dict(stats, worst=ratio, worst_at=where)


def doubled(model, name):
    """A runner wrapper that doubles parameter ``name`` of ``model`` in
    place for each run and halves it back after (exact: a power of 2)."""
    import torch
    w = dict(model.named_parameters())[name]

    def wrap(run):
        def wrapped(batch, rewrites=None):
            with torch.no_grad():
                w.mul_(2.0)
            try:
                return run(batch, rewrites)
            finally:
                with torch.no_grad():
                    w.mul_(0.5)
        return wrapped
    return wrap


def mla_control(cfg, model, batch, B, S):
    """23b: ``MLA_CONTROL`` (the q-LoRA up-projection, a branch only the
    full config has) doubled in the candidate must FAIL and be localized
    to layer 0's ``self_attention``: by its tap scope,
    ``layers.0.self_attention`` (rewrite mode), or by its parameters' path,
    ``dense_layers.0.self_attention*`` (when only gradients flag).
    ``ttrace_check`` keeps every section the localizer does not read on
    the host while it runs, which is what fits its two traced runs on the
    card at this size; after it, both traces must be whole again, every
    leaf back on the card."""
    import torch
    from repro_torch.core.collector import SECTION_FIELDS
    from repro_torch.core.harness import make_model_runner, ttrace_check
    from repro_torch.core.thresholds import MACHINE_EPS
    from repro_torch.optim.adamw import AdamW
    dev = model.device
    opt = AdamW(lr=1e-3)
    ref = make_model_runner(model, opt, device=dev)
    cand = doubled(model, MLA_CONTROL)(make_model_runner(model, opt,
                                                         device=dev))
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    res = ttrace_check(ref, cand, batch, eps=MACHINE_EPS["bfloat16"])
    counts = read_counts()
    stats = dict(counts=counts, seconds=res.seconds,
                 peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                 localized=res.localized_module)
    log(res.summary())
    log(f"mla_control (doubled {MLA_CONTROL}): passed={res.passed}, "
        f"localized {res.localized_module!r}; launches {counts}; step "
        f"seconds {json.dumps(res.seconds)}; peak device memory "
        f"{stats['peak_gib']} GiB")
    loc = res.localized_module or ""
    if res.passed or not loc.startswith(("layers.0.self_attention",
                                         "dense_layers.0.self_attention")):
        raise AssertionError(f"doubled {MLA_CONTROL}: passed={res.passed}, "
                             f"localized {loc!r}")
    off = [f"{f}:{n}" for tr in (res.reference, res.candidate)
           for f in SECTION_FIELDS for n, x in getattr(tr, f).raw_items()
           if x.device != dev]
    if off:
        raise AssertionError(f"mla_control: {len(off)} trace leaves left "
                             f"off the card after the localization, e.g. "
                             f"{off[:3]}")
    check_trace_shapes(res, cfg, B, S, params_per_layer=MLA_PARAMS_PER_LAYER)
    return stats


@contextlib.contextmanager
def compute_dtype(model, dtype):
    """``model`` computing in ``dtype`` for the span of the block (its
    parameters stay as they are; every op follows the embedding's dtype)."""
    saved = model.cdtype
    model.cdtype = dtype
    try:
        yield model
    finally:
        model.cdtype = saved


def decode_runner(model, impl, bugs=frozenset()):
    import functools
    from repro_torch.core.harness import make_decode_runner
    return make_decode_runner(model, functools.partial(
        model.decode_step, mla_impl=impl, mla_bugs=frozenset(bugs)),
        device=model.device)


def decode_check(model, batch, eps, cand, ref_trace=None):
    """``ttrace_check(estimate=False, localize=False)`` of the naive MLA
    decode (or ``ref_trace``, a trace it gave) against ``cand``, floor-only
    thresholds at ``eps`` and ``DECODE_MARGIN``; counts set to 0 just
    before and read just after.  Returns (result, counts)."""
    from repro_torch.core.harness import ttrace_check
    ref = (decode_runner(model, "naive") if ref_trace is None
           else (lambda b, rewrites=None: ref_trace))
    reset_counts()
    res = ttrace_check(ref, cand, batch, eps=eps, margin=DECODE_MARGIN,
                       estimate=False, localize=False)
    return res, read_counts()


def first_flag(res):
    first = res.report.first_flagged_activation()
    return None if first is None else (first.name, first.rel_err,
                                       first.threshold)


def mla_decode(cfg, model, B, T):
    """23c: naive (reference) against absorbed (candidate) MLA decode over
    B x T tokens at f32 compute (bf16 parameters), floor-only thresholds
    (f32 eps, margin 64): the clean pair must PASS with every
    ``decode.final_cache.*`` record bit-identical (one layer: both write
    the cache through the same ``_ckv`` of the same embeddings), and
    ``decode_stale_rope_pos`` must FAIL from some ``decode.t{t}``, t >= 1,
    every logit finite; one rel-err launch a check and no other kernel.
    Printed beside: the clean pair at bf16 compute under bf16 eps, each
    implementation's ms per decode step, the cache's values a token
    against per-head K/V's and the peak memory."""
    import torch
    from repro_torch.core.thresholds import MACHINE_EPS
    from repro_torch.data.synthetic import make_batch
    dev = model.device
    batch = {"tokens": make_batch(cfg, B, T, seed=0, device=dev)["tokens"]}
    m = cfg.mla
    out = {"cache_values_per_token": m.kv_lora_rank + m.qk_rope_dim,
           "per_head_kv_values_per_token": cfg.n_heads * (
               m.qk_nope_dim + m.qk_rope_dim + m.v_head_dim)}
    out["cache_bytes_per_token_f32"] = 4 * out["cache_values_per_token"]
    torch.cuda.reset_peak_memory_stats(dev)
    with compute_dtype(model, torch.float32):
        res, counts = decode_check(model, batch, MACHINE_EPS["float32"],
                                   decode_runner(model, "absorbed"))
        ratio, where = worst_record(res)
        caches = [n for n in res.reference.activations
                  if n.startswith("decode.final_cache.")]
        differ = [n for n in caches if not torch.equal(
            res.reference.activations.raw(n), res.candidate.activations.raw(n))]
        out["clean"] = dict(passed=res.passed, worst=ratio, worst_at=where,
                            records=len(res.report.records), counts=counts,
                            caches=caches, caches_differ=differ,
                            threshold=res.thresholds.threshold(
                                "activation", "decode.t0/logits"),
                            ms_per_step={
                                "naive": res.seconds["estimate"] / T * 1e3,
                                "absorbed": res.seconds["candidate"] / T * 1e3})
        log(f"mla_decode clean (f32 compute, f32 eps, margin "
            f"{DECODE_MARGIN}): " + json.dumps(out["clean"]))
        ref_trace = res.reference
        del res
        stale, scounts = decode_check(
            model, batch, MACHINE_EPS["float32"],
            decode_runner(model, "absorbed", {STALE_ROPE}), ref_trace)
        finite = all(bool(x.isfinite().all()) for n, x in
                     stale.candidate.activations.raw_items()
                     if n.endswith("/logits"))
        out["stale"] = dict(passed=stale.passed, first=first_flag(stale),
                            flagged=sum(r.flagged for r in
                                        stale.report.records),
                            finite=finite, counts=scounts,
                            ms_per_step=stale.seconds["candidate"] / T * 1e3)
        log(f"mla_decode {STALE_ROPE}: " + json.dumps(out["stale"]))
        del stale, ref_trace
    with compute_dtype(model, torch.bfloat16):
        bf, bcounts = decode_check(model, batch, MACHINE_EPS["bfloat16"],
                                   decode_runner(model, "absorbed"))
        bratio, bwhere = worst_record(bf)
        out["bf16"] = dict(passed=bf.passed, worst=bratio, worst_at=bwhere,
                           counts=bcounts, threshold=bf.thresholds.threshold(
                               "activation", "decode.t0/logits"),
                           ms_per_step={
                               "naive": bf.seconds["estimate"] / T * 1e3,
                               "absorbed": bf.seconds["candidate"] / T * 1e3})
        log("mla_decode clean at bf16 compute (bf16 eps, printed beside): "
            + json.dumps(out["bf16"]))
        del bf
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"mla_decode: cache {out['cache_values_per_token']} values a token "
        f"({out['cache_bytes_per_token_f32']} bytes at f32 compute) against "
        f"{out['per_head_kv_values_per_token']} for per-head K/V; peak "
        f"device memory {out['peak_gib']} GiB")
    clean, st = out["clean"], out["stale"]
    for name, c in (("clean", clean["counts"]), ("stale", st["counts"])):
        if c["packed_sq_norms"] != 1 or any(
                v for k, v in c.items() if k != "packed_sq_norms"):
            raise AssertionError(f"mla_decode {name}: launches {c}")
    if not clean["passed"] or clean["caches_differ"] or not clean["caches"]:
        raise AssertionError(f"clean MLA decode: passed={clean['passed']}, "
                             f"caches differing {clean['caches_differ']}")
    first = st["first"]
    if (st["passed"] or not st["finite"] or first is None
            or not first[0].startswith("decode.t")
            or first[0].startswith("decode.t0/")):
        raise AssertionError(f"{STALE_ROPE}: passed={st['passed']}, first "
                             f"flagged {first}, finite {st['finite']}")
    return out


def decode_vs_forward(model, B, T):
    """The logits of ``model``'s decode path stepped over B x T tokens
    against ``forward`` + ``unembed``, and ``make_prefill_step``'s against
    the last decode step's, normwise, at f32 and at bf16 compute."""
    import torch
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    batch = make_batch(model.cfg, B, T, seed=0, device=model.device)
    out = {}
    for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        with compute_dtype(model, dt), torch.no_grad():
            t0 = time.perf_counter()
            want = model.unembed(model.forward({"tokens": batch["tokens"]}))
            pre = make_prefill_step(model)({"tokens": batch["tokens"]})
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
            step = make_serve_step(model)
            cache = model.init_cache(B, T)
            got = []
            t0 = time.perf_counter()
            for t in range(T):
                lg, cache = step(cache, {"tokens": batch["tokens"][:, t:t + 1],
                                         "pos": t})
                got.append(lg)
            torch.cuda.synchronize()
            dec_s = time.perf_counter() - t0
            got = torch.cat(got, dim=1)
            out[label] = dict(decode_vs_forward=normwise(got, want.double()),
                              prefill_vs_last=normwise(pre,
                                                       got[:, -1:].double()),
                              finite=bool(got.isfinite().all()),
                              forward_and_prefill_s=fwd_s,
                              decode_ms_per_step=dec_s / T * 1e3)
            del want, pre, got, cache
        log(f"decode vs forward, {model.cfg.name} ({model.cfg.n_layers} "
            f"layers), B {B} x T {T}, {label} compute: "
            + json.dumps(out[label]))
    f = out["f32"]
    if not (f["finite"] and f["decode_vs_forward"] <= CONSISTENCY_TOL
            and f["prefill_vs_last"] <= CONSISTENCY_TOL):
        raise AssertionError(f"decode vs forward at f32: {f}")
    return out


def decode_consistency(device):
    """23d: full-width ``CONSISTENCY[0]`` at ``CONSISTENCY_LAYERS`` layers
    and f32 compute: the logits of the decode path stepped over B x T
    tokens must match ``forward`` + ``unembed`` within ``CONSISTENCY_TOL``
    normwise, and ``make_prefill_step``'s the last decode step's; the
    bf16-compute values printed beside."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    name, B, T = CONSISTENCY
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(name), n_layers=CONSISTENCY_LAYERS)
    model = Model(cfg, seed=0, device=device)
    build_s = time.perf_counter() - t0
    try:
        return dict(decode_vs_forward(model, B, T), build_s=build_s)
    finally:
        del model
        gc.collect()
        torch.cuda.empty_cache()


def serve_cli(runs=SERVE_RUNS):
    """23e: ``python -m repro_torch.launch.serve`` for each of ``runs``
    (``--batch 4 --prompt-len 32 --gen 16``) must exit 0 and print its
    tokens per second."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = {}
    for arch, reduced in runs:
        argv = ["--arch", arch, "--batch", "4", "--prompt-len", "32",
                "--gen", "16", "--device", "cuda"] + (
                    ["--reduced"] if reduced else [])
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", *argv],
            capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
        secs = time.perf_counter() - t0
        lines = cli.stdout.strip().splitlines()
        log(f"--- serve {' '.join(argv)}: rc {cli.returncode} in "
            f"{secs:.2f} s\n" + "\n".join(lines[-2:]))
        rate = [ln.rsplit("(", 1)[1].split(" tok/s")[0] for ln in lines
                if "tok/s)" in ln]
        if cli.returncode != 0 or not rate:
            raise AssertionError(f"serve {arch}: rc {cli.returncode}\n"
                                 f"{cli.stdout[-2000:]}\n"
                                 f"{cli.stderr[-3000:]}")
        out[arch + (" --reduced" if reduced else "")] = dict(
            seconds=secs, tok_per_s=float(rate[-1]))
    return out


def mla_phases(device, phase):
    """Phases 23a-23e (every model and trace freed at the end)."""
    import torch
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model
    cfg = mla_config()
    B, S = MLA_BATCH
    t0 = time.perf_counter()
    model = Model(cfg, seed=0, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"mla model {cfg.name}: {MLA_LAYERS} layer(s), {n_params} "
        f"parameters, built in {time.perf_counter() - t0:.2f} s")
    batch = make_batch(cfg, B, S, seed=0, device=device)
    out = {"mla_reference_step": phase(
        "mla_reference_step", lambda: reference_step(cfg, model, batch))}
    gc.collect()
    torch.cuda.empty_cache()
    out["mla_main"] = phase("mla_main",
                            lambda: mla_main(cfg, model, batch, B, S))
    gc.collect()
    torch.cuda.empty_cache()
    out["mla_control"] = phase("mla_control",
                               lambda: mla_control(cfg, model, batch, B, S))
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    out["mla_decode"] = phase("mla_decode",
                              lambda: mla_decode(cfg, model, *MLA_DECODE))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out["decode_consistency"] = phase("decode_consistency",
                                      lambda: decode_consistency(device))
    out["serve_cli"] = phase("serve_cli", serve_cli)
    return out


# ---------------------------------------------------------------------------
# phases 24a-24d: Mamba2 and the zamba2 hybrid — full-width zamba2-7b cut to
# 12 layers, its Mamba2 scans on gla_scan's scalar, inclusive branch
# ---------------------------------------------------------------------------

def zamba_config():
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(ZAMBA_ARCH), n_layers=ZAMBA_LAYERS)


def candidate_check(model, batch, cand_run, label):
    """``ttrace_check`` under bf16 thresholds of ``cand_run`` against the
    plain ``model``; every launch count set to 0 just before and read just
    after, and each run's launches recorded.  Returns (result, stats)."""
    import torch
    from repro_torch.core.harness import make_model_runner, ttrace_check
    from repro_torch.core.thresholds import MACHINE_EPS
    from repro_torch.optim.adamw import AdamW
    dev = model.device
    ref_runs, cand_runs, marks = [], [], {}
    ref = counted_runner(make_model_runner(model, AdamW(lr=1e-3), device=dev),
                         ref_runs)
    cand_run = counted_runner(cand_run, cand_runs)

    def cand(batch, rewrites=None):
        marks.setdefault("after_estimate", read_counts()["packed_sq_norms"])
        return cand_run(batch, rewrites)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    res = ttrace_check(ref, cand, batch, eps=MACHINE_EPS["bfloat16"])
    counts = read_counts()
    ratio, where = worst_record(res)
    stats = dict(counts=counts, ref_runs=ref_runs, cand_runs=cand_runs,
                 estimate_launches=marks["after_estimate"],
                 after_estimate_launches=(counts["packed_sq_norms"]
                                          - marks["after_estimate"]),
                 seconds=res.seconds, worst=ratio, worst_at=where,
                 localized=res.localized_module,
                 peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    log(res.summary())
    log(f"{label}: " + json.dumps(stats))
    return res, stats


def zamba_check(model, batch, bad=None):
    """``candidate_check`` of the gla_scan candidate (``bad``: that
    parameter doubled in it).  Returns (result, stats)."""
    from repro_torch.optim.adamw import AdamW
    cand_run = gla_runner(model, AdamW(lr=1e-3))
    if bad is not None:
        cand_run = doubled(model, bad)(cand_run)
    return candidate_check(model, batch, cand_run, "zamba2 check" + (
        "" if bad is None else f" (doubled {bad})"))


def kernel_launches(stats, kernel, per_run, runs):
    """Each candidate run ``per_run`` launches of ``kernel`` and the
    reference none; rel-err launches 5 in the estimate and ``runs - 1 +
    1`` after it (the compare, and one a localization); no other kernel."""
    got = [r[kernel] for r in stats["cand_runs"]]
    if got != [per_run] * runs:
        raise AssertionError(f"{kernel} launches per candidate run {got}, "
                             f"expected {per_run} x {runs}")
    if any(r[kernel] for r in stats["ref_runs"]):
        raise AssertionError(f"the reference launched {kernel}")
    rel = (stats["estimate_launches"], stats["after_estimate_launches"])
    if rel != (5, runs):
        raise AssertionError(f"packed_sq_norms launches {rel}, expected "
                             f"(5, {runs})")
    other = {k: v for k, v in stats["counts"].items()
             if k not in ("packed_sq_norms", kernel) and v}
    if other:
        raise AssertionError(f"other kernels launched: {other}")


def zamba_launches(stats, runs):
    """``ZAMBA_LAUNCHES_PER_RUN`` gla_scan launches per candidate run
    (``kernel_launches``)."""
    kernel_launches(stats, "gla_scan", ZAMBA_LAUNCHES_PER_RUN, runs)


def zamba_main(cfg, model, batch, B, S):
    """24a: the clean check must PASS with ``ZAMBA_LAUNCHES_PER_RUN``
    gla_scan launches per candidate run and none in the reference, 5 + 1
    rel-err launches, and the hybrid's tensors (the shared block's taps
    once per use, its parameters once), all finite."""
    res, stats = zamba_check(model, batch)
    if not res.passed:
        raise AssertionError("clean zamba2 gla_scan check did not PASS")
    zamba_launches(stats, 1)
    check_trace_shapes(res, cfg, B, S, taps_per_layer=MAMBA_TAPS_PER_LAYER,
                       params_per_layer=MAMBA_PARAMS_PER_LAYER)
    return stats


def zamba_control(cfg, model, batch, B, S, bad, module):
    """24b / 24c: ``bad`` doubled in the candidate must FAIL and be
    localized to ``module`` (two candidate runs: the check's and the
    localization's)."""
    res, stats = zamba_check(model, batch, bad)
    if res.passed or res.localized_module != module:
        raise AssertionError(f"doubled {bad}: passed={res.passed}, "
                             f"localized {res.localized_module!r}, expected "
                             f"{module!r}")
    zamba_launches(stats, 2)
    check_trace_shapes(res, cfg, B, S, taps_per_layer=MAMBA_TAPS_PER_LAYER,
                       params_per_layer=MAMBA_PARAMS_PER_LAYER)
    return stats


def zamba_phases(device, phase):
    """Phases 24a-24d (every model and trace freed at the end)."""
    import torch
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model
    cfg = zamba_config()
    B, S = ZAMBA_BATCH
    t0 = time.perf_counter()
    model = Model(cfg, seed=0, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"zamba2 model {cfg.name}: {ZAMBA_LAYERS} layers, plan "
        f"{[(seg.name, seg.n) for seg in model.plan]}, {n_params} "
        f"parameters, built in {time.perf_counter() - t0:.2f} s")
    batch = make_batch(cfg, B, S, seed=0, device=device)
    out = {"zamba_reference_step": phase(
        "zamba_reference_step", lambda: reference_step(cfg, model, batch))}
    gc.collect()
    torch.cuda.empty_cache()
    out["zamba_main"] = phase("zamba_main",
                              lambda: zamba_main(cfg, model, batch, B, S))
    for name, (bad, module) in zip(("zamba_control_mamba",
                                    "zamba_control_shared"), ZAMBA_CONTROLS):
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = phase(name, lambda: zamba_control(cfg, model, batch, B,
                                                      S, bad, module))
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    out["zamba_decode"] = phase("zamba_decode", lambda: decode_vs_forward(
        model, *ZAMBA_DECODE))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out["zamba_serve"] = phase("zamba_serve", lambda: serve_cli(
        ((ZAMBA_ARCH, True),)))
    return out


# ---------------------------------------------------------------------------
# phases 25a-25e: the remaining dense options and the frontends —
# full-width qwen3-32b (qk_norm, D 80), codeqwen1.5-7b (qkv_bias) through
# the distributed candidate, llava-next-34b (the VLM frontend) and
# hubert-xlarge (the audio encoder, bidirectional, D 80, full depth)
# ---------------------------------------------------------------------------

def dense_model(spec, device):
    """(config, model) of ``spec`` = (arch, depth, tied) at the published
    width, seed 0."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    arch, layers, tied = spec
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              tie_embeddings=tied)
    t0 = time.perf_counter()
    model = Model(cfg, seed=0, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"dense model {arch}: {layers} layer(s), tied {tied}, d {cfg.d_model}"
        f", {cfg.n_heads} heads of {cfg.d_head}, kv {cfg.n_kv_heads}, "
        f"{n_params} parameters, built in {time.perf_counter() - t0:.2f} s")
    return cfg, model


def dense_flash(cfg, model, batch, B, S, params_per_layer, frontend_params=0,
                bad=None):
    """25a, 25c, 25d: the flash candidate must PASS, one launch a layer per
    candidate run and none in the reference, every kernel call bf16 at the
    config's D in its mode (causal, or bidirectional for an encoder), 5 + 1
    rel-err launches and no other kernel.  ``bad`` = (parameter, module):
    that parameter doubled in the candidate must FAIL at ``module``."""
    from repro_torch.optim.adamw import AdamW
    cand_run = flash_runner(model, AdamW(lr=1e-3))
    label = f"{cfg.name} flash check"
    if bad is not None:
        cand_run = doubled(model, bad[0])(cand_run)
        label += f" (doubled {bad[0]})"
    with kernel_attention_calls() as calls:
        res, stats = candidate_check(model, batch, cand_run, label)
    stats["kernel_calls"] = sorted(set(calls))
    mode = "causal" if cfg.causal else "bidirectional"
    if bad is None and not res.passed:
        raise AssertionError(f"clean {cfg.name} flash check did not PASS")
    if bad is not None and (res.passed or res.localized_module != bad[1]):
        raise AssertionError(f"doubled {bad[0]}: passed={res.passed}, "
                             f"localized {res.localized_module!r}, expected "
                             f"{bad[1]!r}")
    emb = next(r for r in res.report.records
               if (r.kind, r.name) == ("activation", "embedding/output"))
    stats["embedding_output"] = dict(rel_err=emb.rel_err,
                                     threshold=emb.threshold,
                                     flagged=emb.flagged)
    log(f"{label}: embedding/output {json.dumps(stats['embedding_output'])}")
    if stats["kernel_calls"] != [(mode, 0, cfg.d_head, "bfloat16")]:
        raise AssertionError(f"kernel calls {stats['kernel_calls']}, "
                             f"expected bf16 {mode} at D {cfg.d_head}")
    kernel_launches(stats, "flash_attention", cfg.n_layers,
                    1 if bad is None else 2)
    check_trace_shapes(res, cfg, B, S, params_per_layer=params_per_layer,
                       frontend_params=frontend_params)
    return stats


def codeqwen_dist(cfg, model, batch, B, S):
    """25b: the tp2 sp candidate (2 emulated ranks; the QKV bias split with
    its fused columns) must PASS with no kernel but the rel-err one, and a
    second candidate run must give a bit-identical trace."""
    import torch
    res, stats, cand_run = dist_check(cfg, model, batch, CODEQWEN_PCFG)
    dist_verdict("codeqwen_dist", res, stats, cfg, B, S,
                 params_per_layer=CODEQWEN_PARAMS_PER_LAYER)
    first = res.candidate
    del res
    gc.collect()
    torch.cuda.empty_cache()
    diffs = bit_identical(first, cand_run(batch))
    if diffs:
        raise AssertionError(f"two candidate runs differ in {len(diffs)} "
                             f"tensors, first {diffs[:5]}")
    log("codeqwen_dist: a second candidate run is bit-identical in every "
        "section")
    return stats


def codeqwen_control(cfg, model, batch):
    """25b: the candidate's ``CODEQWEN_CONTROL`` bias shifted by
    ``CODEQWEN_SHIFT`` (a new tensor: the reference's stays) must FAIL and
    be localized to its module."""
    from repro_torch.core.collector import named_params
    name, module = CODEQWEN_CONTROL
    params = named_params(model)
    params[name] = params[name].detach() + CODEQWEN_SHIFT
    res, stats, _ = dist_check(cfg, model, batch, CODEQWEN_PCFG,
                               cand_params=params)
    if res.passed or res.localized_module != module:
        raise AssertionError(f"{name} + {CODEQWEN_SHIFT}: passed="
                             f"{res.passed}, localized "
                             f"{res.localized_module!r}, expected {module!r}")
    return dict(stats, localized=res.localized_module)


def dense_cli():
    """25e: the serve CLI decodes reduced qwen3-32b and codeqwen1.5-7b
    and refuses reduced hubert-xlarge as encoder-only; ``list_configs``
    names the reference's eleven configs and the port's
    ``moonlight-16b-a3b``."""
    from repro_torch.configs.base import list_configs
    out = serve_cli(DENSE_SERVE)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    argv = ["--arch", HUBERT[0], "--reduced", "--device", "cuda"]
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    log(f"--- serve {' '.join(argv)}: rc {cli.returncode}: "
        f"{cli.stderr.strip()[-300:]}")
    if cli.returncode == 0 or "encoder-only" not in cli.stderr:
        raise AssertionError(f"serve {HUBERT[0]} was not refused as "
                             f"encoder-only: rc {cli.returncode}")
    names = list_configs()
    want = {"gpt-paper", "tinyllama-1.1b", "mixtral-8x7b", "deepseek-v2-236b",
            "rwkv6-7b", "zamba2-7b", "qwen3-32b", "codeqwen1.5-7b",
            "qwen1.5-110b", "llava-next-34b", "hubert-xlarge",
            "moonlight-16b-a3b"}
    if set(names) != want or len(names) != 12:
        raise AssertionError(f"list_configs() gives {names}")
    log(f"list_configs(): {names}")
    return dict(out, refused=cli.returncode, configs=names)


def dense_phases(device, phase):
    """Phases 25a-25e, each model freed before the next is built."""
    import torch
    from repro_torch.data.synthetic import make_batch

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()

    out = {}
    cfg, model = dense_model(QWEN3, device)
    B, S = QWEN3_BATCH
    batch = make_batch(cfg, B, S, seed=0, device=device)
    out["qwen3_main"] = phase("qwen3_main", lambda: dense_flash(
        cfg, model, batch, B, S, QWEN3_PARAMS_PER_LAYER))
    fresh()
    out["qwen3_control"] = phase("qwen3_control", lambda: dense_flash(
        cfg, model, batch, B, S, QWEN3_PARAMS_PER_LAYER, bad=QWEN3_CONTROL))
    del model, batch
    fresh()

    cfg, model = dense_model(CODEQWEN, device)
    B, S = CODEQWEN_BATCH
    batch = make_batch(cfg, B, S, seed=0, device=device)
    out["codeqwen_dist"] = phase("codeqwen_dist", lambda: codeqwen_dist(
        cfg, model, batch, B, S))
    fresh()
    out["codeqwen_control"] = phase("codeqwen_control", lambda:
                                    codeqwen_control(cfg, model, batch))
    del model, batch
    fresh()

    cfg, model = dense_model(LLAVA, device)
    B, S = LLAVA_BATCH
    batch = make_batch(cfg, B, S, seed=0, device=device)
    log("llava batch: "
        + json.dumps({k: list(v.shape) for k, v in batch.items()}))
    out["llava_main"] = phase("llava_main", lambda: dense_flash(
        cfg, model, batch, B, S, LLAVA_PARAMS_PER_LAYER,
        LLAVA_FRONTEND_PARAMS))
    fresh()
    out["llava_control"] = phase("llava_control", lambda: dense_flash(
        cfg, model, batch, B, S, LLAVA_PARAMS_PER_LAYER,
        LLAVA_FRONTEND_PARAMS, bad=LLAVA_CONTROL))
    del model, batch
    fresh()

    cfg, model = dense_model(HUBERT, device)
    B, S = HUBERT_BATCH
    batch = make_batch(cfg, B, S, seed=0, device=device)
    log(f"hubert: the plain reference's score tensor B H S^2 x 4 = "
        f"{B * cfg.n_heads * S * S * 4 / 1e6:.1f} MB a layer, "
        f"{cfg.n_layers} layers; {int(batch['mask'].sum())} of {B * S} "
        f"frames masked")
    out["hubert_main"] = phase("hubert_main", lambda: dense_flash(
        cfg, model, batch, B, S, HUBERT_PARAMS_PER_LAYER,
        HUBERT_FRONTEND_PARAMS))
    fresh()
    out["hubert_control_mlp"] = phase(
        "hubert_control_mlp", lambda: dense_flash(
            cfg, model, batch, B, S, HUBERT_PARAMS_PER_LAYER,
            HUBERT_FRONTEND_PARAMS, bad=HUBERT_CONTROLS[0]))
    fresh()

    def mask_control():
        stats = dense_flash(cfg, model, batch, B, S, HUBERT_PARAMS_PER_LAYER,
                            HUBERT_FRONTEND_PARAMS, bad=HUBERT_CONTROLS[1])
        if stats["embedding_output"]["flagged"]:
            raise AssertionError("embedding/output flagged, yet the check "
                                 "named another module")
        return stats
    out["hubert_control_mask"] = phase("hubert_control_mask", mask_control)
    del model, batch
    fresh()
    out["dense_cli"] = phase("dense_cli", dense_cli)
    return out


# ---------------------------------------------------------------------------
# phases 26a-26c: the training driver (launch/train.py) over full-width,
# full-depth tinyllama-1.1b with its --ttrace-every check, resume at the
# step level and through the CLI, and the single-pair rel-err layout
# ---------------------------------------------------------------------------

TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_BATCH = (8, 128)       # the CLI's default batch
TRAIN_ARGV = ("--arch", TRAIN_ARCH, "--steps", "8", "--batch", "8", "--seq",
              "128", "--n-micro", "2", "--ttrace-every", "4", "--log-every",
              "1", "--device", "cuda")
TRAIN_CHECK_LAUNCHES = 6     # 5 in the estimate, 1 in the compare
RESUME_LAYERS = 2            # full width, bf16 parameters
RESUME_STEPS = (6, 4)        # save after 6, then 4 more: against 10
RESUME_CLI = ("--reduced", "--steps", "6", "--n-micro", "2",
              "--ttrace-every", "3")
SINGLE_PAIR_SIZES = (1, 65535, 65536, 65537, 3_000_017, 16_777_259)


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` is ``value`` inside the block."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def files_under(*roots) -> set:
    """Every file path under ``roots`` (what a phase may have written);
    ``chiprun_out`` is where this script's own log may go, and
    ``__pycache__`` is Python's."""
    out = set()
    for root in roots:
        for d, dirs, fs in os.walk(root):
            dirs[:] = [x for x in dirs
                       if x not in ("chiprun_out", "__pycache__")]
            out.update(os.path.join(d, f) for f in fs)
    return out


def train_main(device):
    """26a: ``launch.train.main`` for full-width, full-depth tinyllama-1.1b,
    8 steps at B 8 x S 128 in 2 microbatches, the ``--ttrace-every 4``
    check at step 4: it must PASS with ``TRAIN_CHECK_LAUNCHES`` rel-err
    launches and no other kernel, over the tensors ``check_trace_shapes``
    counts; all 8 losses finite; nothing written to disk."""
    import io
    import tempfile
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train as cli

    cfg = get_config(TRAIN_ARCH)
    B, S = TRAIN_BATCH
    step_s, checks = [], []
    make_step, check = cli.make_train_step, cli.ttrace_check

    def timed_make(*a, **kw):
        fn = make_step(*a, **kw)

        def step(*sa):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*sa)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return out
        return step

    def checked(ref, cand, batch, **kw):
        t0 = time.perf_counter()
        res = check(ref, cand, batch, **kw)
        wall = time.perf_counter() - t0
        check_trace_shapes(res, cfg, B, S)
        checks.append(dict(passed=res.passed, tensors=len(res.report.records),
                           seconds=res.seconds, wall=wall,
                           worst=max(r.rel_err / r.threshold
                                     for r in res.report.records)))
        return res

    before = files_under(ROOT, tempfile.gettempdir())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with patched(cli, "make_train_step", timed_make), \
            patched(cli, "ttrace_check", checked), \
            contextlib.redirect_stdout(out):
        losses = cli.main(list(TRAIN_ARGV))
    seconds = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    log(out.getvalue().rstrip())
    written = sorted(files_under(ROOT, tempfile.gettempdir()) - before)
    stats = dict(counts=counts, launches=counts["packed_sq_norms"],
                 losses=losses, step_s=step_s, checks=checks,
                 seconds=seconds, peak_gib=peak)
    log(f"train_main {TRAIN_ARCH} ({cfg.n_layers} layers, B {B} x S {S}, 2 "
        f"microbatches): {json.dumps(stats)}")
    if out.getvalue().count("  [ttrace] regression check: PASS") != 1 or \
            len(checks) != 1 or not checks[0]["passed"]:
        raise AssertionError(f"the step-4 check did not PASS once: {checks}")
    if counts["packed_sq_norms"] != TRAIN_CHECK_LAUNCHES:
        raise AssertionError(f"packed_sq_norms launched "
                             f"{counts['packed_sq_norms']} times, want "
                             f"{TRAIN_CHECK_LAUNCHES}")
    others = {k: v for k, v in counts.items() if k != "packed_sq_norms" and v}
    if others:
        raise AssertionError(f"kernels off the path launched {others}")
    if len(losses) != 8 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}")
    if written:
        raise AssertionError(f"the run wrote {written[:5]}")
    return stats


def train_resume(device, root):
    """26b: full width at ``RESUME_LAYERS`` layers (bf16 parameters),
    ``make_train_step`` at 2 microbatches: 6 steps, ``save_checkpoint``,
    ``load_checkpoint``, 4 more must be bit-identical to 10 uninterrupted
    steps; then ``python -m repro_torch.launch.train`` (``RESUME_CLI``,
    ``--save``) must exit 0 with its check PASSing.  What each wrote is
    logged and removed."""
    import shutil
    import torch
    from repro_torch.checkpoint.store import (load_checkpoint,
                                              save_checkpoint)
    from repro_torch.configs.base import get_config
    from repro_torch.core.collector import named_params
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW, warmup_cosine

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=RESUME_LAYERS)
    B, S = TRAIN_BATCH
    first, rest = RESUME_STEPS
    model = Model(cfg, seed=0, device=device)
    p0 = {k: v.detach().clone() for k, v in named_params(model).items()}
    n_params = sum(v.numel() for v in p0.values())
    opt = AdamW(lr=warmup_cosine(3e-4, 1, first + rest))
    step = make_train_step(model, opt, n_micro=2)

    def run(p, st, steps):
        for k in steps:
            p, st, _ = step(p, st, make_batch(cfg, B, S, seed=0, step=k,
                                              device=device))
        return p, st

    seconds = {}
    t0 = time.perf_counter()
    whole = run(p0, opt.init(p0), range(first + rest))
    torch.cuda.synchronize()
    seconds["uninterrupted"] = time.perf_counter() - t0
    p, st = run(p0, opt.init(p0), range(first))
    ck = os.path.join(root, "train_ckpt")
    t0 = time.perf_counter()
    save_checkpoint(ck, (p, st), step=first)
    seconds["save"] = time.perf_counter() - t0
    ck_gb = dir_gb(ck)
    log(f"work dir holds {dir_gb(root):.3f} GB (a checkpoint of "
        f"{n_params} bf16 parameters and their AdamW state)")
    del p, st
    t0 = time.perf_counter()
    (p, st), at, _ = load_checkpoint(ck, (p0, opt.init(p0)))
    seconds["load"] = time.perf_counter() - t0
    shutil.rmtree(ck)
    resumed = run(p, st, range(at, first + rest))
    diffs = _states_equal(whole, resumed)
    if at != first or diffs:
        raise AssertionError(f"resumed at {at}; leaves differing from the "
                             f"uninterrupted run: {diffs[:5]}")
    log(f"train_resume: {first} steps + save + load + {rest} == "
        f"{first + rest} steps, every leaf of (params, AdamW state) "
        f"bit-identical; seconds {json.dumps(seconds)}")
    del whole, resumed, p, st, model, p0
    gc.collect()
    torch.cuda.empty_cache()

    work = os.path.join(root, "train_cli")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    argv = [*RESUME_CLI, "--save", work]
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *argv], capture_output=True, text=True,
                         timeout=600, env=env, cwd=ROOT)
    seconds["cli"] = time.perf_counter() - t0
    cli_gb = dir_gb(work)
    log(f"--- train {' '.join(argv)}: rc {out.returncode} in "
        f"{seconds['cli']:.2f} s\n{out.stdout.strip()}")
    log(f"work dir holds {dir_gb(root):.3f} GB (the CLI's checkpoint)")
    shutil.rmtree(work, ignore_errors=True)
    if out.returncode != 0 or "  [ttrace] regression check: PASS" not in \
            out.stdout or f"saved to {work}" not in out.stdout:
        raise AssertionError(f"train CLI: rc {out.returncode}\n{out.stdout}"
                             f"\n{out.stderr[-3000:]}")
    return dict(seconds=seconds, params=n_params, checkpoint_gb=ck_gb,
                cli_gb=cli_gb)


def check_single_pair(device):
    """26c: ``kernels.relerr.sq_norms`` and ``ops.rel_err`` (one launch
    each of ``packed_sq_norms`` at 65536 elements a block) at
    ``SINGLE_PAIR_SIZES``, f32 and bf16 leaves, against float64 and the
    plain version (``REL_TOL`` on each sum), a zero ``a``, NaN in real
    data, two launches bit-identical.  Returns (largest |kernel - plain|,
    launches)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.relerr import (SINGLE_PAIR_BLOCK,
                                            packed_sq_norms,
                                            packed_sq_norms_ref,
                                            rel_err_ref, single_pair_layout,
                                            sq_norms)

    gen = torch.Generator(device="cpu").manual_seed(26)
    max_err, calls = 0.0, 0
    reset_counts()

    def one(fn, *args):
        nonlocal calls
        n0 = packed_sq_norms.launches
        out = fn(*args)
        if packed_sq_norms.launches != n0 + 1:
            raise AssertionError(f"{fn.__name__}: "
                                 f"{packed_sq_norms.launches - n0} launches")
        calls += 1
        return out

    for n in SINGLE_PAIR_SIZES:
        a = torch.randn(n, generator=gen) * (0.01 + 10 * torch.rand(
            1, generator=gen))
        b = a + 1e-3 * torch.randn(n, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            da, db = a.to(device, dtype), b.to(device, dtype)
            a64, b64 = da.double(), db.double()
            ref = torch.stack([torch.dot(a64 - b64, a64 - b64),
                               torch.dot(a64, a64)])[None]
            k1 = torch.stack(one(sq_norms, da, db))[None]
            k2 = torch.stack(one(sq_norms, da, db))[None]
            plain = packed_sq_norms_ref(*single_pair_layout(da, db),
                                        n_segments=1,
                                        block=SINGLE_PAIR_BLOCK)
            if not torch.equal(k1, k2):
                raise AssertionError(f"n {n} {dtype}: two launches differ")
            _within(k1, ref, f"single pair n {n} {dtype}")
            _within(plain, ref, f"plain n {n} {dtype}")
            max_err = max(max_err, float((k1 - plain).abs().max()))
            got, want = one(ops.rel_err, da, db), rel_err_ref(da, db)
            if abs(got - want) > REL_TOL * want:
                raise AssertionError(f"rel_err n {n} {dtype}: {got} vs "
                                     f"float64 {want}")
            zero = torch.zeros_like(da)
            got, want = one(ops.rel_err, zero, db), rel_err_ref(zero, db)
            if abs(got - want) > REL_TOL * want:
                raise AssertionError(f"zero a, n {n} {dtype}: {got} vs ||b|| "
                                     f"{want}")
            bad = da.clone()
            bad[n // 2] = float("nan")
            if not all(math.isnan(float(x)) for x in one(sq_norms, bad, db)):
                raise AssertionError(f"n {n} {dtype}: a NaN in real data did "
                                     f"not propagate")
        log(f"single pair n {n}: f32 and bf16 ok")
    launches = read_counts()["packed_sq_norms"]
    if launches != calls:
        raise AssertionError(f"{launches} launches for {calls} calls")
    return max_err, launches


def single_pair_timing(device):
    """26c: the largest single pair, f32: the kernel per launch (the card
    held busy), the copy to f32 and the pad (``single_pair_layout``), the
    plain version, and ``torch.linalg.vector_norm`` of a - b and of a as
    the library yardstick, beside the bytes bound 2 n 4 B over HBM."""
    import torch
    from repro_torch.kernels.relerr import (SINGLE_PAIR_BLOCK,
                                            packed_sq_norms,
                                            packed_sq_norms_ref,
                                            single_pair_layout)
    n = SINGLE_PAIR_SIZES[-1]
    gen = torch.Generator(device="cpu").manual_seed(27)
    a = torch.randn(n, generator=gen).to(device)
    b = a + 1e-3 * torch.randn(n, generator=gen).to(device)
    args = single_pair_layout(a, b)
    launches = packed_sq_norms.launches
    kw = dict(n_segments=1, block=SINGLE_PAIR_BLOCK)
    with uninitialized_fill(False):
        ms = device_time_ms(lambda: packed_sq_norms(*args, **kw))
        layout_ms = device_time_ms(lambda: single_pair_layout(a, b))
        plain_ms = device_time_ms(lambda: packed_sq_norms_ref(*args, **kw),
                                  reps=5, warmup=1)
        library_ms = device_time_ms(lambda: (
            torch.linalg.vector_norm(a - b), torch.linalg.vector_norm(a)),
            reps=5, warmup=1)
    packed_sq_norms.launches = launches      # timing launches are not counted
    bound_ms = 2 * n * 4 / HBM_BYTES_PER_S * 1e3
    return dict(n=n, blocks=int(args[2].numel()), ms=ms, layout_ms=layout_ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_share=bound_ms / ms)


def train_phases(device, phase):
    """Phases 26a-26c, in a temporary work dir removed at the end."""
    import shutil
    import tempfile
    import torch
    out = {"train_main": phase("train_main", lambda: train_main(device))}
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        out["train_resume"] = phase("train_resume",
                                    lambda: train_resume(device, root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    single = phase("rel_err_kernel", lambda: check_single_pair(device))
    if single is not None:
        out["rel_err_kernel"] = dict(max_abs_err=single[0],
                                     launches=single[1])
    timed = phase("rel_err_timing", lambda: single_pair_timing(device))
    if timed is not None:
        log(f"packed_sq_norms single pair, n {timed['n']} f32 "
            f"({timed['blocks']} blocks of 65536) on {card_line()}: kernel "
            f"{timed['ms']:.4f} ms ({timed['bound_share']:.3f} of the "
            f"bound), copy to f32 and pad {timed['layout_ms']:.4f} ms, plain "
            f"{timed['plain_ms']:.4f} ms, library (2 vector_norm) "
            f"{timed['library_ms']:.4f} ms, bound {timed['bound_ms']:.4f} "
            f"ms (bytes)")
    return out


# ---------------------------------------------------------------------------
# phases 27a-27d: the dry run (launch/dryrun.py), its meta-device plan held
# against real runs on the card: the planned peak against
# max_memory_allocated, the meta flop count against FlopCounterMode, the
# candidate's collective report against the card's log; then the CLI
# ---------------------------------------------------------------------------

DRY_ARCH = "tinyllama-1.1b"
DRY_TRAIN = (8, 128, 2)          # 26a's B, S and microbatches
DRY_PREFILL = (8, 2048)          # B x S: plain attention, (S, S) scores
DRY_DECODE = (32, 4096)          # B x cache positions, the step at 4095
DRY_PEAK_TOL = 0.10              # planned peak against the card's, relative
DRY_CLI = (("--arch", DRY_ARCH, "--shape", "decode_32k", "--host"),
           ("--arch", "qwen1.5-110b", "--shape", "decode_32k"))


def held(device) -> int:
    """The bytes allocated on the card now, after a collection: what
    earlier phases left, measured before a phase makes its arguments."""
    import torch
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated(device)


def card_run(device, fn, floor):
    """``fn()`` on the card, the peak statistic reset just before: (its
    output, the card's figures).  ``peak`` and ``before`` are
    max_memory_allocated over the call and the bytes allocated as it
    starts, each less ``floor``, what earlier phases left (``held``
    before this phase made its arguments); ``flops`` is
    ``FlopCounterMode``'s count of a second call, ``secs`` the first's
    synchronized seconds.  The peak is read without the counter: its
    module tracker keeps tensors alive for their gradient hooks.  No
    kernel may launch: the dry run's path is the plain model's."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    before = held(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    with FlopCounterMode(display=False) as fc:
        fn()
    launched = {k: v for k, v in read_counts().items() if v}
    if launched:
        raise AssertionError(f"kernels launched on the plain path: {launched}")
    return out, dict(peak=peak - floor, before=before - floor, floor=floor,
                     flops=fc.get_total_flops(), secs=secs)


def plan_against_card(label, rec, card, plan_peak=None):
    """The plan's peak within ``DRY_PEAK_TOL`` of the card's, its flops
    equal to the card's count; logged with the card's line."""
    pd = rec["per_device"]
    planned = pd["peak_bytes"] if plan_peak is None else plan_peak
    rel = planned / card["peak"] - 1
    gib = 2**30
    row = dict(planned_peak_gib=planned / gib,
               card_peak_gib=card["peak"] / gib, rel=rel,
               planned_args_gib=((planned - pd["temp_bytes"]) / gib
                                 if plan_peak is None else None),
               card_before_gib=card["before"] / gib,
               earlier_phases_gib=card["floor"] / gib,
               meta_flops=rec["flops"], card_flops=card["flops"],
               bytes_accessed=rec["bytes_accessed"], meta_s=rec["compile_s"],
               card_s=card["secs"])
    log(f"{label} on {card_line()}: {json.dumps(row)}")
    if abs(rel) > DRY_PEAK_TOL:
        raise AssertionError(f"{label}: planned peak {planned} against the "
                             f"card's {card['peak']} ({rel:+.4f})")
    if rec["flops"] != card["flops"]:
        raise AssertionError(f"{label}: meta flops {rec['flops']} against "
                             f"the card's {card['flops']}")
    return row


def dryrun_train(device):
    """27a: full-width, full-depth ``DRY_ARCH`` at 26a's batch: the
    host-mesh plan of one train step against one real ``make_train_step``
    of the same config, with ``remat`` on (the config's) and off."""
    import torch
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.core.collector import named_params
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.dryrun import dryrun_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW
    B, S, n_micro = DRY_TRAIN
    shape = InputShape("27a", S, B, "train")
    cfg = get_config(DRY_ARCH)
    floor = held(device)
    model = Model(cfg, seed=0, device=device)
    params = {k: p.detach() for k, p in named_params(model).items()}
    batch = make_batch(cfg, B, S, seed=0, device=device)
    out = {}
    for remat in (True, False):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        rec = dryrun_config(model.cfg, shape, make_host_mesh(),
                            n_micro=n_micro)
        opt = AdamW(lr=1e-4)
        st = opt.init(params)
        step = make_train_step(model, opt, n_micro=n_micro)
        res, card = card_run(device, lambda: step(params, st, batch), floor)
        loss = float(res[2]["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"27a loss {loss}")
        out["remat" if remat else "no_remat"] = dict(plan_against_card(
            f"27a train step, remat {'on' if remat else 'off'}", rec, card),
            loss=loss)
        del res, st
    on, off = out["remat"], out["no_remat"]
    log(f"27a: remat takes the card's peak from {off['card_peak_gib']:.4f} "
        f"to {on['card_peak_gib']:.4f} GiB (the plan: "
        f"{off['planned_peak_gib']:.4f} -> {on['planned_peak_gib']:.4f}); "
        f"step {off['card_s']:.3f} -> {on['card_s']:.3f} s (remat on runs "
        f"first)")
    if on["loss"] != off["loss"]:
        raise AssertionError(f"remat changed the loss: {on} {off}")
    model.cfg = cfg
    return out


def dryrun_serve(device):
    """27b: the host-mesh plans of a ``make_prefill_step`` (``DRY_PREFILL``)
    and a ``make_serve_step`` (``DRY_DECODE``) of full-depth ``DRY_ARCH``
    against the same steps on the card."""
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.dryrun import dryrun_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.model import Model
    cfg = get_config(DRY_ARCH)
    floor = held(device)
    model = Model(cfg, seed=0, device=device)
    out = {}
    B, S = DRY_PREFILL
    rec = dryrun_config(cfg, InputShape("27b", S, B, "prefill"),
                        make_host_mesh())
    batch = make_batch(cfg, B, S, seed=0, device=device)
    step = make_prefill_step(model)
    logits, card = card_run(device, lambda: step(batch), floor)
    if tuple(logits.shape) != (B, 1, cfg.vocab) or \
            not bool(logits.isfinite().all()):
        raise AssertionError(f"27b prefill logits {tuple(logits.shape)}")
    del logits, batch
    out["prefill"] = plan_against_card("27b prefill", rec, card)
    B, T = DRY_DECODE
    rec = dryrun_config(cfg, InputShape("27b", T, B, "decode"),
                        make_host_mesh())
    cache = model.init_cache(B, T)
    tokens = make_batch(cfg, B, 1, seed=0, device=device)["tokens"]
    step = make_serve_step(model)
    (logits, cache), card = card_run(
        device, lambda: step(cache, {"tokens": tokens, "pos": T - 1}), floor)
    if tuple(logits.shape) != (B, 1, cfg.vocab) or \
            not bool(logits.isfinite().all()):
        raise AssertionError(f"27b decode logits {tuple(logits.shape)}")
    del logits, cache
    out["decode"] = plan_against_card("27b decode", rec, card)
    return out


def dryrun_dist(device):
    """27c: the meta plan of ``dist_main``'s candidate (full-width
    ``gpt-paper``, dp2·cp2·tp2·sp, B 8 x S 1024, 8 ranks stacked on one
    card) against one real candidate train step: collective reports equal
    by kind, count and bytes; flops equal; the rank-stacked peak within
    ``DRY_PEAK_TOL``."""
    import torch
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.core.collector import named_params
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.dryrun import dryrun_candidate
    from repro_torch.launch.hlo import collective_report
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel.api import (ParallelConfig,
                                          make_candidate_train_step)
    from repro_torch.parallel.mesh import collective_log
    cfg = get_config("gpt-paper")
    B, S = 8, 1024
    pcfg = ParallelConfig(**DIST_MAIN)
    rec = dryrun_candidate(cfg, InputShape("27c", S, B, "train"), pcfg)
    floor = held(device)
    model = Model(cfg, seed=0, device=device)
    step, p0, o0 = make_candidate_train_step(
        cfg, pcfg, named_params(model), AdamW(lr=1e-4), device=device)
    del model
    batch = {k: v for k, v in make_batch(cfg, B, S, seed=0,
                                         device=device).items()
             if k in ("tokens", "labels")}
    calls = []

    def logged():                    # the first of card_run's two calls
        with collective_log() as c:
            out = step(p0, o0, batch)
        calls.append(c)
        return out
    res, card = card_run(device, logged, floor)
    calls = calls[0]
    loss = float(res[0].loss)
    del res
    report = collective_report(calls)
    row = plan_against_card("27c candidate step (rank-stacked)", rec, card,
                            plan_peak=rec["rank_stacked_peak_bytes"])
    log(f"27c collectives, card: {json.dumps(report)}")
    if report != rec["collectives"]:
        raise AssertionError(f"27c: the meta report {rec['collectives']} "
                             f"is not the card's {report}")
    if not math.isfinite(loss):
        raise AssertionError(f"27c loss {loss}")
    torch.cuda.empty_cache()
    return dict(row, collectives=report["total"], loss=loss)


def dryrun_cli():
    """27d: ``python -m repro_torch.launch.dryrun`` on each of ``DRY_CLI``,
    all at once, must exit 0; each pair's per-device GiB logged against
    80 GB."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
             "--out", os.path.join(d, f"{i}.json")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
            for i, argv in enumerate(DRY_CLI)]
        recs = []
        try:
            for i, (argv, p) in enumerate(zip(DRY_CLI, procs)):
                stdout, stderr = p.communicate(timeout=300)
                secs = time.perf_counter() - t0
                log(f"--- dryrun {' '.join(argv)}: rc {p.returncode} after "
                    f"{secs:.2f} s\n" + stdout.strip())
                if p.returncode != 0:
                    raise AssertionError(f"dryrun {argv}: rc {p.returncode}"
                                         f"\n{stderr[-3000:]}")
                with open(os.path.join(d, f"{i}.json")) as f:
                    recs += [(r, secs) for r in json.load(f)]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, secs in recs:
            gib = r["per_device"]["peak_bytes"] / 2**30
            out[f"{r['arch']} {r['shape']} "
                f"{'x'.join(map(str, r['mesh'].values()))}"] = dict(
                    seconds=secs, peak_gib=gib, fits_80gb=gib * 2**30 <= 80e9,
                    bound=r["bound"])
    log("27d per device against 80 GB: " + json.dumps(out))
    return out


def dryrun_phases(device, phase):
    """Phases 27a-27d."""
    import torch
    out = {}
    for name, fn in (("dryrun_train", lambda: dryrun_train(device)),
                     ("dryrun_serve", lambda: dryrun_serve(device)),
                     ("dryrun_candidate", lambda: dryrun_dist(device)),
                     ("dryrun_cli", dryrun_cli)):
        out[name] = phase(name, fn)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.base import get_config
    from repro_torch.core.thresholds import MACHINE_EPS
    from repro_torch.kernels import build

    failures = []
    ok = {}

    def phase(name, fn):
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception:                  # reported, and the run exits 1
            failures.append(name)
            log(f"PHASE {name} FAILED after {time.perf_counter() - t0:.2f} s")
            traceback.print_exc(file=sys.stdout)
            return None
        ok[name] = True
        log(f"PHASE {name} ok ({time.perf_counter() - t0:.2f} s)")
        return out

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    cap = torch.cuda.get_device_capability(0)
    log(f"capability: {cap}")
    if cap != (9, 0):
        print(f"chip_smoke: needs compute capability 9.0, got {cap}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)

    def log_builds(secs):
        for name, s in secs.items():
            log(f"built {name} in {s:.2f} s")
            log(build.lib_path(name).with_suffix(".log").read_text().strip())
        return secs

    # its thread is joined at phase 16, or at exit if the run ends first
    late_build = concurrent.futures.ThreadPoolExecutor(1).submit(
        build.build_all, LATE_BUILDS)
    phase("build", lambda: log_builds(build.build_all(
        tuple(n for n in build.SOURCES if n not in LATE_BUILDS))))
    if failures:
        return 1

    block = 1024
    kernel_err = phase("kernel", lambda: check_kernel(
        dev, [1, block - 1, block, block + 1, 3_000_017, 4_194_311]))

    cfg = get_config("gpt-paper")
    eps = MACHINE_EPS["bfloat16"]
    B, S = 8, 1024
    main = phase("main", lambda: main_path(dev, cfg, B, S, eps))
    stats = None
    if main is not None:
        res, stats, model, batch = main
        log(res.summary())
        log(f"main path: {stats['tensors']} tensors compared, packed section "
            f"{stats['packed_elems']} elements, loss {stats['loss']:.6f}, "
            f"kernel launches: estimate {stats['estimate_launches']}, "
            f"compare {stats['compare_launches']}")
        log("step seconds: " + json.dumps(stats["seconds"]))

        def verdict():
            if not res.passed:
                raise AssertionError("clean gpt-paper check did not PASS")
            if stats["estimate_launches"] < 1 or stats["compare_launches"] < 1:
                raise AssertionError("packed_sq_norms did not run on both the "
                                     "estimate and the compare")
            check_trace_shapes(res, cfg, B, S)
        phase("main_verdict", verdict)

        def cross():
            r = cross_device_check(cfg)
            log(r.summary())
            if not r.passed:
                raise AssertionError("card vs CPU check did not PASS")
        phase("cross_device", cross)

        def control():
            r = negative_control(cfg, model, batch, eps)
            log(r.summary())
            log("control step seconds: " + json.dumps(r.seconds))
            if r.passed or r.localized_module != "layers.5.mlp":
                raise AssertionError(f"doubled layers.5.mlp.down.w: passed="
                                     f"{r.passed}, localized "
                                     f"{r.localized_module!r}")
        phase("control", control)

        timing = phase("timing", lambda: time_reduction(res))
        if timing is not None:
            log(f"compare-section reduction on {card}: {timing['pairs']} "
                f"pairs, {timing['packed_elems']} packed elements: kernel "
                f"{timing['ms']:.4f} ms, plain {timing['plain_ms']:.4f} ms, "
                f"library (_foreach_sub + 2 _foreach_norm) "
                f"{timing['library_ms']:.4f} ms, bound {timing['bound_ms']:.4f} "
                f"ms ({timing['bound_by']}); pack_device {timing['pack_ms']:.4f} "
                f"ms; kernel vs plain: max abs {timing['max_abs_err']:.3g}, "
                f"max rel {timing['max_rel_err']:.3g}")
    fp8_err = phase("fp8_kernel", lambda: check_fp8_kernels(dev))
    fp8 = fp8_timed = None
    if main is not None:
        fp8 = phase("fp8_main", lambda: fp8_main(model, batch, cfg, B, S))
        phase("fp8_control", lambda: fp8_control(model, batch))
    if fp8_err is not None:
        fp8_timed = phase("fp8_timing", lambda: fp8_timing(dev))
        if fp8_timed is not None:
            fp8_timed, fp8_built = fp8_timed
            for name, info in fp8_built.items():
                log(f"fp8_matmul build {name}: {json.dumps(info)}")
            for name, row in fp8_timed.items():
                log(f"{name} on {card}, per launch over the main path's mix: "
                    f"kernel {row['ms']:.4f} ms, wrapper back-to-back "
                    f"{row['wrapper_ms']:.4f} ms, plain {row['plain_ms']:.4f} "
                    f"ms, library ({row['library']}) {row['library_ms']} ms, "
                    f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    flash_err = phase("flash_kernel", lambda: check_flash_kernel(dev))
    flash = flash_timed = None
    if main is not None:
        flash = phase("flash_main", lambda: flash_verdict(
            "flash_main", *flash_check(model, batch), cfg, B, S))
        phase("flash_long", lambda: flash_long(model, cfg, 2, 4096))
        phase("flash_control", lambda: flash_control(cfg, model, batch))
    if flash_err is not None:
        flash_timed = phase("flash_timing", lambda: flash_timing(dev))
        if flash_timed is not None:
            flash_timed = flash_timed[0]
            for row in flash_timed:
                log(f"flash_attention {row['shape']} bf16 {row['mode']} on "
                    f"{card}: "
                    f"kernel {row['ms']:.4f} ms ({row['executed_tflops']:.1f} "
                    f"TFLOP/s executed, {row['bound_share']:.3f} of the "
                    f"bound), wrapper back-to-back {row['wrapper_ms']:.4f} ms,"
                    f" plain {row['plain_ms']:.4f} ms, library "
                    f"(scaled_dot_product_attention) {row['library_ms']} ms "
                    f"(by backend, deterministic mode off: "
                    f"{json.dumps(row['library_backends_ms'])}), "
                    f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
                    f"warpgroup cycles by phase "
                    f"{json.dumps(row['phase_share'])}")
    if main is not None:
        phase("dist_main", lambda: dist_main(cfg, model, batch, B, S))
        phase("dist_zero1", lambda: dist_zero1(cfg, model, batch, B, S))
        phase("dist_control", lambda: dist_control(cfg, model, batch))
    # the supervised phases build their own models; then the rwkv6-7b
    # phases need most of the card: drop the gpt-paper state
    main = res = model = batch = None
    torch.cuda.empty_cache()
    sup_phases(cfg, phase)
    phase("build_late", lambda: log_builds(late_build.result()))
    ssm_err = phase("ssm_kernel", lambda: check_ssm_kernel(dev))
    ssm = ssm_timed = None
    B_ssm, S_ssm = 2, 4096
    ssm_run = phase("ssm_main", lambda: ssm_main(dev, B_ssm, S_ssm))
    if ssm_run is not None:
        ssm, _, ssm_model, ssm_batch = ssm_run
        torch.cuda.empty_cache()
        phase("ssm_control", lambda: ssm_control(ssm_model, ssm_batch))
        del ssm_run, ssm_model, ssm_batch
    if ssm_err is not None:
        ssm_timed = phase("ssm_timing", lambda: ssm_timing(dev))
        if ssm_timed is not None:
            ssm_timed, ssm_built = ssm_timed
            for name, info in ssm_built.items():
                log(f"ssm_scan build {name}: {json.dumps(info)}")
            for row in ssm_timed:
                log(f"gla_scan {row['shape']} {row['decay']}"
                    f"{' q/k head stride 0' if row['qk_head_stride_0'] else ''}"
                    f" on {card}: "
                    f"kernel {row['ms']:.4f} ms ({row['executed_tflops']:.1f}"
                    f" TFLOP/s TF32 executed, {row['bound_share']:.3f} of the"
                    f" bound, this design's TF32 floor "
                    f"{row['tf32_floor_ms']:.4f} ms), with the fill "
                    f"{row['filled_ms']:.4f} ms, back to back "
                    f"{row['wrapper_ms']:.4f} ms, plain {row['plain_ms']:.4f}"
                    f" ms, library: no single call, bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}); passes "
                    f"{json.dumps(row['pass_ms'])}")
    # the Mixtral phases need most of the card: every earlier model is gone
    gc.collect()
    torch.cuda.empty_cache()
    moe = moe_phases(dev, phase)
    gc.collect()
    torch.cuda.empty_cache()
    mla_phases(dev, phase)
    gc.collect()
    torch.cuda.empty_cache()
    zamba = zamba_phases(dev, phase)
    gc.collect()
    torch.cuda.empty_cache()
    dense = dense_phases(dev, phase)
    gc.collect()
    torch.cuda.empty_cache()
    trained = train_phases(dev, phase)
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_phases(dev, phase)
    if failures:
        log(f"FAILED phases: {failures}")
        return 1
    relerr_by_path = {"gpt-paper": stats["launches"],
                      "train": trained["train_main"]["launches"],
                      "rel_err": trained["rel_err_kernel"]["launches"]}
    kernels = [{
        "name": "packed_sq_norms", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": sum(relerr_by_path.values()),
        "launches_by_path": relerr_by_path,
        "max_abs_err": max(kernel_err, timing["max_abs_err"],
                           trained["rel_err_kernel"]["max_abs_err"]),
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}]
    for name in ("fp8_matmul", "fp8_matmul_tile128"):
        row = fp8_timed[name]
        kernels.append({
            "name": name, "route": "cuda", "source": FP8_SOURCE,
            "replaces": FP8_REPLACES[name], "launches": fp8[name]["launches"],
            "max_abs_err": fp8_err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    row = flash_timed[0]                 # the main path's shape
    flash_by_path = {"gpt-paper": flash["launches"],
                     MOE_ARCH: moe["moe_flash"]["launches"]}
    for spec, key in ((QWEN3, "qwen3_main"), (LLAVA, "llava_main"),
                      (HUBERT, "hubert_main")):
        flash_by_path[spec[0]] = dense[key]["counts"]["flash_attention"]
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": sum(flash_by_path.values()),
        "launches_by_path": flash_by_path,
        "max_abs_err": flash_err, "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    row = ssm_timed[0]                   # rwkv6-7b's shape, the path's
    zamba_launched = zamba["zamba_main"]["counts"]["gla_scan"]
    kernels.append({
        "name": "gla_scan", "route": "cuda", "source": SSM_SOURCE,
        "replaces": SSM_REPLACES, "launches": ssm["launches"] + zamba_launched,
        "launches_by_path": {"rwkv6-7b": ssm["launches"],
                             "zamba2-7b": zamba_launched},
        "max_abs_err": ssm_err, "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (paddle_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, each a hard check (the script exits nonzero on the first failure):
  1. device: card name and power limit, torch/CUDA versions; build every
     kernel from csrc/ with nvcc (one process per source, in parallel).
  2. forward kernel: flash_attention_fwd (the hand-written kernel) against
     its plain PyTorch version on the card, at the serving, long-prompt,
     training and static-engine prefill (phase 10) shapes, the edge cases,
     head dims 32, 64, 96, 128 and 256 (phase 13's widths at their prefill
     and training shapes), a head dim the wrapper pads (80, to 96) in bf16,
     fp16 and fp32, and views TMA cannot read, bf16 and fp32 (the wrapper
     copies them and launches the same kernel),
     with a tolerance per dtype; times of the kernel, the plain version and
     torch's scaled_dot_product_attention (a yardstick only: the port never
     calls it) beside the least time the card could take (float32 at the
     3xTF32 rate its kernel runs: three TF32 passes a product), the fp32
     kernel at phase 17 (a)'s shape causal and not.
  3. serving at full width: the flagship LLaMA (vocab 32000, hidden 2048,
     8 layers, 16 heads x 128, bf16, random weights from a seed) served by
     LlamaDecodeEngine.generate (8 prompts x 128 tokens, 32 greedy new
     tokens) and LlamaForCausalLM.generate. Launch counts are set to 0 just
     before and read just after: every prefill must launch the forward kernel
     once per layer, serving no backward kernel, and the wrapper must make no
     alignment copy.
  4. card against CPU: the same width at 2 layers in fp32, copied to a CPU
     twin (which runs the plain versions); prefill logits must agree and
     greedy tokens must be identical.
  5. backward kernels: the dq kernel (which also computes delta =
     rowsum(dO * O)) and the dk/dv kernel against the plain backward on the
     card, at the training shapes and the edge cases, head dims 32, 64, 96,
     128 and 256 (phase 13's widths at the training shape), a padded 80 in
     bf16, fp16 and fp32, and views TMA cannot read (q, dO, and an fp32 q:
     the kernels read every input by TMA at every dtype, so the wrapper
     copies such a view once and launches the same kernels once each), with
     a norm-relative tolerance per
     dtype; the fused delta against the plain one at the timed shapes; times
     of each kernel, the whole backward, the plain version and torch's
     flash-attention backward (a yardstick only) beside the least time the
     card could take; the fp32 (3xTF32) kernels also beside their
     tensor-core bound, at phase 17 (a)'s shape causal and not.
  6. training at full width: the flagship in bf16 with per-layer recompute,
     AdamW(multi_precision) at lr 1e-4, batch 8 x 2048, the same batch every
     step. Launch counts are set to 0 before one step and read after it:
     2 forward launches per layer (recompute runs the forward again), one dq
     and one dk/dv launch per layer, no alignment copy. Every parameter must
     get a finite,
     nonzero gradient, and the loss must fall; step time, tokens/s, MFU,
     peak memory and a profiled step's device time by kernel group are
     printed.
  7. training, card against CPU: the same width at 2 layers in fp32, B2
     S256 (so the fp32 kernels run), copied to a CPU twin; two AdamW steps
     on each: losses, step-1 gradients and the parameters after step 2 must
     agree within the tolerances below.
  8. custom-op path: the y = 2x + 1 kernel (axpy) against its plain version,
     bit for bit (NaN where the plain version gives NaN: a NaN's payload is
     not part of the function), at the JAX test's fp32 (8,), a ragged
     1,000,003, unaligned views, 0 elements, bf16 and fp16 with specials and
     2^26 fp32, which is timed beside its bound (the kernel's registers,
     shared memory and spills are the ``ptxas_axpy`` line). Then the op registered
     through register_custom_op as the JAX test registers its Pallas kernel:
     launch count set to 0 before three calls on tensors that require grad,
     one launch per call, outputs on the card without grad_fn; the same
     kernel registered as differentiable must raise CustomOpError. Last, a
     cpp_extension host op (built with the system C++ compiler) on CUDA
     tensors: values and gradients come back on the card.
  9. paged and int8 serving at phase 3's width, depth, batch and prompts:
     LlamaDecodeEngine with the paged cache (block_size 64), the int8 cache
     and both, beside the dense engine; prefill_ms, ms_per_token,
     tokens_per_sec and the cache's bytes against the dense bf16 cache's.
     Launch counts set to 0 before each engine's run: the bf16 prompt pass
     launches the forward kernel once a layer, the int8 one never, decode
     steps never. Logits against the dense engine's (tolerances below); fp32
     greedy tokens of every form equal on the card and on a CPU twin, paged
     equal to dense; beam search (B8 K4, 16 new tokens) on the dense and the
     paged engine, with the paged pool's books balanced; float64 paged and
     dense beams equal.
 10. continuous-batching serving at phase 3's width and depth (bf16, random
     weights from a seed), ContinuousBatchingEngine with both programs (the
     mixed step and the decode burst) captured as CUDA graphs:
     (a) each captured program against its eager function on copies of the
     same pools (decode lanes, draft chains accepted twice then cut and
     rejected at once, a prefill chunk; a burst with inactive rows): tokens,
     accept flags and every pool byte equal; the burst's first tokens equal
     the mixed step's on the same rows at other lanes;
     (b) bench.py:663-666's serving parameters through StaticBatchEngine,
     then the continuous engine cold, then warm (bench_common.py's
     serving_bench, its workload generator and open-loop loop copied here):
     tokens/s, TTFT p50/p99, prefix hit rates, speedup over static; the
     forward kernel launches once a layer per static admission and never in
     the continuous passes; warm tokens equal cold tokens;
     (c) bench.py:667-670's speculative-decoding parameters: spec on and off
     tokens/s, drafted and accepted counts; every pass's tokens equal on and
     off;
     (d) int8 pools: the (b) workload once (tokens/s; pool bytes over bf16
     equal (D + 4) / 2D), and int8 speculation on against off;
     (e) fp32, 2 layers: one add_request/step schedule on the card and on a
     CPU twin gives the same token streams;
     (f) one profiled replay of each program: device ms and kernels beside
     the host ms a step of the warm pass.
 11. serving resilience and the fleet at phase 3's width and depth (bf16),
     through paddle_tpu_torch's own fault-injection harness and watchdog, no
     check caught: (a) bench_suite.py:470-476's fleet drill (3 replicas, 24
     Poisson requests in 3 prefix groups, 64 new tokens): a reference
     fleet, a fleet whose replica loop dies at fleet.replica_step (nth 12),
     then replica 1 drained mid-stream on the reference fleet; every request
     completes with the reference's tokens, no graph is captured after
     warmup (each replica captures its two programs then, side by side), the
     drain loses none; per-replica steps, tokens/s, failovers, recovery ms;
     (b) bench_suite.py:339-343's engine drill: the driving thread killed at
     serving.drive (nth 9), aborted requests resubmitted, a warm relaunch
     (re-admissions hit the radix cache, no program captured again) and the
     reference's tokens; then gold against a bronze flood on a
     strict-priority engine (gold goodput over isolated, typed sheds); (c)
     kv_spill on a pool too small for its batch (preemptions, restores,
     spilled bytes; streams equal an ample pool's), kv_spill with the radix
     cache on (evicted prefixes spill to host RAM and a re-admission
     restores them on the card; streams equal a run without spill) and a
     serving.step delay
     past hang_timeout on one replica of a fleet, recovered by its
     watchdog with the reference's tokens; (d) block_multihead_attention,
     prefill then decode, card against CPU at fp32 within 1e-5, after a
     mixed batch with host lengths is rejected on the host
     (NotImplementedError) and the process's CUDA context survives it.
 12. the training surface at phase 6's width, depth and batch (bf16, AdamW
     multi_precision): (a) bench.py:879-880's knobs as five variants of the
     step (recompute_granularity "full", "full_attn" with fused_head_ce,
     "core_attn", recompute off, "full" with fused_head_ce): launches (2L, L,
     L) under recompute and (L, L, L) off, no alignment copy, every gradient
     finite and nonzero, a falling loss, step_ms, tokens/s, MFU, peak memory
     in the orders off > core_attn > full and fused < standard, one profiled
     step each, the same loss bit for bit after 6 steps at every granularity
     (per head: the recompute's tensors are the forward's), the fused head's
     first loss against the standard head's in fp32, and the matrix products
     one layer issues on the card, every one
     without batch dimensions kept by the selective policy; (b) LinearWarmup
     over CosineAnnealingDecay with ClipGradByGlobalNorm(1.0), 4 steps, each
     opt.step() under sync debug mode "error": the rates against the JAX
     formulas in plain Python, the card's global norm against a float64 host
     sum, the ms clipping adds; (c) at 2 layers: 6 steps, then 3 steps, an
     async CheckpointManager save, a fresh model, optimizer and scheduler
     restored, 3 more: losses and weights equal the uninterrupted run bit for
     bit; bytes written, ms the save blocked, writer, restore and verify
     seconds.
 13. the LLaMA architecture at Phi-3-mini's width (hidden 3072, 32 heads x
     96, 32 layers, vocab 32064) and Gemma-2B's (hidden 2048, 8 heads and 1
     KV head x 256, 18 layers, vocab 256000; not Gemma's GeGLU, embedding
     scale or norm, which the JAX LlamaConfig lacks), bf16, random weights:
     each served at full depth as phase 3 serves the flagship (forward
     launches a prefill = layers, no pad, no copy, 0 math-path attention
     calls); each trained 3 AdamW(multi_precision) steps at B4 S2048 cut to
     4 layers (the Gemma width with the fused head): launches (2L, L, L) a
     step under recompute, every gradient finite and nonzero, a falling fp32
     loss, step_ms, MFU, peak memory and a profiled step; each at 2 layers
     in fp32, card against a CPU twin as phases 4 and 7 (B1 S128 for the
     training); then flash_attention launching the forward kernel once,
     flash_attn_unpadded (3 ragged sequences, fp32) against a per-sequence
     loop of the plain attention and its CPU twin, and every-two rotary card
     against CPU.
 14. the compiled paths: (a) the decode engine's captured programs (the
     prompt pass and the decode step as CUDA graphs) against a second
     engine that calls the same functions without graphs at the flagship
     width (phase 3's cell) and at Phi-3-mini's and Gemma-2B's widths at
     full depth (phase 13's cells): prefill logits and every decode step's
     logits equal bit for bit, equal tokens, prefill_ms, ms_per_token and
     tokens/s of both; the forward launches credited to a replayed prefill
     equal the layers, and at the flagship a profiled replay shows that many
     fa_fwd_wgmma kernels; two interleaved decodes at one batch size give
     their solo tokens; a warm generate captures no graph; what the captured
     programs keep: the reserved device memory over 14 new prefill graphs
     (7 prompt lengths at B8 and B1) and over 5 more batch sizes, against
     bounds; (b) at phase 9's cell the paged, int8 and paged-int8 engines
     captured against the same functions without graphs:
     equal tokens, and beam search (B8 K4, dense and paged) equal tokens and
     scores; (c) the flagship trained under jit.to_static (Inductor, the
     kernels as torch.library ops; phase 6's cell): the cold compile
     seconds, launches (2L, L, L) a warm step and no math-path attention,
     every gradient finite and nonzero, a falling fp32 loss, the median
     step_ms beside phase 6's eager median from this run, peak memory and a
     profiled step by kernel group; then phase 7's 2-layer fp32 shape,
     compiled against eager on the card: losses within 1e-5 relative,
     step-1 gradients within 1e-4 norm-relative; (d) the axpy op inside a
     full_graph=True to_static function: one launch a call, bit for bit the
     plain version; (e) a full_graph=False function with an .item() break:
     equal to eager, at least two compiled segments; (f) the flagship's
     forward at B8 S128 under to_static (no grad): one launch a layer, the
     cold compile seconds, the median ms of a call and a profiled call
     (phase 15's yardstick).
 15. the deploy path: (a) the flagship (phase 3's model) saved by jit.save
     on the card at InputSpec([8, 128], "int64"): its graph holds one
     flash_attention_fwd op a layer and no softmax; served by an
     inference.Predictor (Inductor) with that shape warmed at creation;
     launch counts set to 0 before one run and read after it: 8 forward
     launches, no backward, no math-path call, no alignment copy or pad, no
     compile. The loaded program run as it was saved gives the eager
     logits bit for bit; the Predictor's are no farther from an fp32 run of
     the same weights than the eager model's are (bounds below); the
     artifact's bytes, save, load and compile seconds, and the median ms of
     a run beside the eager forward's and phase 14 (f)'s to_static
     forward at that shape, each with a profiled call;
     (b) 2 layers in fp32 at B2 S128 saved on the card and from a CPU twin:
     the card program launches the fp32 kernel once a layer, card against
     CPU within TOL_E2E_LOGITS, each program equal to its eager model
     within 1e-5; (c) the CPU program loaded for the card raises; (d) a
     function calling the axpy op, saved on the card and reloaded in a
     fresh interpreter that imports only paddle_tpu_torch.jit: one launch a
     call, bit for bit; (e) the flagship's state dict through
     paddle_tpu_torch.save and load bit for bit, and a fresh model loaded
     from it gives the same logits bit for bit. At most DEPLOY_SECONDS.
 16. mixed precision through the op dispatch (paddle.amp): phase 6's cell built
     in float32 and trained with the PaddlePaddle AMP recipe, each variant's
     first step counted (launch counts and the operator stats set to 0
     before it, read after it): (a) auto_cast O1 bf16 with AdamW on the
     float32 parameters, (b) decorate O2 bf16 (bf16 parameters, float32
     masters) and auto_cast O2, (c) auto_cast O1 fp16 with a GradScaler
     (2**15, dynamic): each launches (16, 8, 8) a step with the attention
     op's calls all in the low dtype (the kernels' inputs), no math path,
     a falling loss, step_ms, tokens/s, MFU, peak memory and a profiled
     step (casts named) beside phase 6's eager median from this run; (c)
     waits on the card once a step (torch's sync debug mode counts it),
     then two overflow drills (the scale set to 2**40, which the fp16
     backward kernels must carry to a non-finite gradient, and an inf put in
     one gradient): each step skipped with every parameter, AdamW moment
     and the step count unchanged bit for bit and the scale halved, then a
     normal step trains; (d) 2 layers at the flagship width in float32, B1
     S128, card against a CPU twin under O1 bf16, O2 bf16 and O1 fp16, the
     forward: operator-stats tables equal, losses within TOL_AMP_LOSS; (e)
     the host microseconds of a dispatched add beside torch.add's, and phase 6's
     step with the ops on the dispatch against the same step with it
     bypassed, alternated, with each one's idle share. At most AMP_SECONDS.
 17. master gradients, autograd, streams, samplers and linalg: (a) phase 6's
     cell built in float32 and trained after decorate(O2, bf16,
     master_grad=True) (AdamW with float32 masters): the first step counted
     (launch counts set to 0 before it, read after it): 2L bf16 forward
     launches (forward and recompute), each layer's attention pullback rerun
     in float32 (L fp32 forward, L fp32 dq and L fp32 dk/dv launches, no
     bf16 backward), no math path, every parameter's gradient float32,
     finite and nonzero; one more warm-up step and 3 timed with the port's
     device.Event pairs beside phase 16 (b)'s O2 median and one profiled
     (L fa_fwd_tf32 kernels among its launches; then one more step under
     the port's Profiler with the counts set to 0: its bf16 fa_fwd_wgmma
     launches read from the Profiler's device table, from torch.profiler
     read directly, and from the counter),
     the peak from the port's max_memory_allocated, a falling loss; (b) 2 layers at the
     flagship width, B1 S128, one O2 bf16 master-grad backward card against
     a CPU twin: with the card's attention on the plain math path, as on
     the CPU, gradients within 2e-2 norm-relative; with it on the kernels
     within 3e-2 (the kernels keep fp32 logits where the plain path rounds
     them to bf16); each beside its distance to the float32 gradient; and an fp16 overflow
     drill: from a 2**15 GradScaler, the scale doubles until the fp16
     pullback overflows without master grad (the step skipped, the scale
     halved); at that scale with it every gradient is finite and the step
     is taken; (c) vjp of the flash_attention functional at bf16, B2 S2048
     H16 D128, causal: one forward, one dq and one dk/dv launch (counted),
     cotangents equal torch.autograd.grad of the same call bit for bit; a
     jacobian and a hessian of a small op-surface function, card against
     CPU; (d) phase 3's flagship generate inside stream_guard of a new
     device.Stream: tokens equal the default stream's bit for bit, both
     timed with device.Events beside phase 3's; the port's memory
     statistics equal torch.cuda's; (e) the samplers (a seeded draw
     repeats; the moments of 2**24 draws within 6 standard errors; randperm
     of 2**20 a permutation; multinomial without replacement distinct) and
     cholesky, qr, svd, solve, lstsq, eigh and slogdet at 512 x 512 in
     float32 and float64 within TOL_LINALG (32 n eps) of their
     reconstructions, card and CPU. Phases 2 and 5 time the fp32 kernels at (a)'s shape
     (``master_grad_fp32``), with torch's sdpa and its memory-efficient
     backward in float32 beside them. At most MASTER_SECONDS.
 18. the op surface and the profiler (at most SURFACE_SECONDS): (a) every op
     of ops/compat.py, the generated in-place family and ops/__init__'s
     helpers on CUDA and on CPU tensors from one seed: integer,
     manipulation and comparison outputs equal bit for bit, floating ones
     within the CPU tests' tolerance, in-place ops keep data_ptr(); the
     samplers' moments on the card (2**20 draws, 6 standard errors) and a
     seeded draw that repeats; a to_dlpack/from_dlpack round trip on the
     card shares memory; (b) the fuse'd _rope_cos_sin at S2048 D128 in
     bf16 and fp32 against its eager function (the angle's rounding bound,
     plus a bf16 ulp), with the kernels of one call of each from a profile;
     (c) phase 6's step (flagship width, 8 layers, B8 S2048, recompute,
     AdamW) after one warm-up step, 4 steps under the port's
     Profiler(targets=[CPU, GPU], scheduler=(1, 3)): its device table over
     the two recorded steps counts fa_fwd_wgmma 4L, fa_bwd_dq_wgmma and
     fa_bwd_dkv_wgmma 2L each, equal to the launch counters over the same
     steps (set to 0 when the window opens, read before it closes); the
     merged chrome trace holds op:: host spans and DeviceOp spans on
     other pids, the device spans inside the host window; it loads back;
     summary() prints "Device Op Summary"; the profiled steps' ms beside the
     unprofiled ones' and the Benchmark timer's ips; (d) us of a dispatched
     add over torch.add with the profiler off (phase 16 (e)'s figure).
Phases 3, 9 and 13 time the decode engine's default, the captured path.
The last line is the device JSON object; the line before it the card's name
and power limit; before that the kernels JSON object.

Matmul and cuDNN TF32 are switched off, so every float32 product here is
full float32 (the CPU twins and the fp32 kernel checks depend on it).
"""
from __future__ import annotations

import gc
import importlib
import json
import math
import os
import re
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_TC_FLOPS = 989e12     # bf16 / fp16 tensor cores
PEAK_FP32_FLOPS = 67e12    # fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12   # tf32 tensor cores: the fp32 kernels' 3xTF32 runs three passes
PEAK_HBM_BYTES = 3.35e12

# kernel vs plain version: |kernel - plain| <= TOL * max(1, |plain|), i.e.
# absolute for outputs up to 1 and relative above (a rounding step of the
# output dtype grows with the value). bf16 keeps 8 mantissa bits: the kernel
# rounds P to bf16 before P @ V and both sides round O to bf16, so the two
# may land one bf16 step apart (7.8e-3 at 1.0, 1.6e-2 at 2.0). fp16 keeps 11
# bits. fp32 differs only in summation order and exp implementation.
TOL = {"bfloat16": 2e-2, "float16": 5e-3, "float32": 1e-4}
TOL_LSE = 1e-3             # LSE is float32 on both sides
TOL_E2E_LOGITS = 2e-3      # fp32 model, card vs CPU: sums in another order

# the dq kernel's delta vs the plain one: both fp32 sums of the same 16-bit
# products (exact in fp32), in another order
TOL_DELTA = 1e-5
# backward kernels vs the plain backward: ||kernel - plain|| / ||plain|| per
# gradient. The kernels round P and dS to the input dtype before the dV, dK
# and dQ products (as FA2 does) and the plain version keeps them in fp32;
# both round the gradient to the input dtype at the end. bf16 rounds at
# 2**-9 relative, so each of those roundings adds ~2e-3 of relative error
# with random signs; 2e-2 leaves room for five of them lining up. fp16 rounds
# at 2**-12 (~2.4e-4). fp32 runs its products as 3xTF32 on the tensor cores:
# each ~2**-21 relative (the dropped lo * lo term and lo's truncation to
# tf32) with the tensor cores' fp32 accumulation: 2e-6-2.3e-5 on an H100
# (PERF.md), where CUDA-core kernels read ~1e-7.
TOL_BWD = {"bfloat16": 2e-2, "float16": 5e-3, "float32": 1e-4}

# training, card (kernels, cuBLAS) vs CPU twin (plain versions), fp32
TRAIN_LR = 1e-4
TOL_TRAIN_LOSS = 1e-4      # relative; float32 sums in another order
TOL_TRAIN_GRAD = 1e-4      # norm-relative per parameter, same reason
# An Adam step moves a parameter by about lr at most (|mhat / sqrt(vhat)|
# <= ~1), so after two steps an honest difference is at most 2 * 2 * lr:
# where a gradient is at the level of rounding, its sign may differ.
TOL_TRAIN_PARAM_ABS = 4 * TRAIN_LR
# ... and such elements are few: the updates p2 - p0 of card and CPU must
# agree to 1e-2 norm-relative per parameter.
TOL_TRAIN_UPDATE = 1e-2

# paged and int8 serving (phase 9), relative to the largest |logit| of the
# reference. The paged prompt pass is the dense one's function on the same
# kernel and GEMMs (read 0.0). The paged decode step attends in fp32
# (paged_kv.paged_attention_decode) and the dense one with bf16 products (as
# in the JAX package), so at bf16 the paged first step is held against the
# dense engine with its decode attention in that fp32 arithmetic. The two
# still part where fp32 sums over 192 gathered and 129 filled slots round a
# bf16 output of layer 0 one step apart, and a random 8-layer model carries
# that to 0.0132 of the largest logit on the H100 (the same in two runs on two
# cards), so this bound catches gross faults only. The tight one
# is fp32 (2 layers, flagship width), where paged and dense first steps read
# 0.0, and paged int8 and int8 too: TOL_PAGED_STEP_FP32 leaves room for fp32
# summation order alone.
TOL_PAGED_PREFILL = 1e-3
TOL_PAGED_STEP = 2e-2
TOL_PAGED_STEP_FP32 = 1e-5
# int8 cache against bf16: the bound of tests/test_inference_decode.py:250
TOL_INT8_PREFILL = 0.05
# float64 beams, paged against dense: tests/test_paged_kv.py:258-279 holds the
# scores to rtol 1e-5, atol 1e-6; here the absolute 1e-5, tighter for every
# score above 0.1 in magnitude
TOL_BEAM_SCORES = 1e-5

# axpy (y = 2x + 1) is timed at 2^26 float32 elements: 512 MiB of traffic,
# ten times the 50 MB L2, so every call streams from HBM
AXPY_TIMED_N = 2 ** 26
CPP_SRC = r"""
#include <cstdint>
#include <cmath>
extern "C" void softsign_fwd(const float* x, float* y, int64_t n) {
  for (int64_t i = 0; i < n; ++i) y[i] = x[i] / (1.0f + std::fabs(x[i]));
}
extern "C" void softsign_bwd(const float* x, const float* gy, float* gx,
                             int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float d = 1.0f + std::fabs(x[i]);
    gx[i] = gy[i] / (d * d);
  }
}
"""

FLAGSHIP = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                num_hidden_layers=8, num_attention_heads=16, num_key_value_heads=16,
                max_position_embeddings=2048)

# phase 13: the LLaMA architecture at two published attention widths.
# microsoft/Phi-3-mini-4k-instruct config.json: hidden 3072, 32 heads x 96,
# intermediate 8192, vocab 32064, 32 layers, rope theta 10000, RMS eps 1e-5
# (its fused qkv and gate-up weights compute the function of separate ones;
# its 2047-token sliding window does not bind at these lengths).
PHI3_MINI = dict(vocab_size=32064, hidden_size=3072, intermediate_size=8192,
                 num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
                 max_position_embeddings=4096, rope_theta=10000.0, rms_norm_eps=1e-5)
# google/gemma-2b config.json: hidden 2048, 8 query heads and 1 KV head x 256,
# intermediate 16384, vocab 256000, 18 layers, tied embeddings, rope theta
# 10000, RMS eps 1e-6. Gemma's GeGLU, embedding scale and (1 + w) norm are not
# in the JAX LlamaConfig: this is the LLaMA architecture at Gemma-2B's
# attention and MLP widths.
GEMMA_2B = dict(vocab_size=256000, hidden_size=2048, intermediate_size=16384,
                num_hidden_layers=18, num_attention_heads=8, num_key_value_heads=1,
                max_position_embeddings=8192, rope_theta=10000.0, rms_norm_eps=1e-6,
                tie_word_embeddings=True)
# (name, width, training knobs): the Gemma-width step takes the fused head,
# the knob for a 256000-token vocabulary ([4, 2048, 256000] logits are 4.2 GB
# in bf16 and twice that in fp32)
WIDTHS13 = (("phi3_mini", PHI3_MINI, {}), ("gemma_2b", GEMMA_2B, dict(fused_head_ce=True)))
# served at full depth; trained cut to 4 layers, so that the fp32 masters and
# moments fit beside the rest of the run (~650M parameters at Phi-3-mini's
# width, ~10.4 GB of weights and optimizer state)
TRAIN13 = dict(layers=4, batch=4, steps=3)
# flash_attn_unpadded against a loop of the plain attention, in fp32: sums
# in another order
TOL_VARLEN = 1e-5
# every-two rotary, card against CPU, fp32. The tables: inv_freq comes from
# pow, which may round an ulp or two apart on the two devices (CUDA's powf
# is within 2 ulps), and the angle pos * inv_freq carries that error times
# the position, so a table entry may differ by four ulps (up to 2**-23
# relative each) of the largest angle, plus the ulps of cos and sin. The
# rotation itself, given the same tables on both devices, differs only by an
# fma against a multiply and an add
ROPE_ANGLE_ULPS = 4 * 2.0 ** -23
TOL_ROPE = 1e-5


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, iters=20, reps=5):
    """Device time of one call: ``iters`` calls captured in one CUDA graph and
    replayed, timed with CUDA events, so host-side launch cost does not show."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def call_ms(torch, fn, iters=20, warmup=3):
    """Time of one eager call back to back (host launch cost included)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(Sq, Sk, causal):
    """(query, key) pairs the attention computes: all, or bottom-right causal."""
    if not causal:
        return Sq * Sk
    off = Sk - Sq
    return sum(min(Sk, i + off + 1) for i in range(Sq))


def bound_ms(flops, nbytes, peak):
    """Least time for the card: max(flops / peak, bytes / HBM rate)."""
    t_ops = flops / peak
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def attention_peak(elt):
    """The rate the attention kernels' products run at: bf16/fp16 on the
    tensor cores; float32 as 3xTF32, three TF32 passes a product."""
    return PEAK_TC_FLOPS if elt == 2 else PEAK_TF32_FLOPS / 3


def attention_bound_ms(B, Sq, Sk, Hq, Hkv, D, causal, elt):
    """Forward: flops = 4 D per visible (query, key) pair; bytes = q, k, v
    read once, o written once, plus the fp32 LSE."""
    flops = 4.0 * D * visible_pairs(Sq, Sk, causal) * B * Hq
    nbytes = (2 * B * Sq * Hq * D + 2 * B * Sk * Hkv * D) * elt + 4 * B * Hq * Sq
    return bound_ms(flops, nbytes, attention_peak(elt))


def backward_bounds_ms(B, Sq, Sk, Hq, Hkv, D, causal, elt):
    """(dq bound, dk/dv bound), each (ms, bound_by). dq: three D-deep products
    (S, dP, dQ), 6 D flops per visible pair (delta's D a row is negligible);
    reads q, dO, O, k, v, LSE, writes dq and delta. dk/dv: four products (S,
    dP, dV, dK), 8 D flops per pair; reads q, dO, k, v, LSE, delta, writes
    dk, dv."""
    pairs = visible_pairs(Sq, Sk, causal) * B * Hq
    qsize, ksize, rows = B * Sq * Hq * D * elt, B * Sk * Hkv * D * elt, 8 * B * Hq * Sq
    peak = attention_peak(elt)
    dq = bound_ms(6.0 * D * pairs, 4 * qsize + 2 * ksize + rows, peak)
    dkv = bound_ms(8.0 * D * pairs, 2 * qsize + 4 * ksize + rows, peak)
    return dq, dkv


def ptxas_summary(log):
    """{kernel: {registers, smem, stack, spill_stores, spill_loads}} from an
    ``nvcc -Xptxas -v`` log (kernel names demangled to their template)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            out.setdefault(name, {}).update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(name, {}).update(registers=int(m.group(1)),
                                            smem=int(smem.group(1)) if smem else 0)
    # _ZN..fa_bwd_dq_wgmmaI13__nv_bfloat16Li128EEEv.. -> fa_bwd_dq_wgmma<__nv_bfloat16, 128>
    # _ZN..axpy_vectorsI6__halfEEv.. -> axpy_vectors<__half>
    named = {}
    for mangled, info in out.items():
        m = re.search(r"(fa_\w+?)I(?:\d+(\w+?))?Li(\d+)EE", mangled)
        a = re.search(r"(axpy_(?:vectors|elements))I(?:\d+(\w+?)|f)EE", mangled)
        if m:
            key = f"{m.group(1)}<{m.group(2) or 'float'}, {m.group(3)}>"
        elif a:
            key = f"{a.group(1)}<{a.group(2) or 'float'}>"
        else:
            key = mangled
        named[key] = info
    return named


def unaligned(torch, shape, dtype, gen):
    """A (B, S, H, D) view 2 bytes past a 16-byte boundary: TMA cannot read it."""
    n = math.prod(shape)
    return torch.randn(n + 1, device="cuda", generator=gen).to(dtype)[1:].view(shape)


def phase_kernel(torch, fa):
    """Kernel against its plain version; times at the timed shapes."""
    import numpy as np

    gen = torch.Generator(device="cuda").manual_seed(1234)
    # phase 10's static engine prefills each admission as one (1, bucket) call
    S_static = static_bucket(serve10_workload(FLAGSHIP["vocab_size"],
                                              np.random.RandomState(0))[0])
    cases = [
        # name, B, Sq, Sk, Hq, Hkv, D, dtype, causal, timed
        ("flagship_prefill", 8, 128, 128, 16, 16, 128, "bfloat16", True, True),
        ("static_prefill", 1, S_static, S_static, 16, 16, 128, "bfloat16", True, True),
        ("long_prompt", 1, 2048, 2048, 16, 16, 128, "bfloat16", True, True),
        ("training_shape", 8, 2048, 2048, 16, 16, 128, "bfloat16", True, True),
        # phase 16 (c)'s fp16 training: the kernel at the training shape in fp16
        ("training_shape_fp16", 8, 2048, 2048, 16, 16, 128, "float16", True, True),
        # phase 17 (a)'s master-grad pullbacks: the fp32 kernel at that shape
        ("master_grad_fp32", 8, 2048, 2048, 16, 16, 128, "float32", True, True),
        ("master_grad_fp32_noncausal", 8, 2048, 2048, 16, 16, 128, "float32", False, True),
        ("gqa_hkv4", 2, 512, 512, 16, 4, 128, "bfloat16", True, False),
        ("mqa_hkv1", 2, 512, 512, 16, 1, 128, "bfloat16", True, False),
        ("non_causal", 2, 512, 512, 16, 16, 128, "bfloat16", False, False),
        ("cross_length_causal", 2, 128, 2048, 16, 16, 128, "bfloat16", True, False),
        ("ragged_1000", 2, 1000, 1000, 16, 16, 128, "bfloat16", True, False),
        ("ragged_d64_noncausal", 2, 333, 1000, 8, 2, 64, "bfloat16", False, False),
        ("fp16_d64", 2, 256, 256, 16, 16, 64, "float16", True, False),
        ("fp32", 2, 256, 256, 16, 16, 128, "float32", True, False),
        ("fp32_ragged_gqa_d64", 1, 300, 700, 8, 2, 64, "float32", True, False),
        ("d32_reference_test", 1, 128, 128, 2, 2, 32, "bfloat16", False, False),
        ("d32_bf16", 2, 512, 512, 16, 16, 32, "bfloat16", True, False),
        ("d32_fp16", 2, 512, 512, 16, 16, 32, "float16", True, False),
        ("d32_fp32", 2, 256, 256, 16, 16, 32, "float32", True, False),
        ("ragged_d32_gqa", 2, 300, 700, 8, 2, 32, "bfloat16", True, False),
        ("unaligned_view", 2, 256, 256, 16, 4, 128, "bfloat16", True, False),
        ("unaligned_view_fp32", 2, 256, 256, 16, 4, 128, "float32", True, False),
        # the fp32 kernel's key-tail mask without the causal one: 1000 and
        # 333 keys end inside a tile, at D 128 and at D 256's 16-key tiles
        ("ragged_fp32_noncausal", 2, 333, 1000, 8, 2, 128, "float32", False, False),
        ("ragged_d256_fp32_noncausal", 1, 200, 333, 4, 2, 256, "float32", False, False),
        # phase 13's widths: Phi-3-mini's attention (32 heads x 96) and
        # Gemma-2B's (8 query heads, 1 KV head, x 256), at the serving
        # prefill (B8 S128) and training (B8 S2048) shapes
        ("phi3_prefill_d96", 8, 128, 128, 32, 32, 96, "bfloat16", True, True),
        ("phi3_training_d96", 8, 2048, 2048, 32, 32, 96, "bfloat16", True, True),
        ("gemma_prefill_d256", 8, 128, 128, 8, 1, 256, "bfloat16", True, True),
        ("gemma_training_d256", 8, 2048, 2048, 8, 1, 256, "bfloat16", True, True),
        ("d96_fp16_gqa", 2, 512, 512, 16, 4, 96, "float16", True, False),
        ("d96_fp32", 2, 256, 256, 8, 8, 96, "float32", True, False),
        ("d96_ragged_noncausal", 2, 333, 1000, 8, 2, 96, "bfloat16", False, False),
        ("d96_cross_length_causal", 2, 128, 2048, 8, 8, 96, "bfloat16", True, False),
        ("d256_fp16_gqa", 2, 512, 512, 8, 2, 256, "float16", True, False),
        ("d256_fp32_ragged_mqa", 1, 300, 700, 4, 1, 256, "float32", True, False),
        ("d256_ragged_noncausal", 2, 1000, 1000, 8, 8, 256, "bfloat16", False, False),
        ("d256_cross_length_causal", 2, 128, 1024, 8, 1, 256, "bfloat16", True, False),
        # a head dim the kernels pad (to 96): q, k and v padded, 1 launch
        ("d80_padded_bf16_gqa", 2, 512, 512, 8, 2, 80, "bfloat16", True, False),
        ("d80_padded_fp16", 2, 300, 300, 8, 8, 80, "float16", True, False),
        ("d80_padded_fp32", 1, 256, 256, 4, 4, 80, "float32", True, False),
        ("unaligned_view_d96", 2, 256, 256, 16, 4, 96, "bfloat16", True, False),
    ]
    checks, rows = [], {}
    for name, B, Sq, Sk, Hq, Hkv, D, dt, causal, timed in cases:
        dtype = getattr(torch, dt)
        if name.startswith("unaligned_view"):
            q = unaligned(torch, (B, Sq, Hq, D), dtype, gen)
            k, v = (unaligned(torch, (B, Sk, Hkv, D), dtype, gen) for _ in range(2))
            if not all(fa._needs_alignment_copy(t) for t in (q, k, v)):
                fail("the unaligned-view case is readable by TMA as it lies")
        else:
            q = torch.randn(B, Sq, Hq, D, device="cuda", generator=gen).to(dtype)
            k = torch.randn(B, Sk, Hkv, D, device="cuda", generator=gen).to(dtype)
            v = torch.randn(B, Sk, Hkv, D, device="cuda", generator=gen).to(dtype)
        before = (fa.launches, fa.copies_for_alignment, fa.pads_for_head_dim)
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal)
        torch.cuda.synchronize()
        launched = fa.launches - before[0]
        copies = fa.copies_for_alignment - before[1]
        pads = fa.pads_for_head_dim - before[2]
        # a view TMA cannot read is copied (q, k and v), then the same kernel
        # runs once; a head dim the kernels are not built for is padded (q, k
        # and v); everything else is read where it lies
        want_copies = 3 if name.startswith("unaligned_view") else 0
        want_pads = 0 if D in fa._HEAD_DIMS else 3
        if launched != 1 or copies != want_copies or pads != want_pads:
            fail(f"{name}: {launched} launches, {copies} alignment copies and {pads} "
                 f"head-dim pads, want 1, {want_copies} and {want_pads}")
        if out.shape != q.shape or out.dtype != q.dtype:
            fail(f"{name}: output {tuple(out.shape)} {out.dtype}")
        ref, ref_lse = fa.flash_attention_fwd_plain(q, k, v, causal)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        scaled = (diff / ref.float().abs().clamp(min=1.0)).max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        row = dict(name=name, shape=[B, Sq, Sk, Hq, Hkv, D], dtype=dt, causal=causal,
                   max_abs_err=err, max_scaled_err=scaled, tol=TOL[dt], lse_err=lse_err,
                   launches=launched, copies_for_alignment=copies, pads_for_head_dim=pads)
        if not (math.isfinite(scaled) and scaled <= TOL[dt]):
            fail(f"kernel disagrees with its plain version at {row}")
        if not (math.isfinite(lse_err) and lse_err <= TOL_LSE):
            fail(f"kernel LSE disagrees with the plain version at {row}")
        if timed:
            # torch's call takes equal head counts: K and V of a GQA case are
            # repeated to Hq heads beforehand, outside the timing
            qt, kt, vt = (x.transpose(1, 2) for x in (
                q, k.repeat_interleave(Hq // Hkv, dim=2), v.repeat_interleave(Hq // Hkv, dim=2)))
            fns = dict(
                kernel=lambda: fa.flash_attention_fwd(q, k, v, causal),
                plain=lambda: fa.flash_attention_fwd_plain(q, k, v, causal),
                library=lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal))
            # the fp32 case's calls take 10-100 ms: fewer of them
            it = 4 if dtype == torch.float32 else 20
            for key, fn in fns.items():
                row[f"{key}_ms"] = device_ms(torch, fn, iters=it)
                row[f"{key}_call_ms"] = call_ms(torch, fn, iters=it)
            row["bound_ms"], row["bound_by"] = attention_bound_ms(
                B, Sq, Sk, Hq, Hkv, D, causal, q.element_size())
            row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        print("kernel_check " + json.dumps(row), flush=True)
        checks.append(row)
        if timed:
            rows[name] = row
        del q, k, v, out, lse, ref, ref_lse, diff
        if timed:
            del qt, kt, vt, fns
        torch.cuda.empty_cache()
    return checks, rows


def serve_timed(torch, fa, engine, prompts, new, sync):
    """One engine's serving numbers: a warm-up generate, then, with the launch
    counts set to 0, one timed generate of ``new`` tokens, one timed prefill
    and ``new - 1`` timed decode steps. Launches are read after each part."""
    engine.generate(prompts, max_new_tokens=2)        # warm-up: allocator, libraries
    sync()
    reset_counts(fa)
    t0 = time.perf_counter()
    toks = engine.generate(prompts, max_new_tokens=new)
    sync()
    gen_s = time.perf_counter() - t0
    after_generate = fa.launches

    t0 = time.perf_counter()
    logits, cache, pos = engine.prefill(prompts)
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = fa.launches

    tok = logits.argmax(-1, keepdim=True)
    first_step = None
    sync()
    t0 = time.perf_counter()
    for _ in range(new - 1):
        logits_d, cache = engine.decode_step(tok, cache, pos)
        if first_step is None:
            first_step = logits_d.clone()
        tok = logits_d.argmax(-1, keepdim=True)
        pos += 1
    sync()
    ms_per_token = (time.perf_counter() - t0) * 1e3 / (new - 1)
    B = prompts.shape[0]
    return dict(
        toks=toks, logits=logits, first_step=first_step, last_step=logits_d, cache=cache,
        tok=tok, pos=pos,
        numbers=dict(prefill_ms=prefill_ms, ms_per_token=ms_per_token,
                     tokens_per_sec=B * new / gen_s, generate_s=gen_s, batch=B,
                     prompt=prompts.shape[1], new_tokens=new,
                     launches_generate=after_generate,
                     launches_prefill=after_prefill - after_generate,
                     launches_decode=fa.launches - after_prefill))


def phase_serving(torch, fa, models, width=FLAGSHIP):
    """The port's main path at the flagship width (or ``width``)."""
    cfg = models.LlamaConfig(**width, dtype="bfloat16")
    L = cfg.num_hidden_layers
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (8, 128), device="cuda", generator=gen)
    new = 32
    engine = models.LlamaDecodeEngine(model, max_len=128 + new + 1)
    run = serve_timed(torch, fa, engine, prompts, new, torch.cuda.synchronize)
    num, toks = run["numbers"], run["toks"]

    steps = 3
    full = model.generate(prompts, max_new_tokens=steps)
    torch.cuda.synchronize()
    launches = fa.launches
    after_decode = num["launches_generate"] + num["launches_prefill"] + num["launches_decode"]

    if (fa.launches_bwd_dq, fa.launches_bwd_dkv) != (0, 0):
        fail("serving launched a backward kernel")
    if fa.copies_for_alignment or fa.pads_for_head_dim:
        fail(f"serving made {fa.copies_for_alignment} alignment copies and "
             f"{fa.pads_for_head_dim} head-dim pads")
    if num["launches_generate"] != L:
        fail(f"engine.generate launched the kernel {num['launches_generate']} times, want {L}")
    if num["launches_prefill"] != L:
        fail(f"prefill launched the kernel {num['launches_prefill']} times, want {L}")
    if num["launches_decode"]:
        fail("decode steps launched the flash kernel; they attend in plain torch")
    if launches - after_decode != L * steps:
        fail(f"model.generate launched {launches - after_decode} times, want {L * steps}")
    if toks.shape != (8, new) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"generated tokens out of range or misshapen: {tuple(toks.shape)}")
    if full.shape != (8, 128 + steps) or full.max() >= cfg.vocab_size:
        fail(f"model.generate output misshapen: {tuple(full.shape)}")
    if not (torch.isfinite(run["logits"]).all() and torch.isfinite(run["last_step"]).all()):
        fail("non-finite logits in the serving phase")
    out = dict(path="captured", prefill_ms=num["prefill_ms"], ms_per_token=num["ms_per_token"],
               tokens_per_sec=num["tokens_per_sec"], generate_s=num["generate_s"], batch=8,
               prompt=128, new_tokens=new, launches=launches,
               launches_per_prefill=num["launches_prefill"], layers=L,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del model, engine, run
    return out


def reset_counts(fa):
    fa.launches = fa.launches_bwd_dq = fa.launches_bwd_dkv = fa.copies_for_alignment = 0
    fa.pads_for_head_dim = 0
    fa.launches_f32 = fa.launches_bwd_dq_f32 = fa.launches_bwd_dkv_f32 = 0


def counts_f32(fa):
    """The float32 kernels' share of ``counts``."""
    return fa.launches_f32, fa.launches_bwd_dq_f32, fa.launches_bwd_dkv_f32


def counts(fa):
    return fa.launches, fa.launches_bwd_dq, fa.launches_bwd_dkv


def norm_rel(a, ref):
    """||a - ref|| / ||ref|| in float32 (0 when both are 0)."""
    a, ref = a.float(), ref.float()
    den = ref.norm().item()
    num = (a - ref).norm().item()
    return num / den if den > 0 else num


def library_backward(torch, q, k, v, do, causal, scale):
    """torch's flash-attention backward on the outputs of its own forward (a
    yardstick: one library call computing dq, dk and dv; the port never
    calls it); in float32, which torch's flash kernels do not take, its
    memory-efficient attention's backward. Returns the callable."""
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    if q.dtype == torch.float32:
        out, lse, seed, offset = torch.ops.aten._scaled_dot_product_efficient_attention(
            qt, kt, vt, None, True, 0.0, causal, scale=scale)
        return lambda: torch.ops.aten._scaled_dot_product_efficient_attention_backward(
            dot, qt, kt, vt, None, out, lse, seed, offset, 0.0, [True, True, True, False],
            causal, scale=scale)
    out, lse, cq, ck, mq, mk, seed, offset, _ = (
        torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, causal, False, scale=scale))
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        dot, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0, causal, seed, offset, scale=scale)


def phase_backward(torch, fa):
    """Backward kernels against the plain backward; times at the timed shapes."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    cases = [
        # name, B, Sq, Sk, Hq, Hkv, D, dtype, causal, timed
        ("training", 8, 2048, 2048, 16, 16, 128, "bfloat16", True, True),
        ("training_fp16", 8, 2048, 2048, 16, 16, 128, "float16", True, True),
        # phase 17 (a)'s master-grad pullbacks: the fp32 kernels at that shape
        ("master_grad_fp32", 8, 2048, 2048, 16, 16, 128, "float32", True, True),
        # the same without the causal mask: no block skips a tile
        ("master_grad_fp32_noncausal", 8, 2048, 2048, 16, 16, 128, "float32", False, True),
        ("long_b1", 1, 2048, 2048, 16, 16, 128, "bfloat16", True, True),
        ("gqa_hkv4", 2, 512, 512, 16, 4, 128, "bfloat16", True, False),
        ("mqa_hkv1", 2, 512, 512, 16, 1, 128, "bfloat16", True, False),
        ("non_causal", 2, 512, 512, 16, 16, 128, "bfloat16", False, False),
        ("cross_length_causal", 2, 128, 2048, 16, 16, 128, "bfloat16", True, False),
        ("ragged_1000", 2, 1000, 1000, 16, 16, 128, "bfloat16", True, False),
        ("ragged_d64_noncausal", 2, 333, 1000, 8, 2, 64, "bfloat16", False, False),
        ("fp16_d64", 2, 256, 256, 16, 16, 64, "float16", True, False),
        ("fp32", 2, 256, 256, 16, 16, 128, "float32", True, False),
        ("fp32_ragged_gqa_d64", 1, 300, 700, 8, 2, 64, "float32", True, False),
        ("d32_reference_test", 1, 128, 128, 2, 2, 32, "bfloat16", False, False),
        ("d32_bf16_gqa", 2, 512, 512, 16, 4, 32, "bfloat16", True, False),
        ("d32_fp16_gqa", 2, 512, 512, 16, 4, 32, "float16", True, False),
        ("d32_fp32_gqa", 2, 256, 256, 16, 4, 32, "float32", True, False),
        ("ragged_d32_gqa", 2, 300, 700, 8, 2, 32, "bfloat16", True, False),
        ("unaligned_q", 2, 256, 256, 16, 4, 128, "bfloat16", True, False),
        ("unaligned_do", 2, 256, 256, 16, 4, 128, "bfloat16", True, False),
        # phase 13's widths at the training shape, the edge cases at D = 96
        # and 256, and a head dim the kernels pad (to 96)
        ("phi3_training_d96", 8, 2048, 2048, 32, 32, 96, "bfloat16", True, True),
        ("gemma_training_d256", 8, 2048, 2048, 8, 1, 256, "bfloat16", True, True),
        ("d96_fp16_gqa", 2, 512, 512, 16, 4, 96, "float16", True, False),
        ("d96_fp32", 2, 256, 256, 8, 8, 96, "float32", True, False),
        ("d96_ragged_noncausal", 2, 333, 1000, 8, 2, 96, "bfloat16", False, False),
        ("d96_cross_length_causal", 2, 128, 2048, 8, 8, 96, "bfloat16", True, False),
        ("d256_fp16_gqa", 2, 512, 512, 8, 2, 256, "float16", True, False),
        ("d256_fp32_ragged_mqa", 1, 300, 700, 4, 1, 256, "float32", True, False),
        ("d256_ragged_noncausal", 2, 1000, 1000, 8, 8, 256, "bfloat16", False, False),
        ("d256_cross_length_causal", 2, 128, 1024, 8, 1, 256, "bfloat16", True, False),
        ("d80_padded_bf16_gqa", 2, 512, 512, 8, 2, 80, "bfloat16", True, False),
        ("d80_padded_fp16", 2, 300, 300, 8, 8, 80, "float16", True, False),
        ("d80_padded_fp32", 1, 256, 256, 4, 4, 80, "float32", True, False),
        ("unaligned_do_d96", 2, 256, 256, 16, 4, 96, "bfloat16", True, False),
        # the fp32 kernels read by TMA too: an unaligned fp32 q is copied once
        ("unaligned_q_fp32", 2, 256, 256, 16, 4, 128, "float32", True, False),
    ]
    checks, rows = [], {}
    for name, B, Sq, Sk, Hq, Hkv, D, dt, causal, timed in cases:
        dtype = getattr(torch, dt)
        scale = 1.0 / math.sqrt(D)
        q = torch.randn(B, Sq, Hq, D, device="cuda", generator=gen).to(dtype)
        k = torch.randn(B, Sk, Hkv, D, device="cuda", generator=gen).to(dtype)
        v = torch.randn(B, Sk, Hkv, D, device="cuda", generator=gen).to(dtype)
        do = torch.randn(B, Sq, Hq, D, device="cuda", generator=gen).to(dtype)
        if name.startswith("unaligned_q"):
            q = unaligned(torch, (B, Sq, Hq, D), dtype, gen)
        if name.startswith("unaligned_do"):
            do = unaligned(torch, (B, Sq, Hq, D), dtype, gen)
        with torch.no_grad():
            out, lse = fa.flash_attention_fwd_lse(q, k, v, causal)
        before = (fa.launches_bwd_dq, fa.launches_bwd_dkv, fa.copies_for_alignment,
                  fa.pads_for_head_dim)
        if D in fa._HEAD_DIMS:
            got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal)
        else:
            # a head dim the kernels are not built for reaches them through
            # autograd: the forward pads q, k and v, the backward gets them
            # and a padded dO, and the gradients come back sliced
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            fa.flash_attention_fwd(*leaves, causal=causal).backward(do)
            got = [t.grad for t in leaves]
        torch.cuda.synchronize()
        launched = (fa.launches_bwd_dq - before[0], fa.launches_bwd_dkv - before[1])
        copies = fa.copies_for_alignment - before[2]
        pads = fa.pads_for_head_dim - before[3]
        # a view TMA cannot read is copied once for both kernels; everything
        # else is read where it lies
        want_copies = 1 if name.startswith("unaligned") else 0
        want_pads = 0 if D in fa._HEAD_DIMS else 3
        if launched != (1, 1) or copies != want_copies or pads != want_pads:
            fail(f"{name}: (dq, dk/dv) launches {launched}, {copies} alignment copies and "
                 f"{pads} head-dim pads, want (1, 1), {want_copies} and {want_pads}")
        ref = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
        row = dict(name=name, shape=[B, Sq, Sk, Hq, Hkv, D], dtype=dt, causal=causal,
                   tol=TOL_BWD[dt], launches=list(launched), copies_for_alignment=copies,
                   pads_for_head_dim=pads)
        for gname, a, r in zip(("dq", "dk", "dv"), got, ref):
            if a.shape != r.shape or a.dtype != r.dtype:
                fail(f"{gname} at {name}: {tuple(a.shape)} {a.dtype}, want "
                     f"{tuple(r.shape)} {r.dtype}")
            row[f"{gname}_err"] = norm_rel(a, r)
            row[f"{gname}_max_abs_err"] = (a.float() - r.float()).abs().max().item()
        del ref
        if not all(math.isfinite(row[f"{g}_err"]) and row[f"{g}_err"] <= TOL_BWD[dt]
                   for g in ("dq", "dk", "dv")):
            fail(f"backward kernels disagree with the plain backward at {row}")
        if timed:
            # the delta the dq kernel writes, against the plain version's
            delta = fa._launch_bwd_dq(q, k, v, do, out, lse, causal, scale)[1]
            row["delta_err"] = norm_rel(delta, fa._delta(out, do))
            row["tol_delta"] = TOL_DELTA
            if not (math.isfinite(row["delta_err"]) and row["delta_err"] <= TOL_DELTA):
                fail(f"the dq kernel's delta disagrees with the plain one at {row}")
            fns = dict(
                dq=lambda: fa._launch_bwd_dq(q, k, v, do, out, lse, causal, scale),
                dkv=lambda: fa._launch_bwd_dkv(q, k, v, do, lse, delta, causal, scale),
                bwd=lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, causal),
                plain=lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal),
                # torch's backward takes equal head counts: K and V of a GQA
                # case repeated to Hq heads beforehand (it then returns dK
                # and dV per q head, without the group sum)
                library=library_backward(torch, q, k.repeat_interleave(Hq // Hkv, dim=2),
                                         v.repeat_interleave(Hq // Hkv, dim=2), do, causal,
                                         scale))
            it = 4 if dtype == torch.float32 else 20
            for key, fn in fns.items():
                row[f"{key}_ms"] = device_ms(torch, fn, iters=it)
                row[f"{key}_call_ms"] = call_ms(torch, fn, iters=it)
            (row["dq_bound_ms"], row["dq_bound_by"]), (row["dkv_bound_ms"],
                                                       row["dkv_bound_by"]) = (
                backward_bounds_ms(B, Sq, Sk, Hq, Hkv, D, causal, q.element_size()))
            for key in ("dq", "dkv"):
                row[f"{key}_share_of_bound"] = row[f"{key}_bound_ms"] / row[f"{key}_ms"]
            rows[name] = row
        print("backward_check " + json.dumps(row), flush=True)
        checks.append(row)
        del q, k, v, do, out, lse, got
        if timed:
            del delta, fns
        torch.cuda.empty_cache()
    return checks, rows


_KERNEL_GROUPS = (  # (substring of the kernel name, group), first match wins
    ("fa_fwd", "attention forward kernel"), ("fa_bwd_dq", "attention dq kernel"),
    ("fa_bwd_dkv", "attention dk/dv kernel"), ("triton_", "Inductor (Triton)"), ("gemm", "GEMM"), ("xmma", "GEMM"),
    ("nvjet", "GEMM"), ("cutlass", "GEMM"), ("foreach", "optimizer (foreach)"),
    ("multi_tensor", "optimizer (foreach)"), ("softmax", "softmax / log_softmax"),
    ("reduce", "reductions"), ("elementwise", "elementwise"), ("memcpy", "memcpy / memset"),
    ("memset", "memcpy / memset"))
# CUPTI records the host waiting on a full launch queue as a device-side
# activity; it is not a kernel
_NOT_KERNELS = ("Command Buffer Full",)


def profile_step(torch, step, step_ms, kernel_groups=_KERNEL_GROUPS):
    """Device time of one step (training, or a decode step) by kernel group,
    from torch.profiler (CUPTI): the device-side events only, so no time
    counts twice. idle_share compares their sum with the step time measured
    without the profiler; kernel_launches counts the device-side events,
    launches_by_group the same by group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    groups, launches, kernels = {}, {}, []
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3
        if e.device_type != DeviceType.CUDA or ms <= 0 or e.key in _NOT_KERNELS:
            continue
        low = e.key.lower()
        group = next((g for sub, g in kernel_groups if sub in low), "other")
        groups[group] = groups.get(group, 0.0) + ms
        launches[group] = launches.get(group, 0) + e.count
        kernels.append((ms, e.count, e.key[:160]))
    device = sum(groups.values())
    kernels.sort(reverse=True)
    # kernel launches torch.profiler kept no record of (a session in a
    # process that has run for a while loses its first few: profiler/
    # profiler.py _PRIMER_LAUNCHES)
    from paddle_tpu_torch.profiler.profiler import _lost_launches

    lost = _lost_launches(prof.events(), (DeviceType.CUDA,), 0.0)
    return dict(device_ms=device, idle_share=1.0 - device / step_ms if device else None,
                lost_launch_records=lost,
                profiled_ms=profiled_ms, kernel_launches=sum(n for _, n, _ in kernels),
                by_group=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
                launches_by_group=launches, top_kernels=[dict(ms=ms, launches=n, name=k) for ms, n, k in kernels[:12]])


def phase_training(torch, fa, models, AdamW, smi, width=FLAGSHIP, knobs=None, batch=8,
                   warm=1, timed=5, math_calls=None):
    """The training main path at the flagship width and depth (or ``width``
    with the config ``knobs``): step 1 counted and checked, ``warm`` more
    steps, ``timed`` timed ones and one profiled, then the loss; with
    ``math_calls`` (count_math_path), step 1 must not take sdpa's math path."""
    cfg = models.LlamaConfig(**width, dtype="bfloat16", recompute=True,
                             recompute_granularity="full", **(knobs or {}))
    L, B, S = cfg.num_hidden_layers, batch, 2048
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    model.train()
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(), multi_precision=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", generator=gen)

    def losses(loss, logits):
        # (loss, its fp32 recomputation from the logits); the fused head
        # gives no logits and an fp32 loss already
        with torch.no_grad():
            if logits is None:
                return loss.item(), loss.item()
            return loss.item(), model.criterion(logits.float(), labels).item()

    # step 1: counted, and every parameter's gradient checked
    torch.cuda.synchronize()
    reset_counts(fa)
    if math_calls is not None:
        math_calls[0] = 0
    loss, logits = model(ids, labels=labels)
    loss.backward()
    torch.cuda.synchronize()
    per_step = counts(fa)
    if per_step != (2 * L, L, L):
        fail(f"one training step launched (fwd, dq, dk/dv) = {per_step}, "
             f"want {(2 * L, L, L)}")
    if math_calls is not None and math_calls[0]:
        fail(f"a training step took sdpa's math path {math_calls[0]} times")
    if fa.copies_for_alignment or fa.pads_for_head_dim:
        fail(f"a training step made {fa.copies_for_alignment} alignment copies and "
             f"{fa.pads_for_head_dim} head-dim pads")
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())
           or not bool((p.grad != 0).any())]
    if bad:
        fail(f"parameters without a finite nonzero gradient: {bad}")
    first = losses(loss, logits)
    del logits
    opt.step()
    opt.clear_grad()

    def step():
        loss, _ = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    for _ in range(warm):
        step()
    times = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = sorted(times)[len(times) // 2]
    profile = profile_step(torch, step, step_ms)
    with torch.no_grad():
        last = losses(*model(ids, labels=labels))
    if not all(math.isfinite(x) for x in first + last):
        fail(f"non-finite training loss: first {first}, last {last}")
    # the fp32 recomputation of the loss decides: the bf16 loss rounds to
    # 2**-4 near ln(32000)
    if not last[1] < first[1]:
        fail(f"the loss did not fall over {2 + warm + timed} steps: {first} -> {last}")
    n_params = sum(p.numel() for p in model.parameters())
    n_embed = model.llama.embed_tokens.weight.numel()
    tokens = B * S
    flops = 6.0 * (n_params - n_embed) * tokens + 6.0 * L * B * S * S * cfg.hidden_size
    return dict(
        step_ms=step_ms, step_ms_all=times, tokens_per_sec=tokens / (step_ms / 1e3),
        mfu=flops / (step_ms / 1e3) / PEAK_TC_FLOPS,
        mfu_formula="(6*(params-embedding)*tokens + 6*L*B*S^2*hidden) / step_s / 989e12",
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        loss_first=first[0], loss_last=last[0], loss_first_fp32=first[1],
        loss_last_fp32=last[1], params=n_params, batch=B, seq=S, layers=L,
        launches_per_step=dict(fwd=per_step[0], bwd_dq=per_step[1], bwd_dkv=per_step[2]),
        steps=2 + warm + timed, knobs=knobs or {}, profile=profile, card=smi)


def phase_train_card_vs_cpu(torch, fa, models, AdamW, width=FLAGSHIP, shape=(2, 256),
                            **knobs):
    """Two AdamW steps of an fp32 model (``width`` at 2 layers) on the card
    (kernels in fp32) and of its CPU twin (plain versions)."""
    import copy

    cfg = models.LlamaConfig(**dict(width, num_hidden_layers=2), dtype="float32",
                             recompute=True, **knobs)
    L = cfg.num_hidden_layers
    gpu = models.LlamaForCausalLM(cfg, device="cuda", seed=5)
    cpu = copy.deepcopy(gpu).to("cpu")
    gpu.train()
    cpu.train()
    p0 = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    og = AdamW(learning_rate=TRAIN_LR, parameters=gpu.parameters())
    oc = AdamW(learning_rate=TRAIN_LR, parameters=cpu.parameters())
    gen = torch.Generator(device="cpu").manual_seed(13)
    ids = torch.randint(0, cfg.vocab_size, shape, generator=gen)
    labels = torch.randint(0, cfg.vocab_size, shape, generator=gen)
    labels[torch.rand(*shape, generator=gen) < 0.1] = -100
    reset_counts(fa)
    losses, grad_err = [], {}
    for i in range(2):
        lg, _ = gpu(ids.cuda(), labels=labels.cuda())
        lg.backward()
        lc, _ = cpu(ids, labels=labels)
        lc.backward()
        losses.append((lg.item(), lc.item()))
        err = abs(losses[-1][0] - losses[-1][1]) / abs(losses[-1][1])
        if not (math.isfinite(err) and err <= TOL_TRAIN_LOSS):
            fail(f"card vs CPU training loss at step {i + 1}: {losses[-1]}")
        if i == 0:
            cgrads = dict(cpu.named_parameters())
            for n, p in gpu.named_parameters():
                grad_err[n] = norm_rel(p.grad.cpu(), cgrads[n].grad)
            worst = max(grad_err, key=grad_err.get)
            if not grad_err[worst] <= TOL_TRAIN_GRAD:
                fail(f"card vs CPU gradient of {worst}: {grad_err[worst]} > {TOL_TRAIN_GRAD}")
        og.step()
        oc.step()
        og.clear_grad()
        oc.clear_grad()
    if counts(fa) != (2 * 2 * L, 2 * L, 2 * L):
        fail(f"card training launched (fwd, dq, dk/dv) = {counts(fa)}, want "
             f"{(2 * 2 * L, 2 * L, 2 * L)}")
    param_abs, update_err = {}, {}
    cparams = dict(cpu.named_parameters())
    for n, p in gpu.named_parameters():
        pg, pc = p.detach().cpu(), cparams[n].detach()
        param_abs[n] = (pg - pc).abs().max().item()
        update_err[n] = norm_rel(pg - p0[n], pc - p0[n])
    worst_abs = max(param_abs, key=param_abs.get)
    worst_upd = max(update_err, key=update_err.get)
    if not param_abs[worst_abs] <= TOL_TRAIN_PARAM_ABS:
        fail(f"card vs CPU parameter {worst_abs} after 2 steps: "
             f"{param_abs[worst_abs]} > {TOL_TRAIN_PARAM_ABS}")
    if not update_err[worst_upd] <= TOL_TRAIN_UPDATE:
        fail(f"card vs CPU update of {worst_upd}: {update_err[worst_upd]} > "
             f"{TOL_TRAIN_UPDATE}")
    out = dict(losses=losses, tol_loss=TOL_TRAIN_LOSS,
               worst_grad_err=[worst, grad_err[worst]], tol_grad=TOL_TRAIN_GRAD,
               worst_param_abs=[worst_abs, param_abs[worst_abs]],
               tol_param_abs=TOL_TRAIN_PARAM_ABS,
               worst_update_err=[worst_upd, update_err[worst_upd]],
               tol_update=TOL_TRAIN_UPDATE, launches=list(counts(fa)), shape=list(shape))
    del gpu, cpu, og, oc
    return out


def phase_card_vs_cpu(torch, fa, models, width=FLAGSHIP):
    """fp32 model (``width`` at 2 layers) on the card (flash kernel in fp32)
    against its CPU twin."""
    import copy

    cfg = models.LlamaConfig(**dict(width, num_hidden_layers=2), dtype="float32")
    gpu = models.LlamaForCausalLM(cfg, device="cuda", seed=3)
    cpu = copy.deepcopy(gpu).to("cpu")
    gen = torch.Generator(device="cpu").manual_seed(11)
    prompts = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen)
    new = 16
    eg = models.LlamaDecodeEngine(gpu, max_len=128 + new)
    ec = models.LlamaDecodeEngine(cpu, max_len=128 + new)
    eg.prefill(prompts)          # captures the prompt pass (its warm-up run launches too)
    before = fa.launches
    lg, _, _ = eg.prefill(prompts)
    if fa.launches - before != cfg.num_hidden_layers:
        fail("the fp32 prefill on the card did not run the flash kernel once per layer")
    lc, _, _ = ec.prefill(prompts)
    err = (lg.cpu() - lc).abs().max().item()
    if not (math.isfinite(err) and err <= TOL_E2E_LOGITS):
        fail(f"card vs CPU prefill logits differ by {err} > {TOL_E2E_LOGITS}")
    tg = eg.generate(prompts, max_new_tokens=new).cpu()
    tc = ec.generate(prompts, max_new_tokens=new)
    if not torch.equal(tg, tc):
        fail(f"card vs CPU greedy tokens differ:\n{tg}\n{tc}")
    del gpu, cpu, eg, ec
    return dict(prefill_logits_max_abs_err=err, tol=TOL_E2E_LOGITS,
                greedy_tokens_identical=True, new_tokens=new)


def same_bits(torch, a, ref):
    """a equals ref bit for bit, but for NaN payloads: NaN exactly where ref
    is NaN."""
    if a.dtype != ref.dtype or a.shape != ref.shape:
        return False
    ints = {4: torch.int32, 2: torch.int16}[a.element_size()]
    an, rn = a.isnan(), ref.isnan()
    return bool(torch.equal(an, rn)) and bool(
        torch.equal(a.view(ints)[~an], ref.view(ints)[~rn]))


def axpy_specials(torch, dtype):
    """+-inf, NaN, +-max finite, +-max/2 (2x lands on max), smallest normal,
    smallest subnormal, signed zeros, -0.5 (2x + 1 = 0) and 1."""
    fi = torch.finfo(dtype)
    vals = [math.inf, -math.inf, math.nan, fi.max, -fi.max, fi.max / 2, -fi.max / 2,
            fi.tiny, -fi.tiny, fi.tiny * fi.eps, -fi.tiny * fi.eps, 0.0, -0.0, -0.5, 1.0]
    return torch.tensor(vals, dtype=torch.float32).to(dtype)


def phase_custom_op(torch, axpy, custom_op, cpp_extension, build_dir):
    """The y = 2x + 1 kernel against its plain version; the op through the
    registry (launch count set to 0 just before, read just after); a
    cpp_extension host op on CUDA tensors."""
    gen = torch.Generator(device="cuda").manual_seed(99)

    def randn(n, dtype):
        return (torch.randn(n, device="cuda", generator=gen) * 100).to(dtype)

    def with_specials(n, dtype):
        x = randn(n, dtype)
        sp = axpy_specials(torch, dtype).cuda()
        x[:sp.numel()] = sp         # in the vector body
        x[-sp.numel():] = sp        # and in the scalar tail
        return x

    # the library call: one PyTorch call computing 1 + 2x, with the 1 a 0-dim
    # CPU tensor (one elementwise launch, fp32 arithmetic for fp16 and bf16,
    # rounded once to x's dtype); timed as the yardstick, never used by the port
    one = torch.tensor(1.0)

    def library(x):
        return torch.add(one, x, alpha=2)

    f32, f16, bf16 = torch.float32, torch.float16, torch.bfloat16
    cases = [
        ("jax_test_fp32_8", torch.arange(8, dtype=f32, device="cuda")),
        ("ragged_fp32_1000003", randn(1_000_003, f32)),
        ("unaligned_view_fp32", randn(1_000_004, f32)[1:]),
        ("empty_fp32", torch.zeros(0, device="cuda")),
        ("bf16_specials_1000003", with_specials(1_000_003, bf16)),
        ("fp16_specials_1000003", with_specials(1_000_003, f16)),
        ("unaligned_view_bf16", with_specials(1_000_011, bf16)[3:]),
        ("fp16_7", randn(7, f16)),
        ("fp32_2^26", randn(AXPY_TIMED_N, f32)),
    ]
    checks, timed = [], None
    for name, x in cases:
        before = axpy.launches
        y = axpy.axpy(x)
        torch.cuda.synchronize()
        launched = axpy.launches - before
        ref = axpy.axpy_plain(x)
        lib = library(x)
        both = torch.isfinite(ref) & torch.isfinite(y)
        err = (y.float() - ref.float())[both].abs().max().item() if both.any() else 0.0
        row = dict(name=name, numel=x.numel(), dtype=str(x.dtype).split(".")[1],
                   aligned16=x.data_ptr() % 16 == 0, launches=launched,
                   bit_exact=same_bits(torch, y, ref), max_abs_err=err,
                   library_bit_exact=same_bits(torch, lib, ref),
                   nan=int(ref.isnan().sum().item()))
        print("axpy_check " + json.dumps(row), flush=True)
        if launched != (1 if x.numel() else 0):
            fail(f"axpy launched {launched} kernels for {name}")
        if not row["bit_exact"] or y.device != x.device:
            fail(f"axpy kernel disagrees with its plain version at {row}")
        if not row["library_bit_exact"]:
            fail(f"the library call does not compute the plain version at {row}")
        if name.startswith("unaligned") and row["aligned16"]:
            fail(f"{name} was meant to be an unaligned view")
        if x.numel() == AXPY_TIMED_N:
            timed = row
            nbytes = 2 * x.numel() * x.element_size()
            # clone: a copy of the same bytes, the bandwidth a stream reaches
            # here. Each is timed in two turns and keeps its lower reading:
            # one reading of the kernel alone spread 0.181-0.192 ms over runs
            # where tools/axpy_ab.py read 0.179 on the same cards.
            fns = (("kernel", lambda: axpy.axpy(x)), ("plain", lambda: axpy.axpy_plain(x)),
                   ("library", lambda: library(x)), ("clone", lambda: x.clone()))
            turns = {key: [] for key, _ in fns}
            for _ in range(2):
                for key, fn in fns:
                    turns[key].append(device_ms(torch, fn))
            for key, fn in fns:
                row[f"{key}_ms"] = min(turns[key])
                row[f"{key}_ms_turns"] = turns[key]
                row[f"{key}_call_ms"] = call_ms(torch, fn)
            # one fma (2 operations) an element, on the fp32 units
            row["bound_ms"], row["bound_by"] = bound_ms(2.0 * x.numel(), nbytes,
                                                        PEAK_FP32_FLOPS)
            row["kernel_gbps"] = nbytes / (row["kernel_ms"] * 1e-3) / 1e9
            print("axpy_timed " + json.dumps(row), flush=True)
        checks.append(row)
        del x, y, ref, lib

    # the main path: the kernel as a registered custom op, as the JAX test
    # registers its Pallas kernel (differentiable=False)
    op = axpy.register_example()
    inputs = [torch.arange(8, dtype=f32, device="cuda").requires_grad_(),
              randn(1_000_003, f32).requires_grad_(), randn(4096, bf16).requires_grad_()]
    torch.cuda.synchronize()
    axpy.launches = 0
    outs = [op(x) for x in inputs]
    torch.cuda.synchronize()
    launches = axpy.launches
    if launches != len(inputs):
        fail(f"{len(inputs)} calls of the registered op launched the kernel {launches} times")
    for x, y in zip(inputs, outs):
        if y.grad_fn is not None or y.requires_grad or y.device != x.device:
            fail(f"registered axpy gave {y.device} requires_grad={y.requires_grad}")
        if not same_bits(torch, y, axpy.axpy_plain(x.detach())):
            fail("registered axpy disagrees with its plain version")
    if not torch.equal(outs[0], torch.arange(8, dtype=f32, device="cuda") * 2 + 1):
        fail(f"registered axpy of arange(8) gave {outs[0].tolist()}")
    # registered as differentiable, the call gives the value and the gradient
    # raises, where returning a detached output would cut it silently
    guarded = custom_op.register_custom_op("chip_smoke_axpy_differentiable", axpy.axpy)
    yg = guarded(inputs[0])
    if not torch.equal(yg.detach(), outs[0]):
        fail(f"the differentiable registration gave {yg.tolist()}")
    try:
        yg.sum().backward()
        fail("a differentiable op over the ctypes kernel cut its gradient silently")
    except custom_op.CustomOpError:
        pass

    # cpp_extension: a host op on CUDA tensors (copied to the host and back)
    src_dir = build_dir / "chip_smoke_cpp_extension"
    src_dir.mkdir(parents=True, exist_ok=True)
    (src_dir / "softsign.cc").write_text(CPP_SRC)
    ext = cpp_extension.load("chip_smoke_softsign", [str(src_dir / "softsign.cc")],
                             build_directory=str(src_dir))
    soft = ext.def_op("chip_smoke_softsign", "softsign_fwd", backward_symbol="softsign_bwd")
    xc = torch.tensor([-2.0, 0.0, 3.0, 0.25], device="cuda", requires_grad=True)
    yc = soft(xc)
    yc.sum().backward()
    want_y = torch.tensor([-2 / 3, 0.0, 0.75, 0.2], device="cuda")
    want_g = torch.tensor([1 / 9, 1.0, 1 / 16, 0.64], device="cuda")
    yb = soft(xc.detach().to(bf16))
    if not (yc.is_cuda and xc.grad.is_cuda and yb.is_cuda and yb.dtype == f32):
        fail(f"cpp_extension op left the card: {yc.device} {xc.grad.device} {yb.device}")
    if not (torch.allclose(yc, want_y, rtol=1e-6) and torch.allclose(xc.grad, want_g, rtol=1e-6)):
        fail(f"cpp_extension op on the card: {yc.tolist()} grad {xc.grad.tolist()}")
    return dict(checks=checks, timed=timed, launches=launches, calls=len(inputs),
                cpp_extension=dict(values=yc.tolist(), grad=xc.grad.tolist(),
                                   device=str(yc.device)))


def cache_bytes(cache):
    """(bytes allocated, bytes of the blocks in use) of an engine's cache: a
    dense cache holds max_len slots for every row; a paged one its pools, of
    which the blocks with a reference are in use."""
    pools = cache.pools if hasattr(cache, "pager") else cache
    allocated = sum(a.numel() * a.element_size() for entry in pools for a in entry)
    if not hasattr(cache, "pager"):
        return allocated, allocated
    pager = cache.pager
    return allocated, allocated * int((pager._refs > 0).sum()) // pager.num_blocks


def rel_err(a, ref):
    """max |a - ref| over max |ref|, in float32."""
    a, ref = a.float(), ref.float()
    return ((a - ref).abs().max() / ref.abs().max()).item()


def phase_paged_serving(torch, fa, models):
    """Paged and int8 serving at the flagship width and depth (phase 3's
    model and prompts: batch 8, prompt 128, 32 new tokens), then the fp32
    card-vs-CPU twins, beam search (B8 K4, 16 tokens) and the float64 beam
    twin."""
    import copy

    batch, prompt, new = 8, 128, 32
    cfg = models.LlamaConfig(**FLAGSHIP, dtype="bfloat16")
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    prompts = torch.randint(0, V, (batch, prompt), device="cuda", generator=gen)
    max_len = prompt + new + 1
    forms = dict(dense={}, paged=dict(kv_cache_layout="paged", block_size=64),
                 int8=dict(kv_cache_dtype="int8"),
                 paged_int8=dict(kv_cache_dtype="int8", kv_cache_layout="paged",
                                 block_size=64))
    runs, out = {}, {}
    for name, kw in forms.items():
        engine = models.LlamaDecodeEngine(model, max_len=max_len, **kw)
        run = serve_timed(torch, fa, engine, prompts, new, torch.cuda.synchronize)
        num = run["numbers"]
        num["cache_bytes"], num["cache_bytes_in_use"] = cache_bytes(run["cache"])
        # one more decode step under the profiler: its kernels, their device
        # time, and the share of ms_per_token the card is idle
        prof = profile_step(torch, lambda: engine.decode_step(
            run["tok"], run["cache"], run["pos"]), num["ms_per_token"])
        num["decode_step_profile"] = {k: prof[k] for k in (
            "device_ms", "idle_share", "kernel_launches", "by_group")}
        # the bf16 prompt pass launches the forward kernel once a layer; the
        # int8 one attends the quantized prompt in plain torch; decode steps
        # never launch it
        want = 0 if "int8" in name else L
        if (num["launches_generate"], num["launches_prefill"], num["launches_decode"]) != (
                want, want, 0):
            fail(f"{name} serving launched the forward kernel (generate, prefill, decode) = "
                 f"{(num['launches_generate'], num['launches_prefill'], num['launches_decode'])}"
                 f", want ({want}, {want}, 0)")
        if (fa.launches_bwd_dq, fa.launches_bwd_dkv, fa.copies_for_alignment) != (0, 0, 0):
            fail(f"{name} serving launched a backward kernel or made an alignment copy")
        toks = run["toks"]
        if toks.shape != (batch, new) or toks.min() < 0 or toks.max() >= V:
            fail(f"{name}: generated tokens out of range or misshapen: {tuple(toks.shape)}")
        for key in ("logits", "first_step", "last_step"):
            if not bool(torch.isfinite(run[key]).all()):
                fail(f"{name}: non-finite {key}")
        runs[name] = run
        out[name] = dict(num, path="captured")
        del run["cache"], engine
    dense_bytes = out["dense"]["cache_bytes"]
    for name in forms:
        out[name]["cache_bytes_over_dense_bf16"] = out[name]["cache_bytes"] / dense_bytes
        out[name]["cache_bytes_in_use_over_dense_bf16"] = (
            out[name]["cache_bytes_in_use"] / dense_bytes)
    D = cfg.hidden_size // cfg.num_attention_heads
    if abs(out["int8"]["cache_bytes_over_dense_bf16"] - (D + 4) / (2 * D)) > 1e-9:
        fail(f"int8 cache is {out['int8']['cache_bytes_over_dense_bf16']} of bf16, want "
             f"(D + 4) / 2D = {(D + 4) / (2 * D)}")

    class DenseFp32Attention(models.LlamaDecodeEngine):
        """The dense engine with its decode attention in the paged decode
        step's arithmetic (``paged_kv.paged_attention_decode``: fp32 products,
        scores times 1/sqrt(D), fp32 softmax) over the filled prefix: the
        reference of the paged first step (MHA, as the flagship)."""

        def _attend(self, q, ck, cv, pos_mask):
            logits = torch.einsum("bshd,bthd->bhst", q.float(), ck.float()) * (
                1.0 / math.sqrt(self.head_dim))
            probs = torch.softmax(torch.where(pos_mask[:, None], logits, -1e30), dim=-1)
            return torch.einsum("bhst,bthd->bshd", probs, cv.float()).to(q.dtype)

    ref = DenseFp32Attention(model, max_len=max_len)
    _, ref_cache, ref_pos = ref.prefill(prompts)
    ref_step, _ = ref.decode_step(runs["paged"]["logits"].argmax(-1, keepdim=True),
                                  ref_cache, ref_pos)
    del ref, ref_cache
    errs = dict(
        paged_prefill=rel_err(runs["paged"]["logits"], runs["dense"]["logits"]),
        paged_first_step=rel_err(runs["paged"]["first_step"], ref_step),
        # reported, not bounded: against the dense engine's own bf16 decode step
        paged_first_step_vs_dense_bf16=rel_err(runs["paged"]["first_step"],
                                               runs["dense"]["first_step"]),
        int8_prefill=rel_err(runs["int8"]["logits"], runs["dense"]["logits"]),
        paged_int8_prefill_vs_int8=rel_err(runs["paged_int8"]["logits"],
                                           runs["int8"]["logits"]))
    out["errors"] = dict(errs, tol_paged_prefill=TOL_PAGED_PREFILL,
                         tol_paged_step=TOL_PAGED_STEP, tol_int8_prefill=TOL_INT8_PREFILL)
    print("paged_serving_errors " + json.dumps(out["errors"]), flush=True)
    if not errs["paged_prefill"] <= TOL_PAGED_PREFILL:
        fail(f"paged prefill logits vs dense: {errs['paged_prefill']} > {TOL_PAGED_PREFILL}")
    if not errs["paged_first_step"] <= TOL_PAGED_STEP:
        fail(f"paged first-step logits vs dense with fp32 decode attention: "
             f"{errs['paged_first_step']} > {TOL_PAGED_STEP}")
    if not errs["int8_prefill"] <= TOL_INT8_PREFILL:
        fail(f"int8 prefill logits vs bf16: {errs['int8_prefill']} > {TOL_INT8_PREFILL}")
    if not errs["paged_int8_prefill_vs_int8"] <= TOL_PAGED_PREFILL:
        fail(f"paged int8 prefill logits vs dense int8: {errs['paged_int8_prefill_vs_int8']}")
    del runs

    # fp32, 2 layers at the flagship width: greedy tokens of every form on the
    # card and on a CPU twin with the same weights; on the card, the first
    # decode step's logits of paged against dense, where both attend in fp32
    cfg32 = models.LlamaConfig(**dict(FLAGSHIP, num_hidden_layers=2), dtype="float32")
    card = models.LlamaForCausalLM(cfg32, device="cuda", seed=3)
    host = copy.deepcopy(card).to("cpu")
    gen_cpu = torch.Generator(device="cpu").manual_seed(11)
    p32 = torch.randint(0, V, (2, prompt), generator=gen_cpu)
    toks, steps = {}, {}
    for name, kw in forms.items():
        engine = models.LlamaDecodeEngine(card, max_len=prompt + 16, **kw)
        tg = engine.generate(p32, max_new_tokens=16).cpu()
        logits, cache, pos = engine.prefill(p32)
        steps[name] = engine.decode_step(logits.argmax(-1, keepdim=True), cache, pos)[0]
        tc = models.LlamaDecodeEngine(host, max_len=prompt + 16, **kw).generate(
            p32, max_new_tokens=16)
        if not torch.equal(tg, tc):
            fail(f"fp32 {name}: card vs CPU greedy tokens differ:\n{tg}\n{tc}")
        toks[name] = tg
        del engine, cache
    step_errs = dict(paged_vs_dense=rel_err(steps["paged"], steps["dense"]),
                     paged_int8_vs_int8=rel_err(steps["paged_int8"], steps["int8"]))
    print("fp32_first_step_errors " + json.dumps(step_errs), flush=True)
    for key, err in step_errs.items():
        if not err <= TOL_PAGED_STEP_FP32:
            fail(f"fp32 first-step logits, {key}: {err} > {TOL_PAGED_STEP_FP32}")
    if not torch.equal(toks["paged"], toks["dense"]):
        fail(f"fp32 paged vs dense greedy tokens differ:\n{toks['paged']}\n{toks['dense']}")
    if not torch.equal(toks["paged_int8"], toks["int8"]):
        fail(f"fp32 paged int8 vs int8 greedy tokens differ")
    out["fp32_card_vs_cpu"] = dict(tokens_identical=True, forms=list(forms), new_tokens=16,
                                   first_step_errors=step_errs, tol=TOL_PAGED_STEP_FP32)
    del card, host

    # beam search at bf16, full width: dense and paged
    B, K, T = 8, 4, 16
    out["beam"] = {}
    for name in ("dense", "paged"):
        engine = models.LlamaDecodeEngine(model, max_len=prompt + T + 1, **forms[name])
        engine.beam_search(prompts[:B], beam_size=K, max_new_tokens=2)   # warm-up
        torch.cuda.synchronize()
        reset_counts(fa)
        t0 = time.perf_counter()
        tokens, scores = engine.beam_search(prompts[:B], beam_size=K, max_new_tokens=T)
        torch.cuda.synchronize()
        beam_s = time.perf_counter() - t0
        if fa.launches != L:
            fail(f"{name} beam search launched the forward kernel {fa.launches} times, want {L}")
        if tokens.shape != (B, K, T) or tokens.min() < 0 or tokens.max() >= V:
            fail(f"{name} beam tokens out of range or misshapen: {tuple(tokens.shape)}")
        if not bool(torch.isfinite(scores).all()):
            fail(f"{name} beam scores not finite: {scores}")
        row = dict(path="captured", seconds=beam_s, ms_per_step=beam_s * 1e3 / T, batch=B, beams=K,
                   new_tokens=T, launches=fa.launches)
        if name == "paged":
            pager = engine._pager
            live = int((pager._refs > 0).sum())
            if live + len(pager._free) != pager.num_blocks - 1:
                fail(f"paged beam pool books: {live} live + {len(pager._free)} free != "
                     f"{pager.num_blocks - 1}")
            row.update(live_blocks=live, free_blocks=len(pager._free))
        out["beam"][name] = row
        del engine
    del model

    # float64, 2 layers, a 16-token prompt (the attention's math path): paged
    # and dense beams are one function
    cfg64 = models.LlamaConfig(**dict(FLAGSHIP, num_hidden_layers=2), dtype="float64")
    m64 = models.LlamaForCausalLM(cfg64, device="cuda", seed=4)
    p64 = prompts[:2, :16]
    res = {}
    for name in ("dense", "paged"):
        kw = dict(forms[name], block_size=8) if name == "paged" else {}
        res[name] = models.LlamaDecodeEngine(m64, max_len=32, **kw).beam_search(
            p64, beam_size=4, max_new_tokens=8, eos_token_id=5, length_penalty=0.5)
    if not torch.equal(res["paged"][0], res["dense"][0]):
        fail(f"float64 paged vs dense beam tokens differ:\n{res['paged'][0]}\n"
             f"{res['dense'][0]}")
    score_err = (res["paged"][1] - res["dense"][1]).abs().max().item()
    if not score_err <= TOL_BEAM_SCORES:
        fail(f"float64 paged vs dense beam scores differ by {score_err}")
    out["beam_float64"] = dict(tokens_identical=True, max_score_err=score_err,
                               tol=TOL_BEAM_SCORES)
    return out


def drive_serving(eng, prompts, new_tokens, arrivals):
    """Open-loop serving loop (a copy of bench_common.py:101 ``_drive_serving``):
    submit request i once the wall clock passes arrivals[i], step the engine
    whenever it has work, and collect per-request TTFT and outputs. Returns
    (wall_s, total_tokens, ttfts_ms, outputs in submission order)."""
    n = len(prompts)
    outputs = [None] * n
    ttfts = [0.0] * n
    rid2idx = {}
    submitted = finished = total = 0
    t0 = time.perf_counter()
    while finished < n:
        now = time.perf_counter() - t0
        while submitted < n and arrivals[submitted] <= now:
            rid = eng.submit(prompts[submitted], max_new_tokens=int(new_tokens[submitted]))
            rid2idx[rid] = submitted
            submitted += 1
        if eng.num_active or eng.num_pending:
            for rid, toks in eng.step():
                i = rid2idx[rid]
                st = eng.pop_stats(rid) or {}
                ttfts[i] = st.get("ttft_ns", 0) / 1e6
                outputs[i] = list(toks)
                total += len(toks)
                finished += 1
        elif submitted < n:
            time.sleep(min(0.001, max(arrivals[submitted] - now, 0.0)))
    return time.perf_counter() - t0, total, ttfts, outputs


def poisson_prefix_workload(vocab, *, n_requests, n_groups, prefix_blocks, block_size,
                            tail_range, new_range=None, max_new=None,
                            mean_interarrival_s=0.002, rng=None, seed=0):
    """The Poisson open-loop mixed-length workload with per-group shared
    prompt prefixes (a copy of bench_common.py:132): ``(prompts, new_tokens,
    arrivals)``, drawn per request in the order group, tail, new."""
    import numpy as np

    if rng is None:
        rng = np.random.RandomState(seed)
    prefix_len = prefix_blocks * block_size
    prefixes = [rng.randint(0, vocab, (prefix_len,)).astype("int32") for _ in range(n_groups)]
    prompts, new_tokens = [], []
    for _ in range(n_requests):
        g = int(rng.randint(n_groups))
        tail = rng.randint(0, vocab, (int(rng.randint(tail_range[0], tail_range[1] + 1)),)
                           ).astype("int32")
        prompts.append(np.concatenate([prefixes[g], tail]))
        if new_range is not None:
            new_tokens.append(int(rng.randint(new_range[0], new_range[1] + 1)))
        else:
            new_tokens.append(max_new)
    arrivals = np.cumsum(rng.exponential(mean_interarrival_s, n_requests)) \
        if mean_interarrival_s > 0 else np.zeros(n_requests)
    return prompts, new_tokens, arrivals


def serve10_workload(vocab, rng):
    """Phase 10's serving workload (``SERVE10``) drawn from ``rng``."""
    P = SERVE10
    return poisson_prefix_workload(
        vocab, n_requests=P["n_requests"], n_groups=P["n_groups"],
        prefix_blocks=P["prefix_blocks"], block_size=P["block_size"],
        tail_range=P["tail_range"], new_range=P["new_range"],
        mean_interarrival_s=P["mean_interarrival_s"], rng=rng)


def static_bucket(prompts):
    """The static engine's one prefill bucket: the longest prompt rounded up
    to 32 tokens."""
    return -(-max(len(p) for p in prompts) // 32) * 32


def clone_pools(pools):
    return [tuple(leaf.clone() for leaf in entry) for entry in pools]


def copy_pools(dst, src):
    for de, se in zip(dst, src):
        for d, s in zip(de, se):
            d.copy_(s)


def same_pool_bytes(torch, a, b):
    """Every byte of two pool lists equal."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    return all(x.shape == y.shape and x.dtype == y.dtype
               and torch.equal(x.view(ints[x.element_size()]), y.view(ints[y.element_size()]))
               for ea, eb in zip(a, b) for x, y in zip(ea, eb))


def percentile(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs), q))


class StepClock:
    """Wall time of an engine's steps and of its two programs' calls inside
    them (each call ends in its result's device-to-host copy): host ms a step
    is the step time outside the program calls."""

    def __init__(self, torch, eng):
        self.steps, self.step_s = 0, 0.0
        self.calls = {"step": [0, 0.0], "burst": [0, 0.0]}
        step = eng.step

        def timed_step(*a, **k):
            t0 = time.perf_counter()
            out = step(*a, **k)
            self.step_s += time.perf_counter() - t0
            self.steps += 1
            return out

        eng.step = timed_step
        for key in self.calls:
            prog = eng._step_jit() if key == "step" else eng._burst_jit()

            def timed(*a, _prog=prog, _acc=self.calls[key]):
                t0 = time.perf_counter()
                out = _prog(*a)
                torch.cuda.synchronize()
                _acc[0] += 1
                _acc[1] += time.perf_counter() - t0
                return out

            eng._jit_cache[key] = timed

    def reset(self):
        self.steps, self.step_s = 0, 0.0
        for acc in self.calls.values():
            acc[:] = [0, 0.0]

    def summary(self):
        prog_s = sum(s for _, s in self.calls.values())
        return dict(steps=self.steps, step_ms=self.step_s * 1e3 / max(self.steps, 1),
                    host_ms_per_step=(self.step_s - prog_s) * 1e3 / max(self.steps, 1),
                    **{f"{k}_calls": n for k, (n, _) in self.calls.items()},
                    **{f"{k}_call_ms": s * 1e3 / max(n, 1) for k, (n, s) in self.calls.items()})


# phase 10: bench.py:663-666 (serving) and :667-670 (speculative decoding),
# the JAX package's on-TPU parameters
SERVE10 = dict(max_batch=16, block_size=64, chunk_size=128, max_step_tokens=None, decode_burst=8,
               n_requests=24, n_groups=3, prefix_blocks=4, tail_range=(32, 128),
               new_range=(32, 128), mean_interarrival_s=0.002, repeats=2)
SPEC10 = dict(max_batch=4, block_size=64, chunk_size=64, max_step_tokens=128, decode_burst=8,
              spec_lookahead=16, n_requests=12, n_groups=3, pattern_len=64, head_len=16,
              max_new=256, repeats=2)
# kernel groups of a serving step, with paged attention's parts apart
_SERVING_GROUPS = (("vectorized_gather", "paged gather"), ("gemv", "attention products (gemv)"),
                   ("direct_copy", "copies and casts"), ("index", "index writes")) + _KERNEL_GROUPS


def graphs_vs_eager(torch, models, model):
    """(a) The captured mixed step and burst against their eager functions on
    copies of the same pools: a pack of decode lanes, two draft chains (one
    accepted twice then cut, one rejected at once) and a prefill chunk; a
    burst over 13 decoding rows and 3 inactive ones. Then (f): one profiled
    replay of each."""
    import numpy as np

    P = SERVE10
    eng = models.ContinuousBatchingEngine(
        model, max_batch=P["max_batch"], max_len=576, block_size=P["block_size"],
        chunk_size=P["chunk_size"], decode_burst=P["decode_burst"])
    inner, pager, T, B, V = (eng._inner, eng._pager, eng.max_step_tokens, eng.max_batch,
                             model.config.vocab_size)
    gen = torch.Generator(device="cuda").manual_seed(21)
    with torch.inference_mode():
        for entry in eng._pools:
            for leaf in entry:
                leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda") * 0.5)
    base = clone_pools(eng._pools)
    rng = np.random.RandomState(21)
    lens = np.array([30 * b + 20 for b in range(B)])
    lens[14:] = 0
    need = lens + 6
    need[14], need[15] = 64, 0
    pager.ensure_capacity(need)
    tok, pos, slot, chain, valid = (np.zeros(T, np.int32), np.zeros(T, np.int32),
                                    np.zeros(T, np.int32), np.zeros(T, bool), np.zeros(T, bool))
    lane, heads = 0, {}
    for b, n in [(b, 1) for b in range(12)] + [(12, 5), (13, 3)]:
        heads[b] = lane
        tok[lane] = rng.randint(V)
        slot[lane:lane + n] = b
        pos[lane:lane + n] = lens[b] + np.arange(n)
        chain[lane + 1:lane + n] = True
        lane += n
    slot[lane:lane + 64], pos[lane:lane + 64] = 14, np.arange(64)
    tok[lane:lane + 64] = rng.randint(0, V, 64)
    valid[:lane + 64] = True
    fn = inner.build_mixed_step()
    dev = lambda a: torch.from_numpy(a).cuda()   # noqa: E731
    scratch = clone_pools(base)

    def greedy():
        with torch.inference_mode():
            out = fn(dev(np.stack([tok, pos])), scratch, pager.block_tables, dev(slot),
                     dev(valid), dev(np.zeros(T, bool)))
        return out[0].cpu().numpy()

    # slot 12: two drafts the model agrees with, a third it does not, a fourth
    # continuing the third; slot 13: a first draft it does not agree with
    h12, h13 = heads[12], heads[13]
    tok[h12 + 1] = greedy()[h12]
    tok[h12 + 2] = greedy()[h12 + 1]
    tok[h12 + 3] = (greedy()[h12 + 2] + 1) % V
    tok[h12 + 4] = greedy()[h12 + 3]
    tok[h13 + 1] = (greedy()[h13] + 1) % V
    tok[h13 + 2] = greedy()[h13 + 1]
    del scratch
    pack = np.stack([tok, pos])
    inputs = (torch.from_numpy(pack), pager.block_tables, dev(slot), dev(valid), dev(chain))
    eager = clone_pools(base)
    with torch.inference_mode():
        out_e = fn(dev(pack), eager, *inputs[1:])
        out_g = eng._step_jit()(*inputs).clone()
    mixed_equal = bool(torch.equal(out_g, out_e)) and same_pool_bytes(torch, eng._pools, eager)
    accept = out_g[1].cpu().numpy()
    accepts = dict(slot12=accept[h12 + 1:h12 + 5].tolist(), slot13=accept[h13 + 1:h13 + 3].tolist())
    if not mixed_equal:
        fail("the captured mixed step differs from its eager function")
    if accepts != dict(slot12=[1, 1, 0, 0], slot13=[0, 0]) or accept[~chain].any():
        fail(f"mixed step accept flags {accepts}, want slot12 [1, 1, 0, 0], slot13 [0, 0]")
    del eager

    # the burst: rows 0-12 decode at lens, rows 13-15 inactive (no blocks,
    # token 0 at position 0: they write one value into the null block)
    for b in (13, 14, 15):
        pager.free_sequence(b)
    bl = lens.copy()
    bl[13:] = 0
    pager.ensure_capacity(np.where(bl > 0, bl + P["decode_burst"], 0))
    bpack = np.stack([np.where(bl > 0, rng.randint(0, V, B), 0), bl]).astype(np.int32)
    copy_pools(eng._pools, base)
    eager = clone_pools(base)
    with torch.inference_mode():
        bout_e = inner.build_decode_burst(P["decode_burst"], rows=eng._burst_rows)(
            dev(bpack), eager, pager.block_tables)
        bout_g = eng._burst_jit()(torch.from_numpy(bpack), pager.block_tables).clone()
    burst_equal = bool(torch.equal(bout_g, bout_e)) and same_pool_bytes(torch, eng._pools, eager)
    if not burst_equal:
        fail("the captured burst differs from its eager function")
    # the burst's first tokens against the mixed step's on the same rows, put
    # at lanes 20-32 (across a lane group's edge): a decode token must not
    # depend on the program that computes it
    rows = np.flatnonzero(bl > 0)
    at = 20 + np.arange(len(rows))
    mpack, mslot, mvalid = np.zeros((2, T), np.int32), np.zeros(T, np.int32), np.zeros(T, bool)
    mpack[:, at], mslot[at], mvalid[at] = bpack[:, rows], rows, True
    copy_pools(eager, base)
    with torch.inference_mode():
        mout = fn(dev(mpack), eager, pager.block_tables, dev(mslot), dev(mvalid),
                  dev(np.zeros(T, bool)))
    burst_lanes_equal = bool(torch.equal(mout[0, at].cpu(), bout_e[rows, 0].cpu()))
    if not burst_lanes_equal:
        fail("the burst's first tokens differ from the mixed step's on the same rows")
    del eager, base

    # (f) one profiled replay of each program; device ms of a replay by CUDA
    # events beside the profiler's sum
    with torch.inference_mode():
        step_prog, burst_prog = eng._jit_cache["step"], eng._jit_cache["burst"]
        replays = dict(
            mixed_step=lambda: step_prog(*inputs).cpu(),
            burst=lambda: burst_prog(torch.from_numpy(bpack), pager.block_tables).cpu())
        profiles = {}
        for name, call in replays.items():
            ms = call_ms(torch, call, iters=5, warmup=1)
            prof = profile_step(torch, call, ms, kernel_groups=_SERVING_GROUPS)
            profiles[name] = dict(call_ms=ms, **{k: prof[k] for k in (
                "device_ms", "profiled_ms", "kernel_launches", "by_group", "top_kernels")})
    captured = [eng._jit_cache[k].captured for k in ("step", "burst")]
    del eng, inputs, step_prog, burst_prog, replays
    torch.cuda.empty_cache()
    return dict(mixed_step_equal=mixed_equal, burst_equal=burst_equal,
                burst_lanes_equal=burst_lanes_equal, accepts=accepts,
                captured=captured, T=T, burst_rows=T, max_len=576, profiles=profiles)


def serving_passes(torch, fa, models, model, L):
    """(b) bench_common.py:205 ``serving_bench`` at bench.py:663-666's on-TPU
    parameters: the static engine, then the continuous engine cold, then warm
    (best of ``repeats``), the kernel launches counted through each. Returns
    the numbers and the continuous engine's pool bytes."""
    import numpy as np

    P, vocab = SERVE10, model.config.vocab_size
    bs, new_range, repeats, n = P["block_size"], P["new_range"], P["repeats"], P["n_requests"]
    rng = np.random.RandomState(0)
    prompts, new_tokens, arrivals = serve10_workload(vocab, rng)
    max_len = max(len(p) for p in prompts) + max(new_range) + bs
    buckets = (static_bucket(prompts),)
    warm_prompt = rng.randint(0, vocab, (bs + 1,)).astype("int32")
    engine_kw = dict(max_batch=P["max_batch"], max_len=max_len, block_size=bs,
                     chunk_size=P["chunk_size"], max_step_tokens=P["max_step_tokens"],
                     decode_burst=P["decode_burst"])
    cont = models.ContinuousBatchingEngine(model, **engine_kw)
    # untimed: both programs captured, and the copy-on-write path (a
    # block-aligned prompt served twice)
    cont.add_request(warm_prompt, max_new_tokens=2 * P["decode_burst"] + 2)
    while cont.num_active:
        cont.step()
    aligned = rng.randint(0, vocab, (2 * bs,)).astype("int32")
    for _ in range(2):
        cont.add_request(aligned, max_new_tokens=2)
        while cont.num_active:
            cont.step()
    cont.prefix_cache.clear()
    cont._stats.clear()

    st = models.StaticBatchEngine(model, max_batch=P["max_batch"], max_len=max_len,
                                  block_size=bs, prefill_buckets=buckets)
    for b in buckets:
        rid = st.submit(rng.randint(0, vocab, (min(b, max_len - 1),)).astype("int32"),
                        max_new_tokens=2)
        while st.num_active or st.num_pending:
            st.step()
        st.pop_stats(rid)
    torch.cuda.synchronize()
    reset_counts(fa)
    static_runs = [drive_serving(st, prompts, new_tokens, arrivals) for _ in range(repeats)]
    static_launches = fa.launches
    if static_launches != L * n * repeats:
        fail(f"static serving launched the forward kernel {static_launches} times over "
             f"{n * repeats} admissions, want {L} an admission")
    del st
    torch.cuda.empty_cache()

    pc = cont.prefix_cache
    clock = StepClock(torch, cont)
    reset_counts(fa)
    h0, m0 = pc.hits, pc.misses
    cold = drive_serving(cont, prompts, new_tokens, arrivals)
    cold_hits, cold_misses = pc.hits - h0, pc.misses - m0
    cold_clock = clock.summary()
    clock.reset()
    warm, match = None, True
    for _ in range(repeats):
        h0, m0 = pc.hits, pc.misses
        run = drive_serving(cont, prompts, new_tokens, arrivals)
        match = match and run[3] == cold[3]
        if warm is None or run[0] < warm[0]:
            warm, warm_hits, warm_misses = run, pc.hits - h0, pc.misses - m0
    warm_clock = clock.summary()
    cont_launches = fa.launches
    if (cont_launches, fa.launches_bwd_dq, fa.launches_bwd_dkv) != (0, 0, 0):
        fail(f"the continuous engine launched the attention kernels "
             f"{(cont_launches, fa.launches_bwd_dq, fa.launches_bwd_dkv)} times, want 0")
    if not match:
        diff = [i for i, (a, b) in enumerate(zip(cold[3], run[3])) if a != b]
        fail(f"warm tokens differ from cold tokens in requests {diff}")
    static = min(static_runs, key=lambda r: r[0])
    tps = lambda r: r[1] / r[0]   # noqa: E731
    out = dict(
        requests=n, repeats=repeats, max_len=max_len, prefill_buckets=list(buckets),
        max_step_tokens=cont.max_step_tokens, burst_rows=cont._burst_rows,
        total_tokens=cold[1], static_tokens_per_sec=tps(static),
        static_ttft_ms=dict(p50=percentile(static[2], 50), p99=percentile(static[2], 99)),
        cold_tokens_per_sec=tps(cold),
        cold_ttft_ms=dict(p50=percentile(cold[2], 50), p99=percentile(cold[2], 99)),
        cold_speedup_vs_static=tps(cold) / tps(static),
        serving_tokens_per_sec=tps(warm),
        ttft_ms=dict(p50=percentile(warm[2], 50), p99=percentile(warm[2], 99)),
        speedup_vs_static=tps(warm) / tps(static),
        cold_prefix_hit_rate=cold_hits / max(cold_hits + cold_misses, 1),
        prefix_hit_rate=warm_hits / max(warm_hits + warm_misses, 1),
        warm_tokens_match=match,
        forward_launches_static=static_launches,
        forward_launches_per_static_admission=static_launches / (n * repeats),
        forward_launches_continuous=cont_launches,
        cold_steps=cold_clock, warm_steps=warm_clock, kv_pool_bytes=cont.kv_pool_bytes)
    del cont, clock
    torch.cuda.empty_cache()
    return out, (prompts, new_tokens, arrivals, engine_kw)


def spec_passes(torch, models, model, kv_cache_dtype=None, repeats=SPEC10["repeats"]):
    """(c) bench_common.py:534 ``spec_bench`` at bench.py:667-670's on-TPU
    parameters: spec off and on at equal engine settings, an untimed pass
    each, then ``repeats`` timed passes of the same requests; every pass's
    tokens must be the same with speculation on and off."""
    import numpy as np

    P, vocab = SPEC10, model.config.vocab_size
    bs, n, g, la = P["block_size"], P["n_requests"], P["n_groups"], P["spec_lookahead"]
    rng = np.random.RandomState(0)
    pats = [rng.randint(0, vocab, (P["pattern_len"],)).astype("int32") for _ in range(g)]
    prompts = [np.concatenate([pats[i % g], rng.randint(0, vocab, (P["head_len"],)
                                                        ).astype("int32")]) for i in range(n)]
    new_tokens = [P["max_new"]] * n
    arrivals = np.zeros(n)
    plen = P["pattern_len"] + P["head_len"]
    max_len = plen + P["max_new"] + la + 2 * bs
    pool_blocks = n * -(-(plen + P["max_new"]) // bs) + P["max_batch"] * -(-max_len // bs) + 8
    passes = {}
    for key, lookahead in (("off", 0), ("on", la)):
        eng = models.ContinuousBatchingEngine(
            model, max_batch=P["max_batch"], max_len=max_len, block_size=bs,
            chunk_size=P["chunk_size"], max_step_tokens=P["max_step_tokens"],
            decode_burst=P["decode_burst"], pool_blocks=pool_blocks, spec_lookahead=lookahead,
            kv_cache_dtype=kv_cache_dtype)
        runs = [drive_serving(eng, prompts, new_tokens, arrivals)]   # untimed
        # the timed passes' drafts (all passes' when none is timed)
        d0, a0 = (eng.spec_drafted, eng.spec_accepted) if repeats else (0, 0)
        runs += [drive_serving(eng, prompts, new_tokens, arrivals) for _ in range(repeats)]
        passes[key] = (runs, eng.spec_drafted - d0, eng.spec_accepted - a0, eng.kv_pool_bytes)
        del eng
        torch.cuda.empty_cache()
    (off, _, _, _), (on, drafted, accepted, _) = passes["off"], passes["on"]
    match = all(a[3] == b[3] for a, b in zip(off, on))
    if not match:
        fail(f"{kv_cache_dtype or 'bf16'}: speculation on changed the tokens")
    best = {k: min(v[0][1:] or v[0][:1], key=lambda r: r[0]) for k, v in passes.items()}
    return dict(requests=n, max_new=P["max_new"], max_len=max_len, pool_blocks=pool_blocks,
                spec_lookahead=la, repeats=repeats,
                spec_off_tokens_per_sec=best["off"][1] / best["off"][0],
                spec_on_tokens_per_sec=best["on"][1] / best["on"][0],
                spec_speedup=(best["on"][1] / best["on"][0]) / (best["off"][1] / best["off"][0]),
                spec_drafted_tokens=drafted, spec_accepted_tokens=accepted,
                spec_accept_rate=accepted / max(drafted, 1),
                untimed_pass_s=dict(off=off[0][0], on=on[0][0]), spec_tokens_match=match)


def int8_serving(torch, models, model, workload, bf16_pool_bytes):
    """(d) The (b) workload once through the int8 engine: tokens/s and pool
    bytes over the bf16 engine's; then int8 speculation on against off over
    one pass of the (c) workload."""
    prompts, new_tokens, arrivals, engine_kw = workload
    eng = models.ContinuousBatchingEngine(model, kv_cache_dtype="int8", **engine_kw)
    drive_serving(eng, prompts[:2], [2 * SERVE10["decode_burst"] + 2] * 2, [0.0, 0.0])
    eng.prefix_cache.clear()
    wall, total, ttft, _ = drive_serving(eng, prompts, new_tokens, arrivals)
    ratio = eng.kv_pool_bytes / bf16_pool_bytes
    D = model.config.hidden_size // model.config.num_attention_heads
    del eng
    torch.cuda.empty_cache()
    # D int8 values and one fp32 scale per token and head, against 2 D bytes
    if abs(ratio - (D + 4) / (2 * D)) > 1e-9:
        fail(f"int8 pool bytes are {ratio} of bf16, want (D + 4) / 2D = {(D + 4) / (2 * D)}")
    spec = spec_passes(torch, models, model, kv_cache_dtype="int8", repeats=0)
    return dict(tokens_per_sec=total / wall, ttft_ms=dict(p50=percentile(ttft, 50),
                                                        p99=percentile(ttft, 99)),
                pool_bytes_over_bf16=ratio, spec_tokens_match=spec["spec_tokens_match"],
                spec_pass_s=spec["untimed_pass_s"], spec_drafted=spec["spec_drafted_tokens"],
                spec_accepted=spec["spec_accepted_tokens"])


def serving_card_vs_cpu(torch, models):
    """(e) fp32, 2 layers at the flagship width: one add_request/step schedule
    (staggered admissions, a prompt longer than a chunk, a prefix hit, a
    block-aligned full hit, drafts) on the card and on a CPU twin; every
    finished token stream must be the same."""
    import copy

    import numpy as np

    cfg = models.LlamaConfig(**dict(FLAGSHIP, num_hidden_layers=2), dtype="float32")
    card = models.LlamaForCausalLM(cfg, device="cuda", seed=3)
    host = copy.deepcopy(card).to("cpu")
    V = cfg.vocab_size
    rng = np.random.RandomState(5)
    pre = rng.randint(0, V, (64,)).astype("int32")
    p0 = np.concatenate([pre, rng.randint(0, V, (20,)).astype("int32")])
    p1 = np.concatenate([pre, rng.randint(0, V, (70,)).astype("int32")])
    p2 = np.tile(rng.randint(0, V, (8,)).astype("int32"), 12)
    schedule = {0: [p0], 1: [p1], 3: [p2], 6: [p0], 9: [pre]}
    kw = dict(max_batch=5, max_len=256, block_size=64, chunk_size=64, decode_burst=4,
              spec_lookahead=4, pool_blocks=40)
    streams = {}
    for name, model in (("card", card), ("cpu", host)):
        eng = models.ContinuousBatchingEngine(model, **kw)
        done = {}
        for s in range(400):
            for p in schedule.get(s, ()):
                if eng.add_request(p, max_new_tokens=24) is None:
                    fail("the card-vs-CPU schedule found no free slot")
            done.update(eng.step())
            if s > max(schedule) and not eng.num_active:
                break
        streams[name] = (done, eng.prefix_cache.hits, eng.spec_drafted, eng.spec_accepted)
        del eng
    if streams["card"][0] != streams["cpu"][0] or len(streams["card"][0]) != 5:
        fail(f"fp32 serving, card vs CPU token streams differ:\n{streams['card'][0]}\n"
             f"{streams['cpu'][0]}")
    del card, host
    torch.cuda.empty_cache()
    return dict(streams_identical=True, requests=len(streams["card"][0]),
                prefix_hits=streams["card"][1], drafted=streams["card"][2],
                accepted=streams["card"][3])


def phase_continuous(torch, fa, models, smi):
    """Phase 10: continuous-batching serving at the flagship width."""
    cfg = models.LlamaConfig(**FLAGSHIP, dtype="bfloat16")
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    out = {}
    t0 = time.perf_counter()
    out["graphs"] = graphs_vs_eager(torch, models, model)
    print("continuous_graphs " + json.dumps(dict(out["graphs"], card=smi)), flush=True)
    out["serving"], workload = serving_passes(torch, fa, models, model,
                                              cfg.num_hidden_layers)
    print("continuous_serving " + json.dumps(dict(out["serving"], card=smi)), flush=True)
    out["spec"] = spec_passes(torch, models, model)
    print("continuous_spec " + json.dumps(dict(out["spec"], card=smi)), flush=True)
    out["int8"] = int8_serving(torch, models, model, workload, out["serving"]["kv_pool_bytes"])
    print("continuous_int8 " + json.dumps(dict(out["int8"], card=smi)), flush=True)
    del model
    torch.cuda.empty_cache()
    out["fp32_card_vs_cpu"] = serving_card_vs_cpu(torch, models)
    print("continuous_card_vs_cpu " + json.dumps(out["fp32_card_vs_cpu"]), flush=True)
    # (f): a step's device ms (one profiled replay) against its wall time: the
    # unprofiled program call (the replay with its copies, on the host clock)
    # plus the host ms a step of the warm pass
    warm = out["serving"]["warm_steps"]
    out["steps"] = {}
    for name in ("mixed_step", "burst"):
        prof = out["graphs"]["profiles"][name]
        step_ms = prof["call_ms"] + warm["host_ms_per_step"]
        out["steps"][name] = dict(device_ms=prof["device_ms"], call_ms=prof["call_ms"],
                                  kernel_launches=prof["kernel_launches"],
                                  host_ms_per_step=warm["host_ms_per_step"],
                                  step_ms=step_ms,
                                  idle_share=1.0 - prof["device_ms"] / step_ms)
    print("continuous_steps " + json.dumps(dict(out["steps"], card=smi)), flush=True)
    out["seconds"] = time.perf_counter() - t0
    return out


# phase 11: bench_suite.py:470-476 (the fleet drill) and :339-343 (the engine
# chaos drill), the JAX package's on-TPU parameters; max_len sized to each
# workload (the JAX engines default to max_position_embeddings)
FLEET11 = dict(replicas=3, max_batch=8, block_size=64, chunk_size=128, decode_burst=8,
               n_requests=24, n_groups=3, prefix_blocks=4, tail_range=(32, 96), max_new=64,
               kill_nth=12, mean_interarrival_s=0.002, max_len=448)
CHAOS11 = dict(max_batch=8, block_size=64, chunk_size=128, decode_burst=8, max_queue=12,
               n_requests=12, n_bronze=48, prompt_len=96, max_new=64, kill_nth=9, max_len=192,
               repeats=3)
# a pool of 15 usable blocks for 8 requests of 200-400 tokens that grow by 64
# (the ample pool holds 4 x 8); the JAX engine preempts only a request that is
# not decoding, so these sizes are ones whose schedule never finds every slot
# decoding on a dry pool (the schedule depends on the lengths alone)
SPILL11 = dict(max_batch=4, block_size=64, chunk_size=128, decode_burst=8, max_len=512,
               n_requests=8, prompt_range=(200, 400), max_new=64, pool_blocks=16)
# three waves of 4 prompts (4 full blocks and a 32-token tail each) through
# one engine: wave 2's grants evict wave 1's cached prefixes, which spill to
# host RAM, and wave 3 (wave 1's prompts again) restores them from there. The
# pool (29 usable blocks) holds one wave (4 x 6 blocks) and what the cache
# keeps of the last; the reference's pool (63 usable) holds all three waves
RSPILL11 = dict(max_batch=4, block_size=64, chunk_size=128, decode_burst=8, max_len=512,
                per_wave=4, prompt_len=288, max_new=64, pool_blocks=30,
                reference_pool_blocks=64)
HANG11 = dict(replicas=2, n_requests=8, hang_timeout=1.0, delay_s=3.0, nth=5)


def drive_fleet(fl, prompts, new_tokens, arrivals, deadline_s=90.0, on_submitted=None):
    """Open-loop fleet driver (a copy of bench_common.py:340 ``_drive_fleet``):
    submit request i once the wall clock passes arrivals[i], collect results
    and merged stats. Returns (wall_s, outputs, ttfts_ms, n_complete)."""
    n = len(prompts)
    outputs, ttfts, frid2idx = [None] * n, [0.0] * n, {}
    submitted = done = 0
    t0 = time.perf_counter()
    while done < n and time.perf_counter() - t0 < deadline_s:
        now = time.perf_counter() - t0
        while submitted < n and arrivals[submitted] <= now:
            frid = fl.submit(prompts[submitted], max_new_tokens=int(new_tokens[submitted]))
            frid2idx[frid] = submitted
            submitted += 1
            if on_submitted is not None:
                on_submitted(submitted - 1)
        for frid, toks in fl.pop_results():
            i = frid2idx.get(frid)
            if i is None:
                continue
            st = fl.pop_stats(frid) or {}
            ttfts[i] = st.get("ttft_ns", 0) / 1e6
            outputs[i] = [int(t) for t in toks]
            done += 1
        time.sleep(0.0005)
    return time.perf_counter() - t0, outputs, ttfts, done


def drive_until_done(eng, rid2work, deadline_s=90.0, tenant=""):
    """Driver-mode collector (a copy of bench_common.py:669
    ``_drive_until_done``): poll the engine's results and aborts until every
    tracked request resolves, resubmitting each aborted one. Returns
    ({original rid: tokens}, number of aborts)."""
    remap = {rid: rid for rid in rid2work}
    results, aborted = {}, 0
    t0 = time.perf_counter()
    while any(cur not in results for cur in remap.values()) \
            and time.perf_counter() - t0 < deadline_s:
        for rid, toks in eng.pop_results():
            results[rid] = [int(t) for t in toks]
        for err in eng.pop_aborted():
            orig = next((o for o, cur in remap.items() if cur == err.rid), None)
            if orig is None:
                continue
            aborted += 1
            prompt, max_new = rid2work[orig]
            remap[orig] = eng.submit(prompt, max_new_tokens=max_new, timeout=deadline_s,
                                     tenant=tenant)
        time.sleep(0.001)
    return {orig: results.get(cur) for orig, cur in remap.items()}, aborted


def first_difference(torch, model, prompts, want, got):
    """The first request and token where two passes differ, and the top-2 gap
    of the reference's logits there (a dense forward of the prompt and the
    reference tokens before it): a near-tie says rounding flipped it."""
    import numpy as np

    for i, (a, b) in enumerate(zip(want, got)):
        if a == b:
            continue
        a, b = a or [], b or []
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        ids = np.concatenate([prompts[i], np.asarray(a[:j], np.int32)]).astype(np.int64)
        with torch.inference_mode():
            logits = model(torch.from_numpy(ids[None]).cuda())[0, -1].float()
        top = torch.topk(logits, 2).values
        return dict(request=i, token=j, want=a[j] if j < len(a) else None,
                    got=b[j] if j < len(b) else None, top2_gap=float(top[0] - top[1]))
    return None


def fleet11_workload(vocab, rng):
    P = FLEET11
    return poisson_prefix_workload(
        vocab, n_requests=P["n_requests"], n_groups=P["n_groups"],
        prefix_blocks=P["prefix_blocks"], block_size=P["block_size"],
        tail_range=P["tail_range"], max_new=P["max_new"],
        mean_interarrival_s=P["mean_interarrival_s"], rng=rng)


def fleet_drills(torch, fleet, fi, serving_mod, model, dev="cuda"):
    """(a) bench_common.py:374 ``fleet_bench`` on the port: a reference fleet,
    a fleet whose replica loop dies at ``fleet.replica_step`` (nth
    ``kill_nth``), then a drain of replica 1 mid-stream on the reference fleet.
    Warmup runs one request through every replica at once (long enough to
    burst), so each engine captures both programs then, side by side; the
    failover must capture nothing after it."""
    import numpy as np

    P, vocab = FLEET11, model.config.vocab_size
    rng = np.random.RandomState(0)
    prompts, new_tokens, arrivals = fleet11_workload(vocab, rng)
    warm_prompt = rng.randint(0, vocab, (6,)).astype("int32")
    n = P["n_requests"]

    def fleet_():
        return fleet.FleetRouter(
            model, replicas=P["replicas"], max_new_tokens=P["max_new"],
            engine_kwargs=dict(max_batch=P["max_batch"], max_len=P["max_len"],
                               block_size=P["block_size"], chunk_size=P["chunk_size"],
                               decode_burst=P["decode_burst"]))

    def warm(fl):
        c0 = serving_mod._Program.captures
        t0 = time.perf_counter()
        ok = fl.warmup(warm_prompt, max_new_tokens=2 * P["decode_burst"] + 2, timeout=300)
        captured = serving_mod._Program.captures - c0
        if not ok or captured != 2 * P["replicas"]:
            fail(f"fleet warmup: done {ok}, {captured} graphs captured, want "
                 f"{2 * P['replicas']} (two per replica)")
        return time.perf_counter() - t0

    def tps(wall, outs):
        return sum(len(t) for t in outs if t) / wall

    fi.reset()
    f_ref = f_kill = None
    try:
        f_ref = fleet_()
        warm_s = warm(f_ref)
        ref_wall, ref_out, ref_ttft, ref_done = drive_fleet(f_ref, prompts, new_tokens, arrivals)
        if ref_done != n:
            fail(f"fleet reference pass completed {ref_done} of {n} requests")
        ref_steps = [r["steps"] for r in f_ref.replica_snapshot()]

        f_kill = fleet_()
        warm(f_kill)
        c0 = serving_mod._Program.captures
        fi.arm("fleet.replica_step", action="raise", nth=P["kill_nth"])
        kill_wall, kill_out, _ttft, kill_done = drive_fleet(f_kill, prompts, new_tokens,
                                                            arrivals)
        captured_after = serving_mod._Program.captures - c0
        trips = fi.trips()
        fi.reset()
        recs = [(r, rec) for r in f_kill.replicas for rec in r.engine.recovery_stats]
        kill = dict(killed=trips == [("fleet.replica_step", "raise")],
                    all_complete=kill_done == n, tokens_match_reference=kill_out == ref_out,
                    failovers=f_kill.failovers, recoveries=len(recs),
                    recovery_ms=recs[0][1]["ms"] if recs else None,
                    down_replica=recs[0][0].tag if recs else None,
                    graphs_captured_after_warmup=captured_after,
                    reference_wall_s=ref_wall, reference_tokens_per_sec=tps(ref_wall, ref_out),
                    reference_ttft_ms=dict(p50=percentile(ref_ttft, 50),
                                           p99=percentile(ref_ttft, 99)),
                    reference_replica_steps=ref_steps, warmup_s=warm_s,
                    kill_wall_s=kill_wall, kill_tokens_per_sec=tps(kill_wall, kill_out),
                    kill_replica_steps=[r["steps"] for r in f_kill.replica_snapshot()],
                    states=f_kill.states())
        if not (kill["killed"] and kill["all_complete"] and kill["recoveries"] == 1
                and kill["failovers"] >= 1):
            fail(f"fleet kill drill: {kill}")
        if not kill["tokens_match_reference"]:
            fail("fleet kill drill: tokens differ from the reference fleet's: "
                 f"{first_difference(torch, model, prompts, ref_out, kill_out)}")
        if captured_after:
            fail(f"fleet kill drill captured {captured_after} graphs after warmup, want 0")
        f_kill.stop()
        del f_kill
        f_kill = None

        drained = {}

        def on_submitted(i):
            if i == n // 2 and not drained:
                drained.update(f_ref.drain(1, timeout=90.0))

        c0 = serving_mod._Program.captures
        drain_wall, drain_out, _d, drain_done = drive_fleet(f_ref, prompts, new_tokens,
                                                            arrivals, on_submitted=on_submitted)
        if not drained:
            drained.update(f_ref.drain(1, timeout=90.0))
        drain = dict(migrated=drained.get("migrated"), parked=bool(drained.get("parked")),
                     all_complete=drain_done == n, lost=n - drain_done,
                     tokens_match_reference=drain_out == ref_out,
                     drained_replica=drained.get("replica"), states=f_ref.states(),
                     graphs_captured=serving_mod._Program.captures - c0,
                     wall_s=drain_wall, tokens_per_sec=tps(drain_wall, drain_out),
                     replica_steps=[r["steps"] for r in f_ref.replica_snapshot()])
        if drain["lost"] or not drain["parked"] or drain["graphs_captured"]:
            fail(f"fleet drain drill: {drain}")
        if not drain["tokens_match_reference"]:
            fail("fleet drain drill: tokens differ from the reference pass: "
                 f"{first_difference(torch, model, prompts, ref_out, drain_out)}")
    finally:
        fi.reset()
        for f in (f_ref, f_kill):
            if f is not None:
                f.stop()
    del f_ref
    return kill, drain, (prompts, new_tokens, ref_out)


def hang_drill(fleet, fi, model, workload):
    """(c) A ``serving.step`` delay past ``hang_timeout`` on one replica of a
    fleet with per-replica watchdogs: the scanner recovers the stuck engine,
    its requests move to the other replica, and the outputs equal the
    reference fleet's."""
    P, H = FLEET11, HANG11
    prompts, new_tokens, ref_out = workload
    prompts, ref_out = prompts[:H["n_requests"]], ref_out[:H["n_requests"]]
    fl = fleet.FleetRouter(
        model, replicas=H["replicas"], max_new_tokens=P["max_new"],
        hang_timeout=H["hang_timeout"],
        engine_kwargs=dict(max_batch=P["max_batch"], max_len=P["max_len"],
                           block_size=P["block_size"], chunk_size=P["chunk_size"],
                           decode_burst=P["decode_burst"]))
    fi.reset()
    try:
        if not fl.warmup(prompts[0][:6], max_new_tokens=2 * P["decode_burst"] + 2, timeout=300):
            fail("hang drill: warmup did not finish")
        fi.arm("serving.step", action="delay", delay_s=H["delay_s"], nth=H["nth"])
        wall, out, _t, done = drive_fleet(fl, prompts, new_tokens[:len(prompts)],
                                          [0.0] * len(prompts))
        trips = fi.trips()
        recs = [rec for r in fl.replicas for rec in r.engine.recovery_stats]
        res = dict(delayed=trips == [("serving.step", "delay")], all_complete=done == len(out),
                   tokens_match_reference=out == ref_out, recoveries=len(recs),
                   recovered_hang=any("hang" in r["reason"] for r in recs),
                   recovery_ms=recs[0]["ms"] if recs else None, failovers=fl.failovers,
                   wall_s=wall, hang_timeout_s=H["hang_timeout"], delay_s=H["delay_s"],
                   states=fl.states())
    finally:
        fi.reset()
        fl.stop()
    if not (res["delayed"] and res["all_complete"] and res["tokens_match_reference"]
            and res["recovered_hang"]):
        fail(f"hang drill: {res}")
    return res


def chaos_drill(models, fi, serving_mod, model):
    """(b) bench_common.py:1019 ``chaos_bench`` on the port: a reference pass
    through the driving thread, a pass whose driving thread dies at
    ``serving.drive`` (nth ``kill_nth``) with the aborted requests resubmitted,
    then the gold/bronze overload on a strict-priority engine."""
    import threading

    import numpy as np

    P, vocab = CHAOS11, model.config.vocab_size
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, vocab, (P["prompt_len"],)).astype("int32")
               for _ in range(P["n_requests"])]
    work = {i: (p, P["max_new"]) for i, p in enumerate(prompts)}

    def engine(**kw):
        return models.ContinuousBatchingEngine(
            model, max_batch=P["max_batch"], max_len=P["max_len"], block_size=P["block_size"],
            chunk_size=P["chunk_size"], decode_burst=P["decode_burst"],
            max_queue=P["max_queue"], **kw)

    def submit_all(eng, tenant=""):
        return {i: eng.submit(p, max_new_tokens=mn, timeout=90.0, tenant=tenant)
                for i, (p, mn) in work.items()}

    fi.reset()
    e1 = engine()
    e1.start_driver()
    rids = submit_all(e1)
    t0 = time.perf_counter()
    ref, _ = drive_until_done(e1, {rids[i]: work[i] for i in work})
    ref_wall = time.perf_counter() - t0
    e1.stop_driver()
    ref = {i: ref[rids[i]] for i in work}
    del e1

    e2 = engine()
    pc = e2.prefix_cache
    c0 = serving_mod._Program.captures
    fi.arm("serving.drive", action="raise", nth=P["kill_nth"])
    e2.start_driver()
    try:
        rids = submit_all(e2)
        hits0 = pc.hits
        t0 = time.perf_counter()
        out, aborted = drive_until_done(e2, {rids[i]: work[i] for i in work})
        chaos_wall = time.perf_counter() - t0
    finally:
        e2.stop_driver()
        trips = fi.trips()
        fi.reset()
    out = {i: out[rids[i]] for i in work}
    rec = e2.recovery_stats[0] if e2.recovery_stats else {}
    kill = dict(killed=trips == [("serving.drive", "raise")], recoveries=len(e2.recovery_stats),
                recovery_ms=rec.get("ms"), aborted=aborted, recovered_warm=pc.hits > hits0,
                cold=rec.get("cold"), tokens_match_reference=out == ref,
                graphs_captured=serving_mod._Program.captures - c0,
                programs=len(e2._jit_cache), reference_wall_s=ref_wall, chaos_wall_s=chaos_wall,
                tokens=sum(len(t) for t in out.values() if t))
    del e2
    if not (kill["killed"] and kill["recoveries"] == 1 and kill["aborted"] >= 1
            and kill["recovered_warm"] and kill["tokens_match_reference"]
            and kill["graphs_captured"] == kill["programs"] == 2):
        fail(f"engine chaos kill drill: {kill}")

    # the gold/bronze overload: strict priority keeps the bronze flood out of
    # gold batches; bronze sheds with typed RequestShed
    e3 = engine(strict_priority=True)
    e3.set_tenant("gold", weight=2.0, priority=1)
    e3.set_tenant("bronze", weight=1.0, priority=0)
    e3.start_driver()
    shed, submitted = [0], [0]
    try:
        warm_rids = submit_all(e3, "gold")
        drive_until_done(e3, {warm_rids[i]: work[i] for i in work}, tenant="gold")

        def gold_pass():
            rids = submit_all(e3, "gold")
            t0 = time.perf_counter()
            got, _ = drive_until_done(e3, {rids[i]: work[i] for i in work}, tenant="gold")
            return {i: got[rids[i]] for i in work}, time.perf_counter() - t0

        iso = min((gold_pass() for _ in range(P["repeats"])), key=lambda r: r[1])
        bronze = [rng.randint(0, vocab, (P["prompt_len"],)).astype("int32")
                  for _ in range(P["n_bronze"])]
        over = None
        for _ in range(P["repeats"]):
            stop = threading.Event()

            def flood():
                for p in bronze:
                    if stop.is_set():
                        return
                    submitted[0] += 1
                    try:
                        e3.submit(p, max_new_tokens=P["max_new"], tenant="bronze")
                    except models.RequestShed:
                        shed[0] += 1
                    time.sleep(0.003)

            th = threading.Thread(target=flood, daemon=True)
            th.start()
            run = gold_pass()
            stop.set()
            th.join(timeout=10)
            if over is None or run[1] < over[1]:
                over = run
        t0 = time.perf_counter()
        while (e3.num_active or e3.num_pending) and time.perf_counter() - t0 < 90:
            e3.pop_results()
            time.sleep(0.001)
    finally:
        e3.stop_driver()
    shed[0] += len(e3.pop_shed())
    del e3

    def goodput(run):
        return sum(len(t) for t in run[0].values() if t) / run[1]

    overload = dict(gold_isolated_tokens_per_sec=goodput(iso),
                    gold_overload_tokens_per_sec=goodput(over),
                    gold_goodput_ratio=goodput(over) / goodput(iso),
                    gold_tokens_match_isolated=over[0] == iso[0],
                    gold_tokens_match_reference=iso[0] == ref, bronze_submitted=submitted[0],
                    bronze_shed=shed[0], repeats=P["repeats"])
    if not (overload["gold_tokens_match_isolated"] and overload["gold_tokens_match_reference"]
            and overload["bronze_shed"] >= 1):
        fail(f"engine chaos overload drill: {overload}")
    return dict(kill=kill, overload=overload, requests=P["n_requests"], max_new=P["max_new"])


def spill_workload(vocab, rng):
    """SPILL11's prompts: every length drawn first, then the tokens, so the
    schedule (which depends on the lengths alone) does not depend on the
    vocabulary."""
    P = SPILL11
    lens = rng.randint(P["prompt_range"][0], P["prompt_range"][1] + 1, P["n_requests"])
    return [rng.randint(0, vocab, (int(n),)).astype("int32") for n in lens]


def spill_drill(models, model):
    """(c) kv_spill on a pool too small for the batch: preemptions spill the
    K/V of requests mid-prefill to host RAM and restore them; every stream
    must equal the ample-pool engine's."""
    import numpy as np

    P = SPILL11
    prompts = spill_workload(model.config.vocab_size, np.random.RandomState(0))
    runs = {}
    for name, pool in (("ample", None), ("small", P["pool_blocks"])):
        eng = models.ContinuousBatchingEngine(
            model, max_batch=P["max_batch"], max_len=P["max_len"], block_size=P["block_size"],
            chunk_size=P["chunk_size"], decode_burst=P["decode_burst"], kv_spill=True,
            prefix_cache=False, pool_blocks=pool)
        rids = [eng.submit(p, max_new_tokens=P["max_new"]) for p in prompts]
        done, steps = {}, 0
        t0 = time.perf_counter()
        while (eng.num_active or eng.num_pending) and steps < 5000:
            done.update(eng.step())
            steps += 1
        runs[name] = dict(out=[[int(t) for t in done.get(r, [])] for r in rids],
                          wall_s=time.perf_counter() - t0, steps=steps,
                          pool_blocks=eng._pager.num_blocks, preemptions=eng.preemptions,
                          restores=eng.preempt_restores, spilled_bytes=eng.spilled_bytes)
        del eng
    small, ample = runs["small"], runs["ample"]
    res = dict(streams_match=small["out"] == ample["out"],
               complete=all(len(o) == P["max_new"] for o in small["out"]),
               **{k: small[k] for k in ("preemptions", "restores", "spilled_bytes",
                                        "pool_blocks", "steps", "wall_s")},
               ample_pool_blocks=ample["pool_blocks"], ample_steps=ample["steps"],
               ample_wall_s=ample["wall_s"], ample_preemptions=ample["preemptions"],
               requests=P["n_requests"], max_new=P["max_new"])
    if not (res["streams_match"] and res["complete"] and res["preemptions"] >= 1
            and res["restores"] == res["preemptions"]):
        fail(f"spill drill: {res}")
    return res


def radix_spill_drill(models, model):
    """(c) kv_spill with the radix prefix cache on: three waves (RSPILL11)
    through one engine whose pool holds one wave, so wave 2's grants spill
    wave 1's cached prefixes to host RAM and wave 3, wave 1's prompts again,
    restores them into the card's pools (restore_chain). Every stream must
    equal an engine without spill whose pool keeps every prefix."""
    import numpy as np

    P = RSPILL11
    rng = np.random.RandomState(1)
    vocab = model.config.vocab_size
    first, second = ([rng.randint(0, vocab, (P["prompt_len"],)).astype("int32")
                      for _ in range(P["per_wave"])] for _ in range(2))
    runs = {}
    for name, spill, pool in (("reference", False, P["reference_pool_blocks"]),
                              ("spill", True, P["pool_blocks"])):
        eng = models.ContinuousBatchingEngine(
            model, max_batch=P["max_batch"], max_len=P["max_len"], block_size=P["block_size"],
            chunk_size=P["chunk_size"], decode_burst=P["decode_burst"], kv_spill=spill,
            pool_blocks=pool)
        pc = eng.prefix_cache
        outs, held = [], []
        t0 = time.perf_counter()
        for wave in (first, second, first):
            rids = [eng.submit(p, max_new_tokens=P["max_new"]) for p in wave]
            done, steps = {}, 0
            while (eng.num_active or eng.num_pending) and steps < 2000:
                done.update(eng.step())
                steps += 1
            outs.append([[int(t) for t in done.get(r, [])] for r in rids])
            held.append(sum(t.numel() * t.element_size() for se in pc._spilled.values()
                            for entry in se.payload for t in entry))
        runs[name] = dict(out=outs, wall_s=time.perf_counter() - t0, evicted=pc.evicted,
                          restores=pc.restores, hits=pc.hits, preemptions=eng.preemptions,
                          pool_blocks=eng._pager.num_blocks, host_bytes_after_wave=held)
        del eng
    spill, ref = runs["spill"], runs["reference"]
    res = dict(streams_match=spill["out"] == ref["out"],
               complete=all(len(o) == P["max_new"] for w in spill["out"] for o in w),
               **{k: spill[k] for k in ("evicted", "restores", "hits", "preemptions",
                                        "pool_blocks", "host_bytes_after_wave", "wall_s")},
               reference_pool_blocks=ref["pool_blocks"], reference_hits=ref["hits"],
               reference_evicted=ref["evicted"], reference_wall_s=ref["wall_s"], waves=3, per_wave=P["per_wave"],
               prompt_len=P["prompt_len"], max_new=P["max_new"])
    if not (res["streams_match"] and res["complete"] and res["evicted"] >= 1
            and res["reference_evicted"] == 0
            and res["restores"] >= 1 and res["host_bytes_after_wave"][1] > 0):
        fail(f"radix spill drill: {res}")
    return res


def block_mha_card_vs_cpu(torch, IF):
    """(d) block_multihead_attention, prefill then one decode step, on the card
    and on the CPU at fp32 with the flagship's heads (16 x 128) and block 64:
    outputs and caches within 1e-5 (tests/test_paged_kv.py's tolerance). The
    lengths go to the card too, so its checks run as device asserts. First, a
    mixed batch with host lengths must raise NotImplementedError on the host,
    and the valid calls after it must run in the same process."""
    import numpy as np

    B, H, D, bs, max_blocks = 4, 16, 128, 64, 4
    enc = np.array([100, 64, 37, 200], np.int32)
    rng = np.random.RandomState(11)
    nb = 1 + B * max_blocks
    tables = np.arange(1, nb).reshape(B, max_blocks)
    qkv = rng.randn(int(enc.sum()), 3 * H * D).astype(np.float32)
    q1 = rng.randn(B, 3 * H * D).astype(np.float32)
    zeros, ones = np.zeros(B, np.int32), np.ones(B, np.int32)
    # a mixed prefill+decode batch with host (numpy) lengths: rejected on the
    # host with the JAX exception, before anything reaches the card, so the
    # process's CUDA context survives and the valid calls below still run
    kc = torch.zeros((nb, H, bs, D), device="cuda")
    mixed_enc, mixed_dec = np.array([100, 0, 37, 200], np.int32), np.array([0, 5, 0, 0],
                                                                          np.int32)
    try:
        IF.block_multihead_attention(
            torch.from_numpy(qkv[:337]).cuda(), kc, torch.zeros_like(kc), mixed_enc, mixed_dec,
            mixed_enc, block_tables=tables, block_size=bs)
    except NotImplementedError as e:
        rejected = str(e)
    else:
        fail("block_multihead_attention accepted a mixed batch with host lengths")
    torch.cuda.synchronize()   # raises here if a device assert had fired
    del kc
    res = {}
    for dev in ("cuda", "cpu"):
        t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)   # noqa: E731
        kc = torch.zeros((nb, H, bs, D), device=dev)
        vc = torch.zeros_like(kc)
        out, _, kc, vc = IF.block_multihead_attention(
            t(qkv), kc, vc, t(enc), t(zeros), t(enc), block_tables=t(tables), block_size=bs,
            max_enc_len_this_time=torch.tensor([int(enc.max())]))
        out2, _, kc, vc = IF.block_multihead_attention(
            t(q1), kc, vc, t(zeros), t(enc), t(ones), block_tables=t(tables), block_size=bs,
            max_enc_len_this_time=torch.tensor([0]))
        res[dev] = [x.cpu() for x in (out, out2, kc, vc)]
    errs = [float((a - b).abs().max()) for a, b in zip(res["cuda"], res["cpu"])]
    out = dict(prefill_max_abs_err=errs[0], decode_max_abs_err=errs[1],
               cache_max_abs_err=max(errs[2:]), tol=1e-5, lens=enc.tolist(), heads=H,
               head_dim=D, block_size=bs, host_length_rejection=rejected,
               valid_calls_after_rejection=True)
    if max(errs) > 1e-5:
        fail(f"block_multihead_attention, card vs CPU: {out}")
    return out


def phase_resilience(torch, fa, models, fleet, fi, serving_mod, IF, smi):
    """Phase 11: serving resilience and the fleet at the flagship width. The
    attention kernels' counts are set to 0 before and read after: the
    continuous engines launch none."""
    cfg = models.LlamaConfig(**FLAGSHIP, dtype="bfloat16")
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    out = {}
    reset_counts(fa)
    kill, drain, workload = fleet_drills(torch, fleet, fi, serving_mod, model)
    print("fleet_kill " + json.dumps(dict(kill, card=smi)), flush=True)
    print("fleet_drain " + json.dumps(dict(drain, card=smi)), flush=True)
    out["fleet_kill"], out["fleet_drain"] = kill, drain
    out["engine_chaos"] = chaos_drill(models, fi, serving_mod, model)
    print("engine_chaos " + json.dumps(dict(out["engine_chaos"], card=smi)), flush=True)
    out["spill_hang"] = dict(spill=spill_drill(models, model),
                             radix_spill=radix_spill_drill(models, model),
                             hang=hang_drill(fleet, fi, model, workload))
    print("spill_hang " + json.dumps(dict(out["spill_hang"], card=smi)), flush=True)
    out["launches"] = counts(fa)
    if out["launches"] != (0, 0, 0):
        fail(f"phase 11's engines launched the attention kernels {out['launches']} times, "
             "want 0")
    del model
    torch.cuda.empty_cache()
    out["block_mha"] = block_mha_card_vs_cpu(torch, IF)
    print("block_mha_card_vs_cpu " + json.dumps(dict(out["block_mha"], card=smi)), flush=True)
    return out


# phase 12: the training surface at the flagship width and depth. The bench's
# knobs (bench.py:879-880: BENCH_REMAT_GRAN, BENCH_FUSED_CE) as variants of
# phase 6's step; each variant's first step is counted and checked, then 1
# more warm step and 3 timed ones (the median is kept)
VARIANTS12 = (
    ("full", dict(recompute=True, recompute_granularity="full")),
    ("full_attn_fused", dict(recompute=True, recompute_granularity="full_attn",
                             fused_head_ce=True)),
    ("core_attn", dict(recompute=True, recompute_granularity="core_attn")),
    ("off", dict(recompute=False)),
    ("full_fused", dict(recompute=True, recompute_granularity="full", fused_head_ce=True)),
)
# the fused head's first-step loss (fp32 log-sum-exp over bf16 logits, chunk
# by chunk) against the standard head's loss recomputed in fp32 from its bf16
# logits: the same function of the same hidden states; the chunked LM-head
# GEMM may round a bf16 logit one step (2**-8 relative) apart from the
# whole-batch one, which moves a token's loss by ~1e-2 at most and the mean
# over 16384 tokens by far less
TOL_FUSED_LOSS = 2e-3
# the global gradient norm on the card (fp32 squares, fp32 sums in another
# order) against a float64 host sum of the same bf16 gradients
TOL_GLOBAL_NORM = 1e-4
SCHED12 = dict(base=1e-4, T_max=8, warmup=2, start=1e-5)


def product_ops(torch, layer, h):
    """The aten matrix products one decoder layer issues for ``h`` (a
    TorchDispatchMode over its forward): {op name: count}."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = {}

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func)
            if "mm" in name or "matmul" in name or "dot" in name or "linear" in name:
                seen[name] = seen.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), Record():
        layer._block(h)
    return seen


def fp32_loss(torch, model, ids, labels):
    """The loss in fp32: the fused head's own, or the standard head's
    recomputed in fp32 from its logits."""
    with torch.no_grad():
        loss, logits = model(ids, labels=labels)
        if logits is None:
            return loss.item()
        out = model.criterion(logits.float(), labels).item()
    del logits
    return out


def train_variant(torch, fa, models, optim, kw, ids, labels):
    """One variant of the flagship step: launches and gradients of step 1,
    then the median of 3 timed steps after 1 more warm one, the peak memory
    of those 4 steps above what was allocated before the model was built,
    and one profiled step (5 steps in all, as the loss check counts)."""
    cfg = models.LlamaConfig(**FLAGSHIP, dtype="bfloat16", **kw)
    L, (B, S) = cfg.num_hidden_layers, ids.shape
    # what earlier phases left allocated (graph pools, caches) is not this
    # variant's: garbage is collected first, and the peak is read above the rest
    gc.collect()
    torch.cuda.empty_cache()
    baseline = torch.cuda.memory_allocated()
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    model.train()
    opt = optim.AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(),
                      multi_precision=True)
    loss_first = fp32_loss(torch, model, ids, labels)
    torch.cuda.synchronize()
    reset_counts(fa)
    loss, _ = model(ids, labels=labels)
    loss.backward()
    torch.cuda.synchronize()
    launches = counts(fa)
    want = (2 * L, L, L) if cfg.recompute else (L, L, L)
    if launches != want:
        fail(f"phase 12 {kw}: one step launched (fwd, dq, dk/dv) = {launches}, want {want}")
    if fa.copies_for_alignment:
        fail(f"phase 12 {kw}: {fa.copies_for_alignment} alignment copies")
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())
           or not bool((p.grad != 0).any())]
    if bad:
        fail(f"phase 12 {kw}: parameters without a finite nonzero gradient: {bad}")
    opt.step()
    opt.clear_grad()

    def step():
        loss, _ = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()

    # the peak of the steps alone (parameters, gradients, masters and
    # moments are all live by now), not of the fp32 loss evaluations
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() - baseline
    step_ms = sorted(times)[1]
    prof = profile_step(torch, step, step_ms)
    loss_last = fp32_loss(torch, model, ids, labels)
    if not (math.isfinite(loss_first) and math.isfinite(loss_last)
            and loss_last < loss_first):
        fail(f"phase 12 {kw}: the loss did not fall over 6 steps: {loss_first} -> {loss_last}")
    n_params = sum(p.numel() for p in model.parameters())
    n_embed = model.llama.embed_tokens.weight.numel()
    flops = 6.0 * (n_params - n_embed) * B * S + 6.0 * L * B * S * S * cfg.hidden_size
    del model, opt, loss
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, step_ms_all=times, tokens_per_sec=B * S / (step_ms / 1e3),
                mfu=flops / (step_ms / 1e3) / PEAK_TC_FLOPS, peak_mem_bytes=peak,
                peak_mem_gb=peak / 1e9, baseline_mem_bytes=baseline,
                launches_per_step=list(launches), loss_first_fp32=loss_first,
                loss_last_fp32=loss_last,
                profile={k: prof[k] for k in ("device_ms", "idle_share", "profiled_ms",
                                              "kernel_launches", "by_group")})


def knob_variants(torch, fa, models, optim, saved_ops, smi):
    """(a) the bench's knobs at the flagship width and depth."""
    B, S = 8, 2048
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, FLAGSHIP["vocab_size"], (B, S), device="cuda", generator=gen)
    labels = torch.randint(0, FLAGSHIP["vocab_size"], (B, S), device="cuda", generator=gen)
    out = {}
    for name, kw in VARIANTS12:
        out[name] = train_variant(torch, fa, models, optim, kw, ids, labels)
        print(f"train_variant {name} " + json.dumps(dict(out[name], knobs=kw, card=smi)),
              flush=True)
    mem = {k: v["peak_mem_bytes"] for k, v in out.items()}
    orders = [("off", "core_attn"), ("core_attn", "full"),        # granularity, standard head
              ("core_attn", "full_attn_fused"), ("full", "full_fused")]  # fused < standard
    broken = [(a, b) for a, b in orders if not mem[a] > mem[b]]
    if broken:
        fail(f"phase 12 peak memory breaks the order(s) {broken}: {mem}")
    # recompute changes no value: the recomputed tensors are the forward's (the
    # kernels and GEMMs are deterministic), so after the same 6 steps every
    # granularity reaches the same loss bit for bit, with either head
    for group in (("full", "core_attn", "off"), ("full_attn_fused", "full_fused")):
        last = {k: out[k]["loss_last_fp32"] for k in group}
        if len(set(last.values())) != 1:
            fail(f"phase 12: recompute changed the trained loss: {last}")
    fused_err = abs(out["full_attn_fused"]["loss_first_fp32"] - out["full"]["loss_first_fp32"])
    fused_err = max(fused_err, abs(out["full_fused"]["loss_first_fp32"]
                                   - out["full"]["loss_first_fp32"]))
    if not fused_err <= TOL_FUSED_LOSS:
        fail(f"phase 12 fused head's first-step loss vs the standard head's in fp32: "
             f"{fused_err} > {TOL_FUSED_LOSS}")
    # the products one layer issues on the card, and that the selective
    # policy keeps every one without batch dimensions (a product it missed
    # would be recomputed silently)
    cfg = models.LlamaConfig(**dict(FLAGSHIP, num_hidden_layers=1), dtype="bfloat16")
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    model.train()
    h = torch.randn(B, S, cfg.hidden_size, device="cuda", dtype=torch.bfloat16)
    ops = product_ops(torch, model.llama.layers[0], h)
    saved = {str(o) for o in saved_ops["dots_with_no_batch_dims_saveable"]}
    # products with batch dimensions (attention's, where the plain version
    # runs) are recomputed on purpose, as under the JAX policy
    batched = {str(o) for o in saved_ops["dots_saveable"]} - saved
    missed = sorted(set(ops) - saved - batched)
    del model, h
    torch.cuda.empty_cache()
    if missed:
        fail(f"phase 12: the layer's products {missed} are not in the selective policy "
             f"{sorted(saved)}")
    return dict(variants=out, peak_mem_orders=[f"{a} > {b}" for a, b in orders],
                same_loss_after_6_steps=[["full", "core_attn", "off"],
                                         ["full_attn_fused", "full_fused"]],
                fused_loss_err=fused_err, tol_fused_loss=TOL_FUSED_LOSS,
                layer_product_ops=ops, policy_saves=sorted(saved))


def plain_schedule(step, base, T_max, warmup, start):
    """LinearWarmup(CosineAnnealingDecay(base, T_max), warmup, start, base)'s
    rate after ``step`` scheduler steps, in plain Python (the JAX formulas:
    the cosine's epoch starts once the warmup is over)."""
    if step < warmup:
        return start + (base - start) * step / warmup
    return base * (1 + math.cos(math.pi * (step - warmup) / T_max)) / 2


def schedule_and_clip(torch, models, optim, tnn, smi):
    """(b) AdamW multi_precision under LinearWarmup(CosineAnnealingDecay) with
    ClipGradByGlobalNorm(1.0), 4 steps at the flagship width and depth; every
    opt.step() under sync debug mode "error"."""
    from paddle_tpu_torch.nn.clip import global_norm

    cfg = models.LlamaConfig(**FLAGSHIP, dtype="bfloat16", recompute=True)
    B, S = 8, 2048
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    model.train()
    sc = SCHED12
    sched = optim.lr.LinearWarmup(optim.lr.CosineAnnealingDecay(sc["base"], T_max=sc["T_max"]),
                                  warmup_steps=sc["warmup"], start_lr=sc["start"],
                                  end_lr=sc["base"])
    clip = tnn.ClipGradByGlobalNorm(1.0)
    opt = optim.AdamW(learning_rate=sched, parameters=model.parameters(), multi_precision=True,
                      grad_clip=clip)
    gen = torch.Generator(device="cuda").manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", generator=gen)
    lrs, losses, norm, clip_ms = [], [], None, []
    for i in range(4):
        loss, _ = model(ids, labels=labels)
        loss.backward()
        grads = [p.grad for p in model.parameters()]
        if i == 0:
            card = global_norm(grads).item()
            host = math.sqrt(sum(float((g.cpu().double() ** 2).sum()) for g in grads))
            norm = dict(card=card, host_fp64=host, rel_err=abs(card - host) / host)
            if not norm["rel_err"] <= TOL_GLOBAL_NORM:
                fail(f"phase 12 global norm on the card vs the host: {norm}")
        # the device time clipping adds: the clip alone on this step's pairs
        pairs = list(zip(model.parameters(), grads))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        clip(pairs)
        ev[1].record()
        torch.cuda.synchronize()
        clip_ms.append(ev[0].elapsed_time(ev[1]))
        del pairs
        lrs.append(opt.get_lr())
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            opt.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        opt.clear_grad()
        sched.step()
        losses.append(loss.item())
    want = [plain_schedule(i, **sc) for i in range(4)]
    if any(abs(a - b) > 1e-15 for a, b in zip(lrs, want)):
        fail(f"phase 12 schedule: get_lr() {lrs}, the JAX formulas give {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"phase 12 schedule and clipping: non-finite loss {losses}")
    del model, opt
    torch.cuda.empty_cache()
    return dict(lrs=lrs, plain_lrs=want, losses=losses, global_norm=norm,
                tol_global_norm=TOL_GLOBAL_NORM, clip_ms=clip_ms,
                clip_ms_median=sorted(clip_ms)[len(clip_ms) // 2],
                sync_debug_mode="error", schedule=sc)


def checkpoint_resume(torch, models, optim, tnn, ckpt):
    """(c) at the flagship width with 2 layers: 6 steps uninterrupted, then 3
    steps, an async save, a fresh model, optimizer and scheduler restored, and
    steps 4-6: losses and final weights equal bit for bit."""
    import shutil
    import tempfile

    cfg = models.LlamaConfig(**dict(FLAGSHIP, num_hidden_layers=2), dtype="bfloat16",
                             recompute=True)
    B, S = 8, 2048
    gen = torch.Generator(device="cuda").manual_seed(2)
    batches = [(torch.randint(0, cfg.vocab_size, (B, S), device="cuda", generator=gen),
                torch.randint(0, cfg.vocab_size, (B, S), device="cuda", generator=gen))
               for _ in range(6)]

    def build(seed):
        model = models.LlamaForCausalLM(cfg, device="cuda", seed=seed)
        model.train()
        sc = SCHED12
        sched = optim.lr.LinearWarmup(
            optim.lr.CosineAnnealingDecay(sc["base"], T_max=sc["T_max"]),
            warmup_steps=sc["warmup"], start_lr=sc["start"], end_lr=sc["base"])
        opt = optim.AdamW(learning_rate=sched, parameters=model.named_parameters(),
                          multi_precision=True, grad_clip=tnn.ClipGradByGlobalNorm(1.0))
        return model, opt, sched

    def train(model, opt, sched, steps):
        out = []
        for ids, labels in (batches[i] for i in steps):
            loss, _ = model(ids, labels=labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            sched.step()
            out.append(loss.item())
        return out

    ref = build(0)
    ref_losses = train(*ref, range(6))
    ref_params = {n: p.detach().clone() for n, p in ref[0].named_parameters()}
    del ref
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        run = build(0)
        losses = train(*run, range(3))
        mgr = ckpt.CheckpointManager(root, keep=1)
        arrays, meta = ckpt.training_state(run[0], run[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(3, arrays, meta=meta)
        blocked_ms = (time.perf_counter() - t0) * 1e3
        mgr.wait()
        write_s = time.perf_counter() - t0 - blocked_ms / 1e3
        del run, arrays
        torch.cuda.empty_cache()
        fresh = build(123)
        t0 = time.perf_counter()
        rc = mgr.restore()
        restore_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ckpt.load_training_state(rc, fresh[0], fresh[1])
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        doc = ckpt.verify_checkpoint(rc.path)
        verify_s = time.perf_counter() - t0
        del rc
        losses += train(*fresh, range(3, 6))
        same = {n: bool(torch.equal(p, ref_params[n])) for n, p in fresh[0].named_parameters()}
        mgr.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = dict(losses=losses, ref_losses=ref_losses, losses_equal=losses == ref_losses,
               weights_equal=all(same.values()), bytes_written=doc["total_bytes"],
               shards=doc["n_shards"], save_blocked_ms=blocked_ms, writer_s=write_s,
               restore_s=restore_s, load_s=load_s, verify_s=verify_s, verified=True,
               params=sum(p.numel() for p in fresh[0].parameters()), layers=2)
    if not (out["losses_equal"] and out["weights_equal"]):
        fail(f"phase 12 checkpoint resume is not bit-identical: {out}, weights {same}")
    del fresh
    torch.cuda.empty_cache()
    return out


def count_math_path(port_F):
    """Count the calls of sdpa's math path (a probe of this script: the
    module's ``_math_sdpa`` wrapped with a counter). Returns the counter, a
    one-element list."""
    calls = [0]
    inner = port_F._math_sdpa

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    port_F._math_sdpa = counted
    return calls


def functionals_on_card(torch, fa, port_F, tF, IF, math_calls):
    """flash_attention reaching the forward kernel, flash_attn_unpadded
    against a per-sequence loop of the plain attention (and its CPU twin),
    every-two rotary card against CPU."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = {}
    for name, Hq, Hkv, D in (("d96", 32, 32, 96), ("d256", 8, 1, 256)):
        q, k, v = (torch.randn(2, 256, h, D, device="cuda", generator=gen).to(torch.bfloat16)
                   for h in (Hq, Hkv, Hkv))
        reset_counts(fa)
        math_calls[0] = 0
        o, none = tF.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        if none is not None or fa.launches != 1 or math_calls[0]:
            fail(f"phase 13 flash_attention {name}: {fa.launches} launches, "
                 f"{math_calls[0]} math-path calls")
        ref = fa.flash_attention_fwd_plain(q, k, v, True)[0]
        diff = (o.float() - ref.float()).abs()
        err = (diff / ref.float().abs().clamp(min=1.0)).max().item()
        if not err <= TOL["bfloat16"]:
            fail(f"phase 13 flash_attention {name} vs the plain version: {err}")
        out[f"flash_attention_{name}"] = dict(launches=1, max_scaled_err=err,
                                              tol=TOL["bfloat16"])

        # three ragged sequences packed as one, fp32
        cu = torch.tensor([0, 100, 357, 512], dtype=torch.int32)
        qv, kv, vv = (torch.randn(512, h, D, device="cuda", generator=gen)
                      for h in (Hq, Hkv, Hkv))
        if Hq != Hkv:  # flash_attn_unpadded takes equal head counts, as in JAX
            kv, vv = kv.repeat_interleave(Hq // Hkv, 1), vv.repeat_interleave(Hq // Hkv, 1)
        for causal in (False, True):
            got = tF.flash_attn_unpadded(qv, kv, vv, cu.cuda(), cu.cuda(), 257, 257,
                                         causal=causal)[0]
            loop = torch.cat([port_F._math_sdpa(qv[a:b][None], kv[a:b][None], vv[a:b][None],
                                                causal=causal)[0]
                              for a, b in zip(cu[:-1].tolist(), cu[1:].tolist())])
            twin = tF.flash_attn_unpadded(qv.cpu(), kv.cpu(), vv.cpu(), cu, cu, 257, 257,
                                          causal=causal)[0]
            errs = ((got - loop).abs().max().item(), (got.cpu() - twin).abs().max().item())
            if not max(errs) <= TOL_VARLEN:
                fail(f"phase 13 flash_attn_unpadded {name} causal={causal}: {errs}")
            out[f"flash_attn_unpadded_{name}_causal{int(causal)}"] = dict(
                vs_loop=errs[0], vs_cpu=errs[1], tol=TOL_VARLEN)

        # every-two rotary (the default pairing), q, k and v rotated: the
        # tables the card generates (from positions, and from position ids)
        # against the CPU's, then the rotation with the card's tables on both
        x = [torch.randn(2, 256, Hq, D, device="cuda", generator=gen) for _ in range(3)]
        pos = torch.randint(0, 4096, (2, 256), device="cuda", generator=gen)
        for key, p in (("tables", None), ("position_ids", pos)):
            tables = IF._rope_tables(256, D, 10000.0, torch.float32, "cuda", p)
            twin_tables = IF._rope_tables(256, D, 10000.0, torch.float32, "cpu",
                                          None if p is None else p.cpu())
            table_err = max((a.cpu() - b).abs().max().item()
                            for a, b in zip(tables, twin_tables))
            table_tol = 1e-6 + ROPE_ANGLE_ULPS * (255 if p is None else p.max().item())
            cos, sin = tables
            got = IF.fused_rotary_position_embedding(*x, sin=sin, cos=cos)
            twin = IF.fused_rotary_position_embedding(*(t.cpu() for t in x), sin=sin.cpu(),
                                                      cos=cos.cpu())
            err = max((a.cpu() - b).abs().max().item() for a, b in zip(got, twin))
            if p is None:  # the default path generates the same tables itself
                dflt = IF.fused_rotary_position_embedding(*x)
                err = max([err] + [(a - b).abs().max().item() for a, b in zip(dflt, got)])
            if not (table_err <= table_tol and err <= TOL_ROPE):
                fail(f"phase 13 every-two rotary {name} {key}, card vs CPU: tables "
                     f"{table_err} (tol {table_tol}), rotation {err} (tol {TOL_ROPE})")
            out[f"rope_every_two_{name}_{key}"] = dict(
                tables_card_vs_cpu=table_err, tol_tables=table_tol, card_vs_cpu=err,
                tol=TOL_ROPE)
        del q, k, v, o, ref, qv, kv, vv, x
    torch.cuda.empty_cache()
    return out


def phase_widths(torch, fa, models, AdamW, port_F, tF, IF, smi):
    """Phase 13: Phi-3-mini's and Gemma-2B's widths served (full depth) and
    trained (4 layers), each call between counts set to 0 and read; 2-layer
    fp32 card against CPU; the attention functionals on the card."""
    math_calls = count_math_path(port_F)
    out = {}
    for name, width, knobs in WIDTHS13:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        math_calls[0] = 0
        serving = phase_serving(torch, fa, models, width)
        if math_calls[0]:
            fail(f"phase 13 {name} serving took the math path {math_calls[0]} times")
        serving.update(math_path_calls=0, seconds=time.perf_counter() - t0)
        print(f"widths_serving_{name} " + json.dumps(dict(serving, card=smi)), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        training = phase_training(torch, fa, models, AdamW, smi,
                                  width=dict(width, num_hidden_layers=TRAIN13["layers"]),
                                  knobs=knobs, batch=TRAIN13["batch"], warm=0,
                                  timed=TRAIN13["steps"] - 2, math_calls=math_calls)
        training["seconds"] = time.perf_counter() - t0
        print(f"widths_training_{name} " + json.dumps(training), flush=True)
        t0 = time.perf_counter()
        e2e = phase_card_vs_cpu(torch, fa, models, width)
        train_e2e = phase_train_card_vs_cpu(torch, fa, models, AdamW, width, shape=(1, 128),
                                            **knobs)
        e2e_s = time.perf_counter() - t0
        print(f"widths_card_vs_cpu_{name} " + json.dumps(dict(
            serving=e2e, training=train_e2e, seconds=e2e_s)), flush=True)
        out[name] = dict(serving=serving, training=training, card_vs_cpu=e2e,
                         train_card_vs_cpu=train_e2e)
        gc.collect()
        torch.cuda.empty_cache()
    out["functionals"] = functionals_on_card(torch, fa, port_F, tF, IF, math_calls)
    print("widths_functionals " + json.dumps(out["functionals"]), flush=True)
    return out


def phase_train_surface(torch, fa, models, optim, tnn, ckpt, saved_ops, smi):
    """Phase 12: the training surface at the flagship width and depth."""
    out = dict(knobs=knob_variants(torch, fa, models, optim, saved_ops, smi))
    print("train_knobs " + json.dumps(dict({k: v for k, v in out["knobs"].items()
                                            if k != "variants"}, card=smi)), flush=True)
    out["schedule_clip"] = schedule_and_clip(torch, models, optim, tnn, smi)
    print("schedule_clip " + json.dumps(dict(out["schedule_clip"], card=smi)), flush=True)
    out["checkpoint"] = checkpoint_resume(torch, models, optim, tnn, ckpt)
    print("checkpoint_resume " + json.dumps(dict(out["checkpoint"], card=smi)), flush=True)
    return out


# phase 14: the compiled paths
# (name, width) of the captured-decode cells: phase 3's and phase 13's
WIDTHS14 = (("flagship", FLAGSHIP), ("phi3_mini", PHI3_MINI), ("gemma_2b", GEMMA_2B))
# to_static against eager at 2 layers fp32 (phase 7's shape): Inductor
# fuses elementwise chains and sums in another order, in full float32
TOL_COMPILED_LOSS = 1e-5   # relative
TOL_COMPILED_GRAD = 1e-4   # norm-relative per parameter
# the .item() break (e): Inductor's tanh is libdevice's, eager's ATen's
TOL_BREAK = 1e-6
# (a) what the captured programs keep: the engine's graphs share one memory
# pool, so 14 new prefill graphs keep their (B, V) logits (4 MiB at the
# flagship), not a private pool of intermediates each (tens of MiB each)
MEM14_PROMPTS = 32 << 20   # bytes


def uncaptured(engine):
    """``engine`` with its programs run as plain calls of the same functions,
    without graphs: the reference a captured engine is held to."""
    def program(slot, key, fn):
        pools = slot.cache
        dev = pools[0][0].device
        return lambda first, *rest: fn(first.to(dev), pools, *(x.to(dev) for x in rest))

    engine._program = program
    return engine


def captured_memory(torch, models, model, gen):
    """Phase 14 (a), what the captured programs keep: an engine warmed at the
    longest prompt (128) at B8 and B1 serves 7 shorter prompt lengths at
    both (14 new prefill graphs): the reserved device memory grows by at
    most MEM14_PROMPTS. Then B2 to B6, past the free list's cap of slots:
    it grows by at most that and the cap's worth of B8 caches, and the free
    list holds the cap."""
    V = model.config.vocab_size
    engine = models.LlamaDecodeEngine(model, max_len=128 + 5)
    ids = torch.randint(0, V, (8, 128), device="cuda", generator=gen)
    for B in (8, 1):
        engine.generate(ids[:B], max_new_tokens=4)
    kv8 = sum(a.numel() * a.element_size() for e in engine._free[0].cache for a in e)
    torch.cuda.synchronize()
    r0, c0 = torch.cuda.memory_reserved(), models.llama_decode._Program.captures
    for S in (16, 32, 48, 64, 80, 96, 112):
        for B in (8, 1):
            engine.generate(ids[:B, :S], max_new_tokens=4)
    torch.cuda.synchronize()
    r1, graphs = torch.cuda.memory_reserved(), models.llama_decode._Program.captures - c0
    for B in (2, 3, 4, 5, 6):
        engine.generate(ids[:B], max_new_tokens=4)
    torch.cuda.synchronize()
    r2, free = torch.cuda.memory_reserved(), len(engine._free)
    cap = engine.max_free_slots
    out = dict(prompt_graphs=graphs, reserved_growth_prompts=r1 - r0,
               bound_prompts=MEM14_PROMPTS, reserved_growth_batches=r2 - r0,
               bound_batches=MEM14_PROMPTS + cap * kv8, kv_bytes_b8=kv8, free_slots=free,
               max_free_slots=cap)
    if graphs != 14:
        fail(f"7 new prompt lengths at 2 batch sizes captured {graphs} graphs, want 14")
    if r1 - r0 > MEM14_PROMPTS or r2 - r0 > MEM14_PROMPTS + cap * kv8 or free != cap:
        fail(f"captured programs keep too much: {out}")
    del engine
    return out


def kernel_count(torch, fn, substr):
    """How many kernels whose name holds ``substr`` a profiled ``fn()`` ran
    on the card (CUPTI records the kernels of a replayed graph one by one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and substr in e.key)


def captured_vs_eager(torch, fa, models, serving_mod, name, width, smi):
    """Phase 14 (a) at one width: the captured engine against the same
    functions without graphs (``uncaptured``) on phase 3's prompts (B8, 128
    tokens, 32 new)."""
    cfg = models.LlamaConfig(**width, dtype="bfloat16")
    L, V, new = cfg.num_hidden_layers, cfg.vocab_size, 32
    gc.collect()
    torch.cuda.empty_cache()
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    prompts = torch.randint(0, V, (8, 128), device="cuda", generator=gen)
    captured = models.LlamaDecodeEngine(model, max_len=128 + new + 1)
    eager = uncaptured(models.LlamaDecodeEngine(model, max_len=128 + new + 1))
    c0 = serving_mod._Program.captures
    lc, cc, pos = captured.prefill(prompts)
    le, ce, _ = eager.prefill(prompts)
    if not torch.equal(lc, le):
        fail(f"{name}: captured prefill logits differ from eager by "
             f"{(lc.float() - le.float()).abs().max().item()}")
    tok = lc.argmax(-1, keepdim=True)
    for i in range(new - 1):
        lc, cc = captured.decode_step(tok, cc, pos)
        le, ce = eager.decode_step(tok, ce, pos)
        if not torch.equal(lc, le):
            fail(f"{name}: captured decode step {i} logits differ from eager by "
                 f"{(lc.float() - le.float()).abs().max().item()}")
        tok = lc.argmax(-1, keepdim=True)
        pos += 1
    del cc, ce
    graphs = serving_mod._Program.captures - c0
    if graphs != 2:
        fail(f"{name}: the first prefill and decode captured {graphs} graphs, want 2")
    out = {}
    for path, engine in (("captured", captured), ("eager", eager)):
        run = serve_timed(torch, fa, engine, prompts, new, torch.cuda.synchronize)
        num = run["numbers"]
        if (num["launches_generate"], num["launches_prefill"], num["launches_decode"]) != (
                L, L, 0):
            fail(f"{name} {path}: forward launches (generate, prefill, decode) = "
                 f"{(num['launches_generate'], num['launches_prefill'], num['launches_decode'])}"
                 f", want ({L}, {L}, 0)")
        # one more decode step under the profiler: kernels, device ms, idle share
        prof = profile_step(torch, lambda: engine.decode_step(run["tok"], run["cache"],
                                                              run["pos"]), num["ms_per_token"])
        out[path] = dict(prefill_ms=num["prefill_ms"], ms_per_token=num["ms_per_token"],
                         tokens_per_sec=num["tokens_per_sec"], generate_s=num["generate_s"],
                         launches_per_prefill=num["launches_prefill"],
                         decode_step_profile={k: prof[k] for k in (
                             "device_ms", "idle_share", "kernel_launches", "by_group")})
        out[path + "_toks"] = run["toks"]
        del run
    if not torch.equal(out["captured_toks"], out.pop("eager_toks")):
        fail(f"{name}: captured and eager generate tokens differ")
    toks = out.pop("captured_toks")
    c0 = serving_mod._Program.captures
    warm = captured.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    out["warm_generate_graphs_captured"] = serving_mod._Program.captures - c0
    if out["warm_generate_graphs_captured"] or not torch.equal(warm, toks):
        fail(f"{name}: a warm generate captured {out['warm_generate_graphs_captured']} graphs "
             f"or changed its tokens")
    if name == "flagship":
        # the credit against the kernels a profiled replay runs
        reset_counts(fa)
        n = kernel_count(torch, lambda: captured.prefill(prompts), "fa_fwd_wgmma")
        if (n, fa.launches) != (L, L):
            fail(f"a replayed prefill ran {n} fa_fwd_wgmma kernels and was credited "
                 f"{fa.launches} launches, want {L} and {L}")
        out["profiled_replay"] = dict(fa_fwd_wgmma_kernels=n, credited=fa.launches)
        # two live caches at one batch size: their own buffers, solo tokens
        other = torch.randint(0, V, (8, 128), device="cuda", generator=gen)
        solo = captured.generate(other, max_new_tokens=8)
        caches = [captured.prefill(p) for p in (prompts, other)]
        streams = [[c[0].argmax(-1, keepdim=True)] for c in caches]
        handles, poss = [c[1] for c in caches], [c[2] for c in caches]
        for _ in range(7):
            for j in range(2):
                logits, handles[j] = captured.decode_step(streams[j][-1], handles[j], poss[j])
                poss[j] += 1
                streams[j].append(logits.argmax(-1, keepdim=True))
        got = [torch.cat(st, dim=1) for st in streams]
        if not (torch.equal(got[0], toks[:, :8]) and torch.equal(got[1], solo)):
            fail(f"{name}: interleaved decodes at one batch size changed their tokens")
        out["interleaved_solo_tokens"] = True
        del caches, handles
        out["memory"] = captured_memory(torch, models, model, gen)
    out.update(batch=8, prompt=128, new_tokens=new, layers=L,
               ms_per_token_captured_over_eager=(out["captured"]["ms_per_token"]
                                                 / out["eager"]["ms_per_token"]),
               bit_equal_logits=True, card=smi)
    del model, captured, eager
    return out


def captured_forms(torch, models):
    """Phase 14 (b): phase 9's cell, the paged, int8 and paged-int8 engines
    captured against the same functions without graphs (tokens), and beam
    search B8 K4 dense and paged (tokens and scores)."""
    cfg = models.LlamaConfig(**FLAGSHIP, dtype="bfloat16")
    V = cfg.vocab_size
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    prompts = torch.randint(0, V, (8, 128), device="cuda", generator=gen)
    forms = dict(paged=dict(kv_cache_layout="paged", block_size=64),
                 int8=dict(kv_cache_dtype="int8"),
                 paged_int8=dict(kv_cache_dtype="int8", kv_cache_layout="paged",
                                 block_size=64))
    out = {}
    for name, kw in forms.items():
        engines = [models.LlamaDecodeEngine(model, max_len=161, **kw) for _ in range(2)]
        toks = [e.generate(prompts, max_new_tokens=32)
                for e in (engines[0], uncaptured(engines[1]))]
        if not torch.equal(*toks):
            fail(f"{name}: captured and eager tokens differ")
        out[name] = dict(tokens_equal=True, new_tokens=32)
    for name, kw in (("dense", {}), ("paged", forms["paged"])):
        engines = [models.LlamaDecodeEngine(model, max_len=128 + 17, **kw) for _ in range(2)]
        beams = [e.beam_search(prompts, beam_size=4, max_new_tokens=16)
                 for e in (engines[0], uncaptured(engines[1]))]
        if not (torch.equal(beams[0][0], beams[1][0]) and torch.equal(beams[0][1], beams[1][1])):
            fail(f"beam search {name}: captured and eager beams differ")
        out["beam_" + name] = dict(tokens_equal=True, scores_equal=True, batch=8, beams=4,
                                   new_tokens=16)
    del model
    return out


def to_static_training(torch, fa, models, AdamW, jit, smi, eager, math_calls):
    """Phase 14 (c): phase 6's step under jit.to_static (Inductor), against
    phase 6's eager numbers from this run."""
    cfg = models.LlamaConfig(**FLAGSHIP, dtype="bfloat16", recompute=True,
                             recompute_granularity="full")
    L, B, S = cfg.num_hidden_layers, 8, 2048
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    model.train()
    jit.to_static(model)
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(), multi_precision=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", generator=gen)

    def fp32_loss(logits):
        with torch.no_grad():
            return model.criterion(logits.float(), labels).item()

    def step():
        loss, logits = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss, logits

    torch.cuda.synchronize()
    reset_counts(fa)
    t0 = time.perf_counter()
    loss, logits = model(ids, labels=labels)
    loss.backward()
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    cold_counts = counts(fa)
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())
           or not bool((p.grad != 0).any())]
    if bad:
        fail(f"to_static: parameters without a finite nonzero gradient: {bad}")
    first = (loss.item(), fp32_loss(logits))
    del logits
    opt.step()
    opt.clear_grad()
    # a warm step, counted
    torch.cuda.synchronize()
    reset_counts(fa)
    math_calls[0] = 0
    step()
    torch.cuda.synchronize()
    per_step = counts(fa)
    if per_step != (2 * L, L, L):
        fail(f"a to_static step launched (fwd, dq, dk/dv) = {per_step}, want {(2 * L, L, L)}")
    if math_calls[0] or fa.copies_for_alignment or fa.pads_for_head_dim:
        fail(f"a to_static step took the math path {math_calls[0]} times, made "
             f"{fa.copies_for_alignment} alignment copies and {fa.pads_for_head_dim} pads")
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, logits = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    last = (loss.item(), fp32_loss(logits))
    del logits
    step_ms = sorted(times)[len(times) // 2]
    profile = profile_step(torch, step, step_ms)
    if not all(math.isfinite(x) for x in first + last) or not last[1] < first[1]:
        fail(f"the to_static loss did not fall: {first} -> {last}")
    out = dict(step_ms=step_ms, step_ms_all=times, eager_step_ms=eager["step_ms"],
               eager_step_ms_all=eager["step_ms_all"], step_ms_over_eager=step_ms / eager[
                   "step_ms"], tokens_per_sec=B * S / (step_ms / 1e3),
               compile_s=compile_s, cold_step_launches=list(cold_counts),
               launches_per_step=dict(fwd=per_step[0], bwd_dq=per_step[1],
                                      bwd_dkv=per_step[2]),
               math_path_calls=0, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               eager_peak_mem_gb=eager["peak_mem_gb"], loss_first=first[0],
               loss_last=last[0], loss_first_fp32=first[1], loss_last_fp32=last[1],
               batch=B, seq=S, layers=L, steps=8, profile=profile,
               eager_profile_by_group=eager["profile"]["by_group"], card=smi)
    del model, opt
    return out


def to_static_vs_eager_fp32(torch, fa, models, AdamW, jit):
    """Phase 14 (c), second half: 2 layers in fp32 at phase 7's shape, the
    compiled step against the eager step on the card, two AdamW steps."""
    import copy

    cfg = models.LlamaConfig(**dict(FLAGSHIP, num_hidden_layers=2), dtype="float32",
                             recompute=True)
    eager = models.LlamaForCausalLM(cfg, device="cuda", seed=5)
    comp = copy.deepcopy(eager)
    eager.train()
    comp.train()
    jit.to_static(comp)
    oe = AdamW(learning_rate=TRAIN_LR, parameters=eager.parameters())
    oc = AdamW(learning_rate=TRAIN_LR, parameters=comp.parameters())
    gen = torch.Generator(device="cpu").manual_seed(13)
    ids = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen)
    labels[torch.rand(2, 256, generator=gen) < 0.1] = -100
    ids, labels = ids.cuda(), labels.cuda()
    t0 = time.perf_counter()
    losses, grad_err = [], {}
    reset_counts(fa)
    for i in range(2):
        le, _ = eager(ids, labels=labels)
        le.backward()
        lc, _ = comp(ids, labels=labels)
        lc.backward()
        losses.append((lc.item(), le.item()))
        err = abs(losses[-1][0] - losses[-1][1]) / abs(losses[-1][1])
        if not (math.isfinite(err) and err <= TOL_COMPILED_LOSS):
            fail(f"fp32 to_static vs eager loss at step {i + 1}: {losses[-1]}")
        if i == 0:
            eg = dict(eager.named_parameters())
            for n, p in comp.named_parameters():
                grad_err[n] = norm_rel(p.grad, eg[n].grad)
            worst = max(grad_err, key=grad_err.get)
            if not grad_err[worst] <= TOL_COMPILED_GRAD:
                fail(f"fp32 to_static vs eager gradient of {worst}: {grad_err[worst]}")
        oe.step()
        oc.step()
        oe.clear_grad()
        oc.clear_grad()
    if counts(fa) != (2 * 2 * 2 * 2, 2 * 2 * 2, 2 * 2 * 2):
        fail(f"fp32 eager + compiled steps launched {counts(fa)}, want (16, 8, 8)")
    out = dict(losses=losses, tol_loss=TOL_COMPILED_LOSS, worst_grad_err=[worst, grad_err[worst]],
               tol_grad=TOL_COMPILED_GRAD, shape=[2, 256], layers=2,
               seconds=time.perf_counter() - t0)
    del eager, comp
    return out


def axpy_to_static(torch, axpy, jit):
    """Phase 14 (d): the registered axpy op inside a full_graph=True
    to_static function on the card."""
    op = axpy.register_example(name="chip_smoke_axpy_to_static")
    f = jit.to_static(lambda x: op(x), full_graph=True)
    x = torch.randn(2 ** 20 + 3, device="cuda")
    f(x)
    torch.cuda.synchronize()
    axpy.launches = 0
    for _ in range(3):
        y = f(x)
    torch.cuda.synchronize()
    if axpy.launches != 3:
        fail(f"3 calls of the compiled axpy function launched {axpy.launches} kernels")
    if not same_bits(torch, y, axpy.axpy_plain(x)):
        fail("the compiled axpy function differs from the plain version")
    return dict(calls=3, launches=axpy.launches, bit_exact=True, numel=x.numel(),
                signatures=len(f._cache))


def graph_break_on_card(torch, jit):
    """Phase 14 (e): a full_graph=False function with an .item() read."""
    import warnings

    def brk(x):
        h = torch.tanh(x) * 2.0
        if h.sum().item() > 0:
            return h * 3.0
        return h - 1.0

    sf = jit.to_static(brk, full_graph=False)
    x = torch.rand(64, 64, device="cuda") + 0.1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        outs = [sf(x), sf(x)]
    ref = brk(x)
    err = max((o - ref).abs().max().item() / ref.abs().max().item() for o in outs)
    segments = sum(sf.compiled_segment_counts().values())
    if not err <= TOL_BREAK or segments < 2:
        fail(f"the .item() break on the card: error {err}, {segments} compiled segments")
    return dict(max_rel_err=err, tol=TOL_BREAK, segments=segments)


def to_static_forward(torch, fa, models, jit, math_calls, smi):
    """Phase 14 (f): the flagship's forward at phase 15's shape (B8 S128)
    under to_static (Inductor, no grad): launches, the cold compile, the
    median ms of a call and a profiled call, the yardstick phase 15's
    Predictor is read beside."""
    cfg = models.LlamaConfig(**FLAGSHIP, dtype="bfloat16")
    L = cfg.num_hidden_layers
    gc.collect()
    torch.cuda.empty_cache()
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    ids = torch.randint(0, cfg.vocab_size, (8, 128), device="cuda", generator=gen)
    compiled = jit.to_static(lambda x: model(x))

    def fwd():
        with torch.no_grad():
            return compiled(ids)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd()
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    reset_counts(fa)
    math_calls[0] = 0
    fwd()
    torch.cuda.synchronize()
    launched = counts(fa)
    if launched != (L, 0, 0) or math_calls[0] or fa.copies_for_alignment:
        fail(f"the to_static forward launched {launched}, took the math path "
             f"{math_calls[0]} times, made {fa.copies_for_alignment} copies")
    ms, ms_all = timed_runs(torch, fwd)
    profile = profile_step(torch, fwd, ms)
    if len(compiled._cache) != 1:
        fail(f"the to_static forward compiled {len(compiled._cache)} signatures")
    del model, compiled
    return dict(batch=8, seq=128, layers=L, compile_s=compile_s, launches=launched[0],
                ms=ms, ms_all=ms_all, profile=profile,
                timing=f"CUDA events around each call, median of {DEPLOY_RUNS}", card=smi)


def phase_compiled(torch, fa, axpy, models, AdamW, jit, serving_mod, port_F, smi, eager):
    """Phase 14: the compiled paths (module docstring)."""
    out = dict(decode={})
    for name, width in WIDTHS14:
        t0 = time.perf_counter()
        row = captured_vs_eager(torch, fa, models, serving_mod, name, width, smi)
        row["seconds"] = time.perf_counter() - t0
        print(f"captured_decode_{name} " + json.dumps(row), flush=True)
        out["decode"][name] = row
    t0 = time.perf_counter()
    out["forms"] = captured_forms(torch, models)
    out["forms"]["seconds"] = time.perf_counter() - t0
    print("captured_forms " + json.dumps(out["forms"]), flush=True)
    math_calls = count_math_path(port_F)
    out["training"] = to_static_training(torch, fa, models, AdamW, jit, smi, eager, math_calls)
    print("to_static_training " + json.dumps(out["training"]), flush=True)
    out["fp32"] = to_static_vs_eager_fp32(torch, fa, models, AdamW, jit)
    print("to_static_vs_eager_fp32 " + json.dumps(out["fp32"]), flush=True)
    out["axpy"] = axpy_to_static(torch, axpy, jit)
    out["graph_break"] = graph_break_on_card(torch, jit)
    print("to_static_ops " + json.dumps(dict(axpy=out["axpy"], graph_break=out["graph_break"])),
          flush=True)
    out["forward"] = to_static_forward(torch, fa, models, jit, math_calls, smi)
    print("to_static_forward " + json.dumps(out["forward"]), flush=True)
    return out


# phase 15: the deploy path. The flagship's loaded program, run as it was
# saved, must give the eager model's logits bit for bit: the same operations
# in the same order. The Predictor runs that program compiled by Inductor,
# which keeps intermediates in fp32 inside its fused kernels where eager code
# rounds each op's result to bf16: through 8 random layers its logits part
# from eager's by ~2e-2 norm-relative, and eager's from an fp32 run of the
# same weights by as much (on an H100 80GB HBM3 at 700 W: 0.0195 and 0.0175;
# the Predictor 0.0146 from fp32). So the Predictor is held to the fp32 run: no
# farther from it than the eager model is (times DEPLOY_REF_FACTOR), its
# argmax agreeing with it as often as eager's (less DEPLOY_ARGMAX_SLACK).
DEPLOY_REF_FACTOR = 1.25
DEPLOY_ARGMAX_SLACK = 0.01
# (b) fp32: each loaded program against its own eager model runs the same
# operations (compiled by nothing): only summation order may differ
TOL_DEPLOY_FP32 = 1e-5     # norm-relative
DEPLOY_RUNS = 20           # timed calls of the Predictor, eager and to_static
DEPLOY_SECONDS = 120       # phase 15's share of the script's time
# (d) run in a fresh interpreter that imports only paddle_tpu_torch.jit
AXPY_DEPLOY_CODE = r"""
import json, sys, torch
from paddle_tpu_torch import jit
f = jit.load(sys.argv[1])
axpy = sys.modules["paddle_tpu_torch.ops.cuda.axpy"]
x = torch.randn(int(sys.argv[2]), device="cuda", generator=torch.Generator("cuda").manual_seed(5))
f(x)
torch.cuda.synchronize()
axpy.launches = 0
ys = [f(x) for _ in range(3)]
torch.cuda.synchronize()
launches = axpy.launches
ref = x * 2.0 + 1.0
print(json.dumps(dict(calls=3, launches=launches, bit_exact=all(
    torch.equal(y.view(torch.int32), ref.view(torch.int32)) for y in ys),
    ops=[str(n.target) for n in f._program.graph.nodes if n.op == "call_function"])))
"""


def graph_ops(program):
    """The call_function targets of a loaded program's graph, as strings."""
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]


def timed_runs(torch, fn, runs=DEPLOY_RUNS):
    """Median and all ms of ``runs`` calls, CUDA events around each call
    (the host's launch time shows where it exceeds the device's)."""
    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2], times


def fp32_logits(torch, model, ids):
    """Logits of ``model``'s weights (bf16 values) run in fp32."""
    import copy

    m32 = copy.deepcopy(model).float()
    out = m32(ids)
    del m32
    return out


def agreement(a, b):
    """Share of positions where the argmaxes of two logits agree."""
    return (a.argmax(-1) == b.argmax(-1)).float().mean().item()


def deploy_flagship(torch, fa, models, jit, inference, math_calls, tmp, smi, static):
    """Phase 15 (a) and (e): the flagship saved on the card, served by a
    Predictor from the saved program, its state dict through paddle.save."""
    cfg = models.LlamaConfig(**FLAGSHIP, dtype="bfloat16")
    L, B, S = cfg.num_hidden_layers, 8, 128
    gc.collect()
    torch.cuda.empty_cache()
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    prefix = os.path.join(tmp, "flagship")
    t0 = time.perf_counter()
    jit.save(model, prefix, input_spec=[jit.InputSpec([B, S], "int64", "input_ids")])
    save_s = time.perf_counter() - t0
    sizes = {ext: os.path.getsize(prefix + ext) for ext in (".pdmodel", ".pdiparams")}
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    config = inference.Config(prefix)
    config.enable_use_gpu(device_id=0, precision=inference.PrecisionType.Bfloat16)
    config.exp_set_warmup_shapes([((B, S), "int64")])
    t0 = time.perf_counter()
    pred = inference.create_predictor(config)
    create_s = time.perf_counter() - t0
    ops = graph_ops(pred._fn._program)
    n_fwd = sum(t.startswith("paddle_tpu_torch.flash_attention_fwd") for t in ops)
    softmax = [t for t in ops if "softmax" in t]
    if n_fwd != L or softmax:
        fail(f"the saved flagship holds {n_fwd} flash_attention_fwd nodes (want {L}) "
             f"and softmax nodes {softmax}")
    if pred._warmed_shapes != [(B, S)] or pred.compiles < 1:
        fail(f"the Predictor warmed {pred._warmed_shapes} with {pred.compiles} compiles")
    gen = torch.Generator(device="cuda").manual_seed(7)
    ids = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", generator=gen)
    handle = pred.get_input_handle(pred.get_input_names()[0])
    handle.share_external_data(ids)
    compiles = pred.compiles
    torch.cuda.synchronize()
    reset_counts(fa)
    math_calls[0] = 0
    pred.run()
    torch.cuda.synchronize()
    launched = counts(fa)
    extra = (math_calls[0], fa.copies_for_alignment, fa.pads_for_head_dim,
             pred.compiles - compiles)
    if launched != (L, 0, 0) or extra != (0, 0, 0, 0):
        fail(f"a Predictor.run launched (fwd, dq, dk/dv) = {launched}, want {(L, 0, 0)}; "
             f"math path, alignment copies, pads, compiles = {extra}, want zeros")
    logits = pred.get_output_handle("output_0")._value
    if logits.shape != (B, S, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        fail(f"the Predictor's logits are misshapen or not finite: {tuple(logits.shape)}")
    with torch.no_grad():
        eager = model(ids)
        as_saved = pred._fn(ids)          # the loaded program, not compiled
        ref = fp32_logits(torch, model, ids)
    if not torch.equal(as_saved, eager):
        fail(f"the loaded program's logits differ from eager's by "
             f"{norm_rel(as_saved, eager)} (norm-relative); they must be equal")
    acc = dict(predictor_vs_eager=norm_rel(logits, eager),
               predictor_vs_fp32=norm_rel(logits, ref), eager_vs_fp32=norm_rel(eager, ref),
               argmax_predictor_eager=agreement(logits, eager),
               argmax_predictor_fp32=agreement(logits, ref),
               argmax_eager_fp32=agreement(eager, ref), ref_factor=DEPLOY_REF_FACTOR,
               argmax_slack=DEPLOY_ARGMAX_SLACK, loaded_program_equals_eager=True)
    if not (acc["predictor_vs_fp32"] <= DEPLOY_REF_FACTOR * acc["eager_vs_fp32"]
            and acc["argmax_predictor_fp32"] >= acc["argmax_eager_fp32"] - DEPLOY_ARGMAX_SLACK):
        fail(f"the Predictor's logits are farther from the fp32 run than eager's: {acc}")
    host = pred.run([ids.cpu().numpy()])[0]
    if host.shape != (B, S, cfg.vocab_size) or host.dtype.name != "float32":
        fail(f"Predictor.run(inputs) gave {host.dtype} {host.shape}")
    def eager_fwd():
        with torch.no_grad():
            return model(ids)

    run_ms, run_all = timed_runs(torch, pred.run)
    eager_ms, eager_all = timed_runs(torch, eager_fwd)
    # device ms by kernel group and idle share of one call each; the
    # to_static forward's from phase 14 (f), the same model and ids
    profiles = dict(predictor=profile_step(torch, pred.run, run_ms),
                    to_static=static["profile"],
                    eager=profile_step(torch, eager_fwd, eager_ms))
    if pred.compiles != compiles:
        fail(f"the timed runs compiled {pred.compiles - compiles} graphs")
    out = dict(batch=B, seq=S, layers=L, dtype="bfloat16", save_s=save_s,
               load_s=pred.load_s, compile_s=pred.warmup_s, create_s=create_s,
               pdmodel_bytes=sizes[".pdmodel"], pdiparams_bytes=sizes[".pdiparams"],
               weight_bytes=weight_bytes, flash_nodes=n_fwd,
               launches_per_run=dict(fwd=launched[0], bwd_dq=launched[1], bwd_dkv=launched[2]),
               math_path_calls=extra[0], alignment_copies=extra[1], pads=extra[2],
               compiles_at_run=extra[3], accuracy=acc,
               run_ms=run_ms, run_ms_all=run_all, eager_ms=eager_ms, eager_ms_all=eager_all,
               to_static_ms=static["ms"], to_static_ms_all=static["ms_all"],
               to_static_compile_s=static["compile_s"], profiles=profiles,
               assert_nodes=sum("_assert_tensor_metadata" in t for t in ops),
               timing=f"CUDA events around each call, median of {DEPLOY_RUNS}", card=smi)
    del pred, logits, eager, host, as_saved, ref
    out["state_dict"] = state_dict_round_trip(torch, models, model, ids, cfg, tmp)
    del model
    return out


def state_dict_round_trip(torch, models, model, ids, cfg, tmp):
    """Phase 15 (e): the flagship's state dict through paddle_tpu_torch.save
    and load, bit for bit, and into a fresh model: logits bit for bit."""
    import paddle_tpu_torch as pt

    path = os.path.join(tmp, "flagship.pdparams")
    sd = model.state_dict()
    t0 = time.perf_counter()
    pt.save(sd, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = pt.load(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    bad = [k for k, v in sd.items()
           if back[k].dtype != v.dtype or back[k].device != v.device
           or not torch.equal(back[k].view(torch.int16), v.view(torch.int16))]
    if sorted(back) != sorted(sd) or bad:
        fail(f"paddle.save/load of the flagship changed {bad or sorted(set(back) ^ set(sd))}")
    fresh = models.LlamaForCausalLM(cfg, device="cuda", seed=1)
    fresh.load_state_dict(back)
    with torch.no_grad():
        same = torch.equal(fresh(ids), model(ids))
    if not same:
        fail("a model loaded from the flagship's paddle.save file gives other logits")
    out = dict(bytes=os.path.getsize(path), tensors=len(sd), save_s=save_s, load_s=load_s,
               bit_exact=True, logits_bit_exact=same)
    os.remove(path)
    del fresh, back
    return out


def deploy_fp32(torch, fa, models, jit, tmp):
    """Phase 15 (b) and (c): 2 layers in fp32 at S128 saved on the card and
    from a CPU twin; the CPU program refused on the card."""
    import copy

    cfg = models.LlamaConfig(**dict(FLAGSHIP, num_hidden_layers=2), dtype="float32")
    gpu = models.LlamaForCausalLM(cfg, device="cuda", seed=3)
    cpu = copy.deepcopy(gpu).to("cpu")
    spec = [jit.InputSpec([2, 128], "int64", "input_ids")]
    jit.save(gpu, os.path.join(tmp, "fp32_card"), input_spec=spec)
    jit.save(cpu, os.path.join(tmp, "fp32_cpu"), input_spec=spec)
    on_card = jit.load(os.path.join(tmp, "fp32_card"))
    on_cpu = jit.load(os.path.join(tmp, "fp32_cpu"), device="cpu")
    card_ops, cpu_ops = graph_ops(on_card._program), graph_ops(on_cpu._program)
    n_card = sum(t.startswith("paddle_tpu_torch.flash_attention_fwd") for t in card_ops)
    n_cpu = sum(t.startswith("paddle_tpu_torch.flash_attention_fwd") for t in cpu_ops)
    if n_card != 2 or n_cpu != 0:
        fail(f"fp32 programs hold {n_card} (card) and {n_cpu} (CPU) flash_attention_fwd "
             "nodes, want 2 and 0")
    gen = torch.Generator(device="cpu").manual_seed(11)
    ids = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen)
    torch.cuda.synchronize()
    before = fa.launches
    lg = on_card(ids)
    torch.cuda.synchronize()
    launched = fa.launches - before
    lc = on_cpu(ids)
    with torch.no_grad():
        eg, ec = gpu(ids.cuda()), cpu(ids)
    err = (lg.cpu() - lc).abs().max().item()
    err_card, err_cpu = norm_rel(lg, eg), norm_rel(lc, ec)
    if launched != 2:
        fail(f"the fp32 program on the card launched the kernel {launched} times, want 2")
    if not (math.isfinite(err) and err <= TOL_E2E_LOGITS):
        fail(f"fp32 programs, card against CPU: {err} > {TOL_E2E_LOGITS}")
    if not (err_card <= TOL_DEPLOY_FP32 and err_cpu <= TOL_DEPLOY_FP32):
        fail(f"fp32 programs against their eager models: card {err_card}, CPU {err_cpu} "
             f"> {TOL_DEPLOY_FP32}")
    refused = []
    for what, call in (("jit.load", lambda: jit.load(os.path.join(tmp, "fp32_cpu"))),
                       ("jit.load(device='cuda')",
                        lambda: jit.load(os.path.join(tmp, "fp32_cpu"), device="cuda"))):
        try:
            call()
        except RuntimeError as e:
            if "exported for cpu" not in str(e):
                fail(f"{what} of a CPU program raised another error: {e}")
            refused.append(what)
        else:
            fail(f"{what} ran a CPU program on the card")
    del gpu, cpu, on_card, on_cpu
    return dict(layers=2, shape=[2, 128], launches_card=launched,
                card_vs_cpu_max_abs_err=err, tol=TOL_E2E_LOGITS,
                card_vs_eager_norm_rel=err_card, cpu_vs_eager_norm_rel=err_cpu,
                tol_eager=TOL_DEPLOY_FP32, cpu_program_refused_on_card=refused)


def deploy_axpy_start(axpy, jit, tmp, root):
    """Phase 15 (d): a function calling the registered axpy op, saved on the
    card, then reloaded in a fresh interpreter that imports only
    paddle_tpu_torch.jit (started here, read by ``deploy_axpy_check``; it
    runs while the flagship is saved and compiled)."""
    op = axpy.register_example(name="chip_smoke_axpy_deploy")
    n = 2 ** 20 + 3
    prefix = os.path.join(tmp, "axpy")
    jit.save(lambda x: op(x), prefix, input_spec=[jit.InputSpec([n], "float32", "x")],
             device="cuda")
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.Popen([sys.executable, "-c", AXPY_DEPLOY_CODE, prefix, str(n)],
                            cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, n


def deploy_axpy_check(proc, n):
    """Phase 15 (d), read: one launch a call, bit for bit 2x + 1."""
    try:
        stdout, stderr = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail("the saved axpy function did not finish in a fresh interpreter")
    if proc.returncode != 0:
        fail(f"the saved axpy function did not run in a fresh interpreter:\n{stderr[-3000:]}")
    res = json.loads(stdout.strip().splitlines()[-1])
    if res["ops"].count("paddle_tpu_torch.axpy.default") != 1:
        fail(f"the saved axpy function's graph calls {res['ops']}")
    if res["launches"] != res["calls"] or not res["bit_exact"]:
        fail(f"the reloaded axpy function: {res}")
    return dict(numel=n, calls=res["calls"], launches=res["launches"],
                launches_per_call=res["launches"] // res["calls"], bit_exact=True,
                fresh_interpreter=True)


def phase_deploy(torch, fa, axpy, models, jit, inference, port_F, smi, root, static):
    """Phase 15: the deploy path (module docstring); ``static`` is phase 14
    (f)'s to_static forward, the yardstick of the Predictor's run."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    proc = None
    try:
        proc, n = deploy_axpy_start(axpy, jit, tmp, root)
        math_calls = count_math_path(port_F)
        out = dict(flagship=deploy_flagship(torch, fa, models, jit, inference, math_calls,
                                            tmp, smi, static))
        print("deploy_flagship " + json.dumps(out["flagship"]), flush=True)
        out["fp32"] = deploy_fp32(torch, fa, models, jit, tmp)
        out["axpy"] = deploy_axpy_check(proc, n)
        print("deploy_checks " + json.dumps(dict(fp32=out["fp32"], axpy=out["axpy"])),
              flush=True)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# phase 16: mixed precision through the op dispatch (paddle.amp), phase 6's
# cell trained with the PaddlePaddle AMP recipe. (d) holds 2 layers at the
# flagship width on the card (kernels, cuBLAS) against a CPU twin (plain
# versions) under the same auto_cast: both round the same products and
# attention outputs to the low dtype, each with its own summation order, so a
# value on a rounding boundary may land one low-dtype step apart; the
# float32 cross-entropy of those logits then agrees to a fraction of that
# step. TOL_AMP_LOSS is op_test's low-dtype bound: 2**-6 of the loss for
# bf16 (8 mantissa bits) and 2**-8 for fp16 (11), each several times what a
# one-step flip in every logit could move a mean over 128 tokens.
TOL_AMP_LOSS = {"bfloat16": 2e-2, "float16": 5e-3}
AMP_SCALE = 2.0 ** 15      # GradScaler's init_loss_scaling in (c)
AMP_OVERFLOW_SCALE = 2.0 ** 40   # (c)'s drill: overflows every fp16 gradient
AMP_SECONDS = 150          # phase 16's share of the script's time
DISPATCH_CALLS = 10000     # (e): host time of a dispatched op, per call


def op_stats_step(torch, dbg, step):
    """``step()`` with the operator stats collected: its table."""
    dbg.enable_operator_stats_collection()
    try:
        step()
    finally:
        table = dbg._OP_STATS[0]
        dbg._OP_STATS[0] = None
    return dict(table or {})


def amp_variant(torch, fa, models, T, name, level, dtype, math_calls, smi, decorate=False,
                scaler=False, warm=2, timed=5):
    """Phase 6's cell (flagship, 8 layers, B8 S2048, full recompute) built
    in float32 and trained with ``auto_cast(level, dtype)``: AdamW on the
    float32 parameters (``decorate``: O2's bf16 parameters with float32
    masters; ``scaler``: a GradScaler). Step 1 is counted (launch counters
    and the operator stats), then ``warm`` steps, ``timed`` timed ones and
    one profiled. Returns the records and, for (c), the live objects."""
    cfg = models.LlamaConfig(**FLAGSHIP, dtype="float32", recompute=True,
                             recompute_granularity="full")
    L, B, S = cfg.num_hidden_layers, 8, 2048
    low = getattr(torch, dtype)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    model.train()
    opt = T.optimizer.AdamW(learning_rate=TRAIN_LR, parameters=model.parameters())
    if decorate:
        T.amp.decorate(model, opt, level="O2", dtype=dtype)
        kinds = {str(p.dtype) for p in model.parameters()}
        if kinds != {str(low)} or not opt._multi_precision:
            fail(f"{name}: decorate left parameters {kinds}, masters {opt._multi_precision}")
    gs = T.amp.GradScaler(init_loss_scaling=AMP_SCALE) if scaler else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", generator=gen)
    scales = []

    def step():
        with T.amp.auto_cast(level=level, dtype=dtype):
            loss, _ = model(ids, labels=labels)
        if gs is None:
            loss.backward()
            opt.step()
        else:
            gs.scale(loss).backward()
            gs.step(opt)
            gs.update()
            scales.append(gs._scale)
        opt.clear_grad()
        return loss

    torch.cuda.synchronize()
    reset_counts(fa)
    math_calls[0] = 0
    box = []
    table = op_stats_step(torch, T.amp.debugging, lambda: box.append(step()))
    torch.cuda.synchronize()
    per_step = counts(fa)
    first = box[0].float().item()
    want_col = {"float16": 0, "bfloat16": 1}[dtype]
    want_attn = [0, 0, 0, 0]
    want_attn[want_col] = 2 * L     # forward and recompute
    if per_step != (2 * L, L, L):
        fail(f"{name}: a step launched (fwd, dq, dk/dv) = {per_step}, want {(2 * L, L, L)}")
    if table.get("flash_attention") != want_attn:
        fail(f"{name}: flash_attention calls by dtype {table.get('flash_attention')}, "
             f"want {want_attn} ({dtype} kernel inputs)")
    if math_calls[0] or fa.copies_for_alignment or fa.pads_for_head_dim:
        fail(f"{name}: {math_calls[0]} math-path calls, {fa.copies_for_alignment} alignment "
             f"copies, {fa.pads_for_head_dim} pads")
    for _ in range(warm):
        step()
    times = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = sorted(times)[len(times) // 2]
    last = loss.float().item()
    profile = profile_step(torch, step, step_ms, kernel_groups=(
        ("cast_kernel", "casts"), ("copy_kernel", "casts")) + _KERNEL_GROUPS)
    if not (math.isfinite(first) and math.isfinite(last) and last < first):
        fail(f"{name}: the loss did not fall: {first} -> {last}")
    n_params = sum(p.numel() for p in model.parameters())
    n_embed = model.llama.embed_tokens.weight.numel()
    flops = 6.0 * (n_params - n_embed) * B * S + 6.0 * L * B * S * S * cfg.hidden_size
    out = dict(level=level, dtype=dtype, decorate=decorate, step_ms=step_ms,
               step_ms_all=times, tokens_per_sec=B * S / (step_ms / 1e3),
               mfu=flops / (step_ms / 1e3) / PEAK_TC_FLOPS,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               loss_first=first, loss_last=last,
               launches_per_step=dict(fwd=per_step[0], bwd_dq=per_step[1],
                                      bwd_dkv=per_step[2]),
               op_stats_first_step={k: table[k] for k in sorted(table)},
               math_path_calls=0, param_dtypes=sorted({str(p.dtype).removeprefix("torch.")
                                                       for p in model.parameters()}),
               steps=1 + warm + timed + 1, profile=profile, card=smi)
    if scaler:
        out["scales"] = scales
    return out, (model, opt, gs, step, ids, labels)


def host_reads(torch, fn):
    """Where ``fn()`` waited on the card: torch's sync debug mode warns once
    per synchronizing call; for each, the innermost Python frames (function
    and file:line) that called it."""
    import traceback
    import warnings

    waits = []

    def show(message, category, filename, lineno, file=None, line=None):
        frames = traceback.extract_stack()[:-1][-4:]
        # the probe's own switch back to mode 0 warns once: not a wait
        if "synchroniz" in str(message) and not any(
                f.name == "set_sync_debug_mode" for f in frames):
            waits.append(" < ".join(f"{f.name} {os.path.basename(f.filename)}:{f.lineno}"
                                    for f in reversed(frames)))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return waits


def overflow_drills(torch, T, live, name):
    """(c): one fp16 step whose loss scale overflows every gradient, and one
    with an inf put in one gradient: each must be skipped with the
    parameters, the AdamW moments and the step count unchanged bit for bit,
    and the scale halved; then a normal step trains."""
    model, opt, gs, step, ids, labels = live

    def snapshot():
        return ([p.detach().clone() for p in model.parameters()],
                [{k: v.clone() for k, v in opt._accumulators[id(p)].items()}
                 for p in model.parameters()], opt._step_count)

    def unchanged(before):
        params, moments, count = before
        same = all(torch.equal(p.detach(), q) for p, q in zip(model.parameters(), params))
        same = same and all(torch.equal(v, m[k]) for p, m in zip(model.parameters(), moments)
                            for k, v in opt._accumulators[id(p)].items())
        return same and opt._step_count == count

    def scaled_backward():
        with T.amp.auto_cast(level="O1", dtype="float16"):
            loss, _ = model(ids, labels=labels)
        gs.scale(loss).backward()
        return loss

    out = {}
    resume = gs._scale
    for drill in ("scale_2_40", "inf_in_one_gradient"):
        before = snapshot()
        if drill == "scale_2_40":
            gs.set_init_loss_scaling(AMP_OVERFLOW_SCALE)
        start = gs._scale
        scaled_backward()
        q = model.llama.layers[0].self_attn.q_proj.weight
        if drill == "inf_in_one_gradient":
            q.grad[0, 0] = float("inf")
        nonfinite = sum(not bool(torch.isfinite(p.grad).all()) for p in model.parameters())
        # layer 0's q projection takes its gradient through the fp16
        # attention backward kernels: an overflow must reach it non-finite
        q_finite = bool(torch.isfinite(q.grad).all())
        gs.unscale_(opt)
        found = gs._found_inf
        gs.step(opt)
        gs.update()
        opt.clear_grad()
        if not found or not unchanged(before):
            fail(f"{name} {drill}: found_inf {found}, state unchanged {unchanged(before)}")
        if gs._scale != start / 2:
            fail(f"{name} {drill}: scale {start} -> {gs._scale}, want it halved")
        if drill == "scale_2_40" and q_finite:
            fail(f"{name}: at scale 2**40 the attention backward gave a finite q_proj gradient")
        out[drill] = dict(found_inf=found, scale_before=start, scale_after=gs._scale,
                          nonfinite_grads=nonfinite, params=len(list(model.parameters())),
                          q_proj_layer0_finite=q_finite, skipped_bit_for_bit=True)
        if drill == "scale_2_40":
            gs.set_init_loss_scaling(resume)
    before = snapshot()
    loss = step()
    if gs._cached_found_inf or unchanged(before) or not math.isfinite(loss.float().item()):
        fail(f"{name}: the step after the drills did not train (found_inf "
             f"{gs._cached_found_inf}, loss {loss.float().item()})")
    out["next_step"] = dict(trained=True, loss=loss.float().item(), scale=gs._scale)
    return out


def amp_card_vs_cpu(torch, fa, models, T):
    """(d): 2 layers at the flagship width, float32 parameters, B1 S128, on
    the card and as a CPU twin, under O1 bf16, O2 bf16 and O1 fp16: the
    forward's operator-stats tables equal, the losses within TOL_AMP_LOSS
    (forward only: the CPU's low-dtype products take seconds each)."""
    import copy

    cfg = models.LlamaConfig(**dict(FLAGSHIP, num_hidden_layers=2), dtype="float32")
    gpu = models.LlamaForCausalLM(cfg, device="cuda", seed=7)
    cpu = copy.deepcopy(gpu).to("cpu")
    gpu.train()
    cpu.train()
    gen = torch.Generator(device="cpu").manual_seed(17)
    ids = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen)
    out = {}
    for level, dtype in (("O1", "bfloat16"), ("O2", "bfloat16"), ("O1", "float16")):
        losses, tables = [], []
        reset_counts(fa)
        seconds = []
        for model, dev in ((gpu, "cuda"), (cpu, "cpu")):
            def run():
                with torch.no_grad(), T.amp.auto_cast(level=level, dtype=dtype):
                    loss, _ = model(ids.to(dev), labels=labels.to(dev))
                losses.append(loss.float().item())
            t0 = time.perf_counter()
            tables.append(op_stats_step(torch, T.amp.debugging, run))
            seconds.append(time.perf_counter() - t0)
        launched = counts(fa)
        err = abs(losses[0] - losses[1]) / abs(losses[1])
        key = f"{level}_{dtype}"
        if tables[0] != tables[1]:
            fail(f"card vs CPU {key}: operator stats differ: {tables[0]} vs {tables[1]}")
        if not (math.isfinite(err) and err <= TOL_AMP_LOSS[dtype]):
            fail(f"card vs CPU {key}: losses {losses}, relative {err}")
        if launched != (2, 0, 0):
            fail(f"card vs CPU {key}: the card launched {launched}, want (2, 0, 0)")
        out[key] = dict(losses=losses, rel_err=err, tol=TOL_AMP_LOSS[dtype],
                        op_stats_equal=True, ops=len(tables[0]), launches=list(launched),
                        flash_attention=tables[0].get("flash_attention"),
                        card_s=seconds[0], cpu_s=seconds[1])
    del gpu, cpu
    return out


def dispatch_us(torch, T):
    """The host microseconds of ``T.add`` on two 1024-element tensors on the
    card and of ``torch.add`` on the same, each the median of DISPATCH_CALLS
    timed calls, the two calls alternated (the host's load drifts, and a
    block of one after a block of the other reads the drift), and their
    difference: what the dispatch costs an op."""
    a = torch.randn(1024, device="cuda")
    b = torch.randn(1024, device="cuda")
    fns = (T.add, torch.add)
    for _ in range(200):
        for fn in fns:
            fn(a, b)
    torch.cuda.synchronize()
    ts = ([], [])
    for _ in range(DISPATCH_CALLS):
        for fn, out in zip(fns, ts):
            t0 = time.perf_counter_ns()
            fn(a, b)
            out.append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    dispatched, plain = (sorted(t)[len(t) // 2] / 1e3 for t in ts)
    return dict(dispatched_add_us=dispatched, torch_add_us=plain,
                dispatch_us=dispatched - plain)


def dispatch_cost(torch, T, models, AdamW, fa, smi):
    """(e): the host microseconds of one dispatched op (``T.add`` on two
    1024-element tensors on the card, AMP off) against the same torch call,
    the median of DISPATCH_CALLS timed calls each; and phase 6's eager step
    with the model's ops on the dispatch against the same step with the
    dispatch bypassed (each op's function called directly), alternated,
    each with a profiled step's idle share."""
    from paddle_tpu_torch.ops import _apply

    calls = dispatch_us(torch, T)
    cfg = models.LlamaConfig(**FLAGSHIP, dtype="bfloat16", recompute=True,
                             recompute_granularity="full")
    gc.collect()
    torch.cuda.empty_cache()
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    model.train()
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(), multi_precision=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (8, 2048), device="cuda", generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (8, 2048), device="cuda", generator=gen)
    dispatch = _apply.apply

    def bypass(opdef, *args, **kwargs):
        return opdef.fn(*args, **kwargs)

    def step():
        loss, _ = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()

    times = {"dispatch": [], "bypass": []}
    try:
        for _ in range(2):
            step()
        for mode in ("dispatch", "bypass", "bypass", "dispatch") * 2:
            _apply.apply = dispatch if mode == "dispatch" else bypass
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                times[mode].append((time.perf_counter() - t0) * 1e3)
        med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        profiles = {}
        for mode in ("dispatch", "bypass"):
            _apply.apply = dispatch if mode == "dispatch" else bypass
            p = profile_step(torch, step, med[mode])
            profiles[mode] = dict(idle_share=p["idle_share"], device_ms=p["device_ms"])
    finally:
        _apply.apply = dispatch
    del model, opt
    return dict(calls=calls, calls_timed=DISPATCH_CALLS, step_ms=med, step_ms_all=times,
                profiles=profiles, card=smi)


def phase_amp(torch, fa, models, T, AdamW, port_F, smi, eager):
    """Phase 16 (module docstring); ``eager`` is phase 6's result."""
    math_calls = count_math_path(port_F)
    out = {}
    for key, level, dtype, kw in (("o1_bf16", "O1", "bfloat16", {}),
                                  ("o2_bf16", "O2", "bfloat16", dict(decorate=True)),
                                  ("o1_fp16", "O1", "float16", dict(scaler=True))):
        t0 = time.perf_counter()
        row, live = amp_variant(torch, fa, models, T, key, level, dtype, math_calls, smi,
                                **kw)
        row["eager_bf16_step_ms"] = eager["step_ms"]
        row["step_ms_over_eager"] = row["step_ms"] / eager["step_ms"]
        row["eager_bf16_idle_share"] = eager["profile"]["idle_share"]
        if key == "o1_fp16":
            # the scaler reads one flag on the host a step (found_inf); the
            # whole step's waits are recorded with their places
            model, opt, gs = live[:3]
            row["host_reads_step"] = host_reads(torch, live[3])
            if len(row["host_reads_step"]) != 1:
                fail(f"{key}: a scaled step waited on the card at {row['host_reads_step']}, "
                     f"want once (the scaler's found_inf)")
            with T.amp.auto_cast(level="O1", dtype="float16"):
                loss, _ = model(live[4], labels=live[5])
            gs.scale(loss).backward()
            reads = host_reads(torch, lambda: (gs.step(opt), gs.update()))
            opt.clear_grad()
            if len(reads) != 1:
                fail(f"{key}: the scaler's step and update waited on the card at {reads}, "
                     f"want once")
            row["host_reads_scaler"] = reads
            row["drills"] = overflow_drills(torch, T, live, key)
        row["seconds"] = time.perf_counter() - t0
        print(f"amp_{key} " + json.dumps(row), flush=True)
        out[key] = row
        del live
    t0 = time.perf_counter()
    out["card_vs_cpu"] = amp_card_vs_cpu(torch, fa, models, T)
    out["card_vs_cpu"]["seconds"] = time.perf_counter() - t0
    print("amp_card_vs_cpu " + json.dumps(out["card_vs_cpu"]), flush=True)
    t0 = time.perf_counter()
    out["dispatch"] = dispatch_cost(torch, T, models, AdamW, fa, smi)
    out["dispatch"]["seconds"] = time.perf_counter() - t0
    print("amp_dispatch " + json.dumps(out["dispatch"]), flush=True)
    return out


MASTER_SECONDS = 180       # phase 17's share of the script's time
TOL_MASTER_GRAD = 2e-2     # (b): norm-relative per parameter, test_torch_amp's bf16 bound
# (b) with the card's attention on the kernels and the CPU's on the plain
# path: at this width the bf16 forward alone moves each run's master
# gradient 2.3-2.5% from the float32 gradient (measured on an H100,
# PERF.md); the kernels keep fp32 logits where the plain path rounds them to
# bf16, and the two runs part by about as much
TOL_MASTER_GRAD_KERNEL = 3e-2
MASTER_SCALE = 2.0 ** 15   # (b)'s drill starts at GradScaler's usual scale
TOL_TRANSFORMS = 1e-5      # (c): jacobian and hessian, card against CPU, norm-relative
SAMPLES = 2 ** 24          # (e): draws a moment is taken over
SAMPLER_SIGMAS = 6.0
# (e): relative reconstruction residual at n = 512: 32 n eps (a backward
# stable factorization's residual is O(n eps); cuSOLVER's fp32 SVD reads
# 1.7e-4 on an H100)
TOL_LINALG = {"float32": 32 * 512 * 2.0 ** -23, "float64": 32 * 512 * 2.0 ** -52}


def master_training(torch, fa, models, T, math_calls, smi, o2):
    """(a): phase 6's cell built in float32, decorate(O2, bf16, master_grad),
    AdamW with float32 masters: step 1 counted (every parameter a finite
    float32 master gradient), one more warm-up step, 3 timed with the port's
    Event pairs and one profiled; peak memory from the port's statistics."""
    cfg = models.LlamaConfig(**FLAGSHIP, dtype="float32", recompute=True,
                             recompute_granularity="full")
    L, B, S = cfg.num_hidden_layers, 8, 2048
    gc.collect()
    T.device.empty_cache()
    T.device.cuda.reset_max_memory_allocated()
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    model.train()
    opt = T.optimizer.AdamW(learning_rate=TRAIN_LR, parameters=model.parameters())
    T.amp.decorate(model, opt, level="O2", dtype="bfloat16", master_grad=True)
    if {p.dtype for p in model.parameters()} != {torch.bfloat16} or not opt._multi_precision:
        fail("master grad: decorate left the parameters or the masters wrong")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", generator=gen)

    def forward_backward():
        with T.amp.auto_cast(level="O2", dtype="bfloat16"):
            loss, _ = model(ids, labels=labels)
        loss.backward()
        return loss

    def step():
        loss = forward_backward()
        opt.step()
        opt.clear_grad()
        return loss

    T.device.synchronize()
    reset_counts(fa)
    math_calls[0] = 0
    first = forward_backward().float().item()
    T.device.synchronize()
    total, f32 = counts(fa), counts_f32(fa)
    bf16 = tuple(a - b for a, b in zip(total, f32))
    # the bf16 forward runs in the forward and the recompute; each layer's
    # attention pullback reruns in float32: the fp32 forward and both fp32
    # backward kernels, and no bf16 backward
    if bf16 != (2 * L, 0, 0) or f32 != (L, L, L):
        fail(f"master grad: a step launched bf16 {bf16} and fp32 {f32} (fwd, dq, dk/dv), "
             f"want {(2 * L, 0, 0)} and {(L, L, L)}")
    if math_calls[0] or fa.copies_for_alignment or fa.pads_for_head_dim:
        fail(f"master grad: {math_calls[0]} math-path calls, {fa.copies_for_alignment} "
             f"copies, {fa.pads_for_head_dim} pads")
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or p.grad.dtype != torch.float32
           or not bool(torch.isfinite(p.grad).all()) or not bool((p.grad != 0).any())]
    if bad:
        fail(f"master grad: parameters without a finite nonzero float32 gradient: {bad}")
    opt.step()
    opt.clear_grad()
    step()
    times = []
    for _ in range(3):
        t0, t1 = T.device.Event(enable_timing=True), T.device.Event(enable_timing=True)
        t0.record()
        loss = step()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    last = loss.float().item()
    if not (math.isfinite(first) and math.isfinite(last) and last < first):
        fail(f"master grad: the loss did not fall: {first} -> {last}")
    step_ms = sorted(times)[1]
    peak = T.device.max_memory_allocated()
    profile = profile_step(torch, step, step_ms, kernel_groups=(
        ("cast_kernel", "casts"), ("copy_kernel", "casts"),
        ("fa_fwd_tf32", "attention forward kernel (fp32)"),
        ("fa_bwd_dq_tf32", "attention dq kernel (fp32)"),
        ("fa_bwd_dkv_tf32", "attention dk/dv kernel (fp32)")) + _KERNEL_GROUPS)
    # the card ran the fp32 forward kernel once a layer in the profiled step
    fwd_tf32 = profile["launches_by_group"].get("attention forward kernel (fp32)", 0)
    if fwd_tf32 != L:
        fail(f"master grad: a profiled step ran {fwd_tf32} fa_fwd_tf32 kernels, want {L}")
    fwd_bf16 = fwd_bf16_records(torch, fa, T, step, profile)
    T.autograd.master_grad.set_master_grad(False)
    del model, opt
    return dict(step_ms=step_ms, step_ms_all=times, o2_bf16_step_ms=o2["step_ms"],
                step_ms_over_o2=step_ms / o2["step_ms"], tokens_per_sec=B * S / (step_ms / 1e3),
                peak_mem_gb=peak / 1e9, loss_first=first, loss_last=last,
                launches_per_step=dict(fwd=total[0], bwd_dq=total[1], bwd_dkv=total[2]),
                launches_bf16=dict(fwd=bf16[0], bwd_dq=bf16[1], bwd_dkv=bf16[2]),
                launches_f32=dict(fwd=f32[0], bwd_dq=f32[1], bwd_dkv=f32[2]),
                grads="float32, finite, nonzero", math_path_calls=0, steps=6,
                fa_fwd_tf32_kernels=fwd_tf32, fa_fwd_wgmma_records=fwd_bf16, profile=profile,
                card=smi)


def fwd_bf16_records(torch, fa, T, step, profile):
    """A master-grad step's bf16 forward launches (``fa_fwd_wgmma``) by
    three records (PERF.md's open question on 15 against 16): the launch
    counter and torch.profiler read directly (``key_averages()``, as
    ``profile_step`` reads it, with and without its nonzero-time filter, the
    raw device events, and the kernel launches without a device record) over
    one step, then the counter and the port's Profiler's device table over
    the next; ``profile`` is profile_step's group count over the step
    before."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from paddle_tpu_torch.profiler.profiler import _lost_launches

    def bf16_launches():
        return counts(fa)[0] - counts_f32(fa)[0]

    torch.cuda.synchronize()
    reset_counts(fa)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = [(e.key[:100], e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "fa_fwd_wgmma" in e.key]
    direct = dict(counter=bf16_launches(), key_averages=sum(c for _, c, _ in rows),
                  lost_launch_records=_lost_launches(prof.events(), (DeviceType.CUDA,), 0.0),
                  key_averages_nonzero=sum(c for _, c, t in rows if t > 0),
                  events=sum(1 for e in prof.events()
                             if e.device_type == DeviceType.CUDA and "fa_fwd_wgmma" in e.name),
                  rows=rows)
    reset_counts(fa)
    P = T.profiler
    with P.Profiler(targets=[P.ProfilerTarget.CPU, P.ProfilerTarget.GPU]) as p:
        step()
        counter = bf16_launches()
    res = p._last_result
    table = [(r["name"][:100], r["calls"]) for r in res.device_op_stats()
             if "fa_fwd_wgmma" in r["name"]]
    return dict(profile_step=profile["launches_by_group"].get("attention forward kernel"),
                torch_profiler=direct,
                port_profiler=dict(counter=counter, device_table=sum(c for _, c in table),
                                   rows=table, lost_device_records=res.lost_device_records))


def master_card_vs_cpu(torch, fa, models, T, port_F):
    """(b): 2 layers at the flagship width, float32 weights, B1 S128, one O2
    bf16 master-grad backward on a CPU twin and twice on the card: with the
    attention on the kernels, and with it on the plain math path as on the
    CPU. Every gradient float32; the math-path run within TOL_MASTER_GRAD of
    the CPU's (the same arithmetic on both), the kernel run within
    TOL_MASTER_GRAD_KERNEL; each run's distance to the card's float32
    gradient (float32 forward and backward) printed beside them."""
    import copy

    cfg = models.LlamaConfig(**dict(FLAGSHIP, num_hidden_layers=2), dtype="float32")
    base = models.LlamaForCausalLM(cfg, device="cuda", seed=7)
    base.train()
    gen = torch.Generator(device="cpu").manual_seed(17)
    ids = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen)

    def run(dev, master=True, kernel=True):
        model = copy.deepcopy(base).to(dev)
        if master:
            T.amp.decorate(model, level="O2", dtype="bfloat16", master_grad=True)
        use_kernel = port_F._use_kernel
        if not kernel:
            port_F._use_kernel = lambda q: False
        t0 = time.perf_counter()
        try:
            with T.amp.auto_cast(enable=master, level="O2", dtype="bfloat16"):
                loss, _ = model(ids.to(dev), labels=labels.to(dev))
            loss.backward()
        finally:
            port_F._use_kernel = use_kernel
            T.autograd.master_grad.set_master_grad(False)
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        return grads, time.perf_counter() - t0

    reset_counts(fa)
    fp32, _ = run("cuda", master=False)
    kern, card_s = run("cuda")
    launched = counts(fa)
    math_, _ = run("cuda", kernel=False)
    cpu, cpu_s = run("cpu")
    # the fp32 run: 2 layers, fp32 (2, 2, 2); the master run: bf16 (2, 0, 0)
    # and fp32 (2, 2, 2)
    if launched != (6, 4, 4) or counts_f32(fa) != (4, 4, 4):
        fail(f"master grad card vs CPU: the fp32 and master runs launched {launched} "
             f"(fp32 {counts_f32(fa)}), want (6, 4, 4) and (4, 4, 4)")

    def worst(a, b):
        return max(norm_rel(a[n], b[n]) for n in a)

    dtypes = {str(g.dtype) for gs in (kern, math_, cpu) for g in gs.values()}
    out = dict(math_path_vs_cpu=worst(math_, cpu), kernel_vs_cpu=worst(kern, cpu),
               kernel_vs_fp32=worst(kern, fp32), cpu_vs_fp32=worst(cpu, fp32),
               math_path_vs_fp32=worst(math_, fp32), tol=TOL_MASTER_GRAD,
               tol_kernel=TOL_MASTER_GRAD_KERNEL, params=len(cpu), grad_dtypes=sorted(dtypes),
               card_s=card_s, cpu_s=cpu_s)
    if dtypes != {"torch.float32"} or not (
            math.isfinite(out["math_path_vs_cpu"]) and out["math_path_vs_cpu"] <= TOL_MASTER_GRAD
            and out["kernel_vs_cpu"] <= TOL_MASTER_GRAD_KERNEL):
        fail(f"master grad card vs CPU: {out}")
    del base
    return out


def overflow_drill(torch, models, T):
    """(b): O2 fp16 at 2 layers, flagship width, B1 S128, a GradScaler: from
    2**15 the scale doubles until the fp16 pullback overflows without master
    grad (the scaler finds a non-finite gradient and skips the step: every
    parameter unchanged, the scale halved); at that scale, with master grad,
    every gradient is finite and the step is taken."""
    cfg = models.LlamaConfig(**dict(FLAGSHIP, num_hidden_layers=2), dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(3)
    ids = torch.randint(0, cfg.vocab_size, (1, 128), device="cuda", generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (1, 128), device="cuda", generator=gen)

    def drill(master, scale):
        model = models.LlamaForCausalLM(cfg, device="cuda", seed=11)
        model.train()
        opt = T.optimizer.AdamW(learning_rate=TRAIN_LR, parameters=model.parameters())
        T.amp.decorate(model, opt, level="O2", dtype="float16", master_grad=master)
        gs = T.amp.GradScaler(init_loss_scaling=scale)
        with T.amp.auto_cast(level="O2", dtype="float16"):
            loss, _ = model(ids, labels=labels)
        gs.scale(loss).backward()
        finite = all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())
        dtypes = sorted({str(p.grad.dtype).removeprefix("torch.") for p in model.parameters()})
        before = [p.detach().clone() for p in model.parameters()]
        gs.step(opt)
        gs.update()
        moved = any(not torch.equal(b, p) for b, p in zip(before, model.parameters()))
        T.autograd.master_grad.set_master_grad(False)
        return dict(master_grad=master, scale=scale, all_grads_finite=finite,
                    grad_dtypes=dtypes, found_inf=bool(gs._cached_found_inf),
                    step_taken=moved, scale_after=gs._scale)

    tries = []
    scale = MASTER_SCALE
    while True:
        plain = drill(False, scale)
        tries.append(plain)
        if not plain["all_grads_finite"] or scale >= 2.0 ** 24:
            break
        scale *= 2
    if plain["all_grads_finite"] or not plain["found_inf"] or plain["step_taken"] or \
            plain["scale_after"] != scale / 2:
        fail(f"overflow drill without master grad: {plain}")
    master = drill(True, scale)
    if not master["all_grads_finite"] or master["found_inf"] or not master["step_taken"] or \
            master["grad_dtypes"] != ["float32"]:
        fail(f"overflow drill with master grad: {master}")
    return dict(scale=scale, scales_tried=[t["scale"] for t in tries], without=plain,
                with_master_grad=master)


def transforms_on_card(torch, fa, T, tfunc):
    """(c): vjp of the flash_attention functional at bf16, B2 S2048 H16 D128,
    causal: one forward and one dq and dk/dv launch, cotangents and output
    equal torch.autograd.grad of the same call bit for bit; jacobian and
    hessian of a small function of the op surface, card against CPU."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(2, 2048, 16, 128, device="cuda", generator=gen).to(
        torch.bfloat16) for _ in range(4))

    def attn(q, k, v):
        return tfunc.flash_attention(q, k, v, causal=True)[0]

    torch.cuda.synchronize()
    reset_counts(fa)
    out, grads = T.autograd.vjp(attn, [q, k, v], do)
    torch.cuda.synchronize()
    launched = counts(fa)
    if launched != (1, 1, 1) or fa.copies_for_alignment or fa.pads_for_head_dim:
        fail(f"vjp of flash_attention launched {launched}, want (1, 1, 1)")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    ref_out = attn(*leaves)
    ref = torch.autograd.grad(ref_out, leaves, do)
    if not torch.equal(out, ref_out.detach()) or not all(
            torch.equal(a, b) for a, b in zip(grads, ref)):
        fail("vjp of flash_attention differs from torch.autograd.grad of the same call")
    del q, k, v, do, out, grads, leaves, ref_out, ref
    w_np = torch.randn(4, 3, generator=torch.Generator().manual_seed(9))
    x_np = torch.randn(2, 4, generator=torch.Generator().manual_seed(10))
    res = {}
    for dev in ("cuda", "cpu"):
        W, x = w_np.to(dev), x_np.to(dev)
        res[dev] = (
            T.autograd.jacobian(lambda x: T.tanh(T.matmul(x, W)), x),
            T.autograd.hessian(lambda x: T.add(T.sum(T.multiply(T.exp(x), T.sin(x))),
                                               T.sum(T.tanh(T.matmul(x, W)))), x))
    errs = dict(jacobian=norm_rel(res["cuda"][0].cpu(), res["cpu"][0]),
                hessian=norm_rel(res["cuda"][1].cpu(), res["cpu"][1]))
    if not all(math.isfinite(e) and e <= TOL_TRANSFORMS for e in errs.values()):
        fail(f"jacobian / hessian card against CPU: {errs}")
    return dict(vjp_launches=list(launched), vjp_bit_exact=True, shape=[2, 2048, 16, 128],
                dtype="bfloat16", card_vs_cpu=errs, tol=TOL_TRANSFORMS,
                jacobian_shape=list(res["cuda"][0].shape),
                hessian_shape=list(res["cuda"][1].shape))


def streams_and_memory(torch, fa, models, T, serving):
    """(d): phase 3's flagship generate on the default stream, then inside
    stream_guard of a new port Stream: the same tokens bit for bit, each
    timed with the port's Events beside phase 3's generate; the port's
    memory statistics against torch.cuda's."""
    cfg = models.LlamaConfig(**FLAGSHIP, dtype="bfloat16")
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (8, 128), device="cuda", generator=gen)
    new = 32
    engine = models.LlamaDecodeEngine(model, max_len=128 + new + 1)
    engine.generate(prompts, max_new_tokens=2)
    d = T.device
    default = d.current_stream()

    def timed():
        e0, e1 = d.Event(enable_timing=True), d.Event(enable_timing=True)
        e0.record()
        toks = engine.generate(prompts, max_new_tokens=new)
        e1.record()
        e1.synchronize()
        return toks, e0.elapsed_time(e1)

    toks0, ms0 = timed()
    side = d.Stream()
    if side.cuda_stream == default.cuda_stream:
        fail("device.Stream() gave the default stream")
    side.wait_stream(default)
    with d.stream_guard(side):
        if d.current_stream() != side:
            fail("stream_guard did not make its stream current")
        toks1, ms1 = timed()
    default.wait_stream(side)
    if d.current_stream() != default:
        fail("stream_guard did not put the default stream back")
    if not torch.equal(toks0, toks1):
        fail("generate inside stream_guard gave other tokens than on the default stream")
    del engine, model
    stats = dict(memory_allocated=(d.memory_allocated(), torch.cuda.memory_allocated()),
                 max_memory_allocated=(d.max_memory_allocated(),
                                       torch.cuda.max_memory_allocated()),
                 memory_reserved=(d.memory_reserved(), torch.cuda.memory_reserved()),
                 max_memory_reserved=(d.max_memory_reserved(),
                                      torch.cuda.max_memory_reserved()))
    if any(a != b for a, b in stats.values()) or d.memory_stats() != torch.cuda.memory_stats():
        fail(f"the port's memory statistics differ from torch.cuda's: {stats}")
    props = d.cuda.get_device_properties()
    if (d.cuda.get_device_name() != torch.cuda.get_device_name(0)
            or d.cuda.get_device_capability() != torch.cuda.get_device_capability(0)
            or d.cuda.device_count() != torch.cuda.device_count()):
        fail("device.cuda's name, capability or count differ from torch.cuda's")
    return dict(generate_ms_default_stream=ms0, generate_ms_side_stream=ms1,
                phase3_generate_ms=serving["generate_s"] * 1e3, tokens_equal=True,
                batch=8, prompt=128, new_tokens=new, memory_stats_equal=True,
                memory=stats, device_name=d.cuda.get_device_name(),
                capability=list(d.cuda.get_device_capability()),
                total_memory_gb=props.total_memory / 1e9)


def _moment_check(name, got, want, se):
    if not abs(got - want) <= SAMPLER_SIGMAS * se:
        fail(f"sampler {name}: {got}, want {want} within {SAMPLER_SIGMAS} x {se}")
    return dict(got=got, want=want, se=se)


def samplers_and_linalg(torch, T):
    """(e): the samplers on the card (a seeded draw twice gives the same
    values; the moments of SAMPLES draws within SAMPLER_SIGMAS standard
    errors; randperm(2**20) a permutation; multinomial without replacement
    distinct within each row) and cholesky, qr, svd, solve, lstsq, eigh and
    slogdet at 512 x 512 in float32 and float64, card and CPU each within
    TOL_LINALG of its own reconstruction, logdet card against CPU."""
    n = SAMPLES
    draws = dict(randn=lambda: T.randn([n]), rand=lambda: T.rand([n]),
                 randint=lambda: T.randint(0, 10, [n]),
                 normal=lambda: T.normal(2.0, 3.0, [n]),
                 bernoulli=lambda: T.bernoulli(torch.full((n,), 0.3, device="cuda")),
                 poisson=lambda: T.poisson(torch.full((n,), 4.0, device="cuda")),
                 exponential_=lambda: T.exponential_(torch.empty(n, device="cuda"), 2.0),
                 randperm=lambda: T.randperm(2 ** 20))
    seeded = {}
    for name, fn in draws.items():
        T.seed(1234)
        a = fn()
        T.seed(1234)
        b = fn()
        if a.device.type != "cuda" or not torch.equal(a, b):
            fail(f"sampler {name}: a seeded draw did not repeat on the card")
        seeded[name] = str(a.dtype).removeprefix("torch.")
    T.seed(99)
    moments = {}
    # (mean, variance, fourth central moment) of each distribution
    for name, fn, mean, var, mu4 in (
            ("randn", draws["randn"], 0.0, 1.0, 3.0),
            ("rand", draws["rand"], 0.5, 1 / 12, 1 / 80),
            ("normal", draws["normal"], 2.0, 9.0, 3 * 81.0),
            ("randint", draws["randint"], 4.5, 8.25, 8.25 ** 2 * 1.78),
            ("bernoulli", draws["bernoulli"], 0.3, 0.21, 0.21 * (1 - 3 * 0.21)),
            ("poisson", draws["poisson"], 4.0, 4.0, 4.0 * (1 + 3 * 4.0)),
            ("exponential_", draws["exponential_"], 0.5, 0.25, 9 * 0.5 ** 4)):
        x = fn().double()
        m = x.mean().item()
        v = x.var().item()
        moments[name] = dict(mean=_moment_check(name + " mean", m, mean, math.sqrt(var / n)),
                             var=_moment_check(name + " var", v, var,
                                               math.sqrt((mu4 - var ** 2) / n)))
    perm = T.randperm(2 ** 20)
    if not torch.equal(perm.sort().values, torch.arange(2 ** 20, device="cuda")):
        fail("randperm(2**20) is not a permutation")
    probs = torch.rand(64, 1000, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(1))
    picks = T.multinomial(probs, 100)
    distinct = all(len(set(r.tolist())) == 100 for r in picks)
    if not distinct or picks.shape != (64, 100) or picks.dtype != torch.int64:
        fail("multinomial without replacement repeated an index")
    linalg = {}
    for dt in ("float32", "float64"):
        dtype = getattr(torch, dt)
        g = torch.Generator().manual_seed(21)
        A = torch.randn(512, 512, generator=g, dtype=torch.float64)
        well = A / math.sqrt(512) + 4 * torch.eye(512, dtype=torch.float64)
        spd = A @ A.T / 512 + torch.eye(512, dtype=torch.float64)
        b = torch.randn(512, 8, generator=g, dtype=torch.float64)
        rows = {}
        for dev in ("cuda", "cpu"):
            a, w, s, rhs = (t.to(dev, dtype) for t in (A, well, spd, b))
            L = T.linalg.cholesky(s)
            Q, R = T.linalg.qr(a)
            U, S_, Vh = T.linalg.svd(a)
            x = T.linalg.solve(w, rhs)
            xl = T.linalg.lstsq(w, rhs)[0]
            ev, V = T.linalg.eigh(s)
            sl = T.linalg.slogdet(s)
            rel = lambda r, ref: ((r - ref).norm() / ref.norm()).item()  # noqa: E731
            rows[dev] = dict(cholesky=rel(L @ L.T, s), qr=rel(Q @ R, a),
                             svd=rel(U * S_ @ Vh, a), solve=rel(w @ x, rhs),
                             lstsq=rel(w @ xl, rhs), eigh=rel(V * ev @ V.T, s),
                             slogdet_sign=sl[0].item(), logdet=sl[1].item())
        for key in ("cholesky", "qr", "svd", "solve", "lstsq", "eigh"):
            for dev in ("cuda", "cpu"):
                if not rows[dev][key] <= TOL_LINALG[dt]:
                    fail(f"linalg {key} {dt} on {dev}: residual {rows[dev][key]}")
        logdet_rel = abs(rows["cuda"]["logdet"] - rows["cpu"]["logdet"]) / abs(
            rows["cpu"]["logdet"])
        if rows["cuda"]["slogdet_sign"] != 1.0 or not logdet_rel <= TOL_LINALG[dt]:
            fail(f"slogdet {dt}: card {rows['cuda']}, cpu {rows['cpu']}")
        linalg[dt] = dict(card=rows["cuda"], cpu=rows["cpu"], logdet_rel=logdet_rel,
                          tol=TOL_LINALG[dt])
    return dict(seeded_repeat=seeded, moments=moments, samples=n, sigmas=SAMPLER_SIGMAS,
                randperm_is_permutation=True, multinomial_distinct=True, linalg=linalg)


def phase_master(torch, fa, models, T, port_F, tfunc, smi, amp, serving):
    """Phase 17 (module docstring); ``amp`` is phase 16's result and
    ``serving`` phase 3's."""
    math_calls = count_math_path(port_F)
    out = {}
    for key, fn in (
            ("training", lambda: master_training(torch, fa, models, T, math_calls, smi,
                                                 amp["o2_bf16"])),
            ("card_vs_cpu", lambda: master_card_vs_cpu(torch, fa, models, T, port_F)),
            ("overflow", lambda: overflow_drill(torch, models, T)),
            ("transforms", lambda: transforms_on_card(torch, fa, T, tfunc)),
            ("streams", lambda: streams_and_memory(torch, fa, models, T, serving)),
            ("samplers_linalg", lambda: samplers_and_linalg(torch, T))):
        t0 = time.perf_counter()
        out[key] = fn()
        out[key]["seconds"] = time.perf_counter() - t0
        print(f"master_{key} " + json.dumps(out[key]), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return out


SURFACE_SECONDS = 120      # phase 18's share of the script's time
SURFACE_DRAWS = 2 ** 20    # (a): draws a sampler's moments are taken over
# (a): floating outputs, card against CPU: the CPU tests' tolerances
# (tests/test_torch_compat.py), rtol and atol, at the CPU tests' reduction
# lengths (16 terms at most: the card sums in another order)
TOL_SURFACE = (1e-5, 1e-6)
# (b): the fused rope tables against eager at S2048. inv_freq comes from pow,
# Inductor's on the card against CUDA's eager powf (each within 2 ulps), and
# the angle t * inv_freq carries that error times the position: four ulps
# (2**-23 relative each) of the largest angle, plus an ulp of cos and sin;
# bf16 tables round that to a bf16 ulp (2**-8) more
ROPE_S, ROPE_D = 2048, 128
TOL_FUSE_ROPE = {"float32": 4 * ROPE_S * 2.0 ** -23 + 2.0 ** -22,
                 "bfloat16": 4 * ROPE_S * 2.0 ** -23 + 2.0 ** -22 + 2.0 ** -8}


def surface_cases():
    """(a)'s cases: (name, function of the namespace and the inputs, input
    specs, "exact" or "float", in-place: None, "keep" (the op writes into
    its first argument's storage) or "swap" (its result, of another shape
    or dtype, takes the argument's place)). Specs: ("n", shape) normal float32,
    ("u", shape, lo, hi) uniform float32, ("i", shape, lo, hi) int64,
    ("b", shape) bool, ("a", array)."""
    def n(*s):
        return ("n", s)

    def u(s, lo, hi):
        return ("u", s, lo, hi)

    def i(s, lo, hi):
        return ("i", s, lo, hi)

    def b(*s):
        return ("b", s)

    E, F = "exact", "float"
    out = [
        ("add_n", lambda T, x, y, z: T.add_n([x, y, z]), [n(64, 64)] * 3, F),
        ("hstack", lambda T, x, y: T.hstack([x, y]), [n(8, 3), n(8, 5)], E),
        ("vstack", lambda T, x, y: T.vstack([x, y]), [n(5), n(3, 5)], E),
        ("row_stack", lambda T, x, y: T.row_stack([x, y]), [n(2, 4), n(1, 4)], E),
        ("column_stack", lambda T, x, y: T.column_stack([x, y]), [n(6), n(6, 2)], E),
        ("dstack", lambda T, x, y: T.dstack([x, y]), [n(4), n(1, 4, 3)], E),
        ("hsplit", lambda T, x: T.hsplit(x, [2, 5]), [n(4, 8)], E),
        ("vsplit", lambda T, x: T.vsplit(x, 2), [n(6, 3)], E),
        ("dsplit", lambda T, x: T.dsplit(x, [1]), [n(2, 2, 4)], E),
        ("block_diag", lambda T, x, y, z: T.block_diag([x, y, z]), [n(3, 3), n(2, 4), n(5)], E),
        ("cartesian_prod", lambda T, x, y: T.cartesian_prod([x, y]),
         [i((5,), 0, 9), i((4,), 0, 9)], E),
        ("combinations", lambda T, x: T.combinations(x, 3), [n(7)], E),
        ("combinations_replacement", lambda T, x: T.combinations(x, 2, with_replacement=True),
         [i((5,), 0, 9)], E),
        ("diagonal_scatter", lambda T, x, y: T.diagonal_scatter(x, y, offset=1),
         [n(64, 64), n(63)], E),
        ("select_scatter", lambda T, x, y: T.select_scatter(x, y, 1, -1), [n(32, 16), n(32)], E),
        ("slice_scatter", lambda T, x, y: T.slice_scatter(x, y, [1], [1], [9], [2]),
         [n(16, 12), n(16, 4)], E),
        ("take_raise_clips", lambda T, x, idx: T.take(x, idx), [n(32, 32), i((512,), -2000, 2000)],
         E),
        ("take_wrap", lambda T, x, idx: T.take(x, idx, mode="wrap"),
         [n(32, 32), i((512,), -3000, 3000)], E),
        ("unflatten", lambda T, x: T.unflatten(x, 1, [4, -1]), [n(8, 32)], E),
        ("unfold", lambda T, x: T.unfold(x, 1, 16, 8), [n(4, 128)], E),
        ("reverse", lambda T, x: T.reverse(x, [0, 1]), [n(8, 9)], E),
        ("matrix_transpose", lambda T, x: T.matrix_transpose(x), [n(4, 8, 16)], E),
        ("vecdot", lambda T, x, y: T.vecdot(x, y), [n(64, 16), n(64, 16)], F),
        ("tensordot", lambda T, x, y: T.tensordot(x, y, 2), [n(16, 4, 3), n(4, 3, 16)], F),
        ("cdist", lambda T, x, y: T.cdist(x, y), [n(64, 8), n(48, 8)], F),
        ("cdist_p1", lambda T, x, y: T.cdist(x, y, p=1.0), [n(64, 8), n(48, 8)], F),
        ("pdist", lambda T, x: T.pdist(x), [n(40, 4)], F),
        ("sinc", lambda T, x: T.sinc(x), [n(4096)], F),
        ("sgn", lambda T, x: T.sgn(x), [n(256)], E),
        ("signbit", lambda T, x: T.signbit(x), [n(256)], E),
        ("positive", lambda T, x: T.positive(x), [n(256)], E),
        ("frexp", lambda T, x: T.frexp(x), [n(256)], E),
        ("renorm", lambda T, x: T.renorm(x, 2.0, 0, 3.0), [n(16, 64)], F),
        ("cumulative_trapezoid", lambda T, y: T.cumulative_trapezoid(y, dx=0.25), [n(64, 8)], F),
        ("histogram_bin_edges", lambda T, x: T.histogram_bin_edges(x, bins=32), [n(4096)], F),
        ("isin", lambda T, x, t: T.isin(x, t, invert=True), [i((256,), 0, 64), i((16,), 0, 64)], E),
        ("isneginf", lambda T, x: T.isneginf(x),
         [("a", [-float("inf"), float("inf"), float("nan"), 1.0])], E),
        ("isposinf", lambda T, x: T.isposinf(x),
         [("a", [-float("inf"), float("inf"), float("nan"), 1.0])], E),
        ("isreal", lambda T, x: T.isreal(T.as_complex(x)), [n(64, 2)], E),
        ("is_empty", lambda T, x: T.is_empty(x), [n(0, 3)], E),
        ("as_complex", lambda T, x: T.as_complex(x), [n(64, 2)], E),
        ("as_real", lambda T, x: T.as_real(T.as_complex(x)), [n(64, 2)], E),
        ("gammaln", lambda T, x: T.gammaln(x), [u((1024,), 0.1, 8.0)], F),
        ("gammainc", lambda T, a, x: T.gammainc(a, x), [u((1024,), 0.5, 6.0),
                                                        u((1024,), 0.1, 8.0)], F),
        ("gammaincc", lambda T, a, x: T.gammaincc(a, x), [u((1024,), 0.5, 6.0),
                                                          u((1024,), 0.1, 8.0)], F),
        ("multigammaln", lambda T, x: T.multigammaln(x, 4), [u((1024,), 2.0, 9.0)], F),
        ("polygamma_0", lambda T, x: T.polygamma(x, 0), [u((1024,), 0.5, 6.0)], F),
        ("polygamma_2", lambda T, x: T.polygamma(x, 2), [u((1024,), 0.5, 6.0)], F),
        ("increment", lambda T, x: T.increment(x, 2.0), [n(64)], E),
        ("bitwise_invert", lambda T, x: T.bitwise_invert(x), [i((64,), -99, 99)], E),
        ("tolist", lambda T, x: T.to_tensor(T.tolist(x), place=x.device), [i((4, 5), 0, 9)], E),
    ]
    rows = [(name, fn, specs, kind, None) for name, fn, specs, kind in out]
    # the generated in-place family and the stragglers: each keeps its storage
    unary = {"abs_": n(256), "acos_": u((256,), -0.9, 0.9), "atan_": n(256), "cos_": n(256),
             "sin_": n(256), "sinh_": n(256), "tan_": u((256,), -1.0, 1.0), "tanh_": n(256),
             "digamma_": u((256,), 0.5, 4.0), "erf_": n(256), "expm1_": n(256),
             "frac_": n(256), "i0_": n(256), "lgamma_": u((256,), 0.5, 4.0),
             "log_": u((256,), 0.5, 4.0), "log10_": u((256,), 0.5, 4.0),
             "log2_": u((256,), 0.5, 4.0), "logit_": u((256,), 0.1, 0.9), "neg_": n(256),
             "square_": n(256), "trunc_": n(256), "gammaln_": u((256,), 0.5, 4.0),
             "sinc_": n(256), "nan_to_num_": ("a", [float("nan"), 1.0, float("inf"), -2.0])}
    for name, spec in unary.items():
        rows.append((name, lambda T, x, _n=name: getattr(T, _n)(x), [spec], F, "keep"))
    binary_f = {"copysign_": (n(256), n(256)), "hypot_": (n(256), n(256)),
                "pow_": (u((256,), 0.5, 2.0), n(256)), "remainder_": (n(256), u((256,), 0.5, 2.0)),
                "gammainc_": (u((256,), 0.5, 4.0), u((256,), 0.5, 4.0)),
                "gammaincc_": (u((256,), 0.5, 4.0), u((256,), 0.5, 4.0)),
                "ldexp_": (n(256), i((256,), -3, 4))}
    for name, specs in binary_f.items():
        rows.append((name, lambda T, x, y, _n=name: getattr(T, _n)(x, y), list(specs), F, "keep"))
    binary_i = {"bitwise_and_": (-99, 99), "bitwise_or_": (-99, 99), "bitwise_xor_": (-99, 99),
                "gcd_": (1, 60), "lcm_": (1, 12), "floor_divide_": (1, 9),
                "floor_mod_": (1, 9), "mod_": (1, 9), "bitwise_left_shift_": (0, 4),
                "bitwise_right_shift_": (0, 4)}
    for name, (lo, hi) in binary_i.items():
        rows.append((name, lambda T, x, y, _n=name: getattr(T, _n)(x, y),
                     [i((256,), 0 if "shift" in name else -99, 99), i((256,), lo, hi)], E, "keep"))
    rows += [
        ("bitwise_not_", lambda T, x: T.bitwise_not_(x), [i((64,), -99, 99)], E, "keep"),
        ("bitwise_invert_", lambda T, x: T.bitwise_invert_(x), [i((64,), -99, 99)], E, "keep"),
        ("cumsum_", lambda T, x: T.cumsum_(x, 1), [n(64, 8)], F, "keep"),
        ("cumprod_", lambda T, x: T.cumprod_(x, 0), [u((8, 16), 0.5, 1.5)], F, "keep"),
        ("multigammaln_", lambda T, x: T.multigammaln_(x, 3), [u((256,), 2.0, 6.0)], F, "keep"),
        ("polygamma_", lambda T, x: T.polygamma_(x, 1), [u((256,), 0.5, 4.0)], F, "keep"),
        ("tril_", lambda T, x: T.tril_(x, -1), [n(16, 16)], E, "keep"),
        ("triu_", lambda T, x: T.triu_(x, 2), [n(16, 16)], E, "keep"),
        ("masked_fill_", lambda T, x, m: T.masked_fill_(x, m, 7.0), [n(16, 16), b(16, 16)], E,
         True),
        ("masked_scatter_", lambda T, x, m, v: T.masked_scatter_(x, m, v),
         [n(16, 16), b(16, 16), n(256)], E, "keep"),
        ("addmm_", lambda T, c, x, y: T.addmm_(c, x, y, beta=0.5, alpha=2.0),
         [n(32, 32), n(32, 8), n(8, 32)], F, "keep"),
        ("renorm_", lambda T, x: T.renorm_(x, 2.0, 1, 2.0), [n(16, 32)], F, "keep"),
        ("index_add_", lambda T, x, idx, v: T.index_add_(x, idx, 0, v),
         [n(16, 8), i((32,), 0, 16), n(32, 8)], F, "keep"),
        ("index_put_", lambda T, x, idx, v: T.index_put_(x, (idx,), v),
         [n(16, 8), ("a", list(range(0, 16, 3))), n(6, 8)], E, "keep"),
        ("index_fill_", lambda T, x, idx: T.index_fill_(x, idx, 1, -3.0),
         [n(16, 8), ("a", [0, 5, 7])], E, "keep"),
    ]
    # shape- and dtype-changing members (cast_, flatten_, the comparisons, ...)
    # take the result's place: no storage to keep
    for name, fn, specs in (
            ("cast_", lambda T, x: T.cast_(x, "int32"), [n(64)]),
            ("flatten_", lambda T, x: T.flatten_(x), [n(4, 16)]),
            ("t_", lambda T, x: T.t_(x), [n(4, 16)]),
            ("transpose_", lambda T, x: T.transpose_(x, [1, 0, 2]), [n(2, 3, 4)]),
            ("equal_", lambda T, x, y: T.equal_(x, y), [i((64,), 0, 3), i((64,), 0, 3)]),
            ("greater_equal_", lambda T, x, y: T.greater_equal_(x, y), [n(64), n(64)]),
            ("greater_than_", lambda T, x, y: T.greater_than_(x, y), [n(64), n(64)]),
            ("less_equal_", lambda T, x, y: T.less_equal_(x, y), [n(64), n(64)]),
            ("less_than_", lambda T, x, y: T.less_than_(x, y), [n(64), n(64)]),
            ("less_", lambda T, x, y: T.less_(x, y), [n(64), n(64)]),
            ("logical_and_", lambda T, x, y: T.logical_and_(x, y), [b(64), b(64)]),
            ("logical_or_", lambda T, x, y: T.logical_or_(x, y), [b(64), b(64)]),
            ("logical_not_", lambda T, x: T.logical_not_(x), [b(64)]),
            ("where_", lambda T, c, x, y: T.where_(c, x, y), [b(64), n(64), n(64)])):
        rows.append((name, fn, specs, E, "swap"))
    return rows


def _surface_input(torch, spec, rng):
    import numpy as np

    kind = spec[0]
    if kind == "n":
        a = rng.standard_normal(spec[1]).astype(np.float32)
    elif kind == "u":
        a = rng.uniform(spec[2], spec[3], spec[1]).astype(np.float32)
    elif kind == "i":
        a = rng.randint(spec[2], spec[3], spec[1]).astype(np.int64)
    elif kind == "b":
        a = rng.rand(*spec[1]) > 0.5
    else:
        a = np.asarray(spec[1])
        a = a.astype(np.float32) if a.dtype == np.float64 else a
    return torch.from_numpy(a)


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat(x)]
    return [out]


def op_surface_on_card(torch, T):
    """(a): every case on CUDA and on CPU tensors from one seed."""
    dev = "cuda"
    import numpy as np

    rows, worst = [], {}
    for k, (name, fn, specs, kind, inplace) in enumerate(surface_cases()):
        rng = np.random.RandomState(1000 + k)
        host = [_surface_input(torch, s, rng) for s in specs]
        card = [x.to(dev, copy=True) for x in host]
        ptr = card[0].data_ptr() if card else None
        cpu_out = _flat(fn(T, *host))
        gpu_out = _flat(fn(T, *card))
        if inplace is not None:
            if gpu_out[0] is not card[0] or cpu_out[0] is not host[0]:
                fail(f"surface {name}: the in-place op did not return its first argument")
            if inplace == "keep" and card[0].data_ptr() != ptr:
                fail(f"surface {name}: the in-place op moved its tensor's storage")
        if len(cpu_out) != len(gpu_out):
            fail(f"surface {name}: {len(gpu_out)} outputs on the card, {len(cpu_out)} on the CPU")
        err = 0.0
        for g, c in zip(gpu_out, cpu_out):
            if g.device.type != dev:
                fail(f"surface {name}: an output on {g.device}, not the card")
            if g.dtype != c.dtype or tuple(g.shape) != tuple(c.shape):
                fail(f"surface {name}: card {g.dtype} {tuple(g.shape)}, CPU {c.dtype} "
                     f"{tuple(c.shape)}")
            g = g.cpu()
            if kind == "exact" or not (c.is_floating_point() or c.is_complex()):
                same = torch.equal(g, c) if not (c.is_floating_point() or c.is_complex()) \
                    else bool(((g == c) | (torch.isnan(g) & torch.isnan(c))).all())
                if not same:
                    fail(f"surface {name}: card and CPU differ where they must be equal")
            else:
                rtol, atol = TOL_SURFACE
                if not torch.allclose(g, c, rtol=rtol, atol=atol, equal_nan=True):
                    d = (g - c).abs().max().item()
                    fail(f"surface {name}: card and CPU differ by {d} (rtol {rtol}, atol {atol})")
                if c.numel():
                    err = max(err, ((g - c).abs() / (c.abs() + atol / rtol)).max().item())
        worst[name] = err
        rows.append(name)
    # the samplers on the card: a seeded draw repeats, moments within
    # SAMPLER_SIGMAS standard errors of SURFACE_DRAWS draws
    moments = {}
    for name, draw, (mean, var), stat in (
            ("standard_gamma", lambda: T.standard_gamma(torch.full((SURFACE_DRAWS,), 2.5,
                                                                   device=dev)),
             (2.5, 2.5), lambda v: v),
            ("binomial", lambda: T.binomial(torch.full((SURFACE_DRAWS,), 10, device=dev),
                                            torch.full((SURFACE_DRAWS,), 0.3, device=dev)),
             (3.0, 2.1), lambda v: v),
            ("log_normal", lambda: T.log_normal(0.5, 1.5, [SURFACE_DRAWS]), (0.5, 2.25),
             torch.log)):
        T.seed(29)
        a = draw()
        T.seed(29)
        again = draw()
        if a.device.type != dev or not torch.equal(a, again):
            fail(f"sampler {name}: not on the card, or a seeded draw did not repeat")
        v = stat(a.double())
        m, s2 = v.mean().item(), v.var().item()
        se = math.sqrt(var / SURFACE_DRAWS)
        # the variance's standard error, allowing an excess kurtosis up to 6
        se_var = var * math.sqrt(8.0 / SURFACE_DRAWS)
        if abs(m - mean) > SAMPLER_SIGMAS * se or abs(s2 - var) > SAMPLER_SIGMAS * se_var:
            fail(f"sampler {name}: mean {m} and variance {s2}, want {mean} and {var} within "
                 f"{SAMPLER_SIGMAS} standard errors")
        moments[name] = dict(mean=m, var=s2, want_mean=mean, want_var=var, dtype=str(a.dtype))
    x = torch.randn(4096, device=dev)
    y = T.from_dlpack(T.to_dlpack(x))
    if y.data_ptr() != x.data_ptr() or y.device != x.device:
        fail("dlpack: the round trip on the card copied the tensor")
    return dict(cases=len(rows), worst_scaled_err=max(worst.values()),
                moments=moments, samples=SURFACE_DRAWS, dlpack_shares_memory=True)


def fuse_on_card(torch, T):
    """(b): the fuse'd rope tables against their eager function."""
    from paddle_tpu_torch.models.llama import _rope_cos_sin

    P = T.profiler

    def kernels(fn):
        """The kernels of one call, from the port's Profiler."""
        with P.Profiler(targets=[P.ProfilerTarget.CPU, P.ProfilerTarget.GPU]) as prof:
            fn()
        res = prof._last_result
        names = sorted(e["name"][:80] for e in res.device_events())
        if not names or res.lost_device_records:
            fail(f"fuse: a profiled call recorded {len(names)} kernels and lost "
                 f"{res.lost_device_records}")
        return names

    out = {}
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        args = (ROPE_S, ROPE_D, 10000.0, dtype, "cuda")
        t0 = time.perf_counter()
        fc, fs = _rope_cos_sin(*args)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        ec, es = _rope_cos_sin.__wrapped__(*args)
        if fc.dtype != dtype or fc.shape != (ROPE_S, ROPE_D) or fc.device.type != "cuda":
            fail(f"fuse: the {dt} table is {fc.dtype} {tuple(fc.shape)} on {fc.device}")
        err = max((fc.float() - ec.float()).abs().max().item(),
                  (fs.float() - es.float()).abs().max().item())
        if not err <= TOL_FUSE_ROPE[dt]:
            fail(f"fuse: the {dt} rope tables part from eager by {err}, "
                 f"more than {TOL_FUSE_ROPE[dt]}")
        fused_k = kernels(lambda: _rope_cos_sin(*args))
        eager_k = kernels(lambda: _rope_cos_sin.__wrapped__(*args))
        out[dt] = dict(max_abs_err=err, tol=TOL_FUSE_ROPE[dt], compile_s=compile_s,
                       fused_ms=call_ms(torch, lambda: _rope_cos_sin(*args)),
                       eager_ms=call_ms(torch, lambda: _rope_cos_sin.__wrapped__(*args)),
                       fused_kernels=fused_k, eager_kernels=eager_k)
    out["variants"] = len(_rope_cos_sin.variants)
    return out


def profiled_training(torch, fa, models, T, AdamW):
    """(c): phase 6's step under the port's Profiler."""
    import contextlib
    import io
    import shutil
    import tempfile

    P = T.profiler
    cfg = models.LlamaConfig(**FLAGSHIP, dtype="bfloat16", recompute=True,
                             recompute_granularity="full")
    L, B, S = cfg.num_hidden_layers, 8, 2048
    gc.collect()
    torch.cuda.empty_cache()
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    model.train()
    opt = AdamW(learning_rate=TRAIN_LR, parameters=model.parameters(), multi_precision=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", generator=gen)

    def step():
        loss, _ = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()

    step()
    results, times = [], []
    with P.Profiler(targets=[P.ProfilerTarget.CPU, P.ProfilerTarget.GPU], scheduler=(1, 3),
                    on_trace_ready=lambda prof: results.append(prof._last_result)) as prof:
        for i in range(4):
            if i == 1:   # the RECORD window opened at the step() before
                reset_counts(fa)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if i == 2:   # before the step() that closes the window
                counted = counts(fa)
            prof.step(num_samples=B * S)
        timer = prof.step_info(unit="tokens")
    if len(results) != 1:
        fail(f"profiler: {len(results)} finished windows, want 1")
    res = results[0]
    rows = res.device_op_stats()
    table = tuple(sum(r["calls"] for r in rows if key in r["name"])
                  for key in ("fa_fwd_wgmma", "fa_bwd_dq_wgmma", "fa_bwd_dkv_wgmma"))
    if table != (4 * L, 2 * L, 2 * L) or table != counted or res.lost_device_records:
        fail(f"profiler: the device table counts (fwd, dq, dk/dv) = {table} over two steps, "
             f"the counters {counted}, {res.lost_device_records} launches without a record; "
             f"want {(4 * L, 2 * L, 2 * L)} in both and none lost")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    try:
        path = os.path.join(tmp, "flagship.json")
        res.save(path)
        size_mb = os.path.getsize(path) / 1e6
        with open(path) as f:
            spans = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        host = [e for e in spans if e.get("cat") != "DeviceOp"]
        ops = [e for e in host if e["name"].startswith("op::")]
        dev = [e for e in spans if e.get("cat") == "DeviceOp"]
        if not ops or not dev:
            fail(f"profiler: the trace holds {len(ops)} op:: spans and {len(dev)} device spans")
        if {e["pid"] for e in ops} & {e["pid"] for e in dev}:
            fail("profiler: host and device spans share a pid")
        lo = min(e["ts"] for e in host)
        hi = max(e["ts"] + e["dur"] for e in host)
        starts = sorted(e["ts"] for e in dev)
        # a kernel starts after its launch; the tail may run past the last
        # host span (the queue drains after the host moves on)
        if starts[0] < lo - 1e3 or not lo <= starts[len(starts) // 2] <= hi:
            fail(f"profiler: device spans start {starts[0] - lo:.1f} us from the host window "
                 f"({hi - lo:.1f} us long), median at {starts[len(starts) // 2] - lo:.1f}")
        tail = max(e["ts"] + e["dur"] for e in dev) - hi
        loaded = P.load_profiler_result(path)
        if len(loaded.events) != len(res.events):
            fail(f"profiler: {len(loaded.events)} host events loaded back, "
                 f"{len(res.events)} saved")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        prof.summary()
    if "Device Op Summary" not in buf.getvalue():
        fail("profiler: summary() printed no Device Op Summary")
    device_ms = sum(r["total_ns"] for r in rows) / 1e6 / 2
    unprofiled = (times[0] + times[3]) / 2
    profiled = (times[1] + times[2]) / 2
    del model, opt
    return dict(device_table=dict(zip(("fa_fwd_wgmma", "fa_bwd_dq_wgmma", "fa_bwd_dkv_wgmma"),
                                      table)),
                counters=dict(zip(("fwd", "bwd_dq", "bwd_dkv"), counted)),
                step_ms=times, profiled_step_ms=profiled, unprofiled_step_ms=unprofiled,
                profiled_over_unprofiled=profiled / unprofiled, device_ms_per_step=device_ms,
                host_events=len(res.events), op_spans=len(ops), device_events=len(dev),
                lost_device_records=res.lost_device_records,
                trace_mb=size_mb, device_tail_past_host_us=tail,
                timer=timer.strip(),
                top_kernels=[dict(name=r["name"][:80], calls=r["calls"],
                                  total_ms=r["total_ns"] / 1e6) for r in rows[:8]])


def phase_surface(torch, fa, models, T, AdamW, smi):
    """Phase 18 (module docstring)."""
    from paddle_tpu_torch.ops import _apply

    out = {}
    for key, fn in (("ops", lambda: op_surface_on_card(torch, T)),
                    ("fuse", lambda: fuse_on_card(torch, T)),
                    ("profiler", lambda: profiled_training(torch, fa, models, T, AdamW))):
        t0 = time.perf_counter()
        out[key] = fn()
        out[key]["seconds"] = time.perf_counter() - t0
        print(f"surface_{key} " + json.dumps(out[key]), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    if _apply._PROFILER[0] is not None:
        fail("profiler: the dispatch's slot is still set after the window closed")
    out["dispatch"] = dict(dispatch_us(torch, T), card=smi)
    print("surface_dispatch " + json.dumps(out["dispatch"]), flush=True)
    return out



def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing was run", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import paddle_tpu_torch as T
        import paddle_tpu_torch.models as models
        from paddle_tpu_torch.ops.cuda import _build
        from paddle_tpu_torch.ops.cuda import axpy
        from paddle_tpu_torch.ops.cuda import flash_attention as fa
        from paddle_tpu_torch.optimizer import AdamW
        from paddle_tpu_torch.utils import cpp_extension, custom_op
        import paddle_tpu_torch.incubate.nn.functional as incubate_functional
        from paddle_tpu_torch import serving as fleet
        from paddle_tpu_torch.analysis import faultinject
        from paddle_tpu_torch.models import serving as serving_mod
        import paddle_tpu_torch.optimizer as optim
        import paddle_tpu_torch.nn as tnn
        import paddle_tpu_torch.checkpoint as ckpt
        from paddle_tpu_torch.distributed.fleet.recompute import SAVED_OPS
        import paddle_tpu_torch.nn.functional as tfunc
        from paddle_tpu_torch import inference, jit
        # the module (the package's attribute of that name is the function)
        port_F = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN", flush=True)
    # Inductor's and Triton's compiled code go beside the kernels' build
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(_build.BUILD_DIR / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(_build.BUILD_DIR / "triton"))

    # phase 1: device and build
    smi = nvidia_smi()
    print(f"card: {smi}", flush=True)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}", flush=True)
    build_s = _build.build_all()
    print(f"build_seconds {build_s:.1f} ({', '.join(_build.sources())})", flush=True)
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    # every forward and backward instantiation: registers, spills and stack
    print("ptxas_fwd " + json.dumps(ptxas_summary(_build.build_log("flash_attention_fwd"))),
          flush=True)
    print("ptxas_bwd " + json.dumps(ptxas_summary(_build.build_log("flash_attention_bwd"))),
          flush=True)
    # the axpy kernel's instantiations: registers, shared memory, spills
    print("ptxas_axpy " + json.dumps(ptxas_summary(_build.build_log("axpy"))), flush=True)

    # phase 2: forward kernel against its plain version
    t0 = time.perf_counter()
    checks, fwd_rows = phase_kernel(torch, fa)
    main_row = fwd_rows["flagship_prefill"]
    print(f"phase_seconds 2 {time.perf_counter() - t0:.1f}", flush=True)

    # phase 3: the serving main path (launch counts set to 0 inside, read after)
    t0 = time.perf_counter()
    serving = phase_serving(torch, fa, models)
    print("serving " + json.dumps(dict(serving, card=smi)), flush=True)
    print(f"phase_seconds 3 {time.perf_counter() - t0:.1f}", flush=True)

    # phase 4: card against CPU
    t0 = time.perf_counter()
    e2e = phase_card_vs_cpu(torch, fa, models)
    print("card_vs_cpu " + json.dumps(e2e), flush=True)
    print(f"phase_seconds 4 {time.perf_counter() - t0:.1f}", flush=True)

    # phase 5: backward kernels against the plain backward
    t0 = time.perf_counter()
    bwd_checks, bwd_rows = phase_backward(torch, fa)
    print(f"phase_seconds 5 {time.perf_counter() - t0:.1f}", flush=True)

    # phase 6: the training main path (launch counts set to 0 inside, read after)
    t0 = time.perf_counter()
    training = phase_training(torch, fa, models, AdamW, smi)
    print("training " + json.dumps(training), flush=True)
    print(f"phase_seconds 6 {time.perf_counter() - t0:.1f}", flush=True)

    # phase 7: training, card against CPU
    t0 = time.perf_counter()
    train_e2e = phase_train_card_vs_cpu(torch, fa, models, AdamW)
    print("train_card_vs_cpu " + json.dumps(train_e2e), flush=True)
    print(f"phase_seconds 7 {time.perf_counter() - t0:.1f}", flush=True)

    # phase 8: the custom-op path (launch count set to 0 inside, read after)
    t0 = time.perf_counter()
    custom = phase_custom_op(torch, axpy, custom_op, cpp_extension, _build.BUILD_DIR)
    print("custom_op " + json.dumps(dict(launches=custom["launches"], calls=custom["calls"],
                                         cpp_extension=custom["cpp_extension"])), flush=True)
    print(f"phase_seconds 8 {time.perf_counter() - t0:.1f}", flush=True)

    # phase 9: paged and int8 serving (launch counts set to 0 inside, read after)
    t0 = time.perf_counter()
    paged = phase_paged_serving(torch, fa, models)
    print("paged_serving " + json.dumps(dict(paged, card=smi)), flush=True)
    print(f"phase_seconds 9 {time.perf_counter() - t0:.1f}", flush=True)

    # phase 10: continuous-batching serving (launch counts set to 0 inside,
    # read after)
    t0 = time.perf_counter()
    continuous = phase_continuous(torch, fa, models, smi)
    print(f"phase_seconds 10 {time.perf_counter() - t0:.1f}", flush=True)

    # phase 11: serving resilience and the fleet (fault points armed inside,
    # every drill's outputs held to its undisturbed reference)
    t0 = time.perf_counter()
    resilience = phase_resilience(torch, fa, models, fleet, faultinject, serving_mod,
                                  incubate_functional, smi)
    print(f"phase_seconds 11 {time.perf_counter() - t0:.1f}", flush=True)

    # phase 12: the training surface (launch counts set to 0 before each
    # variant's first step, read after it)
    t0 = time.perf_counter()
    surface = phase_train_surface(torch, fa, models, optim, tnn, ckpt, SAVED_OPS, smi)
    print(f"phase_seconds 12 {time.perf_counter() - t0:.1f}", flush=True)

    # phase 13: Phi-3-mini's and Gemma-2B's widths (launch counts set to 0
    # before each call, read after it)
    t0 = time.perf_counter()
    widths = phase_widths(torch, fa, models, AdamW, port_F, tfunc, incubate_functional, smi)
    print(f"phase_seconds 13 {time.perf_counter() - t0:.1f}", flush=True)

    # phase 14: the compiled paths (launch counts set to 0 before each
    # counted call, read after it)
    t0 = time.perf_counter()
    compiled = phase_compiled(torch, fa, axpy, models, AdamW, jit, serving_mod, port_F, smi,
                              training)
    print(f"phase_seconds 14 {time.perf_counter() - t0:.1f}", flush=True)

    # phase 15: the deploy path (launch counts set to 0 before the counted
    # Predictor.run, read after it; axpy's in the fresh interpreter)
    t0 = time.perf_counter()
    deploy = phase_deploy(torch, fa, axpy, models, jit, inference, port_F, smi, root,
                          compiled["forward"])
    from torch._inductor import async_compile
    if hasattr(async_compile, "shutdown_compile_workers"):
        async_compile.shutdown_compile_workers()    # Inductor's compile processes
    deploy_s = time.perf_counter() - t0
    print(f"phase_seconds 15 {deploy_s:.1f}", flush=True)
    if deploy_s > DEPLOY_SECONDS:
        fail(f"phase 15 took {deploy_s:.1f} s, more than its {DEPLOY_SECONDS} s")

    # phase 16: mixed precision (launch counts and the operator stats set to
    # 0 before each variant's first step, read after it)
    t0 = time.perf_counter()
    amp = phase_amp(torch, fa, models, T, AdamW, port_F, smi, training)
    amp_s = time.perf_counter() - t0
    print(f"phase_seconds 16 {amp_s:.1f}", flush=True)
    if amp_s > AMP_SECONDS:
        fail(f"phase 16 took {amp_s:.1f} s, more than its {AMP_SECONDS} s")
    amp_launches = {f"amp_{k}": amp[k]["launches_per_step"] for k in
                    ("o1_bf16", "o2_bf16", "o1_fp16")}

    # phase 17: master-grad training, autograd, streams, samplers and linalg
    # (launch counts set to 0 before the counted master-grad step and the
    # vjp, read after each)
    t0 = time.perf_counter()
    master = phase_master(torch, fa, models, T, port_F, tfunc, smi, amp, serving)
    master_s = time.perf_counter() - t0
    print(f"phase_seconds 17 {master_s:.1f}", flush=True)
    if master_s > MASTER_SECONDS:
        fail(f"phase 17 took {master_s:.1f} s, more than its {MASTER_SECONDS} s")
    # phase 18: the op surface and the profiler (launch counts set to 0 when
    # the profiled flagship's RECORD window opens, read before it closes)
    t0 = time.perf_counter()
    op_surface = phase_surface(torch, fa, models, T, AdamW, smi)
    surface_s = time.perf_counter() - t0
    print(f"phase_seconds 18 {surface_s:.1f}", flush=True)
    if surface_s > SURFACE_SECONDS:
        fail(f"phase 18 took {surface_s:.1f} s, more than its {SURFACE_SECONDS} s")
    profiled = op_surface["profiler"]["counters"]

    mg_total = master["training"]["launches_per_step"]
    mg_bf16 = master["training"]["launches_bf16"]

    kernel = dict(
        name="flash_attention_fwd", route="cuda",
        source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:48",
        launches=serving["launches"],
        launches_by_path=dict(serving=serving["launches"],
                              training=training["launches_per_step"]["fwd"],
                              paged_prefill=paged["paged"]["launches_prefill"],
                              int8_prefill=paged["int8"]["launches_prefill"],
                              static_prefill=continuous["serving"][
                                  "forward_launches_per_static_admission"],
                              continuous=continuous["serving"]["forward_launches_continuous"],
                              resilience=resilience["launches"][0],
                              train_knobs={k: v["launches_per_step"][0] for k, v in
                                           surface["knobs"]["variants"].items()},
                              to_static_training=compiled["training"]["launches_per_step"]["fwd"],
                              captured_prefill=compiled["decode"]["flagship"]["captured"][
                                  "launches_per_prefill"],
                              to_static_forward=compiled["forward"]["launches"],
                              deploy=deploy["flagship"]["launches_per_run"]["fwd"],
                              master_grad_bf16=mg_bf16["fwd"],
                              profiled_two_steps=profiled["fwd"],
                              **{k: v["fwd"] for k, v in amp_launches.items()}),
        max_abs_err=main_row["max_abs_err"],
        tol=main_row["tol"], ms=main_row["kernel_ms"], kernel_ms=main_row["kernel_ms"],
        call_ms=main_row["kernel_call_ms"],
        plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
        bound_by=main_row["bound_by"], library_ms=main_row["library_ms"],
        shape=main_row["shape"], dtype=main_row["dtype"],
        **{name: dict(ms=r["kernel_ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                      bound_ms=r["bound_ms"], bound_by=r["bound_by"], shape=r["shape"],
                      max_abs_err=r["max_abs_err"], max_scaled_err=r["max_scaled_err"],
                      tol=r["tol"])
           for name, r in fwd_rows.items() if name != "flagship_prefill"},
        checks=checks)
    kernel["static_prefill"].update(
        launches=continuous["serving"]["forward_launches_static"],
        launches_per_admission=continuous["serving"]["forward_launches_per_static_admission"])
    tr, b1 = bwd_rows["training"], bwd_rows["long_b1"]
    bwd_kernels = []
    for key, name, line, grads in (("dq", "flash_attention_bwd_dq", 130, ("dq",)),
                                   ("dkv", "flash_attention_bwd_dkv", 171, ("dk", "dv"))):
        bwd_kernels.append(dict(
            name=name, route="cuda", source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces=f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            launches=training["launches_per_step"][f"bwd_{key}"],
            launches_by_path=dict(training=training["launches_per_step"][f"bwd_{key}"],
                                  train_knobs={k: v["launches_per_step"][1 + (key == "dkv")]
                                               for k, v in
                                               surface["knobs"]["variants"].items()},
                                  to_static_training=compiled["training"][
                                      "launches_per_step"][f"bwd_{key}"],
                                  master_grad_bf16=mg_bf16[f"bwd_{key}"],
                                  profiled_two_steps=profiled[f"bwd_{key}"],
                                  **{k: v[f"bwd_{key}"] for k, v in amp_launches.items()}),
            max_abs_err=max(tr[f"{g}_max_abs_err"] for g in grads),
            norm_rel_err=max(tr[f"{g}_err"] for g in grads), tol=tr["tol"],
            ms=tr[f"{key}_ms"], kernel_ms=tr[f"{key}_ms"], call_ms=tr[f"{key}_call_ms"],
            **({"delta_err": tr["delta_err"], "tol_delta": TOL_DELTA} if key == "dq" else {}),
            # the plain version and the library call compute dq, dk and dv together
            plain_ms=tr["plain_ms"], bound_ms=tr[f"{key}_bound_ms"],
            bound_by=tr[f"{key}_bound_by"], library_ms=tr["library_ms"],
            backward_ms=tr["bwd_ms"], shape=tr["shape"], dtype=tr["dtype"],
            long_b1=dict(ms=b1[f"{key}_ms"], plain_ms=b1["plain_ms"],
                         bound_ms=b1[f"{key}_bound_ms"], library_ms=b1["library_ms"],
                         backward_ms=b1["bwd_ms"])))
    bwd_kernels[0]["checks"] = bwd_checks
    ax = custom["timed"]
    axpy_kernel = dict(
        name="axpy", route="cuda", source="paddle_tpu_torch/csrc/axpy.cu",
        replaces="tests/test_extension_points.py:57", launches=custom["launches"],
        launches_by_path=dict(custom_op=custom["launches"],
                              to_static=compiled["axpy"]["launches"],
                              deploy=deploy["axpy"]["launches_per_call"]),
        max_abs_err=ax["max_abs_err"], bit_exact=ax["bit_exact"], ms=ax["kernel_ms"],
        kernel_ms=ax["kernel_ms"], call_ms=ax["kernel_call_ms"], plain_ms=ax["plain_ms"],
        plain_call_ms=ax["plain_call_ms"], bound_ms=ax["bound_ms"], bound_by=ax["bound_by"],
        library_ms=ax["library_ms"], library_call_ms=ax["library_call_ms"],
        library_call="torch.add(torch.tensor(1.0), x, alpha=2)",
        kernel_gbps=ax["kernel_gbps"], clone_ms=ax["clone_ms"], shape=[ax["numel"]],
        dtype=ax["dtype"],
        checks=custom["checks"])
    # kernels 1-3 at the head dims phase 13 runs: times at the training shape
    # (the forward's also at the serving prefill), launches from phase 13
    dim_kernels = []
    for D, wname, tkey, pkey in ((96, "phi3_mini", "phi3_training_d96", "phi3_prefill_d96"),
                                 (256, "gemma_2b", "gemma_training_d256",
                                  "gemma_prefill_d256")):
        w, f, pre, b = widths[wname], fwd_rows[tkey], fwd_rows[pkey], bwd_rows[tkey]
        dim_kernels.append(dict(
            name=f"flash_attention_fwd_d{D}", route="cuda",
            source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
            replaces="paddle_tpu/ops/pallas/flash_attention.py:48", head_dim=D, width=wname,
            launches=w["serving"]["launches"],
            launches_by_path=dict(serving=w["serving"]["launches"],
                                  per_prefill=w["serving"]["launches_per_prefill"],
                                  training=w["training"]["launches_per_step"]["fwd"],
                                  captured_prefill=compiled["decode"][wname]["captured"][
                                      "launches_per_prefill"]),
            max_abs_err=f["max_abs_err"], max_scaled_err=f["max_scaled_err"], tol=f["tol"],
            ms=f["kernel_ms"], call_ms=f["kernel_call_ms"], plain_ms=f["plain_ms"],
            bound_ms=f["bound_ms"], bound_by=f["bound_by"], library_ms=f["library_ms"],
            shape=f["shape"], dtype=f["dtype"],
            prefill=dict(ms=pre["kernel_ms"], plain_ms=pre["plain_ms"],
                         bound_ms=pre["bound_ms"], bound_by=pre["bound_by"],
                         library_ms=pre["library_ms"], shape=pre["shape"],
                         max_abs_err=pre["max_abs_err"])))
        for key, name, line, grads in (("dq", "flash_attention_bwd_dq", 130, ("dq",)),
                                       ("dkv", "flash_attention_bwd_dkv", 171, ("dk", "dv"))):
            dim_kernels.append(dict(
                name=f"{name}_d{D}", route="cuda",
                source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                replaces=f"paddle_tpu/ops/pallas/flash_attention.py:{line}", head_dim=D,
                width=wname, launches=w["training"]["launches_per_step"][f"bwd_{key}"],
                max_abs_err=max(b[f"{g}_max_abs_err"] for g in grads),
                norm_rel_err=max(b[f"{g}_err"] for g in grads), tol=b["tol"],
                ms=b[f"{key}_ms"], call_ms=b[f"{key}_call_ms"], plain_ms=b["plain_ms"],
                bound_ms=b[f"{key}_bound_ms"], bound_by=b[f"{key}_bound_by"],
                library_ms=b["library_ms"], backward_ms=b["bwd_ms"], shape=b["shape"],
                dtype=b["dtype"]))
    # kernels 1-3 at fp16, phase 16 (c)'s dtype: the training shape's times
    # from phases 2 and 5, launches from phase 16 (c)
    f16, b16 = fwd_rows["training_shape_fp16"], bwd_rows["training_fp16"]
    fp16_launches = amp["o1_fp16"]["launches_per_step"]
    fp16_kernels = [dict(
        name="flash_attention_fwd_fp16", route="cuda",
        source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:48", launches=fp16_launches["fwd"],
        max_abs_err=f16["max_abs_err"], max_scaled_err=f16["max_scaled_err"], tol=f16["tol"],
        ms=f16["kernel_ms"], call_ms=f16["kernel_call_ms"], plain_ms=f16["plain_ms"],
        bound_ms=f16["bound_ms"], bound_by=f16["bound_by"], library_ms=f16["library_ms"],
        shape=f16["shape"], dtype=f16["dtype"])]
    for key, name, line, grads in (("dq", "flash_attention_bwd_dq", 130, ("dq",)),
                                   ("dkv", "flash_attention_bwd_dkv", 171, ("dk", "dv"))):
        fp16_kernels.append(dict(
            name=f"{name}_fp16", route="cuda",
            source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces=f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            launches=fp16_launches[f"bwd_{key}"],
            max_abs_err=max(b16[f"{g}_max_abs_err"] for g in grads),
            norm_rel_err=max(b16[f"{g}_err"] for g in grads), tol=b16["tol"],
            ms=b16[f"{key}_ms"], call_ms=b16[f"{key}_call_ms"], plain_ms=b16["plain_ms"],
            bound_ms=b16[f"{key}_bound_ms"], bound_by=b16[f"{key}_bound_by"],
            library_ms=b16["library_ms"], backward_ms=b16["bwd_ms"], shape=b16["shape"],
            dtype=b16["dtype"]))
    # kernels 1-3's float32 variants (the 3xTF32 forward, dq and dk/dv) at
    # phase 17 (a)'s shape: times from phases 2 and 5 (sdpa and its backward
    # in float32 as the library calls), launches from 17 (a); also without
    # the causal mask
    f32, b32 = fwd_rows["master_grad_fp32"], bwd_rows["master_grad_fp32"]
    f32n = fwd_rows["master_grad_fp32_noncausal"]
    b32n = bwd_rows["master_grad_fp32_noncausal"]
    mg_f32 = master["training"]["launches_f32"]
    f32_kernels = [dict(
        name="flash_attention_fwd_f32", route="cuda",
        source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:48", launches=mg_f32["fwd"],
        launches_by_path=dict(master_grad=mg_f32["fwd"], master_grad_all=mg_total["fwd"]),
        max_abs_err=f32["max_abs_err"], max_scaled_err=f32["max_scaled_err"], tol=f32["tol"],
        ms=f32["kernel_ms"], call_ms=f32["kernel_call_ms"], plain_ms=f32["plain_ms"],
        bound_ms=f32["bound_ms"], bound_by=f32["bound_by"],
        share_of_bound=f32["share_of_bound"], library_ms=f32["library_ms"],
        shape=f32["shape"], dtype=f32["dtype"],
        noncausal=dict(
            ms=f32n["kernel_ms"], plain_ms=f32n["plain_ms"], bound_ms=f32n["bound_ms"],
            share_of_bound=f32n["share_of_bound"], library_ms=f32n["library_ms"],
            max_abs_err=f32n["max_abs_err"], max_scaled_err=f32n["max_scaled_err"]))]
    for key, name, line, grads in (("dq", "flash_attention_bwd_dq", 130, ("dq",)),
                                   ("dkv", "flash_attention_bwd_dkv", 171, ("dk", "dv"))):
        f32_kernels.append(dict(
            name=f"{name}_f32", route="cuda",
            source="paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces=f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            launches=mg_f32[f"bwd_{key}"],
            launches_by_path=dict(master_grad=mg_f32[f"bwd_{key}"]),
            max_abs_err=max(b32[f"{g}_max_abs_err"] for g in grads),
            norm_rel_err=max(b32[f"{g}_err"] for g in grads), tol=b32["tol"],
            ms=b32[f"{key}_ms"], call_ms=b32[f"{key}_call_ms"], plain_ms=b32["plain_ms"],
            bound_ms=b32[f"{key}_bound_ms"], bound_by=b32[f"{key}_bound_by"],
            share_of_bound=b32[f"{key}_share_of_bound"],
            library_ms=b32["library_ms"], backward_ms=b32["bwd_ms"], shape=b32["shape"],
            dtype=b32["dtype"],
            noncausal=dict(
                ms=b32n[f"{key}_ms"], plain_ms=b32n["plain_ms"],
                bound_ms=b32n[f"{key}_bound_ms"],
                share_of_bound=b32n[f"{key}_share_of_bound"],
                library_ms=b32n["library_ms"], backward_ms=b32n["bwd_ms"],
                norm_rel_err=max(b32n[f"{g}_err"] for g in grads))))
    print(json.dumps({"kernels": [kernel] + bwd_kernels + [axpy_kernel] + dim_kernels
                      + fp16_kernels + f32_kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

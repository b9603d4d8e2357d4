#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (paddle_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, each a hard check (the script exits nonzero on the first failure):
  1. device: card name and power limit, torch/CUDA versions; build every
     kernel from csrc/ with nvcc (one process per source, in parallel).
  2. kernel: flash_attention_fwd (the hand-written kernel) against its plain
     PyTorch version on the card, at the serving shapes and the edge cases,
     with a tolerance per dtype; times of the kernel, the plain version and
     torch's scaled_dot_product_attention (a yardstick only: the port never
     calls it) beside the least time the card could take.
  3. serving at full width: the flagship LLaMA (vocab 32000, hidden 2048,
     8 layers, 16 heads x 128, bf16, random weights from a seed) served by
     LlamaDecodeEngine.generate (8 prompts x 128 tokens, 32 greedy new
     tokens) and LlamaForCausalLM.generate. Launch counts are set to 0 just
     before and read just after: every prefill must launch the kernel once
     per layer.
  4. card against CPU: the same width at 2 layers in fp32, copied to a CPU
     twin (which runs the plain versions); prefill logits must agree and
     greedy tokens must be identical.
The last line is the device JSON object; the line before it the card's name
and power limit; before that the kernels JSON object.

Matmul and cuDNN TF32 are switched off, so every float32 product here is
full float32 (the CPU twin and the fp32 kernel checks depend on it).
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_TC_FLOPS = 989e12     # bf16 / fp16 tensor cores
PEAK_FP32_FLOPS = 67e12    # fp32 outside the tensor cores
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

FLAGSHIP = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                num_hidden_layers=8, num_attention_heads=16, num_key_value_heads=16,
                max_position_embeddings=2048)


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


def attention_bound_ms(B, Sq, Sk, Hq, Hkv, D, causal, elt, tensor_cores):
    """Least time for the card: max(flops / peak, bytes / HBM rate). flops =
    4 D per visible (query, key) pair; bytes = q, k, v read once, o written
    once, plus the fp32 LSE."""
    if causal:
        off = Sk - Sq
        pairs = sum(min(Sk, i + off + 1) for i in range(Sq))
    else:
        pairs = Sq * Sk
    flops = 4.0 * D * pairs * B * Hq
    nbytes = (2 * B * Sq * Hq * D + 2 * B * Sk * Hkv * D) * elt + 4 * B * Hq * Sq
    t_ops = flops / (PEAK_TC_FLOPS if tensor_cores else PEAK_FP32_FLOPS)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def phase_kernel(torch, fa):
    """Kernel against its plain version; times at the timed shapes."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    cases = [
        # name, B, Sq, Sk, Hq, Hkv, D, dtype, causal, timed
        ("flagship_prefill", 8, 128, 128, 16, 16, 128, "bfloat16", True, True),
        ("long_prompt", 1, 2048, 2048, 16, 16, 128, "bfloat16", True, True),
        ("gqa_hkv4", 2, 512, 512, 16, 4, 128, "bfloat16", True, False),
        ("mqa_hkv1", 2, 512, 512, 16, 1, 128, "bfloat16", True, False),
        ("non_causal", 2, 512, 512, 16, 16, 128, "bfloat16", False, False),
        ("cross_length_causal", 2, 128, 2048, 16, 16, 128, "bfloat16", True, False),
        ("ragged_1000", 2, 1000, 1000, 16, 16, 128, "bfloat16", True, False),
        ("ragged_d64_noncausal", 2, 333, 1000, 8, 2, 64, "bfloat16", False, False),
        ("fp16_d64", 2, 256, 256, 16, 16, 64, "float16", True, False),
        ("fp32", 2, 256, 256, 16, 16, 128, "float32", True, False),
        ("fp32_ragged_gqa_d64", 1, 300, 700, 8, 2, 64, "float32", True, False),
    ]
    checks, main = [], None
    for name, B, Sq, Sk, Hq, Hkv, D, dt, causal, timed in cases:
        dtype = getattr(torch, dt)
        q = torch.randn(B, Sq, Hq, D, device="cuda", generator=gen).to(dtype)
        k = torch.randn(B, Sk, Hkv, D, device="cuda", generator=gen).to(dtype)
        v = torch.randn(B, Sk, Hkv, D, device="cuda", generator=gen).to(dtype)
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_fwd_plain(q, k, v, causal)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        scaled = (diff / ref.float().abs().clamp(min=1.0)).max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        row = dict(name=name, shape=[B, Sq, Sk, Hq, Hkv, D], dtype=dt, causal=causal,
                   max_abs_err=err, max_scaled_err=scaled, tol=TOL[dt], lse_err=lse_err)
        if not (math.isfinite(scaled) and scaled <= TOL[dt]):
            fail(f"kernel disagrees with its plain version at {row}")
        if not (math.isfinite(lse_err) and lse_err <= TOL_LSE):
            fail(f"kernel LSE disagrees with the plain version at {row}")
        if timed:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            fns = dict(
                kernel=lambda: fa.flash_attention_fwd(q, k, v, causal),
                plain=lambda: fa.flash_attention_fwd_plain(q, k, v, causal),
                library=lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal))
            for key, fn in fns.items():
                row[f"{key}_ms"] = device_ms(torch, fn)
                row[f"{key}_call_ms"] = call_ms(torch, fn)
            row["bound_ms"], row["bound_by"] = attention_bound_ms(
                B, Sq, Sk, Hq, Hkv, D, causal, q.element_size(), dtype != torch.float32)
        print("kernel_check " + json.dumps(row), flush=True)
        checks.append(row)
        if name == "flagship_prefill":
            main = row
    return checks, main


def phase_serving(torch, fa, models):
    """The port's main path at the flagship width."""
    cfg = models.LlamaConfig(**FLAGSHIP, dtype="bfloat16")
    L = cfg.num_hidden_layers
    model = models.LlamaForCausalLM(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (8, 128), device="cuda", generator=gen)
    new = 32
    engine = models.LlamaDecodeEngine(model, max_len=128 + new + 1)
    engine.generate(prompts, max_new_tokens=2)        # warm-up: allocator, libraries
    torch.cuda.synchronize()

    fa.launches = 0
    t0 = time.perf_counter()
    toks = engine.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    after_generate = fa.launches

    t0 = time.perf_counter()
    logits, cache, pos = engine.prefill(prompts)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = fa.launches

    tok = logits.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(new - 1):
        logits_d, cache = engine.decode_step(tok, cache, pos)
        tok = logits_d.argmax(-1, keepdim=True)
        pos += 1
    torch.cuda.synchronize()
    ms_per_token = (time.perf_counter() - t0) * 1e3 / (new - 1)
    after_decode = fa.launches

    steps = 3
    full = model.generate(prompts, max_new_tokens=steps)
    torch.cuda.synchronize()
    launches = fa.launches

    if after_generate != L:
        fail(f"engine.generate launched the kernel {after_generate} times, want {L}")
    if after_prefill - after_generate != L:
        fail(f"prefill launched the kernel {after_prefill - after_generate} times, want {L}")
    if after_decode != after_prefill:
        fail("decode steps launched the flash kernel; they attend in plain torch")
    if launches - after_decode != L * steps:
        fail(f"model.generate launched {launches - after_decode} times, want {L * steps}")
    if toks.shape != (8, new) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"generated tokens out of range or misshapen: {tuple(toks.shape)}")
    if full.shape != (8, 128 + steps) or full.max() >= cfg.vocab_size:
        fail(f"model.generate output misshapen: {tuple(full.shape)}")
    if not (torch.isfinite(logits).all() and torch.isfinite(logits_d).all()):
        fail("non-finite logits in the serving phase")
    return dict(prefill_ms=prefill_ms, ms_per_token=ms_per_token,
                tokens_per_sec=8 * new / gen_s, generate_s=gen_s, batch=8,
                prompt=128, new_tokens=new, launches=launches,
                launches_per_prefill=after_prefill - after_generate,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def phase_card_vs_cpu(torch, fa, models):
    """fp32 model on the card (flash kernel in fp32) against its CPU twin."""
    import copy

    cfg = models.LlamaConfig(**dict(FLAGSHIP, num_hidden_layers=2), dtype="float32")
    gpu = models.LlamaForCausalLM(cfg, device="cuda", seed=3)
    cpu = copy.deepcopy(gpu).to("cpu")
    gen = torch.Generator(device="cpu").manual_seed(11)
    prompts = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen)
    new = 16
    eg = models.LlamaDecodeEngine(gpu, max_len=128 + new)
    ec = models.LlamaDecodeEngine(cpu, max_len=128 + new)
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
    return dict(prefill_logits_max_abs_err=err, tol=TOL_E2E_LOGITS,
                greedy_tokens_identical=True, new_tokens=new)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing was run", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import paddle_tpu_torch.models as models
        from paddle_tpu_torch.ops.cuda import _build
        from paddle_tpu_torch.ops.cuda import flash_attention as fa
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN", flush=True)

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

    # phase 2: kernel against its plain version
    checks, main_row = phase_kernel(torch, fa)

    # phase 3: the main path (launch counts set to 0 inside, read after)
    serving = phase_serving(torch, fa, models)
    print("serving " + json.dumps(dict(serving, card=smi)), flush=True)

    # phase 4: card against CPU
    e2e = phase_card_vs_cpu(torch, fa, models)
    print("card_vs_cpu " + json.dumps(e2e), flush=True)

    kernel = dict(
        name="flash_attention_fwd", route="cuda",
        source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:48",
        launches=serving["launches"], max_abs_err=main_row["max_abs_err"],
        tol=main_row["tol"], ms=main_row["kernel_ms"], kernel_ms=main_row["kernel_ms"],
        call_ms=main_row["kernel_call_ms"],
        plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
        bound_by=main_row["bound_by"], library_ms=main_row["library_ms"],
        shape=main_row["shape"], dtype=main_row["dtype"], checks=checks)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Same-card A/B of the PyTorch port's flash-attention forward kernel between
two trees of this repository.

    git archive <commit> | tar -x -C _archive/parent     # the other tree
    python3 tools/flash_fwd_ab.py --parent _archive/parent

Each run is a process of its own that imports ``paddle_tpu_torch`` from one
tree, builds that tree's kernels from its ``csrc/`` and times its forward
kernel (``flash_attention_fwd_lse``: a CUDA graph of 20 calls, 4 in float32,
timed with CUDA events, as ``chip_smoke.py`` times it) at the serving,
long-prompt and training shapes (bf16, H16 D128, causal) and at the training
shape in float32 (the master-grad pullbacks' kernel; causal and not), with
torch's ``scaled_dot_product_attention`` timed beside it in the same process
as the yardstick (in float32 with matmul TF32 off). A float32 row's bound is
at the 3xTF32 rate its kernel runs (three TF32 passes a product). The runs
go parent, this tree, this tree, parent on one card, so each tree is read
twice and the spread between its two readings shows. The kernel's output is
compared with sdpa's at every shape (a broken build shows as a large error).
Needs one CUDA card; prints a table, then one JSON line with every reading.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (  # name, B, S, H, D, dtype, causal: Sq = Sk, Hq = Hkv
    ("flagship_prefill", 8, 128, 16, 128, "bfloat16", True),
    ("long_prompt", 1, 2048, 16, 128, "bfloat16", True),
    ("training_shape", 8, 2048, 16, 128, "bfloat16", True),
    ("master_grad_fp32", 8, 2048, 16, 128, "float32", True),
    ("master_grad_fp32_noncausal", 8, 2048, 16, 128, "float32", False),
)


def time_tree(tree: Path) -> dict:
    """Time ``tree``'s forward kernel and sdpa at SHAPES (one process)."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke  # the timing and bound helpers; imports nothing at load

    sys.path.insert(0, str(tree.resolve()))
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    if not Path(fa.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"imported {fa.__file__}, not the tree {tree}")
    build_s = _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False  # sdpa's float32 math stays float32
    gen = torch.Generator(device="cuda").manual_seed(2024)
    rows = []
    for name, B, S, H, D, dt, causal in SHAPES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(B, S, H, D, device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        out = fa.flash_attention_fwd_lse(q, k, v, causal)[0]
        lib = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        err = (out.float() - lib.transpose(1, 2).float()).abs().max().item()
        iters = 4 if dtype == torch.float32 else 20
        with torch.no_grad():
            kernel_ms = chip_smoke.device_ms(
                torch, lambda: fa.flash_attention_fwd_lse(q, k, v, causal), iters=iters)
            library_ms = chip_smoke.device_ms(
                torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal), iters=iters)
        bound, by = chip_smoke.attention_bound_ms(B, S, S, H, H, D, causal, q.element_size())
        rows.append(dict(name=name, shape=[B, S, S, H, H, D], dtype=dt, causal=causal,
                         kernel_ms=kernel_ms, library_ms=library_ms, bound_ms=bound,
                         bound_by=by, max_abs_err_vs_sdpa=err))
        del q, k, v, qt, kt, vt, out, lib
        torch.cuda.empty_cache()
    return dict(tree=str(tree), card=chip_smoke.nvidia_smi(), build_s=build_s, rows=rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="unpacked tree of the commit to compare with")
    ap.add_argument("--time-tree", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_tree is not None:
        print(json.dumps(time_tree(args.time_tree)), flush=True)
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    import torch

    if not torch.cuda.is_available():
        print("flash_fwd_ab: no CUDA card visible; nothing was run", file=sys.stderr)
        return 2
    runs = []
    for label, tree in (("parent", args.parent), ("change", ROOT), ("change", ROOT),
                        ("parent", args.parent)):
        proc = subprocess.run([sys.executable, __file__, "--time-tree", str(tree)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            print(f"flash_fwd_ab: the {label} run failed", file=sys.stderr)
            return 1
        runs.append(dict(json.loads(proc.stdout.strip().splitlines()[-1]), label=label))
    print(f"card: {runs[0]['card']}")
    print(f"{'shape':27} {'run':7} {'kernel ms':>10} {'sdpa ms':>9} {'bound ms':>9} "
          f"{'err vs sdpa':>11}")
    for i, (name, *_) in enumerate(SHAPES):
        for run in runs:
            r = run["rows"][i]
            print(f"{name:27} {run['label']:7} {r['kernel_ms']:10.5f} {r['library_ms']:9.5f} "
                  f"{r['bound_ms']:9.5f} {r['max_abs_err_vs_sdpa']:11.2e}")
    print(json.dumps(dict(flash_fwd_ab=runs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

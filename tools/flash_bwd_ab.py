#!/usr/bin/env python3
"""Same-card A/B of the PyTorch port's flash-attention backward kernels (dq,
dk/dv) between two trees of this repository.

    git archive <commit> | tar -x -C _archive/parent     # the other tree
    python3 tools/flash_bwd_ab.py --parent _archive/parent

Each run is a process of its own that imports ``paddle_tpu_torch`` from one
tree, builds that tree's kernels from its ``csrc/`` and times, at the
training, long-prompt and prefill shapes (bf16, H16 D128, causal) and at the
training shape in float32 (the master-grad pullbacks' kernels; causal and
not): the dq kernel, the dk/dv kernel and the whole backward
(``flash_attention_bwd``), a CUDA graph of 20 calls (4 in float32) timed
with CUDA events as ``chip_smoke.py`` times them, with torch's
flash-attention backward (``aten._scaled_dot_product_flash_attention_backward``;
in float32 its memory-efficient attention's) timed beside them in the same
process as the yardstick. A float32 row's bounds are at the 3xTF32 rate
its kernels run (three TF32 passes a product). A tree whose dq launcher takes ``delta``
computes it in plain torch before the kernels (its "dq" is the kernel alone,
its "backward" includes that pass); a tree whose dq launcher takes O fuses it
into the dq kernel. Each tree's gradients are compared with the library's (a
broken build shows as a large error). The runs go parent, this tree, this
tree, parent on one card, so each tree is read twice and the spread between
its two readings shows. Needs one CUDA card; prints a table, then one JSON
line with every reading.
"""
from __future__ import annotations

import argparse
import inspect
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (  # name, B, S, H, D, dtype, causal: Sq = Sk, Hq = Hkv
    ("training_shape", 8, 2048, 16, 128, "bfloat16", True),
    ("long_prompt", 1, 2048, 16, 128, "bfloat16", True),
    ("flagship_prefill", 8, 128, 16, 128, "bfloat16", True),
    ("master_grad_fp32", 8, 2048, 16, 128, "float32", True),
    ("master_grad_fp32_noncausal", 8, 2048, 16, 128, "float32", False),
)


def time_tree(tree: Path) -> dict:
    """Time ``tree``'s backward kernels and torch's backward at SHAPES."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke  # the timing and bound helpers; imports nothing at load

    sys.path.insert(0, str(tree.resolve()))
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    if not Path(fa.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"imported {fa.__file__}, not the tree {tree}")
    build_s = _build.build_all()
    plain_delta = "delta" in inspect.signature(fa._launch_bwd_dq).parameters
    gen = torch.Generator(device="cuda").manual_seed(2024)
    rows = []
    for name, B, S, H, D, dt, causal in SHAPES:
        dtype = getattr(torch, dt)
        q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=gen).to(dtype)
                       for _ in range(4))
        scale = 1.0 / math.sqrt(D)
        with torch.no_grad():
            out, lse = fa.flash_attention_fwd_lse(q, k, v, causal)
        if plain_delta:
            delta = fa._delta(out, do)
            dq_fn = lambda: fa._launch_bwd_dq(q, k, v, do, lse, delta, causal, scale)  # noqa: E731
        else:
            delta = fa._launch_bwd_dq(q, k, v, do, out, lse, causal, scale)[1]
            dq_fn = lambda: fa._launch_bwd_dq(q, k, v, do, out, lse, causal, scale)  # noqa: E731
        library = chip_smoke.library_backward(torch, q, k, v, do, causal, scale)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal)
        ref = [g.transpose(1, 2) for g in library()[:3]]
        err = max(chip_smoke.norm_rel(a, r) for a, r in zip(got, ref))
        fns = dict(
            dq=dq_fn,
            dkv=lambda: fa._launch_bwd_dkv(q, k, v, do, lse, delta, causal, scale),
            bwd=lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, causal),
            library=library)
        iters = 4 if dtype == torch.float32 else 20
        row = {f"{key}_ms": chip_smoke.device_ms(torch, fn, iters=iters)
               for key, fn in fns.items()}
        (row["dq_bound_ms"], _), (row["dkv_bound_ms"], _) = chip_smoke.backward_bounds_ms(
            B, S, S, H, H, D, causal, q.element_size())
        rows.append(dict(name=name, shape=[B, S, S, H, H, D], dtype=dt, causal=causal,
                         plain_delta=plain_delta, norm_rel_err_vs_library=err, **row))
        del q, k, v, do, out, lse, delta, got, ref, library, fns
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
        print("flash_bwd_ab: no CUDA card visible; nothing was run", file=sys.stderr)
        return 2
    runs = []
    for label, tree in (("parent", args.parent), ("change", ROOT), ("change", ROOT),
                        ("parent", args.parent)):
        proc = subprocess.run([sys.executable, __file__, "--time-tree", str(tree)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            print(f"flash_bwd_ab: the {label} run failed", file=sys.stderr)
            return 1
        runs.append(dict(json.loads(proc.stdout.strip().splitlines()[-1]), label=label))
    print(f"card: {runs[0]['card']}")
    print(f"{'shape':27} {'run':7} {'dq ms':>8} {'dk/dv ms':>9} {'bwd ms':>8} {'torch ms':>9} "
          f"{'dq bound':>9} {'dkv bound':>9} {'err vs torch':>12}")
    for i, (name, *_) in enumerate(SHAPES):
        for run in runs:
            r = run["rows"][i]
            print(f"{name:27} {run['label']:7} {r['dq_ms']:8.5f} {r['dkv_ms']:9.5f} "
                  f"{r['bwd_ms']:8.5f} {r['library_ms']:9.5f} {r['dq_bound_ms']:9.5f} "
                  f"{r['dkv_bound_ms']:9.5f} {r['norm_rel_err_vs_library']:12.3e}")
    print(json.dumps(dict(flash_bwd_ab=runs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Same-card A/B of the PyTorch port's y = 2x + 1 kernel (``csrc/axpy.cu``)
between two trees of this repository, and between named build variants of
this tree's source.

    git archive <commit> | tar -x -C _archive/parent     # the other tree
    python3 tools/axpy_ab.py --parent _archive/parent
    python3 tools/axpy_ab.py --parent _archive/parent --variant u1 --variant u2 --variant u4

Each run is a process of its own that imports ``paddle_tpu_torch`` from one
tree, builds that tree's ``csrc/axpy.cu`` (a variant adds its ``-D`` flags to
the build; the port's entry points have no such switch) and times the kernel
through its wrapper ``axpy.axpy`` as ``chip_smoke.py`` does (a CUDA graph of
20 calls, timed with CUDA events), beside two yardsticks in the same process:
``torch.add(torch.tensor(1.0), x, alpha=2)`` (one PyTorch call computing the
same function) and ``x.clone()`` (a copy of the same bytes). Shapes: 2^26
fp32 (the timed case of chip_smoke.py phase 8), 2^26 bf16, 2^26 + 3 fp32 as a
view at element offset 1 (x not 16-byte aligned: the element kernel) and 2^22
fp32 (16 MiB in and out, inside the 50 MB L2). Every kernel output is held to the
plain version bit for bit. Without ``--variant`` the runs go parent, change,
change, parent; with variants, parent, each variant, each variant in reverse
order, parent. Needs one CUDA card; prints a table, then one JSON line with
every reading.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (  # name, elements, dtype, element offset of the view
    ("fp32_2^26", 2 ** 26, "float32", 0),
    ("bf16_2^26", 2 ** 26, "bfloat16", 0),
    ("fp32_2^26+3_view1", 2 ** 26 + 3, "float32", 1),
    ("fp32_2^22", 2 ** 22, "float32", 0),
)
# named builds of this tree's csrc/axpy.cu: extra nvcc flags (the unroll
# depth U, 16-byte vectors a thread; the source's own default is 1)
VARIANTS = {
    "u1": ("-DPT_AXPY_UNROLL=1",),
    "u2": ("-DPT_AXPY_UNROLL=2",),
    "u4": ("-DPT_AXPY_UNROLL=4",),
    "u8": ("-DPT_AXPY_UNROLL=8",),
}


def time_tree(tree: Path, variant: str | None) -> dict:
    """Time ``tree``'s axpy kernel and the yardsticks at SHAPES (one process)."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke  # the timing and bound helpers; imports nothing at load

    sys.path.insert(0, str(tree.resolve()))
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import axpy

    if not Path(axpy.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"imported {axpy.__file__}, not the tree {tree}")
    if variant is not None:
        _build.NVCC_FLAGS = tuple(_build.NVCC_FLAGS) + VARIANTS[variant]
    _build.load("axpy")
    ptxas = [line.strip() for line in _build.build_log("axpy").splitlines()
             if "registers" in line or "spill" in line or "Compiling entry" in line]
    gen = torch.Generator(device="cuda").manual_seed(2026)
    one = torch.tensor(1.0)
    rows = []
    for name, n, dt, offset in SHAPES:
        dtype = getattr(torch, dt)
        x = (torch.randn(n + offset, device="cuda", generator=gen) * 100).to(dtype)[offset:]
        y = axpy.axpy(x)
        exact = chip_smoke.same_bits(torch, y, axpy.axpy_plain(x))
        nbytes = 2 * n * x.element_size()
        row = dict(name=name, numel=n, dtype=dt, x_aligned16=x.data_ptr() % 16 == 0,
                   bit_exact=exact)
        for key, fn in (("kernel", lambda: axpy.axpy(x)),
                        ("library", lambda: torch.add(one, x, alpha=2)),
                        ("clone", lambda: x.clone())):
            row[f"{key}_ms"] = chip_smoke.device_ms(torch, fn)
        row["bound_ms"], row["bound_by"] = chip_smoke.bound_ms(2.0 * n, nbytes,
                                                               chip_smoke.PEAK_FP32_FLOPS)
        row["kernel_tbps"] = nbytes / (row["kernel_ms"] * 1e-3) / 1e12
        rows.append(row)
        del x, y
        torch.cuda.empty_cache()
    return dict(tree=str(tree), variant=variant, card=chip_smoke.nvidia_smi(), ptxas=ptxas,
                rows=rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="unpacked tree of the commit to compare with")
    ap.add_argument("--variant", action="append", choices=sorted(VARIANTS), default=[],
                    help="a named build of this tree's kernel (repeatable)")
    ap.add_argument("--time-tree", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--time-variant", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_tree is not None:
        print(json.dumps(time_tree(args.time_tree, args.time_variant)), flush=True)
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    import torch

    if not torch.cuda.is_available():
        print("axpy_ab: no CUDA card visible; nothing was run", file=sys.stderr)
        return 2
    changes = [("change", v) for v in args.variant] or [("change", None)]
    order = ([("parent", None)] + changes + changes[::-1] + [("parent", None)]
             if args.variant else
             [("parent", None), ("change", None), ("change", None), ("parent", None)])
    runs = []
    for label, variant in order:
        tree = args.parent if label == "parent" else ROOT
        cmd = [sys.executable, __file__, "--time-tree", str(tree)]
        if variant is not None:
            cmd += ["--time-variant", variant]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            print(f"axpy_ab: the {label} {variant or ''} run failed", file=sys.stderr)
            return 1
        runs.append(dict(json.loads(proc.stdout.strip().splitlines()[-1]), label=label))
    print(f"card: {runs[0]['card']}")
    print(f"{'shape':18} {'run':20} {'kernel ms':>10} {'add ms':>9} {'clone ms':>9} "
          f"{'bound ms':>9} {'TB/s':>6} exact")
    for i, (name, *_) in enumerate(SHAPES):
        for run in runs:
            r = run["rows"][i]
            who = run["label"] + (f":{run['variant']}" if run["variant"] else "")
            print(f"{name:18} {who:20} {r['kernel_ms']:10.5f} {r['library_ms']:9.5f} "
                  f"{r['clone_ms']:9.5f} {r['bound_ms']:9.5f} {r['kernel_tbps']:6.3f} "
                  f"{r['bit_exact']}")
    for run in runs[1:len(runs) // 2]:
        print(f"ptxas {run['variant'] or 'change'}: {' | '.join(run['ptxas'])}")
    print(json.dumps(dict(axpy_ab=runs)), flush=True)
    bad = [(run["label"], run["variant"], r["name"]) for run in runs for r in run["rows"]
           if not r["bit_exact"]]
    if bad:
        print(f"axpy_ab: kernel output differs from the plain version at {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

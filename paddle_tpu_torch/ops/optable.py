"""The op table: the port of ``paddle_tpu/ops/optable.py`` over the port's
registry. Each row: name, module (the port file that defines the op),
signature of the op's function, ``differentiable``, ``amp_category`` and the
first docstring line. Custom ops (``utils.register_custom_op``) are left out
unless ``include_custom=True``.

    python -m paddle_tpu_torch.ops.optable   # writes docs/torch_ops.md
"""
from __future__ import annotations

import inspect
import os

from ._apply import get_registry


def op_table(include_custom=False):
    """Every registered op, sorted by name."""
    from ..utils.custom_op import _CUSTOM_OPS

    rows = []
    for name, opdef in sorted(get_registry().items()):
        fn = opdef.fn
        module = getattr(fn, "__module__", "") or ""
        if not include_custom and (name in _CUSTOM_OPS
                                   or not module.startswith("paddle_tpu_torch.")):
            continue
        try:
            sig = str(inspect.signature(fn))
        except (TypeError, ValueError):
            sig = "(...)"
        doc = inspect.getdoc(fn) or ""
        rows.append({
            "name": name,
            "module": module,
            "signature": sig,
            "differentiable": bool(opdef.differentiable),
            "amp_category": opdef.amp_category or "-",
            "summary": doc.splitlines()[0] if doc else "",
        })
    return rows


def generate_op_docs(path=None):
    """Render the op table to markdown (``docs/torch_ops.md`` when ``path``
    is None); returns the path."""
    if path is None:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        path = os.path.join(repo, "docs", "torch_ops.md")
    rows = op_table()
    by_module = {}
    for r in rows:
        by_module.setdefault(r["module"].rsplit(".", 1)[-1], []).append(r)
    lines = [
        "# paddle_tpu_torch op registry",
        "",
        f"{len(rows)} ops registered via `defop` (paddle_tpu_torch/ops/_apply.py). "
        "Regenerate with `python -m paddle_tpu_torch.ops.optable`.",
        "",
    ]
    for module in sorted(by_module):
        lines += [f"## {module} ({len(by_module[module])} ops)", "",
                  "| op | signature | grad | amp |", "|---|---|---|---|"]
        for r in by_module[module]:
            sig = r["signature"].replace("|", "\\|")
            lines.append(f"| `{r['name']}` | `{sig}` | "
                         f"{'yes' if r['differentiable'] else 'no'} | {r['amp_category']} |")
        lines.append("")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


if __name__ == "__main__":
    import paddle_tpu_torch  # noqa: F401  (fills the registry)

    print(generate_op_docs())

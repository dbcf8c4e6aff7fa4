"""Numerical health for the trainer's NaN watchdog.

Port of pixart_sigma_tpu/utils/debug.py. `tree_health`, `find_nonfinite` and
`format_health_report` read a dict of named tensors (parameters, gradients,
the EMA). `first_bad_module` reruns a forward with hooks on every module and
names the first one, in execution order, whose output is non-finite or
above the fp16 maximum: the upstream DebugUnderflowOverflow's localisation,
which the JAX package gets from flax's captured intermediates.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

FP16_MAX = 65504.0  # the overflow threshold of the upstream tracer


@torch.no_grad()
def tree_health(tensors: Dict[str, torch.Tensor]) -> Dict[str, Tuple[float, float, float]]:
    """{name: (finite fraction, abs max, smallest nonzero abs)}."""
    out: Dict[str, Tuple[float, float, float]] = {}
    for name, t in tensors.items():
        a = t.detach().float().abs()
        finite = float(torch.isfinite(a).float().mean()) if a.numel() else 1.0
        amax = float(a.max()) if a.numel() else 0.0
        nz = a[a > 0]
        out[name] = (finite, amax, float(nz.min()) if nz.numel() else 0.0)
    return out


def find_nonfinite(tensors: Dict[str, torch.Tensor]) -> List[str]:
    """Names of the tensors holding NaN or Inf."""
    return [n for n, (finite, _, _) in tree_health(tensors).items() if finite < 1.0]


def format_health_report(tensors: Dict[str, torch.Tensor], top: int = 10) -> str:
    """The `top` worst tensors by abs max."""
    rows = sorted(tree_health(tensors).items(), key=lambda kv: -kv[1][1])[:top]
    lines = [f"{'tensor':60s} finite%   abs_max    abs_min"]
    for name, (finite, amax, amin) in rows:
        lines.append(f"{name[:60]:60s} {finite * 100:6.2f}  {amax:.3e}  {amin:.3e}")
    return "\n".join(lines)


def _first_tensor(out: Any) -> Optional[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, (tuple, list)) and out and isinstance(out[0], torch.Tensor):
        return out[0]
    return None


@torch.no_grad()
def first_bad_module(model: nn.Module, run: Callable[[], Any],
                     threshold: float = FP16_MAX) -> Optional[Dict[str, Any]]:
    """Run `run()` (a forward of `model`) with a hook on every submodule and
    return the first module, in the order the outputs were produced, whose
    output is non-finite or above `threshold`: {'module', 'layer',
    'abs_max', 'nonfinite'}, or None when all are sound."""
    found: List[Dict[str, Any]] = []

    def hook(name):
        def fn(_mod, _inp, out):
            t = _first_tensor(out)
            if found or t is None or not t.is_floating_point():
                return
            a = t.detach().float().abs()
            bad = not bool(torch.isfinite(a).all())
            amax = float(torch.nan_to_num(a, nan=0.0, posinf=float("inf")).max())
            if bad or amax > threshold:
                parts = name.split(".")
                layer = int(parts[1]) if parts[0] == "blocks" and len(parts) > 1 else None
                found.append({"module": name, "layer": layer, "abs_max": amax,
                              "nonfinite": bad})
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules() if n]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return found[0] if found else None


def format_overflow_report(bad: Optional[Dict[str, Any]]) -> str:
    if bad is None:
        return "forward trace: all module outputs finite and under fp16 max"
    where = bad["module"] + (f" [layer {bad['layer']}]" if bad["layer"] is not None else "")
    kind = "non-finite" if bad["nonfinite"] else f"overflow (> {FP16_MAX:.0f})"
    return f"first bad module output: {where} — {kind}, abs_max={bad['abs_max']:.3e}"

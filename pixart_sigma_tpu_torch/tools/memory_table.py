"""Per-rank training-state memory across mesh configurations.

Port of tools/memory_table.py: how many bytes of parameters, optimizer state
(CAME) and EMA land on ONE rank of a (data, fsdp, tensor) mesh for
PixArt-Sigma-XL-2, reckoned from the shapes (the model built on the meta
device: no arrays, no process group) and the placement rule of
`parallel.mesh` (`leaf_spec`, which `param_placement` applies to each
parameter), applied as the JAX tool applies it: to every leaf of the JAX
trees (the parameters in the JAX layout, scan groups stacked; CAME's
momentum, factored row and column statistics and their confidence
statistics, and its step count; the EMA), each by its own shape at its
parameter's path. A seq axis holds no state of its own: its ranks hold
what their (data, fsdp, tensor) coordinates give.

    python -m pixart_sigma_tpu_torch.tools.memory_table [--image-size 1024] [--markdown]
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Dict, List, Sequence, Tuple

DEFAULT_MESHES = "8,1,1;4,2,1;2,4,1;1,8,1;2,2,2;1,4,2"
F32 = 4  # bytes of every state leaf, as JAX keeps them (the count is int32, also 4)


def jax_leaves(image_size: int = 1024) -> List[Tuple[Tuple[str, ...], Tuple[int, ...]]]:
    """(path names, shape) of every leaf of the JAX param tree of
    PixArt-XL-2 at `image_size`, from the port model on the meta device."""
    import torch

    from pixart_sigma_tpu_torch.models.pixart import PixArt, PixArtConfig
    from pixart_sigma_tpu_torch.parallel.mesh import jax_leaf
    from pixart_sigma_tpu_torch.utils.checkpoint import jax_param_path

    cfg = PixArtConfig(input_size=image_size // 8, model_max_length=300,
                       pe_interpolation=image_size / 512.0)
    with torch.device("meta"):
        model = PixArt(cfg)
    leaves: Dict[str, Tuple[int, ...]] = {}
    for name, p in model.named_parameters():
        leaves[jax_param_path(name, cfg)] = tuple(jax_leaf(name, p.shape, cfg)[0])
    return [(tuple(path.split("/")), shape) for path, shape in leaves.items()]


def came_leaves(shape: Tuple[int, ...]) -> List[Tuple[int, ...]]:
    """The shapes of CAME's state for one parameter leaf (JAX's `CameState`):
    the momentum; the row and column second moments (the full second moment
    and a (1,) placeholder for a vector); the confidence row and column."""
    if len(shape) >= 2:
        row, col = shape[:-1], shape[:-2] + shape[-1:]
    else:
        row, col = shape, (1,)
    return [shape, row, col, row, col]


def sharded_bytes(leaves, fsdp_size: int, tp_size: int, min_size: int = 2**16) -> int:
    """Bytes on one rank of the f32 leaves [(path names, shape)] under the
    placement rule over fsdp and tensor axes of these sizes."""
    from pixart_sigma_tpu_torch.parallel.mesh import leaf_spec

    total = 0
    for names, shape in leaves:
        t_axis, f_axis = leaf_spec(shape, names, fsdp_size=fsdp_size, tp_size=tp_size,
                                   fsdp=fsdp_size > 1, tensor=tp_size > 1, min_size=min_size)
        div = (tp_size if t_axis is not None else 1) * (fsdp_size if f_axis is not None else 1)
        total += math.prod(shape) * F32 // div
    return total


def memory_rows(image_size: int, meshes: Sequence[Tuple[int, int, int]]) -> list:
    """[(data, fsdp, tensor, {"params", "opt(CAME)", "ema": bytes}, total)]."""
    params = jax_leaves(image_size)
    opt = [(names, s) for names, shape in params for s in came_leaves(shape)] + [((), ())]
    rows = []
    for d, f, t in meshes:
        per = {"params": sharded_bytes(params, f, t), "opt(CAME)": sharded_bytes(opt, f, t),
               "ema": sharded_bytes(params, f, t)}
        rows.append((d, f, t, per, sum(per.values())))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--image-size", type=int, default=1024)
    p.add_argument("--markdown", action="store_true")
    p.add_argument("--meshes", default=DEFAULT_MESHES,
                   help="semicolon list of data,fsdp,tensor triples")
    args = p.parse_args(argv)
    meshes = [tuple(int(x) for x in m.split(",")) for m in args.meshes.split(";")]
    n_params = sum(math.prod(s) for _, s in jax_leaves(args.image_size))
    print(f"# PixArt-XL-2 {args.image_size}px — {n_params / 1e6:.0f}M params, CAME + EMA, "
          "fp32 state", file=sys.stderr)
    rows = memory_rows(args.image_size, meshes)
    repl_total = rows[0][4] if rows and rows[0][1] == 1 and rows[0][2] == 1 else None
    hdr = ("mesh (dxfxt)", "params", "opt(CAME)", "ema", "total/device", "vs replicated")
    if args.markdown:
        print("| " + " | ".join(hdr) + " |")
        print("|" + "---|" * len(hdr))
    else:
        print(("{:>14}" + "{:>12}" * 5).format(*hdr))
    for d, f, t, per, total in rows:
        gib = lambda b: f"{b / 2**30:.2f} GiB"
        frac = f"{total / repl_total:.2f}x" if repl_total else "-"
        cells = (f"{d}x{f}x{t}", gib(per["params"]), gib(per["opt(CAME)"]), gib(per["ema"]),
                 gib(total), frac)
        if args.markdown:
            print("| " + " | ".join(cells) + " |")
        else:
            print(("{:>14}" + "{:>12}" * 5).format(*cells))


if __name__ == "__main__":
    main()

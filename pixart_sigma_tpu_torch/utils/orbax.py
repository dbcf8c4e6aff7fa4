"""The JAX trainer's orbax checkpoints, read without orbax, tensorstore or JAX.

The JAX package's `save_train_state` writes {params, opt_state, step,
ema_params} with orbax's `StandardCheckpointer` into a `step_<N>`
directory: `_CHECKPOINT_METADATA` (a commit marker), `_METADATA` (JSON: the
tree's key paths and each leaf's value type, and whether the arrays are
zarr v2 on OCDBT), and the OCDBT store (`utils/ocdbt.py`) whose keys are
zarr v2 arrays (`utils/zarr.py`) named by the dotted key path
("params.blocks_scan_0.attn.qkv.kernel"). A run keeps those directories
under `<work_dir>/checkpoints/`.

`read_tree` rebuilds a nested dict of the tree, or of one top-level subtree
("params", "ema_params", "opt_state", "step"), from `_METADATA`: a dict
key (key type 2) stays a str, a sequence index (key type 1, optax's chains
and named tuples' positions) is an int key; leaves are numpy arrays, or
torch.bfloat16 tensors for bfloat16 arrays. `None` leaves and empty
containers are skipped, as orbax's restore without a template skips
them. Arrays are read by a few threads: the C++ decoder runs without the
interpreter lock.
"""

from __future__ import annotations

import json
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

from pixart_sigma_tpu_torch.utils.ocdbt import OcdbtStore
from pixart_sigma_tpu_torch.utils.zarr import read_array

COMMIT_MARKER = "_CHECKPOINT_METADATA"
ARRAY_TYPES = ("jax.Array", "np.ndarray")
SKIPPED_TYPES = ("None", "Tuple", "Dict", "List")  # empty containers and None
READ_THREADS = 8


def latest_step_dir(ckpt_dir: str) -> Optional[str]:
    """The `step_<N>` directory of the largest N under `ckpt_dir`, or None (the
    JAX package's `latest_checkpoint`)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in map(re.compile(r"step_(\d+)").fullmatch,
                                          os.listdir(ckpt_dir)) if m]
    if not steps:
        return None
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{max(steps)}")


def is_orbax_dir(path: str) -> bool:
    """A `step_<N>` directory, or a `checkpoints/` or run directory holding one
    (the JAX package's `_is_orbax_dir`)."""
    return (os.path.exists(os.path.join(path, COMMIT_MARKER))
            or latest_step_dir(path) is not None
            or latest_step_dir(os.path.join(path, "checkpoints")) is not None)


def resolve_step_dir(path: str) -> str:
    """`path` itself when it holds a checkpoint (its commit marker), else the
    newest `step_<N>` of `path` or of `path/checkpoints`."""
    path = os.path.abspath(path)
    if os.path.exists(os.path.join(path, COMMIT_MARKER)):
        return path
    for cand in (path, os.path.join(path, "checkpoints")):
        latest = latest_step_dir(cand)
        if latest is not None:
            return latest
    raise FileNotFoundError(f"no orbax checkpoint at {path}: no {COMMIT_MARKER} in it, and no "
                            "step_N in it or in its checkpoints/")


def _tree_metadata(step_dir: str) -> Dict[str, Any]:
    for name in (COMMIT_MARKER, "_METADATA"):
        if not os.path.isfile(os.path.join(step_dir, name)):
            raise FileNotFoundError(
                f"{step_dir} has no {name}: not a finished orbax checkpoint (orbax writes "
                f"{COMMIT_MARKER} last)")
    with open(os.path.join(step_dir, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise NotImplementedError(
            f"{step_dir}: arrays stored with use_ocdbt={meta.get('use_ocdbt')}, "
            f"use_zarr3={meta.get('use_zarr3')}; the port reads zarr v2 on OCDBT, what the "
            "JAX package's save_train_state writes")
    return meta["tree_metadata"]


def leaves(step_dir: str, subtree: Optional[str] = None) -> List[tuple]:
    """The key path of every array leaf, of the whole tree or of top-level
    key `subtree`; key paths hold str and int keys."""
    out = []
    for entry in _tree_metadata(step_dir).values():
        path = tuple(k["key"] if k["key_type"] == 2 else int(k["key"])
                     for k in entry["key_metadata"])
        vtype = entry["value_metadata"]["value_type"]
        if subtree is not None and path[0] != subtree:
            continue
        if vtype in SKIPPED_TYPES:
            continue
        if vtype not in ARRAY_TYPES:
            raise NotImplementedError(f"{step_dir}: leaf {path} has value type {vtype!r}; "
                                      f"the port reads {ARRAY_TYPES}")
        out.append(path)
    return out


def read_tree(step_dir: str, subtree: Optional[str] = None) -> Dict[Any, Any]:
    """The checkpoint's tree (or its top-level `subtree`, without that key)
    as nested dicts of arrays."""
    step_dir = os.path.abspath(step_dir)
    found = leaves(step_dir, subtree)
    if subtree is not None and not found:
        raise KeyError(f"{step_dir} has no {subtree!r}")
    store = OcdbtStore(step_dir)
    names = [".".join(map(str, path)) for path in found]
    with ThreadPoolExecutor(min(READ_THREADS, max(len(names), 1))) as pool:
        arrays = list(pool.map(lambda n: read_array(store, n), names))
    tree: Dict[Any, Any] = {}
    for path, arr in zip(found, arrays):
        keys = path[1:] if subtree is not None else path
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if keys:
            node[keys[-1]] = arr
        else:
            return arr  # a leaf at the top: "step"
    return tree


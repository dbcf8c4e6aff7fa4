"""Python-file configs with `_base_` inheritance (the files under `configs/`).

Port of pixart_sigma_tpu/config.py: exec the file, merge it over its bases
(dicts deep-merged, everything else overridden) and expose attribute access.
The config files import nothing, so the port reads them as data.
"""

from __future__ import annotations

import copy
import os
import pprint
from typing import Any, Dict


class Config(dict):
    """dict with attribute access (nested dicts stay plain dicts)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(pprint.pformat(dict(self), width=100, sort_dicts=True))


def _exec_config(path: str) -> Dict[str, Any]:
    namespace: Dict[str, Any] = {"__file__": os.path.abspath(path)}
    with open(path) as f:
        code = f.read()
    exec(compile(code, path, "exec"), namespace)
    return {
        k: v
        for k, v in namespace.items()
        if not k.startswith("__") and not callable(v) or k == "tau_fn"
    }


def _deep_merge(base: Dict[str, Any], child: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for k, v in child.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def read_config(path: str) -> Config:
    """Load a python config file, resolving `_base_` inheritance."""
    ns = _exec_config(path)
    bases = ns.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for base in bases:
        base_path = os.path.join(os.path.dirname(os.path.abspath(path)), base)
        merged = _deep_merge(merged, read_config(base_path))
    merged = _deep_merge(merged, ns)
    return Config(merged)

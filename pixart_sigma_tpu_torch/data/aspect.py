"""Aspect-ratio bucket tables (port of pixart_sigma_tpu/data/aspect.py).

The 512/1024/2048 tables are x2/x4/x8 scalings of the 256 base table; the
*_TEST variants drop a fixed set of rare ratio keys.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

_BASE_256: Dict[str, Tuple[float, float]] = {
    "0.25": (128, 512), "0.26": (128, 496), "0.27": (128, 480), "0.28": (128, 464),
    "0.32": (144, 448), "0.33": (144, 432), "0.35": (144, 416), "0.4": (160, 400),
    "0.42": (160, 384), "0.48": (176, 368), "0.5": (176, 352), "0.52": (176, 336),
    "0.57": (192, 336), "0.6": (192, 320), "0.68": (208, 304), "0.72": (208, 288),
    "0.78": (224, 288), "0.82": (224, 272), "0.88": (240, 272), "0.94": (240, 256),
    "1.0": (256, 256), "1.07": (256, 240), "1.13": (272, 240), "1.21": (272, 224),
    "1.29": (288, 224), "1.38": (288, 208), "1.46": (304, 208), "1.67": (320, 192),
    "1.75": (336, 192), "2.0": (352, 176), "2.09": (368, 176), "2.4": (384, 160),
    "2.5": (400, 160), "2.89": (416, 144), "3.0": (432, 144), "3.11": (448, 144),
    "3.62": (464, 128), "3.75": (480, 128), "3.88": (496, 128), "4.0": (512, 128),
}


def _scaled(scale: int) -> Dict[str, List[float]]:
    return {k: [h * scale, w * scale] for k, (h, w) in _BASE_256.items()}


def _without(table: Dict[str, List[float]], keys: Iterable[str]):
    drop = set(keys)
    return {k: v for k, v in table.items() if k not in drop}


_TEST_DROP_SMALL = ("0.26", "0.27", "2.89", "3.11", "3.62", "3.75", "3.88")
_TEST_DROP_2048 = ("0.27", "0.28", "2.89", "3.11", "3.62", "3.75", "3.88")

_TABLES = {256: _scaled(1), 512: _scaled(2), 1024: _scaled(4), 2048: _scaled(8)}
_TEST_TABLES = {
    256: _without(_scaled(1), _TEST_DROP_SMALL),
    512: _without(_scaled(2), _TEST_DROP_SMALL),
    1024: _without(_scaled(4), _TEST_DROP_SMALL),
    2048: _without(_scaled(8), _TEST_DROP_2048),
}


def aspect_ratio_table(base_resolution: int, test: bool = False):
    """Bucket table for a base resolution; other sizes get one square bucket.
    (The hand-tuned 2880 grid is not ported yet.)"""
    tables = _TEST_TABLES if test else _TABLES
    if base_resolution not in tables:
        return {"1.0": [float(base_resolution), float(base_resolution)]}
    return tables[base_resolution]


def get_closest_ratio(height: float, width: float, ratios: Dict[str, List[float]]):
    """(bucket [H, W], ratio_key_as_float) for the nearest bucket."""
    aspect = height / width
    key = min(ratios.keys(), key=lambda r: abs(float(r) - aspect))
    return ratios[key], float(key)

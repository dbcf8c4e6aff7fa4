"""Aspect-ratio bucket tables (port of pixart_sigma_tpu/data/aspect.py).

The 512/1024/2048 tables are x2/x4/x8 scalings of the 256 base table and
2880 is its own hand-tuned grid; the *_TEST variants drop a fixed set of rare
ratio keys, and 2880_TEST is the x16 scaling of the base minus the 2048-test
drops (its square bucket is 4096 x 4096).
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


# multiples of 64, hand-tuned around 2880px
ASPECT_RATIO_2880: Dict[str, List[float]] = {
    "0.25": [1408.0, 5760.0], "0.26": [1408.0, 5568.0], "0.27": [1408.0, 5376.0],
    "0.28": [1408.0, 5184.0], "0.32": [1600.0, 4992.0], "0.33": [1600.0, 4800.0],
    "0.34": [1600.0, 4672.0], "0.4": [1792.0, 4480.0], "0.42": [1792.0, 4288.0],
    "0.47": [1920.0, 4096.0], "0.49": [1920.0, 3904.0], "0.51": [1920.0, 3776.0],
    "0.55": [2112.0, 3840.0], "0.59": [2112.0, 3584.0], "0.68": [2304.0, 3392.0],
    "0.72": [2304.0, 3200.0], "0.78": [2496.0, 3200.0], "0.83": [2496.0, 3008.0],
    "0.89": [2688.0, 3008.0], "0.93": [2688.0, 2880.0], "1.0": [2880.0, 2880.0],
    "1.07": [2880.0, 2688.0], "1.12": [3008.0, 2688.0], "1.21": [3008.0, 2496.0],
    "1.28": [3200.0, 2496.0], "1.39": [3200.0, 2304.0], "1.47": [3392.0, 2304.0],
    "1.7": [3584.0, 2112.0], "1.82": [3840.0, 2112.0], "2.03": [3904.0, 1920.0],
    "2.13": [4096.0, 1920.0], "2.39": [4288.0, 1792.0], "2.5": [4480.0, 1792.0],
    "2.92": [4672.0, 1600.0], "3.0": [4800.0, 1600.0], "3.12": [4992.0, 1600.0],
    "3.68": [5184.0, 1408.0], "3.82": [5376.0, 1408.0], "3.95": [5568.0, 1408.0],
    "4.0": [5760.0, 1408.0],
}

_TEST_DROP_SMALL = ("0.26", "0.27", "2.89", "3.11", "3.62", "3.75", "3.88")
_TEST_DROP_2048 = ("0.27", "0.28", "2.89", "3.11", "3.62", "3.75", "3.88")

_TABLES = {256: _scaled(1), 512: _scaled(2), 1024: _scaled(4), 2048: _scaled(8),
           2880: ASPECT_RATIO_2880}
_TEST_TABLES = {
    256: _without(_scaled(1), _TEST_DROP_SMALL),
    512: _without(_scaled(2), _TEST_DROP_SMALL),
    1024: _without(_scaled(4), _TEST_DROP_SMALL),
    2048: _without(_scaled(8), _TEST_DROP_2048),
    2880: _without(_scaled(16), _TEST_DROP_2048),
}


def aspect_ratio_table(base_resolution: int, test: bool = False):
    """Bucket table for a base resolution; other sizes get one square bucket."""
    tables = _TEST_TABLES if test else _TABLES
    if base_resolution not in tables:
        return {"1.0": [float(base_resolution), float(base_resolution)]}
    return tables[base_resolution]


def get_closest_ratio(height: float, width: float, ratios: Dict[str, List[float]]):
    """(bucket [H, W], ratio_key_as_float) for the nearest bucket."""
    aspect = height / width
    key = min(ratios.keys(), key=lambda r: abs(float(r) - aspect))
    return ratios[key], float(key)


def get_chunks(lst, n):
    """Yield n-sized chunks of `lst`."""
    for i in range(0, len(lst), n):
        yield lst[i : i + n]

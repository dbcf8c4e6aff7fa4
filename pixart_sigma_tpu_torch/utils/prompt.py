"""`--ar h:w` / `--hw h:w` prompt flags (port of pixart_sigma_tpu/utils/prompt.py)."""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np


def prepare_prompt_ar(prompt: str, ratios: Dict[str, Tuple[float, float]]):
    """Parse `--ar h:w` / `--hw h:w` out of a prompt; snap to the closest bin.

    Returns (clean_prompt, hw [1, 2], ar [1, 1], custom_hw [1, 2]) float32.
    """
    prompt_clean = prompt.strip()
    ar_match = re.search(r"--ar\s+(\d+):(\d+)", prompt_clean)
    hw_match = re.search(r"--hw\s+(\d+):(\d+)", prompt_clean)
    custom_h = custom_w = None
    if hw_match:
        custom_h, custom_w = float(hw_match.group(1)), float(hw_match.group(2))
        ar_val = custom_h / custom_w
    elif ar_match:
        ar_val = float(ar_match.group(1)) / float(ar_match.group(2))
    else:
        ar_val = 1.0
    key = min(ratios.keys(), key=lambda r: abs(float(r) - ar_val))
    default_hw = ratios[key]
    prompt_clean = re.sub(r"--ar\s+\d+:\d+", "", prompt_clean)
    prompt_clean = re.sub(r"--hw\s+\d+:\d+", "", prompt_clean).strip()
    custom_hw = default_hw if custom_h is None else [custom_h, custom_w]
    return (
        prompt_clean,
        np.asarray([default_hw], dtype=np.float32),
        np.asarray([[float(key)]], dtype=np.float32),
        np.asarray([custom_hw], dtype=np.float32),
    )

"""Image transforms (PIL and numpy), port of pixart_sigma_tpu/data/transforms.py.

`default_train`: RGB -> shorter side to the resolution (bicubic) -> center
crop -> Normalize(0.5, 0.5); `multiscale_train`: scale to cover the
bucket's size (bicubic) -> center crop. Outputs are channel-last float32
in [-1, 1]. PIL is imported where used, so the feature-only paths run
without it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("image-mode data needs PIL (`pillow`)") from e
    return Image


def open_image(path: str):
    """A PIL image of the file (use as a context manager)."""
    return _pil_image().open(path)


def resize_shorter(img, size: int):
    """torchvision Resize(size) semantics: shorter side -> size, bicubic."""
    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(1, round(h * size / w))
    else:
        new_w, new_h = max(1, round(w * size / h)), size
    return img.resize((new_w, new_h), _pil_image().BICUBIC)


def center_crop(img, crop_h: int, crop_w: int):
    w, h = img.size
    left = int(round((w - crop_w) / 2.0))
    top = int(round((h - crop_h) / 2.0))
    return img.crop((left, top, left + crop_w, top + crop_h))


def resize_and_crop(img, target_h: int, target_w: int):
    """Scale to cover (target_h, target_w), then center-crop (the
    multi-scale transform)."""
    w, h = img.size
    scale = max(target_h / h, target_w / w)
    img = img.resize((round(w * scale), round(h * scale)), _pil_image().BICUBIC)
    return center_crop(img, target_h, target_w)


def to_normalized_array(img) -> np.ndarray:
    """PIL image -> float32 [H, W, 3] in [-1, 1] (Normalize(0.5, 0.5))."""
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0


def default_train(img, resolution: int) -> np.ndarray:
    img = resize_shorter(img, resolution)
    img = center_crop(img, resolution, resolution)
    return to_normalized_array(img)


def multiscale_train(img, target_hw: Tuple[int, int]) -> np.ndarray:
    th, tw = int(target_hw[0]), int(target_hw[1])
    return to_normalized_array(resize_and_crop(img, th, tw))
